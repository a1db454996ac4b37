"""``train_steps_per_s``: training steps completed over the window's wall
time, which ends in ``torch.cuda.synchronize()``; host clock."""


def read(w):
    if w.steps == 0 or w.wall_s <= 0:
        return None
    return w.steps / w.wall_s
