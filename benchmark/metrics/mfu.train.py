"""``mfu.train``: the model operations of the traced window's training
steps (``work['model_flops']`` a step, from ``counts.step_model_flops``:
forward plus twice the forward, no recompute) over the window's time, as a
share of the dense TF32 peak (``counts.PEAK_FLOPS``), in percent."""

from benchmark import counts


def read(w):
    flops = w.work.get("model_flops")
    if not (w.on_card and w.traced and w.steps and flops):
        return None
    return 100.0 * w.steps * flops / (w.window_s * counts.PEAK_FLOPS)
