"""Training CLI of the port (counterpart of the root train.py).

    python -m moco_flow_tpu_torch.train -c cfg.yaml [-r ckpt.npz] \
        [-n job_name] [-s seed] [--device cuda|cpu]

Trains the stage that ``model.type`` names (``train/__init__.py``:
``nerf``, stage 1; ``nof``, stage 2; ``moco_flow``, stage 3), resuming from the newest checkpoint under ``save_dir/exp_name/*/ckpts``
and then from ``-r`` (parameters, the optimizers' state, the clock and the
stage's extra state; a checkpoint of either package). Checkpoints go to
``save_dir/exp_name/<job_name>/ckpts`` every ``save_every_n_step`` steps and
as ``final`` at the end. ``train(config, args)`` takes the config as a dict,
so callers can skip YAML.

Stages 1 and 2 train with their optimizer (``radam`` in ``init_nerf.yaml``,
``adam`` in ``init_nof.yaml``); every phase of stage 3's NoF-supervision
schedule trains (``full``, ``none``, ``msk``; ``MoCoFlowTrainer.phase``).
As in the JAX loop, every ``val_every_n_step`` steps the trainer runs its
val step and then ``visualize_batch``, and once more ``visualize_batch``
after the last step. Stage 2 visualises nothing; the visualisation of
stages 1 and 3 (``train/vis.py``: the spherical video and the mesh) is not
ported, so for them ``val_every_n_step > 0`` raises and names its ROADMAP
item (``trainer.val_func()`` runs the val step alone).
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import time

from . import get_trainer
from .base import BaseTrainer
from .checkpoint import find_latest_checkpoint

def job_dir(config: dict, args) -> str:
    name = getattr(args, "job_name", None) or time.strftime("%b%d_%H%M%S")
    return osp.join(config.get("save_dir", "./log"),
                    config.get("exp_name", "exp"), name)


def train(config: dict, args, smpl_data=None, scene=None) -> BaseTrainer:
    """Build the trainer, resume, and step the clock up to
    ``trainer.num_iters``.

    ``scene``: an in-memory ``SyntheticScene`` in place of the files under
    ``dataloader.root_dir``."""
    tcfg = config["trainer"]
    val_every = tcfg.get("val_every_n_step", 0)
    seed = int(args.seed) if getattr(args, "seed", None) is not None else 0
    trainer = get_trainer(config, device=getattr(args, "device", "cuda"),
                          seed=seed, smpl_data=smpl_data, scene=scene)
    if val_every and not trainer.vis_ported:
        raise NotImplementedError(
            f"val_every_n_step > 0 needs {type(trainer).__name__}'s "
            "visualisation after each val step (train/vis.py), which is not "
            "ported yet: ROADMAP 'Modules to port' item 4; set it to 0 and "
            "call trainer.val_func()")
    trainer.job_dir = job_dir(config, args)
    os.makedirs(osp.join(trainer.job_dir, "ckpts"), exist_ok=True)
    trainer.build_model(config["model"])
    trainer.prepare_dataloader(config["dataloader"])     # val
    trainer.prepare_train_data(config["dataloader"])     # its num_frames wins
    trainer.configure_optimizers(config["optimizer"], config.get("scheduler"))
    latest = find_latest_checkpoint(osp.join(trainer.save_dir, "*", "ckpts",
                                             "*.npz"))
    for ckpt in (latest, args.resume):
        if ckpt:
            trainer.load_ckpt(ckpt)
    clock = trainer.clock
    save_every = tcfg.get("save_every_n_step", 0)
    epoch_len = max(trainer.num_frames, 1)
    while clock.step < tcfg["num_iters"]:
        trainer.train_func()
        if val_every and clock.step % val_every == 0:
            trainer.val_func()
            trainer.visualize_batch()
        if save_every and clock.step % save_every == 0 and clock.step > 0:
            trainer.save_ckpt()
        clock.tick()
        if clock.minibatch >= epoch_len:
            clock.tock()
    if val_every:
        trainer.visualize_batch()
    trainer.save_ckpt("final")
    return trainer


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="training (port)")
    p.add_argument("-c", "--config", required=True, type=str)
    p.add_argument("-r", "--resume", default=None, type=str)
    p.add_argument("-n", "--job_name", default=None, type=str)
    p.add_argument("-s", "--seed", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (the plain versions)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import yaml
    path = args.config
    if args.resume:
        # as the JAX CLI: the config saved beside the checkpoint's run wins
        saved = osp.join(osp.dirname(osp.dirname(args.resume)), "config.yaml")
        if osp.exists(saved):
            path = saved
    with open(path) as f:
        config = yaml.safe_load(f)
    if args.job_name is None:
        args.job_name = time.strftime("%b%d_%H%M%S")
    out = job_dir(config, args)
    os.makedirs(out, exist_ok=True)
    with open(osp.join(out, "config.yaml"), "w") as f:
        yaml.safe_dump(config, f)
    train(config, args)


if __name__ == "__main__":
    main()
