"""Training CLI of the port (counterpart of the root train.py).

    python -m moco_flow_tpu_torch.train -c cfg.yaml [-r ckpt.npz] \
        [-n job_name] [-s seed] [--device cuda|cpu] [--profile] \
        [--num_devices N] [--dist] [--coordinator_address HOST:PORT \
        --num_processes N --process_id R]

Reads the YAML with ``utils/config.py`` (no YAML package needed), so the
published configs run as written. Trains the stage that ``model.type``
names (``train/__init__.py``: ``nerf``, stage 1; ``nof``, stage 2;
``moco_flow``, stage 3) in the layout
``save_dir/exp_name/<job_name>/{ckpts,log,code,config.yaml}``: checkpoints
every ``save_every_n_step`` steps and as ``final`` at the end, ``log.txt``
and ``metrics.jsonl`` in ``log/`` (``train/`` scalars on log steps,
``valid/`` after each val step), the package's source in ``code/``. It
resumes from the newest checkpoint under ``save_dir/exp_name/*/ckpts`` and
then from ``-r`` (parameters, the optimizers' state, the clock and the
stage's extra state; a checkpoint of either package); with ``-r`` the
config saved beside the checkpoint's run wins, as in JAX.

As in the JAX loop, every ``val_every_n_step`` steps the trainer runs its
val step and then ``visualize_batch`` (``train/vis.py``: stages 1 and 3
write a frame strip, the 90-view canonical orbit and the canonical mesh;
stage 2 nothing), and once more ``visualize_batch`` after the last step.
``--profile`` wraps the run in ``torch.profiler`` (``log/plugins/profile``),
whose trace shows each step's ``train.*`` spans and the renderer's
``render.*`` ones (``utils/logging.py::span``).
``train(config, args)`` takes the config as a dict or a ``Config``.

Data parallelism (``parallel/``): ``main`` trains one rank a device, each
drawing ``N_rand`` rays a step (the global batch is ``N_rand`` times the
world), the clock ticking by the world a step and an epoch lasting
``num_frames // world`` steps, as JAX's loop. The ranks are, in order:

- the processes of ``torchrun`` (its environment), or of ``--dist`` /
  ``--coordinator_address``, ``--num_processes``, ``--process_id`` on
  every host; ``--dist`` with none of them configured raises;
- else, with ``--device cuda``, one rank a visible card (at most
  ``--num_devices``), spawned here; one card is world 1 in this process
  with no process group;
- else, with ``--device cpu``, world 1, or ``--num_devices N`` gloo ranks.

Rank 0 writes the run's layout, code snapshot, records and checkpoints.
"""

from __future__ import annotations

import argparse
import copy
import os.path as osp
import time

import torch

from ..parallel import multihost
from ..utils.config import Config
from . import get_trainer
from .base import BaseTrainer
from .checkpoint import find_latest_checkpoint


def require_device(device: str):
    """A CLI asked for the card on a machine without one fails here."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device here "
                           "(pass --device cpu for the plain versions)")


def as_config(config, args, mode: str) -> Config:
    """``config`` as a ``Config`` (a dict makes one with ``args``' resume,
    job name and seed; in train mode that writes the run's layout)."""
    if isinstance(config, Config):
        return config
    seed = getattr(args, "seed", None)
    return Config(config, mode=mode, resume=getattr(args, "resume", None),
                  job_name=getattr(args, "job_name", None),
                  seed=int(seed) if seed is not None else None)


def train(config, args, smpl_data=None, scene=None) -> BaseTrainer:
    """Build the trainer, resume, and step the clock up to
    ``trainer.num_iters``.

    ``scene``: an in-memory ``SyntheticScene`` in place of the files under
    ``dataloader.root_dir``."""
    device = getattr(args, "device", "cuda")
    require_device(device)
    config = as_config(config, args, "train")
    tcfg = config["trainer"]
    val_every = tcfg.get("val_every_n_step", 0)
    trainer = get_trainer(config, device=device, seed=config.seed or 0,
                          smpl_data=smpl_data, scene=scene)
    trainer.build_model(config["model"])
    trainer.broadcast_params()
    trainer.prepare_dataloader(config["dataloader"])     # val
    trainer.prepare_train_data(config["dataloader"])     # its num_frames wins
    trainer.configure_optimizers(config["optimizer"], config.get("scheduler"))
    latest = find_latest_checkpoint(osp.join(config.save_dir, config.exp_name,
                                             "*", "ckpts", "*.npz"))
    for ckpt in (latest, config.resume):
        if ckpt:
            trainer.load_ckpt(ckpt)
    clock = trainer.clock
    save_every = tcfg.get("save_every_n_step", 0)
    world = trainer.world_size
    epoch_len = max(trainer.num_frames // world, 1)
    while clock.step < tcfg["num_iters"]:
        trainer.train_func()
        if val_every and clock.step % val_every == 0:
            trainer.val_func()
            trainer.visualize_batch()
        if save_every and clock.step % save_every == 0 and clock.step > 0:
            trainer.save_ckpt()
        clock.tick(world)
        if clock.minibatch >= epoch_len:
            clock.tock()
    if val_every:
        trainer.visualize_batch()
    trainer.save_ckpt("final")
    return trainer


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="training (port)")
    p.add_argument("-m", "--mode", default="train", type=str)
    p.add_argument("-c", "--config", required=True, type=str)
    p.add_argument("-r", "--resume", default=None, type=str)
    p.add_argument("-n", "--job_name", default=None, type=str)
    p.add_argument("-s", "--seed", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (the plain versions)")
    p.add_argument("--profile", action="store_true",
                   help="trace the run with torch.profiler into "
                        "log/plugins/profile (spans train.step, "
                        "train.inputs/forward/backward/reduce/optimizer, "
                        "render.sample_pdf)")
    add_dist_args(p)
    return p.parse_args(argv)


def add_dist_args(p: argparse.ArgumentParser):
    """JAX's flags of a data-parallel run."""
    p.add_argument("--num_devices", default=None, type=int,
                   help="ranks: at most this many cards (--device cuda), "
                        "or this many gloo ranks (--device cpu)")
    p.add_argument("--dist", action="store_true",
                   help="join a multi-process run (torchrun's environment "
                        "or the three flags below); raises if none is "
                        "configured")
    p.add_argument("--coordinator_address", default=None, type=str,
                   help="host:port of rank 0 (multi-host)")
    p.add_argument("--num_processes", default=None, type=int,
                   help="total number of processes (multi-host)")
    p.add_argument("--process_id", default=None, type=int,
                   help="this process's rank (multi-host)")


def run_ranks(args, config_of, body):
    """Run ``body(config, args)`` on every rank of the run ``args`` asks
    for (module docstring) and return this process's result, or None where
    the ranks are spawned processes. ``config_of(args)`` makes the
    ``Config``, once the ranks agree on the job name."""
    require_device(args.device)
    joined = multihost.maybe_init_distributed(
        args.coordinator_address, args.num_processes, args.process_id,
        require=args.dist)
    kind = torch.device(args.device).type
    if joined:
        args.device = str(multihost.rank_device(kind))
        if kind == "cuda":
            torch.cuda.set_device(args.device)
        args.job_name = multihost.broadcast_object(
            args.job_name or time.strftime("%b%d_%H%M%S"))
        return body(config_of(args), args)
    devices = local_rank_devices(kind, args.num_devices)
    if len(devices) == 1:
        return body(config_of(args), args)
    config = config_of(args)         # the layout, written here once
    multihost.launch(_rank, devices, body, config, args)
    return None


def local_rank_devices(kind: str, num_devices: int | None) -> list:
    """One rank a visible card (at most ``num_devices``), or
    ``num_devices`` (default 1) ranks on the CPU."""
    if kind == "cpu":
        return [torch.device("cpu")] * max(int(num_devices or 1), 1)
    n = torch.cuda.device_count()
    if num_devices:
        n = min(n, int(num_devices))
    return [torch.device("cuda", i) for i in range(max(n, 1))]


def _rank(rank: int, world: int, device, body, config, args):
    args = copy.copy(args)
    args.device = str(device)
    trainer = body(config, args)
    if getattr(trainer, "logger", None) is not None:
        trainer.logger.close()


def _train_body(config, args):
    if args.profile:
        from ..utils.logging import profile_trace
        with profile_trace(config.log_dir):
            return train(config, args)
    return train(config, args)


def main(argv=None) -> BaseTrainer | None:
    """The CLI: trains on the ranks of the run (module docstring) and
    returns the trainer of this process's rank, or None where the ranks
    were spawned."""
    return run_ranks(parse_args(argv), Config.from_args, _train_body)


if __name__ == "__main__":
    main()
