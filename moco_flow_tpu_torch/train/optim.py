"""Optimizers and learning-rate schedules.

Port of the ``adam`` branch of ``moco_flow_tpu/train/optim.py``:
``optax.adam(lr, eps=1e-8)`` is ``torch.optim.Adam(eps=1e-8)`` (the same
bias-corrected update), and the ``steplr`` schedule is a function of the
optimizer's update count, evaluated before each update as optax evaluates
its schedule on the count of updates made so far. The other optimizers
(``radam``, ``ranger``, ``adamw``, ``sgd``, adam with weight decay), the
other schedules wait for ROADMAP 'Modules to port' item 2, and
``zero_grads_where`` (the density freeze) for item 1.
"""

from __future__ import annotations

from typing import Callable

import torch

_LATER = "ROADMAP 'Modules to port' item 2"


def make_schedule(scheduler_config: dict | None, base_lr: float,
                  world_size: int = 1) -> Callable[[int], float]:
    """LR as a function of the update count: ``steplr`` multiplies by
    ``decay_gamma`` at each milestone of ``decay_step`` the count has
    reached (milestones divided by ``world_size``)."""
    if scheduler_config is None:
        return lambda count: base_lr
    kind = scheduler_config["type"]
    if kind != "steplr":
        raise NotImplementedError(f"scheduler {kind!r} is not ported ({_LATER})")
    milestones = sorted(int(s) // world_size
                        for s in scheduler_config["decay_step"])
    gamma = float(scheduler_config["decay_gamma"])

    def schedule(count: int) -> float:
        lr = base_lr
        for m in milestones:
            if count >= m:
                lr *= gamma
        return lr
    return schedule


class ScheduledAdam:
    """``torch.optim.Adam(eps=1e-8)`` whose LR follows ``schedule`` of the
    number of updates made so far."""

    def __init__(self, params: list, schedule: Callable[[int], float]):
        self.schedule = schedule
        self.count = 0
        self.opt = torch.optim.Adam(params, lr=schedule(0),
                                    betas=(0.9, 0.999), eps=1e-8)

    def step(self):
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.opt.step()
        self.count += 1

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)


def make_optimizer(params: list, optimizer_config: dict,
                   scheduler_config: dict | None = None,
                   world_size: int = 1) -> ScheduledAdam:
    kind = optimizer_config["type"]
    wd = optimizer_config.get("weight_decay", 0) or 0
    if kind != "adam" or wd:
        raise NotImplementedError(
            f"optimizer {kind!r} (weight_decay {wd}) is not ported; adam "
            f"without weight decay is ({_LATER})")
    return ScheduledAdam(params, make_schedule(
        scheduler_config, optimizer_config["lr"], world_size))
