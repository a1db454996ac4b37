"""Optimizers and learning-rate schedules.

Port of the ``adam`` branch of ``moco_flow_tpu/train/optim.py``:
``optax.adam(lr, eps=1e-8)`` is ``torch.optim.Adam(eps=1e-8)`` (the same
bias-corrected update), and the ``steplr`` schedule is a function of the
optimizer's update count, evaluated before each update as optax evaluates
its schedule on the count of updates made so far. ``zero_grads_where`` is
the density freeze. The optimizer state goes into checkpoints in the JAX
package's ``opt_named`` form: the keystr paths of optax's ``chain(
scale_by_adam, scale_by_schedule)`` state, ``[0].count``, ``[0].mu<leaf>``,
``[0].nu<leaf>`` and, with a schedule, ``[1].count`` (``state_named`` /
``load_named``). The other optimizers (``radam``, ``ranger``, ``adamw``,
``sgd``, adam with weight decay) and the other schedules wait for ROADMAP
'Modules to port' item 2.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
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


def keystr(path: str) -> str:
    """A '/'-joined parameter path as JAX's ``keystr`` of it:
    ``coarse_NeRF/trunk/0/w`` -> ``['coarse_NeRF']['trunk'][0]['w']``."""
    return "".join(f"[{p}]" if p.isdigit() else f"['{p}']"
                   for p in path.split("/"))


def zero_grads_where(named: dict, freeze_fn: Callable[[str], bool]):
    """Set the gradient of every tensor of ``named`` ({path: tensor}) whose
    path ``freeze_fn`` selects to zeros. Zeros and not None: torch's Adam
    skips a tensor without a gradient and does not advance its step, and
    its bias correction would then part from optax's global count once the
    freeze lifts; with zero moments a zero gradient moves nothing."""
    for path, t in named.items():
        if freeze_fn(path):
            t.grad = torch.zeros_like(t)


class ScheduledAdam:
    """``torch.optim.Adam(eps=1e-8)`` whose LR follows ``schedule`` of the
    number of updates made so far. ``names`` are the parameters' paths (for
    the checkpointed state); ``scheduled`` says whether optax would keep a
    schedule count (``[1].count``) beside Adam's."""

    def __init__(self, params: list, schedule: Callable[[int], float],
                 names: list | None = None, scheduled: bool = True):
        self.schedule = schedule
        self.count = 0
        self.params = list(params)
        self.names = list(names) if names is not None else None
        self.scheduled = scheduled
        self.opt = torch.optim.Adam(self.params, lr=schedule(0),
                                    betas=(0.9, 0.999), eps=1e-8)

    def step(self):
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.opt.step()
        self.count += 1

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def state_named(self, prefix: str) -> dict:
        """The state as optax's keystr paths under ``prefix`` (e.g.
        ``['moco']``): {path: numpy array}."""
        out = {f"{prefix}[0].count": np.asarray(self.count, np.int32)}
        for name, p in zip(self.names, self.params):
            st = self.opt.state.get(p, {})
            for key, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                v = st.get(slot)
                out[f"{prefix}[0].{key}{keystr(name)}"] = (
                    np.zeros(tuple(p.shape), np.float32) if v is None
                    else v.detach().cpu().numpy())
        if self.scheduled:
            out[f"{prefix}[1].count"] = np.asarray(self.count, np.int32)
        return out

    def load_named(self, loaded: dict, prefix: str):
        """Restore from optax's keystr paths (a JAX or a port checkpoint):
        each parameter's step from optax's single Adam count, the schedule
        count from ``[1].count``. Leaves that are missing or of another
        shape keep their state (strict=False)."""
        if f"{prefix}[0].count" not in loaded:
            return
        count = int(np.asarray(loaded[f"{prefix}[0].count"]))
        self.count = int(np.asarray(loaded.get(f"{prefix}[1].count", count)))
        for name, p in zip(self.names, self.params):
            mu = loaded.get(f"{prefix}[0].mu{keystr(name)}")
            nu = loaded.get(f"{prefix}[0].nu{keystr(name)}")
            if mu is None or nu is None or tuple(mu.shape) != tuple(p.shape):
                continue
            self.opt.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": torch.as_tensor(np.asarray(mu)).to(p.device,
                                                              p.dtype),
                "exp_avg_sq": torch.as_tensor(np.asarray(nu)).to(p.device,
                                                                 p.dtype)}


def make_optimizer(params: list, optimizer_config: dict,
                   scheduler_config: dict | None = None,
                   world_size: int = 1,
                   names: list | None = None) -> ScheduledAdam:
    kind = optimizer_config["type"]
    wd = optimizer_config.get("weight_decay", 0) or 0
    if kind != "adam" or wd:
        raise NotImplementedError(
            f"optimizer {kind!r} (weight_decay {wd}) is not ported; adam "
            f"without weight decay is ({_LATER})")
    return ScheduledAdam(params, make_schedule(
        scheduler_config, optimizer_config["lr"], world_size), names=names,
        scheduled=scheduler_config is not None)
