"""Optimizers and learning-rate schedules.

Port of the ``adam`` and ``radam`` branches of
``moco_flow_tpu/train/optim.py``:

- ``optax.adam(lr, eps=1e-8)`` is ``torch.optim.Adam(eps=1e-8)`` (the same
  bias-corrected update);
- ``radam`` is the reference-exact RAdam of ``scale_by_radam_ref`` chained
  as ``make_optimizer`` chains it: eps on the raw ``sqrt(nu)``, ``1 - b^t``
  through ``expm1``, the ``N_sma >= 5`` threshold (step 6 is the first
  rectified update at b2 = 0.999), then the decoupled weight decay, then
  the learning rate. Its scalars are float32 tensors, as JAX computes them.

The ``steplr`` schedule is a function of the optimizer's update count,
evaluated before each update as optax evaluates its schedule on the count
of updates made so far. ``zero_grads_where`` is the density freeze. The
optimizer state goes into checkpoints in the JAX package's ``opt_named``
form, the keystr paths of optax's chained state: ``[0].count``,
``[0].mu<leaf>``, ``[0].nu<leaf>`` and, with a schedule, the schedule's
count (``[1].count``; ``[2].count`` for radam with weight decay, whose
decay state is empty) (``state_named`` / ``load_named``). The other
optimizers (``ranger``, ``adamw``, ``sgd``, adam with weight decay) and the
other schedules wait for ROADMAP 'Modules to port' item 2.
"""

from __future__ import annotations

import math
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


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


class ScheduledRAdam:
    """``chain(scale_by_radam_ref(eps=1e-8), add_decayed_weights(wd)?,
    scale_by_learning_rate(schedule))`` on a list of tensors; the same
    interface as :class:`ScheduledAdam`. A tensor without a gradient counts
    as a zero gradient (optax always has one)."""

    def __init__(self, params: list, schedule: Callable[[int], float],
                 names: list | None = None, scheduled: bool = True,
                 weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 threshold: float = 5.0):
        self.schedule = schedule
        self.count = 0
        self.params = list(params)
        self.names = list(names) if names is not None else None
        self.scheduled = scheduled
        self.wd = float(weight_decay)
        self.b1, self.b2, self.eps, self.threshold = b1, b2, eps, threshold
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def _scalars(self):
        """(rectified, rect_size, degen_size) of the update count, each
        computed in float32 as scale_by_radam_ref computes them (Python
        constants enter rounded to float32)."""
        b2 = self.b2
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        t = _f32(float(self.count))
        tl2 = t * _f32(math.log(b2))
        b2t = torch.exp(tl2)
        one_minus_b2t = -torch.expm1(tl2)
        bc1 = -torch.expm1(t * _f32(math.log(self.b1)))
        ro = _f32(ro_inf) - _f32(2.0) * t * b2t / one_minus_b2t
        rect = torch.sqrt(one_minus_b2t * (ro - 4.0) / _f32(ro_inf - 4.0)
                          * (ro - 2.0) / ro * _f32(ro_inf)
                          / _f32(ro_inf - 2.0)) / bc1
        return bool(ro >= self.threshold), rect, _f32(1.0) / bc1

    @torch.no_grad()
    def step(self):
        # the range torch.optim's optimizers open, so profiles group it alike
        with torch.profiler.record_function("Optimizer.step#RAdam.step"):
            self._step()

    def _step(self):
        # The float32 scalars enter the updates as Python floats: a float32
        # value is exact in a double and the op casts it back to float32, so
        # the update is the same as with a 0-dim tensor, without a
        # host-to-device copy per parameter.
        lr = _f32(-self.schedule(self.count)).item()
        self.count += 1
        rectified, rect, degen = self._scalars()
        rect, degen = rect.item(), degen.item()
        b1, b2 = self.b1, self.b2
        for i, p in enumerate(self.params):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            self.mu[i] = b1 * self.mu[i] + (1 - b1) * g
            self.nu[i] = b2 * self.nu[i] + (1 - b2) * g * g
            m = self.mu[i]
            u = (rect * m / (torch.sqrt(self.nu[i]) + self.eps)
                 if rectified else degen * m)
            if self.wd:
                u = u + self.wd * p
            p.add_(lr * u)

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def _sched_key(self, prefix: str) -> str:
        return f"{prefix}[{2 if self.wd else 1}].count"

    def state_named(self, prefix: str) -> dict:
        """The state as optax's keystr paths under ``prefix``."""
        out = {f"{prefix}[0].count": np.asarray(self.count, np.int32)}
        for name, m, v in zip(self.names, self.mu, self.nu):
            out[f"{prefix}[0].mu{keystr(name)}"] = m.detach().cpu().numpy()
            out[f"{prefix}[0].nu{keystr(name)}"] = v.detach().cpu().numpy()
        if self.scheduled:
            out[self._sched_key(prefix)] = np.asarray(self.count, np.int32)
        return out

    def load_named(self, loaded: dict, prefix: str):
        """Restore from optax's keystr paths; leaves that are missing or of
        another shape keep their state (strict=False)."""
        if f"{prefix}[0].count" not in loaded:
            return
        self.count = int(np.asarray(loaded[f"{prefix}[0].count"]))
        for i, (name, p) in enumerate(zip(self.names, self.params)):
            mu = loaded.get(f"{prefix}[0].mu{keystr(name)}")
            nu = loaded.get(f"{prefix}[0].nu{keystr(name)}")
            if mu is None or nu is None or tuple(mu.shape) != tuple(p.shape):
                continue
            self.mu[i] = torch.from_numpy(np.array(mu)).to(p.device, p.dtype)
            self.nu[i] = torch.from_numpy(np.array(nu)).to(p.device, p.dtype)


def make_optimizer(params: list, optimizer_config: dict,
                   scheduler_config: dict | None = None,
                   world_size: int = 1, names: list | None = None):
    """``adam`` (without weight decay) as :class:`ScheduledAdam`, ``radam``
    as :class:`ScheduledRAdam`."""
    kind = optimizer_config["type"]
    wd = optimizer_config.get("weight_decay", 0) or 0
    schedule = make_schedule(scheduler_config, optimizer_config["lr"],
                             world_size)
    scheduled = scheduler_config is not None
    if kind == "radam":
        return ScheduledRAdam(params, schedule, names=names,
                              scheduled=scheduled, weight_decay=wd)
    if kind != "adam" or wd:
        raise NotImplementedError(
            f"optimizer {kind!r} (weight_decay {wd}) is not ported; adam "
            f"without weight decay and radam are ({_LATER})")
    return ScheduledAdam(params, schedule, names=names, scheduled=scheduled)
