"""Optimizers and learning-rate schedules.

Port of ``moco_flow_tpu/train/optim.py``: every optimizer of its
``make_optimizer`` and every schedule of its ``make_schedule``.

- ``adam`` without weight decay: ``optax.adam(lr, eps=1e-8)`` is
  ``torch.optim.Adam(eps=1e-8)`` (the same bias-corrected update),
  :class:`ScheduledAdam`;
- ``adam`` with weight decay: ``optax.adamw`` (the decay decoupled from the
  Adam step and scaled by the learning rate), :class:`ScheduledAdamW`;
- ``adamw``: the reference's AdamW with a linear warmup baked into the step
  (JAX's ``adamw_warmup``; its schedule is read at the count *after* the
  update), :class:`WarmupAdamW`;
- ``sgd``: ``optax.sgd`` with momentum (a ``trace``), weight decay added to
  the gradient before it, :class:`ScheduledSGD`;
- ``radam``: the reference-exact RAdam of ``scale_by_radam_ref`` chained as
  ``make_optimizer`` chains it: eps on the raw ``sqrt(nu)``, ``1 - b^t``
  through ``expm1``, the ``N_sma >= 5`` threshold (step 6 is the first
  rectified update at b2 = 0.999), then the decoupled weight decay, then
  the learning rate. Its scalars are float32 tensors, as JAX computes them,
  :class:`ScheduledRAdam`;
- ``ranger``: that RAdam with b1 0.95, eps 1e-5 and the strict ``N_sma > 5``
  threshold inside Lookahead (k = 6, alpha = 0.5), :class:`Ranger`.

A schedule (``steplr``, ``explr``, ``cosine``, ``poly``) is a function of
the optimizer's update count, evaluated before each update as optax
evaluates its schedule on the count of updates made so far.
``zero_grads_where`` is the density freeze. The optimizer state goes into
checkpoints in the JAX package's ``opt_named`` form, the keystr paths of
optax's state of JAX's own chain (``state_named`` / ``load_named``), so a
JAX checkpoint resumes in the port and the reverse: for example
``[0].count`` / ``[0].mu<leaf>`` / ``[0].nu<leaf>`` and the schedule's
``[1].count`` (``[2].count`` behind an ``add_decayed_weights``) of the
chains, sgd's ``[0].trace<leaf>`` (``[1][0].trace`` with weight decay),
Lookahead's ``.inner...``, ``.slow<leaf>`` and ``.count``.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch


def make_schedule(scheduler_config: dict | None, base_lr: float,
                  world_size: int = 1) -> Callable[[int], float]:
    """LR as a function of the update count: ``steplr`` multiplies by
    ``decay_gamma`` at each milestone of ``decay_step`` the count has
    reached (milestones divided by ``world_size``); ``explr`` is
    ``lr * lr_decay ** count``; ``cosine`` decays from ``lr`` to 1e-8 over
    ``num_epochs`` updates, ``poly`` to 0 as ``(1 - t / n) ** poly_exp``,
    each then constant."""
    if scheduler_config is None:
        return lambda count: base_lr
    kind = scheduler_config["type"]
    if kind == "steplr":
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
    if kind == "explr":
        decay = float(scheduler_config["lr_decay"])
        return lambda count: base_lr * decay ** count
    if kind == "cosine":
        t_max, eps = scheduler_config["num_epochs"], 1e-8
        return lambda count: eps + (base_lr - eps) * 0.5 * (
            1 + math.cos(math.pi * min(count, t_max) / t_max))
    if kind == "poly":
        n, p = scheduler_config["num_epochs"], scheduler_config["poly_exp"]
        return lambda count: base_lr * (1 - min(count, n) / n) ** p
    raise ValueError(f"scheduler type {kind!r} not implemented")


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


def _leaf(loaded: dict, key: str, like: torch.Tensor):
    """``loaded[key]`` as a tensor like ``like``, or None where it is
    missing or of another shape."""
    v = loaded.get(key)
    if v is None or tuple(np.shape(v)) != tuple(like.shape):
        return None
    return torch.from_numpy(np.array(v)).to(like.device, like.dtype)


class _Optimizer:
    """An optax chain as explicit state over a list of tensors.

    A subclass keeps its per-tensor state in lists named by ``_slots`` (the
    keystr prefix of each, e.g. ``[0].mu``) and its update count under the
    keys of ``_count_keys`` (optax keeps one count per stateful link; they
    are all the number of updates made); its ``_step`` updates the
    tensors.
    ``names`` are the parameters' paths; ``scheduled`` says whether optax
    keeps a schedule count. A tensor without a gradient counts as a zero
    gradient (optax always has one)."""

    def __init__(self, params: list, schedule: Callable[[int], float],
                 names: list | None = None, scheduled: bool = True,
                 weight_decay: float = 0.0):
        self.schedule = schedule
        self.count = 0
        self.params = list(params)
        self.names = list(names) if names is not None else None
        self.scheduled = scheduled
        self.wd = float(weight_decay)

    def _zeros(self) -> list:
        return [torch.zeros_like(p) for p in self.params]

    def _grads(self) -> list:
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self.params]

    def _neg_lr(self, count: int) -> float:
        """-lr at ``count`` rounded to float32 (a float32 value is exact in
        a double, and the op casts it back: the same update as with a 0-dim
        tensor, without a host-to-device copy per tensor)."""
        return _f32(-self.schedule(count)).item()

    @torch.no_grad()
    def step(self):
        self._step()

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def _slots(self) -> dict:
        return {}

    def _count_keys(self) -> list:
        return []

    def state_named(self, prefix: str) -> dict:
        """The state as optax's keystr paths under ``prefix`` (e.g.
        ``['moco']``): {path: numpy array}."""
        out = {f"{prefix}{k}": np.asarray(self.count, np.int32)
               for k in self._count_keys()}
        for key, ts in self._slots().items():
            for name, t in zip(self.names, ts):
                out[f"{prefix}{key}{keystr(name)}"] = \
                    t.detach().cpu().numpy()
        return out

    def load_named(self, loaded: dict, prefix: str):
        """Restore from optax's keystr paths (a JAX or a port checkpoint);
        leaves that are missing or of another shape keep their state
        (strict=False)."""
        for k in self._count_keys():
            if f"{prefix}{k}" in loaded:
                self.count = int(np.asarray(loaded[f"{prefix}{k}"]))
                break
        for key, ts in self._slots().items():
            for i, (name, p) in enumerate(zip(self.names, self.params)):
                v = _leaf(loaded, f"{prefix}{key}{keystr(name)}", p)
                if v is not None:
                    ts[i] = v


class ScheduledRAdam(_Optimizer):
    """``chain(scale_by_radam_ref(b1, b2, eps), add_decayed_weights(wd)?,
    scale_by_learning_rate(schedule))`` on a list of tensors.
    ``strict_threshold`` is Ranger's ``N_sma > 5`` instead of ``>= 5``;
    ``key`` prefixes the keystr paths (``.inner`` inside Lookahead)."""

    def __init__(self, params: list, schedule: Callable[[int], float],
                 names: list | None = None, scheduled: bool = True,
                 weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 threshold: float = 5.0, strict_threshold: bool = False,
                 key: str = ""):
        super().__init__(params, schedule, names, scheduled, weight_decay)
        self.b1, self.b2, self.eps, self.threshold = b1, b2, eps, threshold
        self.strict, self.key = strict_threshold, key
        self.mu, self.nu = self._zeros(), self._zeros()

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
        rectified = ro > self.threshold if self.strict else \
            ro >= self.threshold
        return bool(rectified), rect, _f32(1.0) / bc1

    def updates(self) -> list:
        """Advance the moments on the gradients and return the chain's
        updates (the rescaled step, the decay, times -lr)."""
        lr = self._neg_lr(self.count)
        self.count += 1
        rectified, rect, degen = self._scalars()
        rect, degen = rect.item(), degen.item()
        b1, b2 = self.b1, self.b2
        out = []
        for i, (p, g) in enumerate(zip(self.params, self._grads())):
            self.mu[i] = b1 * self.mu[i] + (1 - b1) * g
            self.nu[i] = b2 * self.nu[i] + (1 - b2) * g * g
            m = self.mu[i]
            u = (rect * m / (torch.sqrt(self.nu[i]) + self.eps)
                 if rectified else degen * m)
            if self.wd:
                u = u + self.wd * p
            out.append(lr * u)
        return out

    def _step(self):
        for p, u in zip(self.params, self.updates()):
            p.add_(u)

    def _slots(self) -> dict:
        return {f"{self.key}[0].mu": self.mu, f"{self.key}[0].nu": self.nu}

    def _count_keys(self) -> list:
        keys = [f"{self.key}[0].count"]
        if self.scheduled:
            keys.append(f"{self.key}[{2 if self.wd else 1}].count")
        return keys


class Ranger(_Optimizer):
    """JAX's ``lookahead(chain(scale_by_radam_ref(b1=0.95, eps=1e-5,
    strict_threshold=True), add_decayed_weights(wd)?,
    scale_by_learning_rate(schedule)))``: every ``sync_period``-th update
    moves the slow copy ``slow_step_size`` of the way to the fast weights
    and lands the parameters on it."""

    def __init__(self, params: list, schedule: Callable[[int], float],
                 names: list | None = None, scheduled: bool = True,
                 weight_decay: float = 0.0, sync_period: int = 6,
                 slow_step_size: float = 0.5):
        super().__init__(params, schedule, names, scheduled, weight_decay)
        self.inner = ScheduledRAdam(
            self.params, schedule, names=names, scheduled=scheduled,
            weight_decay=weight_decay, b1=0.95, b2=0.999, eps=1e-5,
            strict_threshold=True, key=".inner")
        self.k, self.alpha = sync_period, slow_step_size
        self.slow = [p.detach().clone() for p in self.params]

    def _step(self):
        upd = self.inner.updates()
        self.count += 1
        if self.count % self.k == 0:
            for i, (p, u) in enumerate(zip(self.params, upd)):
                fast = p + u
                self.slow[i] = self.slow[i] + self.alpha * (fast
                                                            - self.slow[i])
                upd[i] = self.slow[i] - p
        for p, u in zip(self.params, upd):
            p.add_(u)

    def _slots(self) -> dict:
        return {**self.inner._slots(), ".slow": self.slow}

    def _count_keys(self) -> list:
        return [".count"]

    def state_named(self, prefix: str) -> dict:
        return {**self.inner.state_named(prefix),
                **super().state_named(prefix)}

    def load_named(self, loaded: dict, prefix: str):
        self.inner.load_named(loaded, prefix)
        super().load_named(loaded, prefix)


class ScheduledSGD(_Optimizer):
    """``optax.sgd(schedule, momentum)``, behind
    ``add_decayed_weights(wd)`` where there is weight decay: the trace
    ``t = g + momentum * t`` of the (decayed) gradient, times -lr."""

    def __init__(self, params: list, schedule: Callable[[int], float],
                 names: list | None = None, scheduled: bool = True,
                 weight_decay: float = 0.0, momentum: float = 0.0):
        super().__init__(params, schedule, names, scheduled, weight_decay)
        self.momentum = float(momentum)
        self.trace = self._zeros()

    def _step(self):
        lr = self._neg_lr(self.count)
        self.count += 1
        for i, (p, g) in enumerate(zip(self.params, self._grads())):
            if self.wd:
                g = g + self.wd * p
            self.trace[i] = g + self.momentum * self.trace[i]
            p.add_(lr * self.trace[i])

    def _slots(self) -> dict:
        return {f"{'[1][0]' if self.wd else '[0]'}.trace": self.trace}

    def _count_keys(self) -> list:
        if not self.scheduled:
            return []
        return [f"{'[1][1]' if self.wd else '[1]'}.count"]


class ScheduledAdamW(_Optimizer):
    """``optax.adamw(schedule, eps=1e-8, weight_decay=wd)``:
    ``chain(scale_by_adam, add_decayed_weights(wd),
    scale_by_learning_rate)``, the decay decoupled from the Adam step and
    scaled by the learning rate."""

    def __init__(self, params: list, schedule: Callable[[int], float],
                 names: list | None = None, scheduled: bool = True,
                 weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, schedule, names, scheduled, weight_decay)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu, self.nu = self._zeros(), self._zeros()

    def _step(self):
        lr = self._neg_lr(self.count)
        self.count += 1
        t = _f32(float(self.count))
        bc1 = (1.0 - _f32(self.b1) ** t).item()
        bc2 = (1.0 - _f32(self.b2) ** t).item()
        b1, b2 = self.b1, self.b2
        for i, (p, g) in enumerate(zip(self.params, self._grads())):
            self.mu[i] = (1 - b1) * g + b1 * self.mu[i]
            self.nu[i] = (1 - b2) * (g * g) + b2 * self.nu[i]
            u = (self.mu[i] / bc1) / (torch.sqrt(self.nu[i] / bc2)
                                      + self.eps)
            p.add_(lr * (u + self.wd * p))

    def _slots(self) -> dict:
        return {"[0].mu": self.mu, "[0].nu": self.nu}

    def _count_keys(self) -> list:
        return ["[0].count"] + (["[2].count"] if self.scheduled else [])


class WarmupAdamW(_Optimizer):
    """JAX's ``adamw_warmup`` (the reference's AdamW): Adam with decoupled
    weight decay and a linear warmup, ``slr = 1e-8 + t * lr / warmup`` for
    ``t < warmup``, both the decay and the Adam step scaled by ``slr``; the
    schedule is read at the count after the update."""

    def __init__(self, params: list, schedule: Callable[[int], float],
                 names: list | None = None, scheduled: bool = True,
                 weight_decay: float = 0.0, warmup: int = 0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, schedule, names, scheduled, weight_decay)
        self.warmup = int(warmup)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu, self.nu = self._zeros(), self._zeros()

    def _step(self):
        self.count += 1
        t = _f32(float(self.count))
        lr = _f32(self.schedule(self.count))
        slr = lr
        if self.warmup and self.count < self.warmup:
            slr = _f32(1e-8) + t * lr / _f32(max(self.warmup, 1))
        step = (slr * torch.sqrt(1 - _f32(self.b2) ** t)
                / (1 - _f32(self.b1) ** t)).item()
        decay = (_f32(self.wd) * slr).item()
        b1, b2 = self.b1, self.b2
        for i, (p, g) in enumerate(zip(self.params, self._grads())):
            self.mu[i] = b1 * self.mu[i] + (1 - b1) * g
            self.nu[i] = b2 * self.nu[i] + (1 - b2) * g * g
            p.add_(-step * self.mu[i] / (torch.sqrt(self.nu[i]) + self.eps)
                   - decay * p)

    def _slots(self) -> dict:
        return {".mu": self.mu, ".nu": self.nu}

    def _count_keys(self) -> list:
        return [".count"]


def make_optimizer(params: list, optimizer_config: dict,
                   scheduler_config: dict | None = None,
                   world_size: int = 1, names: list | None = None):
    """The optimizer of ``optimizer_config['type']`` (``sgd``, ``adam``,
    ``adamw``, ``radam``, ``ranger``) over ``params`` with the schedule of
    ``scheduler_config``."""
    kind = optimizer_config["type"]
    wd = optimizer_config.get("weight_decay", 0) or 0
    schedule = make_schedule(scheduler_config, optimizer_config["lr"],
                             world_size)
    kw = dict(names=names, scheduled=scheduler_config is not None)
    if kind == "adam" and not wd:
        return ScheduledAdam(params, schedule, **kw)
    if kind == "adam":
        return ScheduledAdamW(params, schedule, weight_decay=wd, **kw)
    if kind == "adamw":
        return WarmupAdamW(params, schedule, weight_decay=wd,
                           warmup=int(optimizer_config.get("warmup", 0)),
                           **kw)
    if kind == "radam":
        return ScheduledRAdam(params, schedule, weight_decay=wd, **kw)
    if kind == "ranger":
        return Ranger(params, schedule, weight_decay=wd, **kw)
    if kind == "sgd":
        return ScheduledSGD(params, schedule, weight_decay=wd,
                            momentum=optimizer_config.get("momentum", 0.0),
                            **kw)
    raise ValueError(f"optimizer type {kind!r} not implemented")
