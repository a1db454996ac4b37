"""Student distillation: a narrower canonical NeRF for test-time rendering.

Port of ``moco_flow_tpu/render/distill.py``. The trained fine NeRF (the
teacher, 8 x 256 in the published configs) is distilled into a depth x
width student (4 x 128 by default: ~8x fewer trunk FLOPs a sample) with the
same input contract, which then renders as both NeRFs through the same
kernels (#7 on the fused route, #8 on rows); the NoF warps are untouched.
Training only ever sees the teacher: after :func:`swap_render_nerf` the
trainer renders and refuses to train.

The objective, on mixed uniform and self-mined near-surface points (a
hot-point buffer resampled where the teacher has density):
``L = mean w |rgb_s - rgb_t|^2 + sigma_w mean (soft(s_s) - soft(s_t))^2``
with ``soft = log1p(activated sigma)`` and ``w = 1 - exp(-act(sigma_t) dt)``,
plus, under ``relu``, a hinge on the student's raw sigma where the teacher
is occupied (a dead ReLU has no gradient otherwise). Adam with global-norm
clipping 1.0 and a cosine decay to ``lr * lr_decay``.

The teacher's forward and the student's forward and backward run through
the per-op NeRF kernel #8 on embedded rows (``ops/fused_mlp.py``'s
``nerf_fused``: the kernel forward, the recompute backward), in fp32 as
JAX's ``nerf_apply`` calls; CPU tensors run its plain version. A step takes
its random inputs as tensors (:class:`DistillDraws`), so a test can hand it
JAX's; :func:`distill_student` draws them from a ``torch.Generator`` on the
trainer's device seeded by ``seed``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from ..nn.nerf import NeRFConfig, init_nerf
from ..ops.fused_mlp import nerf_fused
from ..train.checkpoint import _flatten, _map_leaves
from ..train.optim import ScheduledAdam
from .volume import embed_padded


@dataclasses.dataclass
class DistillDraws:
    """The random inputs of one distillation step."""
    uniform: torch.Tensor          # (half, 3) points uniform in the box
    jitter: torch.Tensor           # (half, 3) standard normals
    extra: torch.Tensor | None     # (batch, 1) uniform in [-1, 1] (ind) or
                                   # (batch, 3) standard normals (dir)


def _activate(s: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "softplus":
        return torch.nn.functional.softplus(s)
    return torch.relu(s)


def student_config(teacher_cfg: NeRFConfig, depth: int = 4,
                   width: int = 128) -> NeRFConfig:
    """The student's NeRFConfig: narrower and shallower (a skip at
    ``depth // 2`` from depth 4), the same inputs, PE-encoded."""
    skips = tuple(s for s in (depth // 2,) if 0 < s < depth) \
        if depth >= 4 else ()
    return dataclasses.replace(teacher_cfg, depth=depth, width=width,
                               skips=skips, encoding="pe", hash=None)


def _draw(gen: torch.Generator, half: int, extent: float, extra_type: str,
          device) -> DistillDraws:
    def uni(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) \
            + lo
    u = uni((half, 3), -extent, extent)
    j = torch.randn((half, 3), generator=gen, device=device)
    e = None
    if extra_type == "ind":
        e = uni((2 * half, 1), -1.0, 1.0)
    elif extra_type == "dir":
        e = torch.randn((2 * half, 3), generator=gen, device=device)
    return DistillDraws(u, j, e)


def distill_student(trainer, depth: int = 4, width: int = 128,
                    steps: int = 3000, batch: int = 16384, lr: float = 3e-3,
                    extent: float = 1.5, sigma_weight: float = 1.0,
                    seed: int = 0, swap: bool = True, lr_decay: float = 0.1,
                    student_params: dict | None = None,
                    hot: torch.Tensor | None = None,
                    draws: Callable[[int], DistillDraws] | None = None):
    """Distill the trainer's fine NeRF (the coarse one without a fine) into
    a ``depth`` x ``width`` student and, with ``swap``, install it as both
    render-time NeRFs (:func:`swap_render_nerf`).

    ``student_params`` (the initial student), ``hot`` (the initial
    (batch // 2, 3) hot-point buffer) and ``draws`` (step -> its
    :class:`DistillDraws`) replace the ones drawn from ``seed``.
    Returns ``(student_params, student_cfg, final_loss)``; the loss is the
    last step's, before its update."""
    statics = trainer.statics
    dev = trainer.device
    t_cfg: NeRFConfig = statics.fine or statics.coarse
    t_params = trainer.params.get("fine_NeRF") or \
        trainer.params["coarse_NeRF"]
    s_cfg = student_config(t_cfg, depth, width)
    activation = trainer.rcfg_test.activation
    half = batch // 2
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    if student_params is None:
        student_params = init_nerf(torch.Generator().manual_seed(int(seed)),
                                   s_cfg, dev)
    s_params = _map_leaves(student_params,
                           lambda t: t.detach().clone().to(dev))
    if hot is None:
        hot = torch.rand((half, 3), generator=gen, device=dev) \
            * (2 * extent) - extent
    if draws is None:
        def draws(i):
            return _draw(gen, half, extent, t_cfg.extra_feat_type, dev)
    names, leaves = zip(*_flatten(s_params, leaf=lambda t: t).items())
    for t in leaves:
        t.requires_grad_(True)
    total = max(steps, 1)

    def schedule(count: int) -> float:
        c = min(count, total)
        cosine = 0.5 * (1 + math.cos(math.pi * c / total))
        return lr * ((1 - lr_decay) * cosine + lr_decay)

    opt = ScheduledAdam(list(leaves), schedule, names=list(names))
    loss = torch.zeros(())
    for i in range(steps):
        hot, loss = distill_step(
            s_params, leaves, opt, t_params, t_cfg, s_cfg, statics, hot,
            draws(i), activation=activation, extent=extent,
            sigma_weight=sigma_weight)
    for t in leaves:
        t.requires_grad_(False)
    if swap:
        swap_render_nerf(trainer, s_cfg, s_params)
    return s_params, s_cfg, float(loss)


def _extra(cfg: NeRFConfig, statics, raw: torch.Tensor | None):
    """The teacher's extra feature of a step's raw draws: the frame-index
    PE of a uniform index, or the direction PE of a normalized normal."""
    if cfg.extra_feat_type == "ind":
        return embed_padded(raw, statics.nerf_ind, cfg.extra_feat_dim)
    if cfg.extra_feat_type == "dir":
        d = raw / (torch.linalg.norm(raw, dim=-1, keepdim=True) + 1e-9)
        return embed_padded(d, statics.nerf_dir, cfg.extra_feat_dim)
    return None


def distill_step(s_params: dict, leaves, opt, t_params: dict,
                 t_cfg: NeRFConfig, s_cfg: NeRFConfig, statics,
                 hot: torch.Tensor, d: DistillDraws, activation: str,
                 extent: float = 1.5, sigma_weight: float = 1.0):
    """One step: the batch (uniform points and the jittered hot buffer),
    the teacher's targets, the loss, its gradient clipped to global norm 1,
    the Adam update of ``opt``; returns the new hot buffer (the batch's
    ``half`` highest teacher sigmas, a stable sort) and the loss."""
    half = hot.shape[0]
    x = torch.cat([d.uniform, hot + d.jitter * (0.05 * extent)], dim=0)
    extra = _extra(t_cfg, statics, d.extra)
    with torch.no_grad():
        t_out = nerf_fused(t_params, t_cfg,
                           embed_padded(x, statics.nerf_xyz,
                                        t_cfg.in_channels_xyz),
                           extra, False)
    t_rgb, t_sig = t_out[:, :3], t_out[:, 3]
    out = nerf_fused(s_params, s_cfg,
                     embed_padded(x, statics.nerf_xyz, s_cfg.in_channels_xyz),
                     extra, False)
    # composite weight scale: one typical probe step (~a 64^3 grid cell)
    dt = 2.0 * extent / 64.0
    act_t = _activate(t_sig, activation)
    w = 1.0 - torch.exp(-act_t * dt)
    soft_s = torch.log1p(_activate(out[:, 3], activation))
    soft_t = torch.log1p(act_t)
    rgb_l = torch.mean(w[:, None] * (out[:, :3] - t_rgb) ** 2)
    sig_l = torch.mean((soft_s - soft_t) ** 2)
    if activation == "relu":
        # the dead-ReLU hinge: a raw sigma below 0 where the teacher is
        # occupied has no gradient through log1p(relu(s)); this one pulls
        # it back and vanishes once s >= 0
        sig_l = sig_l + 0.05 * torch.mean(torch.where(
            soft_t > 0.0, torch.clamp(-out[:, 3], min=0.0),
            torch.zeros_like(soft_t)))
    loss = rgb_l + sigma_weight * sig_l
    grads = torch.autograd.grad(loss, list(leaves))
    # optax.clip_by_global_norm(1.0)
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < 1.0
    for t, g in zip(leaves, grads):
        t.grad = torch.where(keep, g, (g / norm) * 1.0)
    opt.step()
    idx = torch.argsort(-t_sig, stable=True)[:half]
    return x[idx].detach(), loss.detach()


def swap_render_nerf(trainer, nerf_cfg: NeRFConfig, nerf_params: dict):
    """Install ``nerf_params`` (``nerf_cfg``) as both render-time NeRFs.
    Test-time rendering only: the trainer's caches keyed on the NeRF
    (occupancy grids, the last view's keep mask) are cleared, and its
    ``train_step`` raises from now on."""
    trainer.statics = dataclasses.replace(trainer.statics, coarse=nerf_cfg,
                                          fine=nerf_cfg)
    trainer.params = dict(trainer.params, coarse_NeRF=nerf_params,
                          fine_NeRF=nerf_params)
    trainer.clear_render_caches()

    def _refuse(*args, **kwargs):
        raise RuntimeError(
            "train_step after swap_render_nerf: the distilled student is a "
            "render-time artifact; rebuild the trainer to keep training")
    trainer.train_step = _refuse


def distill_with_restarts(trainer, tries: int = 3, max_loss: float = 0.1,
                          **kwargs):
    """:func:`distill_student` from seed 0 on, restarting with the next seed
    (the teacher restored first) while the final loss is >= ``max_loss``, up
    to ``tries`` seeds: a sharp ReLU target collapses some draws outright.
    Returns ``(student_params, student_cfg, loss, seed)``; the student of
    the last try is swapped in."""
    teacher = (trainer.params, trainer.statics)
    for seed in range(tries):
        if seed:
            trainer.params, trainer.statics = teacher
            trainer.__dict__.pop("train_step", None)
            trainer.clear_render_caches()
        out = distill_student(trainer, seed=seed, **kwargs)
        if out[2] < max_loss:
            break
    return (*out, seed)


def render_psnr_vs_teacher(img_student: np.ndarray,
                           img_teacher: np.ndarray) -> float:
    """PSNR (dB, one decimal) of the student's frame against the
    teacher's."""
    mse = float(np.mean((np.asarray(img_student, np.float32)
                         - np.asarray(img_teacher, np.float32)) ** 2))
    return round(-10.0 * float(np.log10(mse + 1e-12)), 1)
