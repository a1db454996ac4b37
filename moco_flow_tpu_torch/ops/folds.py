"""Operand folds and plain helpers shared by the fused kernels' wrappers.

Port of the folds of ``moco_flow_tpu/ops/megakernel.py``:

- ``_nerf_fold`` / ``_nof_fold`` fold the PE annealing weights into the
  first-layer and skip-layer weight rows (packed as one ``(3+2kc, W)``
  matrix against the ``[x; sin; cos]`` embedding) and apply the per-ray
  features (frame-index embeddings) at ray rank as fp32 "partials",
  in GEMMs of one shape (``_rows_matmul``), so that a ray's bits do not
  depend on the other rays of the call (the packed stream of views and
  ``occ_tighten: 0`` rest on it).
  Both are plain differentiable torch code: the gradients to the model's
  parameters and to the embeddings come from autograd through them, as
  JAX's come through its folds.
- ``_pe_embed`` is the packed embedding every plain version computes.

The test-time pass (``render_pass.py``), the NeRF (``nerf_rays.py``) and
the NoF warp chain (``nof_chain.py``) all take their operands from here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..nn.embedding import freq_bands
from ..nn.nerf import NeRFConfig
from ..nn.nof import NoFConfig

_MAX_LAYERS = 16   # csrc/render_pass.cu kMaxLayers
_MAX_WIDTH = 256   # csrc/pass_tile.cuh kMaxWidth
ROW_TILE = 4096    # rows of every GEMM of the per-ray partials


@dataclasses.dataclass(frozen=True)
class _NerfSpec:
    depth: int
    width: int
    kc: int                # 3 * n_freqs (sin block width)
    skips: tuple
    sigma_only: bool
    has_extra: bool
    logscale: bool


@dataclasses.dataclass(frozen=True)
class _NofSpec:
    depth: int
    width: int
    kc: int
    skips: tuple
    use_quat: bool
    logscale: bool


def _freq_matrix(n_freqs: int, logscale: bool, c: int = 3) -> np.ndarray:
    """(c, n_freqs*c) matrix B with x @ B = [f_0*x, f_1*x, ...] laid out
    frequency-major, like ``posenc``'s block layout."""
    bands = freq_bands(n_freqs, logscale)
    b = np.zeros((c, n_freqs * c), dtype=np.float32)
    for k in range(n_freqs):
        for j in range(c):
            b[j, k * c + j] = bands[k]
    return b


def _anneal_rows(anneal: torch.Tensor | None, kc: int):
    if anneal is None or not kc:
        return None
    return anneal.float().repeat_interleave(3)[:kc, None]


def _pe_rows(w: torch.Tensor, kc: int, w_rep):
    """A PE-consuming weight as ONE packed (3+2kc, W) matrix of
    [x(3); sin(kc); cos(kc)] rows, annealing folded into the sin/cos rows.
    ``kc == 0`` (raw xyz, the reference's init configs) runs as a 1-frequency
    pass whose sin/cos rows are zeros, as in the JAX fold."""
    if kc == 0:
        z = torch.zeros((6, w.shape[-1]), dtype=w.dtype, device=w.device)
        return torch.cat([w[:3], z], dim=0)
    wx, wsin, wcos = w[:3], w[3:3 + kc], w[3 + kc:3 + 2 * kc]
    if w_rep is not None:
        wsin = wsin * w_rep
        wcos = wcos * w_rep
    return torch.cat([wx, wsin, wcos], dim=0)


def _rows_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in fp32 as GEMMs of one shape, ``ROW_TILE`` rows each (the
    last padded with zeros), so a row's bits do not depend on how many rows
    the call has: a BLAS picks its kernel, and with it the order of the
    sum, from the shape."""
    n = x.shape[0]
    x, w = x.float(), w.float()
    if n == 0:
        return x.new_zeros((0, w.shape[1]))
    xp = torch.cat([x, x.new_zeros((-n % ROW_TILE, x.shape[1]))])
    return torch.cat([xp[i:i + ROW_TILE] @ w
                      for i in range(0, xp.shape[0], ROW_TILE)])[:n]


def _nerf_fold(params: dict, cfg: NeRFConfig, n_freqs: int,
               anneal: torch.Tensor | None, extra_emb: torch.Tensor | None,
               sigma_only: bool):
    """NeRF weights as the pass's flat operand list, plus the per-ray extra
    partial ``extra_emb @ W_extra[W:]`` (N, W/2) in fp32 (or None)."""
    kc = 3 * n_freqs
    w_rep = _anneal_rows(anneal, kc)
    in_ch = cfg.in_channels_xyz
    ws = []
    for i, layer in enumerate(params["trunk"]):
        w, b = layer["w"], layer["b"]
        if i == 0:
            ws += [_pe_rows(w, kc, w_rep), b[None]]
        elif i in cfg.skips:
            ws += [_pe_rows(w[:in_ch], kc, w_rep), w[in_ch:], b[None]]
        else:
            ws += [w, b[None]]
    ws += [params["sigma"]["w"].T, params["sigma"]["b"][None]]  # (1,W), (1,1)
    p_extra = None
    if not sigma_only:
        ws += [params["final"]["w"], params["final"]["b"][None]]
        we, be = params["extra"]["w"], params["extra"]["b"]
        if extra_emb is not None:
            ws += [we[:cfg.width], be[None]]
            p_extra = _rows_matmul(extra_emb, we[cfg.width:])  # (N, W/2)
        else:
            ws += [we, be[None]]
        ws += [params["rgb"]["w"], params["rgb"]["b"][None]]
    return ws, p_extra


def _nof_fold(params: dict, cfg: NoFConfig, n_freqs: int,
              anneal: torch.Tensor | None, ind_emb: torch.Tensor):
    """NoF weights as the pass's flat operand list; the frame-index columns
    of layer 0 and of the skip layer become per-ray fp32 partials (N, W)."""
    kc = 3 * n_freqs
    w_rep = _anneal_rows(anneal, kc)
    cx, ce = cfg.in_channels_xyz, cfg.extra_feat_dim
    ws, partials = [], []
    for i, layer in enumerate(params["layers"]):
        w, b = layer["w"], layer["b"]
        if i == 0:
            ws += [_pe_rows(w[:cx], kc, w_rep), b[None]]
            partials.append(_rows_matmul(ind_emb, w[cx:cx + ce]))
        elif i in cfg.skips:
            ws += [_pe_rows(w[:cx], kc, w_rep), w[cx + ce:], b[None]]
            partials.append(_rows_matmul(ind_emb, w[cx:cx + ce]))
        else:
            ws += [w, b[None]]
    ws += [params["head"]["w"], params["head"]["b"][None]]
    return ws, partials


def _trunk_layers(ws, depth: int, skips: tuple):
    """Flat operands -> [(w_pe | None, w_h | None, b)] per layer, and the
    remaining (head) operands."""
    it = iter(ws)
    layers = []
    for i in range(depth):
        if i == 0:
            layers.append((next(it), None, next(it)))
        elif i in skips:
            layers.append((next(it), next(it), next(it)))
        else:
            layers.append((None, next(it), next(it)))
    return layers, list(it)


def _pe_embed(x: torch.Tensor, kc: int, logscale: bool, dt) -> torch.Tensor:
    """Packed embedding (T, 3+2kc) = [x, sin, cos], each cast to ``dt``.
    ``x @ B`` is written out as an exact sum (B has one band per column),
    so no matmul precision setting can touch the phases."""
    b_mat = torch.from_numpy(_freq_matrix(kc // 3, logscale)).to(x.device)
    scaled = (x[:, :, None] * b_mat[None]).sum(dim=1)
    return torch.cat([x.to(dt), torch.sin(scaled).to(dt),
                      torch.cos(scaled).to(dt)], dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a[:, 0:1], a[:, 1:2], a[:, 2:3]
    b0, b1, b2 = b[:, 0:1], b[:, 1:2], b[:, 2:3]
    return torch.cat([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                      a0 * b1 - a1 * b0], dim=-1)


def _cast_matrices(ws, dt: torch.dtype):
    """``_cast_matrices``: true weight matrices (shape[0] > 1) in the
    compute dtype; biases and the (1, W) sigma row stay fp32."""
    if dt != torch.bfloat16:
        return [w.float() for w in ws]
    return [w.to(dt) if w.shape[0] > 1 else w.float() for w in ws]
