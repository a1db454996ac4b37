"""The single NoF warp over whole rays, forward and backward.

Port of ``moco_flow_tpu/ops/megakernel.py``'s ``nof_fused_rays`` and its
custom VJP ``_nof_op`` (kernels ``_nof_fwd_call`` and ``_nof_bwd_call``): one
NoF evaluation a sample, wherever no warp chain runs: the NoF supervision
and the mask loss of the stage-3 step (one "ray" of 2 x N_sampled points),
the chain-off render of the val step, and stage 2's point sets.

- ``_NofOp`` is the ``torch.autograd.Function``. Its inputs are the
  transposed positions ``(3, N, S)``, the per-ray partials of
  ``folds._nof_fold`` and the folded operands (fp32 primals); it saves only
  those, and the gradients to the parameters and the frame embedding come
  from autograd through the fold.
- ``nof_fwd`` / ``nof_bwd`` are the kernels' wrappers: CUDA tensors launch
  the first stage of the warp chain's kernels alone (``csrc/chain_bwd.cu``'s
  ``nof_fwd_launch`` / ``nof_bwd_launch``: the forward as one row-tile
  pass, the backward as row-tile passes over a device scratch and long-K
  weight-gradient products, in chunks of whole rays above
  ``_args.SCRATCH_CAP``), or raise; CPU tensors run the plain versions
  ``_nof_fwd_ref`` / ``_nof_bwd_ref``, which are ``nof_chain.py``'s
  ``_nof_eval`` / ``_nof_vjp`` (written from ``_nof_tile`` and
  ``_nof_bwd_tile``) over all rows. ``nof_fwd.launches`` /
  ``nof_bwd.launches`` count kernel launches.

``nof_fused_rays`` re-chunks a single ray longer than 4096 samples into
4096-sample rays as JAX does (zero-padded, the frame embedding broadcast to
each, the output sliced back): the backward sums each ray's partial
gradient in one block, so a 200,000-point set as one ray would be summed
by one block, and its scratch could be cut into chunks only at whole rays.
"""

from __future__ import annotations

import torch

from ..nn.nof import NoFConfig
from .folds import _cast_matrices, _NofSpec, _nof_fold
from .nerf_rays import _device, _rows, _storage
from .nof_chain import (_bwd_launch, _ChainSpec, _fwd_launch, _nof_eval,
                        _nof_vjp)

# moco_flow_tpu/ops/megakernel.py _FWD_ROWS: a single ray longer than this
# is re-chunked into rays of this many samples
_CHUNK_SAMPLES = 4096


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _prepare(dt, xyz_t, parts, ws):
    s = xyz_t.shape[2]
    rows = [p.float().repeat_interleave(s, dim=0) for p in parts]
    return _rows(xyz_t), rows, _cast_matrices(ws, dt)


def _nof_fwd_ref(spec: _NofSpec, dt, xyz_t, parts, ws):
    """(3, N, S) -> warped (3, N, S)."""
    n, s = xyz_t.shape[1], xyz_t.shape[2]
    x, rows, wsc = _prepare(dt, xyz_t, parts, ws)
    out, _ = _nof_eval(x, rows, wsc, spec, _storage(dt))
    return out.T.reshape(3, n, s)


def _nof_bwd_ref(spec: _NofSpec, dt, xyz_t, parts, ws, g):
    """``_nof_bwd_tile`` over all rows: cotangent g (3, N, S) -> (dxyz
    (3, N, S), [d partial (N, W)], [dW fp32 in the order of ``ws``])."""
    st = _storage(dt)
    n, s = xyz_t.shape[1], xyz_t.shape[2]
    x, rows, wsc = _prepare(dt, xyz_t, parts, ws)
    _, res = _nof_eval(x, rows, wsc, spec, st)
    dx, dparts, dws = _nof_vjp(x, wsc, spec, st, _rows(g), res, n, s)
    return dx.T.reshape(3, n, s), dparts, dws


# ---------------------------------------------------------------------------
# Kernel launches: the warp chain's kernels with one stage (bw@ind)
# ---------------------------------------------------------------------------

def nof_fwd(spec: _NofSpec, dt, xyz_t, parts, ws):
    """Forward kernel #3 (CUDA) or its plain version (CPU)."""
    if _device(xyz_t, "nof_fwd") == "cpu":
        return _nof_fwd_ref(spec, dt, xyz_t, parts, ws)
    out, = _fwd_launch(_ChainSpec(spec, False, False), dt, len(parts), xyz_t,
                       parts, ws, None, entry="nof_fwd")
    nof_fwd.launches += 1
    return out


def nof_bwd(spec: _NofSpec, dt, xyz_t, parts, ws, g):
    """Backward kernel #4 (CUDA) or its plain version (CPU)."""
    if _device(xyz_t, "nof_bwd") == "cpu":
        return _nof_bwd_ref(spec, dt, xyz_t, parts, ws, g)
    out = _bwd_launch(_ChainSpec(spec, False, False), dt, len(parts), xyz_t,
                      parts, ws, None, [g], entry="nof_bwd")
    nof_bwd.launches += 1
    return out


nof_fwd.launches = 0
nof_bwd.launches = 0


class _NofOp(torch.autograd.Function):
    """One NoF warp over whole rays with its hand-chained backward (JAX's
    ``_nof_op`` custom VJP)."""

    @staticmethod
    def forward(ctx, spec, dt, n_parts, xyz_t, *arrs):
        ctx.spec, ctx.dt, ctx.n_parts = spec, dt, n_parts
        ctx.save_for_backward(xyz_t, *arrs)
        return nof_fwd(spec, dt, xyz_t, arrs[:n_parts], arrs[n_parts:])

    @staticmethod
    def backward(ctx, g):
        xyz_t, *arrs = ctx.saved_tensors
        dx, dparts, dws = nof_bwd(ctx.spec, ctx.dt, xyz_t,
                                  arrs[:ctx.n_parts], arrs[ctx.n_parts:],
                                  g.contiguous())
        return (None, None, None, dx, *dparts, *dws)


def nof_fused_rays(params: dict, cfg: NoFConfig, n_freqs: int,
                   logscale: bool, anneal, xyz: torch.Tensor,
                   ind_emb: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """One NoF warp over whole rays (the row-major adapter over the
    transposed kernel).

    Args:
      xyz: (N, S, 3) sample positions.
      ind_emb: (N, E) per-ray embedded frame index.
      compute_dtype: torch.bfloat16 or None (fp32).

    Returns (N, S, 3) warped positions, fp32, differentiable in ``params``,
    ``xyz``, ``ind_emb`` and ``anneal``. One ray of more than 4096 samples
    runs as 4096-sample rays (``_rechunk``).
    """
    n, s = xyz.shape[0], xyz.shape[1]
    if n == 1 and s > _CHUNK_SAMPLES:
        xyz_c, ind_c = _rechunk(xyz, ind_emb)
        out = nof_fused_rays(params, cfg, n_freqs, logscale, anneal, xyz_c,
                             ind_c, compute_dtype)
        return out.reshape(1, -1, 3)[:, :s]
    ws, partials = _nof_fold(params, cfg, n_freqs, anneal, ind_emb)
    spec = _NofSpec(depth=cfg.depth, width=cfg.width, kc=3 * max(n_freqs, 1),
                    skips=tuple(cfg.skips), use_quat=cfg.use_quat,
                    logscale=logscale)
    dt = torch.bfloat16 if compute_dtype == torch.bfloat16 else None
    out_t = _NofOp.apply(spec, dt, len(partials), xyz.permute(2, 0, 1),
                         *partials, *ws)
    return out_t.permute(1, 2, 0)


def _rechunk(xyz: torch.Tensor, ind_emb: torch.Tensor):
    """One ray (1, S, 3) with its embedding (1, E) -> rays of 4096 samples
    (ceil(S / 4096), 4096, 3), zero-padded at the end, each with the same
    embedding (JAX's ``nof_fused_rays``)."""
    flat = xyz.reshape(-1, 3)
    pad = (-flat.shape[0]) % _CHUNK_SAMPLES
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad, 3))], dim=0)
    xyz_c = flat.reshape(-1, _CHUNK_SAMPLES, 3)
    return xyz_c, ind_emb.expand(xyz_c.shape[0], ind_emb.shape[-1])
