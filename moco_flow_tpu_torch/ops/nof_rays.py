"""The single NoF warp over whole rays, forward and backward.

Port of ``moco_flow_tpu/ops/megakernel.py``'s ``nof_fused_rays`` and its
custom VJP ``_nof_op`` (kernels ``_nof_fwd_call`` and ``_nof_bwd_call``): one
NoF evaluation a sample, wherever no warp chain runs: the NoF supervision
and the mask loss of the stage-3 step (one "ray" of 2 x N_sampled points),
and the chain-off render of the val step.

- ``_NofOp`` is the ``torch.autograd.Function``. Its inputs are the
  transposed positions ``(3, N, S)``, the per-ray partials of
  ``folds._nof_fold`` and the folded operands (fp32 primals); it saves only
  those, and the gradients to the parameters and the frame embedding come
  from autograd through the fold.
- ``nof_fwd`` / ``nof_bwd`` are the kernels' wrappers: CUDA tensors launch
  ``csrc/nof_rays.cu`` (or raise), CPU tensors run the plain versions
  ``_nof_fwd_ref`` / ``_nof_bwd_ref``, which are ``nof_chain.py``'s
  ``_nof_eval`` / ``_nof_vjp`` (written from ``_nof_tile`` and
  ``_nof_bwd_tile``) over all rows. ``nof_fwd.launches`` /
  ``nof_bwd.launches`` count kernel launches.

JAX re-chunks a single ray longer than 4096 samples into 4096-sample rays
for the TPU's VMEM; here a tile is a run of flat rows whatever the ray
length, so a long ray goes in as it is (the per-ray partial gradient is
then summed in another order, within fp32 rounding).
"""

from __future__ import annotations

import torch

from ..nn.nof import NoFConfig
from . import _args
from .folds import _cast_matrices, _NofSpec, _nof_fold
from .nerf_rays import _device, _rows, _storage
from .nof_chain import _nof_eval, _nof_vjp

_MAX_PE = 4   # csrc/nof_rays.cu kMaxPe


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
# Kernel launches
# ---------------------------------------------------------------------------

def _launch_args(spec: _NofSpec, dt, xyz_t, parts, ws, ops: _args.Operands):
    """The argument array of nof_rays.cu, completed by the returned
    function, and the length of the flat dW buffer."""
    n, s = xyz_t.shape[1], xyz_t.shape[2]
    ops.check(1 <= len(parts) <= _MAX_PE, f"{len(parts)} partials")
    for p in parts:
        ops.check(tuple(p.shape) == (n, spec.width), f"partial {p.shape}")
    part_ptrs = [ops.ptr(parts[j].float().contiguous())
                 if j < len(parts) else 0 for j in range(_MAX_PE)]
    off, total = _args.offsets(ws)
    net = _args.net_block(ops, ws, off, spec.depth, spec.width, spec.kc,
                          spec.skips, spec.logscale, True)
    xyz = xyz_t.reshape(3, n * s).float().contiguous()

    def complete(nseg=0, blocks=0, out=None, g=None, dx=None, part=None,
                 seg=None, dw=None, dparts=None):
        return _args.as_array(
            [1 if dt == torch.bfloat16 else 0, n, s, int(spec.use_quat),
             len(parts), nseg, blocks, ops.ptr(xyz)] + part_ptrs + net
            + [ops.ptr(out), ops.ptr(g), ops.ptr(dx), ops.ptr(part), total,
               ops.ptr(seg), ops.ptr(dw), ops.ptr(dparts)])

    return complete, total


def _fwd_launch(spec: _NofSpec, dt, xyz_t, parts, ws):
    from ._build import load_library
    lib = load_library()
    n, s = xyz_t.shape[1], xyz_t.shape[2]
    dev = xyz_t.device
    ops = _args.Operands("nof_fwd", dev, _storage(dt))
    complete, _ = _launch_args(spec, dt, xyz_t, parts, ws, ops)
    out = torch.empty((3, n, s), dtype=torch.float32, device=dev)
    rc = _args.call(lib.nof_rays_fwd_launch, complete(out=out),
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nof_fwd kernel failed to launch: "
                           f"{lib.nof_rays_error(rc).decode()} ({rc})")
    return out


def _bwd_launch(spec: _NofSpec, dt, xyz_t, parts, ws, g):
    from ._build import load_library
    lib = load_library()
    n, s = xyz_t.shape[1], xyz_t.shape[2]
    dev = xyz_t.device
    ops = _args.Operands("nof_bwd", dev, _storage(dt))
    ops.check(tuple(g.shape) == (3, n, s), f"cotangent {tuple(g.shape)}")
    complete, total = _launch_args(spec, dt, xyz_t, parts, ws, ops)
    rows = _args.call(lib.nof_rays_tile_rows, complete(), 1)
    if rows <= 0:
        raise RuntimeError(f"nof_bwd: no row tile fits "
                           f"({lib.nof_rays_error(rows).decode()} ({rows}))")
    blocks = min(-(-(n * s) // rows), _args.sm_count(dev))
    nseg = (s - 1) // rows + 2
    gt = g.reshape(3, n * s).float().contiguous()
    dx = torch.empty((3, n, s), dtype=torch.float32, device=dev)
    part = torch.zeros((blocks, total), dtype=torch.float32, device=dev)
    seg = torch.zeros((len(parts), n, nseg, spec.width), dtype=torch.float32,
                      device=dev)
    dw = torch.empty((total,), dtype=torch.float32, device=dev)
    dparts = torch.empty((len(parts), n, spec.width), dtype=torch.float32,
                         device=dev)
    rc = _args.call(lib.nof_rays_bwd_launch,
                    complete(nseg, blocks, None, gt, dx, part, seg, dw,
                             dparts),
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nof_bwd kernel failed to launch: "
                           f"{lib.nof_rays_error(rc).decode()} ({rc})")
    return dx, list(dparts), _args.split(dw, ws)


def nof_fwd(spec: _NofSpec, dt, xyz_t, parts, ws):
    """Forward kernel #3 (CUDA) or its plain version (CPU)."""
    if _device(xyz_t, "nof_fwd") == "cpu":
        return _nof_fwd_ref(spec, dt, xyz_t, parts, ws)
    out = _fwd_launch(spec, dt, xyz_t, parts, ws)
    nof_fwd.launches += 1
    return out


def nof_bwd(spec: _NofSpec, dt, xyz_t, parts, ws, g):
    """Backward kernel #4 (CUDA) or its plain version (CPU)."""
    if _device(xyz_t, "nof_bwd") == "cpu":
        return _nof_bwd_ref(spec, dt, xyz_t, parts, ws, g)
    out = _bwd_launch(spec, dt, xyz_t, parts, ws, g)
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
    ``xyz``, ``ind_emb`` and ``anneal``.
    """
    ws, partials = _nof_fold(params, cfg, n_freqs, anneal, ind_emb)
    spec = _NofSpec(depth=cfg.depth, width=cfg.width, kc=3 * max(n_freqs, 1),
                    skips=tuple(cfg.skips), use_quat=cfg.use_quat,
                    logscale=logscale)
    dt = torch.bfloat16 if compute_dtype == torch.bfloat16 else None
    out_t = _NofOp.apply(spec, dt, len(partials), xyz.permute(2, 0, 1),
                         *partials, *ws)
    return out_t.permute(1, 2, 0)
