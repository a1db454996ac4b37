"""The NeRF of the training step over whole rays, forward and backward.

Port of ``moco_flow_tpu/ops/megakernel.py``'s ``nerf_fused_rays_t`` and its
custom VJP ``_nerf_op`` (kernels ``_nerf_fwd_call`` and ``_nerf_bwd_call``):

- ``_NerfOp`` is the ``torch.autograd.Function``. Its inputs are the
  transposed positions ``(3, N, S)``, the per-ray extra partial and the
  folded operands of ``folds._nerf_fold`` (fp32 primals); it saves only
  those, and the gradients to the model's parameters and to the frame
  embeddings come from autograd through the fold.
- ``nerf_fwd`` / ``nerf_bwd`` are the kernels' wrappers: on CUDA tensors
  they launch ``csrc/nerf_rays.cu``, the forward as one row-tile pass that
  writes only its outputs and the backward as the recompute backward
  (row-tile passes over a device scratch and long-K weight-gradient
  products, ``csrc/wgrad.cu``; a call whose scratch would pass
  ``_args.SCRATCH_CAP`` runs in chunks of whole rays), or raise; on
  CPU tensors they run the plain versions ``_nerf_fwd_ref`` /
  ``_nerf_bwd_ref``, written from ``_nerf_tile`` / ``_nerf_bwd_tile`` so
  that they round where those round (matrices in the compute dtype, biases
  and the sigma row fp32, ``dz`` rounded before each weight-gradient
  product, dW returned fp32).
  ``nerf_fwd.launches`` / ``nerf_bwd.launches`` count kernel launches.
"""

from __future__ import annotations

import torch

from ..nn.embedding import freq_bands
from ..nn.mlp import matmul
from ..nn.nerf import NeRFConfig
from . import _args
from .folds import (_cast_matrices, _NerfSpec, _nerf_fold, _pe_embed,
                    _trunk_layers)


def _storage(dt) -> torch.dtype:
    return torch.bfloat16 if dt == torch.bfloat16 else torch.float32


def _rows(xyz_t: torch.Tensor) -> torch.Tensor:
    """(3, N, S) -> (N*S, 3) fp32 rows."""
    return xyz_t.reshape(3, -1).T.float()


def _sincos(x: torch.Tensor, kc: int, logscale: bool):
    """sin / cos of the PE phases (T, kc), column f*3 + j = band_f * x_j."""
    bands = torch.from_numpy(freq_bands(kc // 3, logscale)).to(x.device)
    scaled = (x[:, None, :] * bands[None, :, None]).reshape(x.shape[0], kc)
    return torch.sin(scaled), torch.cos(scaled)


def _pe_grad(de: torch.Tensor, x: torch.Tensor, kc: int, logscale: bool):
    """Cotangent of the packed embedding [x, sin, cos] -> cotangent of x:
    de_x + B . (de_sin cos - de_cos sin)."""
    sin, cos = _sincos(x, kc, logscale)
    dscaled = de[:, 3:3 + kc] * cos - de[:, 3 + kc:3 + 2 * kc] * sin
    bands = torch.from_numpy(freq_bands(kc // 3, logscale)).to(x.device)
    return de[:, 0:3] + (dscaled.reshape(-1, kc // 3, 3)
                         * bands[None, :, None]).sum(dim=1)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of the stored values (already rounded), fp32."""
    return a.float() @ b.float()


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _nerf_acts(x, p_e, ws, spec: _NerfSpec, st):
    """``_nerf_tile`` on rows: x (T, 3), p_e (T, W/2) or None, ``ws`` cast
    by ``_cast_matrices``. Returns sigma (T, 1), rgb (T, 3) | None and the
    residuals (embedding, trunk activations, final, extra)."""
    e = _pe_embed(x, spec.kc, spec.logscale, st)
    layers, rest = _trunk_layers(ws, spec.depth, spec.skips)
    acts, h = [], None
    for wpe, wh, b in layers:
        z = matmul(e, wpe, st) if wpe is not None else None
        if wh is not None:
            z = matmul(h, wh, st) if z is None else z + matmul(h, wh, st)
        h = torch.relu(z + b.float()).to(st)
        acts.append(h)
    wsig, bsig = rest[0], rest[1]
    sigma = matmul(h, wsig.T, st) + bsig.float()
    if spec.sigma_only:
        return sigma, None, (e, acts, None, None)
    wf, bf, we, be, wr, br = rest[2:]
    hf = (matmul(h, wf, st) + bf.float()).to(st)
    ze = matmul(hf, we, st) + be.float()
    if spec.has_extra:
        ze = ze + p_e
    he = torch.relu(ze).to(st)
    rgb = torch.sigmoid(matmul(he, wr, st) + br.float())
    return sigma, rgb, (e, acts, hf, he)


def _nerf_fwd_ref(spec: _NerfSpec, dt, xyz_t, p_e, ws):
    """(3, N, S) -> (4, N, S) [rgb; sigma], or (1, N, S) sigma."""
    n, s = xyz_t.shape[1], xyz_t.shape[2]
    p_rows = p_e.repeat_interleave(s, dim=0) if spec.has_extra else None
    sigma, rgb, _ = _nerf_acts(_rows(xyz_t), p_rows,
                               _cast_matrices(ws, dt), spec, _storage(dt))
    out = sigma if rgb is None else torch.cat([rgb, sigma], dim=-1)
    return out.T.reshape(-1, n, s)


def _nerf_bwd_ref(spec: _NerfSpec, dt, xyz_t, p_e, ws, g):
    """``_nerf_bwd_tile`` over all rows: cotangent g (4|1, N, S) ->
    (dxyz (3, N, S), d(extra partial) (N, W/2) | None, [dW fp32 in the
    order of ``ws``])."""
    st = _storage(dt)
    n, s = xyz_t.shape[1], xyz_t.shape[2]
    x = _rows(xyz_t)
    gr = g.reshape(g.shape[0], -1).T.float()            # (T, 4|1)
    wsc = _cast_matrices(ws, dt)
    p_rows = p_e.repeat_interleave(s, dim=0) if spec.has_extra else None
    _, rgb, (e, acts, hf, he) = _nerf_acts(x, p_rows, wsc, spec, st)
    layers, rest = _trunk_layers(wsc, spec.depth, spec.skips)
    wsig = rest[0].float()                               # (1, W), fp32
    h_last = acts[-1]
    heads, dp_e = [], None
    if spec.sigma_only:
        dsig = gr
        dh = dsig * wsig
    else:
        wf, _, we, _, wr, _ = rest[2:]
        drgb = gr[:, 0:3] * rgb * (1.0 - rgb)
        dsig = gr[:, 3:4]
        d3 = drgb.to(st)
        dwr = _mm(he.T, d3)
        dbr = drgb.sum(dim=0, keepdim=True)
        dhe = _mm(d3, wr.T)
        dhe = torch.where(he.float() > 0.0, dhe, 0.0).to(st)
        dwe = _mm(hf.T, dhe)
        dbe = dhe.float().sum(dim=0, keepdim=True)
        if spec.has_extra:
            dp_e = dhe.float().reshape(n, s, -1).sum(dim=1)
        dhf = _mm(dhe, we.T)
        dwf = _mm(h_last.T, dhf)        # bf16 x fp32: the unrounded dhf
        dbf = dhf.sum(dim=0, keepdim=True)
        dh = _mm(dhf.to(st), wf.T) + dsig * wsig
        heads = [dwf, dbf, dwe, dbe, dwr, dbr]
    dwsig = _mm(dsig.T, h_last)
    dbsig = dsig.sum(dim=0, keepdim=True)
    de = None
    dlayers = [None] * spec.depth
    for i in range(spec.depth - 1, -1, -1):
        wpe, wh, _ = layers[i]
        dz = torch.where(acts[i].float() > 0.0, dh, 0.0).to(st)
        db = dz.float().sum(dim=0, keepdim=True)
        grads = []
        if wpe is not None:
            grads.append(_mm(e.T, dz))
            de_i = _mm(dz, wpe.T)
            de = de_i if de is None else de + de_i
        if wh is not None:
            grads.append(_mm(acts[i - 1].T, dz))
            dh = _mm(dz, wh.T)
        dlayers[i] = grads + [db]
    dx = _pe_grad(de, x, spec.kc, spec.logscale)
    dws = [d for layer in dlayers for d in layer] + [dwsig, dbsig] + heads
    return dx.T.reshape(3, n, s), dp_e, dws


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _operands(spec: _NerfSpec, n: int, p_e, ws, ops, backward: bool):
    """The parts of ``csrc/nerf_rays.cu``'s argument array that #1 and #2
    share: (the weight block, the flat gradient's size, the fp32 extra
    partial or None)."""
    ops.check(spec.width % 32 == 0 and 32 <= spec.width <= _args.MAX_WIDTH,
              f"width {spec.width}: a multiple of 32 up to {_args.MAX_WIDTH}")
    off, total = _args.offsets(ws)
    n_trunk = len(ws) - (2 if spec.sigma_only else 8)
    blk = _args.row_layers(ops, ws[:n_trunk], off, spec.depth, spec.skips,
                           backward)
    i = n_trunk
    blk += [ops.vec(ws[i]), ops.vec(ws[i + 1]), off[i], off[i + 1]]  # sigma
    for k in range(3):
        blk += ([0] * 5 if spec.sigma_only else
                _args.row_mat(ops, ws, off, i + 2 + 2 * k, i + 3 + 2 * k,
                              backward))
    p = None
    if spec.has_extra:
        ops.check(tuple(p_e.shape) == (n, spec.width // 2),
                  f"extra partial {tuple(p_e.shape)}")
        p = p_e.float().contiguous()
    return blk, total, p


def _scalars(spec: _NerfSpec, dt, n: int, s: int) -> list:
    return [1 if dt == torch.bfloat16 else 0, n, s, int(spec.sigma_only),
            int(spec.has_extra), spec.depth, spec.width, spec.kc]


def _fwd_launch(spec: _NerfSpec, dt, xyz_t, p_e, ws):
    from ._build import load_library
    lib = load_library()
    n, s = xyz_t.shape[1], xyz_t.shape[2]
    dev = xyz_t.device
    ops = _args.Operands("nerf_fwd", dev, _storage(dt))
    blk, _, p = _operands(spec, n, p_e, ws, ops, backward=False)
    xyz = xyz_t.reshape(3, n * s).float().contiguous()
    out = torch.empty((1 if spec.sigma_only else 4, n, s),
                      dtype=torch.float32, device=dev)
    arr = ops.array(
        _scalars(spec, dt, n, s) + [_args.SPLIT_ROWS, 0, 0]
        + [ops.bands(spec.kc, spec.logscale), ops.ptr(xyz), ops.ptr(out), 0,
           ops.ptr(p), 0, 0, 0] + blk)
    rc = _args.call(lib.nerf_fwd_launch, arr,
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nerf_fwd kernel failed to launch: "
                           f"{lib.nerf_bwd_error(rc).decode()} ({rc})")
    return out


def _bwd_launch(spec: _NerfSpec, dt, xyz_t, p_e, ws, g):
    from ._build import load_library
    lib = load_library()
    n, s = xyz_t.shape[1], xyz_t.shape[2]
    dev = xyz_t.device
    ops = _args.Operands("nerf_bwd", dev, _storage(dt))
    ops.check(tuple(g.shape) == (1 if spec.sigma_only else 4, n, s),
              f"cotangent {tuple(g.shape)}")
    blk, total, p = _operands(spec, n, p_e, ws, ops, backward=True)
    xyz = xyz_t.reshape(3, n * s).float().contiguous()
    gt = g.reshape(g.shape[0], n * s).float().contiguous()
    dx = torch.empty((3, n * s), dtype=torch.float32, device=dev)
    dp = (torch.empty((n, spec.width // 2), dtype=torch.float32, device=dev)
          if spec.has_extra else None)
    bands = ops.bands(spec.kc, spec.logscale)

    def make_args(r0, r1, part, scratch):
        """Arguments of rays [r0, r1) (csrc/nerf_rays.cu)."""
        a, b = r0 * s, r1 * s
        whole = (r0, r1) == (0, n)
        ptrs, after = [0] * 7, None
        if part is not None:
            dx_c = dx if whole else torch.empty((3, b - a), device=dev)
            ptrs = [ops.ptr(xyz[:, a:b].contiguous()),
                    ops.ptr(gt[:, a:b].contiguous()), ops.ptr(dx_c),
                    ops.ptr(None if p is None else p[r0:r1]),
                    ops.ptr(part),
                    ops.ptr(None if dp is None else dp[r0:r1]),
                    ops.ptr(scratch)]
            if not whole:
                after = lambda: dx[:, a:b].copy_(dx_c)  # noqa: E731
        return ops.array(
            _scalars(spec, dt, r1 - r0, s)
            + [_args.SPLIT_ROWS, a // _args.SPLIT_ROWS, total, bands] + ptrs
            + blk), after

    dw = _args.run_chunks(ops, lib, "nerf_bwd", n, s, total, make_args)
    return dx.view(3, n, s), dp, _args.split(dw, ws)


def _device(t: torch.Tensor, name: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return t.device.type


def nerf_fwd(spec: _NerfSpec, dt, xyz_t, p_e, ws):
    """Forward kernel #1 (CUDA) or its plain version (CPU)."""
    if _device(xyz_t, "nerf_fwd") == "cpu":
        return _nerf_fwd_ref(spec, dt, xyz_t, p_e, ws)
    out = _fwd_launch(spec, dt, xyz_t, p_e, ws)
    nerf_fwd.launches += 1
    return out


def nerf_bwd(spec: _NerfSpec, dt, xyz_t, p_e, ws, g):
    """Backward kernel #2 (CUDA) or its plain version (CPU)."""
    if _device(xyz_t, "nerf_bwd") == "cpu":
        return _nerf_bwd_ref(spec, dt, xyz_t, p_e, ws, g)
    out = _bwd_launch(spec, dt, xyz_t, p_e, ws, g)
    nerf_bwd.launches += 1
    return out


nerf_fwd.launches = 0
nerf_bwd.launches = 0


class _NerfOp(torch.autograd.Function):
    """The NeRF over whole rays with its hand-chained backward (JAX's
    ``_nerf_op`` custom VJP)."""

    @staticmethod
    def forward(ctx, spec, dt, xyz_t, p_e, *ws):
        ctx.spec, ctx.dt = spec, dt
        ctx.save_for_backward(xyz_t, p_e, *ws)
        return nerf_fwd(spec, dt, xyz_t, p_e, ws)

    @staticmethod
    def backward(ctx, g):
        xyz_t, p_e, *ws = ctx.saved_tensors
        dx, dp_e, dws = nerf_bwd(ctx.spec, ctx.dt, xyz_t, p_e, ws,
                                 g.contiguous())
        return (None, None, dx, dp_e, *dws)


def nerf_fused_rays_t(params: dict, cfg: NeRFConfig, n_freqs: int,
                      logscale: bool, anneal, xyz_t: torch.Tensor,
                      extra_emb, sigma_only: bool, compute_dtype=None):
    """Fused NeRF over whole rays, transposed xyz I/O.

    Args:
      xyz_t: (3, N, S) sample positions, components leading.
      extra_emb: (N, E) per-ray extra feature embedding, or None.
      anneal: (n_freqs,) PE annealing weights, or None.
      compute_dtype: torch.bfloat16 or None (fp32).

    Returns (4, N, S) [rgb; sigma] fp32, or (1, N, S) sigma if
    ``sigma_only``. Differentiable in ``params``, ``xyz_t``,
    ``extra_emb`` and ``anneal``.
    """
    if cfg.encoding != "pe":
        raise NotImplementedError("the fused NeRF takes PE-encoded NeRFs")
    has_extra = (extra_emb is not None and not sigma_only
                 and cfg.extra_feat_type != "none")
    ws, p_extra = _nerf_fold(params, cfg, n_freqs, anneal,
                             extra_emb if has_extra else None, sigma_only)
    spec = _NerfSpec(depth=cfg.depth, width=cfg.width, kc=3 * max(n_freqs, 1),
                     skips=tuple(cfg.skips), sigma_only=sigma_only,
                     has_extra=has_extra, logscale=logscale)
    dt = torch.bfloat16 if compute_dtype == torch.bfloat16 else None
    return _NerfOp.apply(spec, dt, xyz_t, p_extra, *ws)
