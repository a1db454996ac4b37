"""The test-time render pass: (o, d, z) -> optional bw-NoF warp -> NeRF ->
dense sigma and rgb, as one kernel.

Port of ``moco_flow_tpu/ops/megakernel.py``'s test-time pass
(``render_pass_fused`` / ``_pass_call``), on the operand folds of
``folds.py``:

- ``render_pass_ref`` is the plain PyTorch version, written from
  ``_nof_tile`` / ``_nerf_tile``: it rounds where they round.
- ``render_pass`` is the wrapper: on a CUDA tensor it launches the kernel of
  ``csrc/render_pass.cu`` (or raises): in bf16 the warp-specialised wgmma
  tile of ``csrc/wg_tile.cuh``, in fp32 the split-TF32 product of
  ``csrc/row_tile.cuh``; on a CPU tensor it computes ``render_pass_ref``.
  ``render_pass.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..nn.mlp import matmul
from ..nn.nerf import NeRFConfig
from . import _args
from .folds import (_MAX_LAYERS, _MAX_WIDTH, _NerfSpec, _NofSpec, _cross,
                    _nerf_fold, _nof_fold, _pe_embed, _trunk_layers)


@dataclasses.dataclass
class _Pass:
    """Folded operands of one pass, shared by the kernel and the plain
    version so both compute from the same tensors."""
    nerf: _NerfSpec
    nof: _NofSpec | None
    dtype: torch.dtype
    nerf_ws: list
    p_extra: torch.Tensor | None
    nof_ws: list
    partials: list


def _fold(params, nerf_key, nerf_cfg, nof_cfg, nerf_freqs, nof_freqs,
          nerf_logscale, nof_logscale, anneal_nerf, anneal_nof, extra_emb,
          ind_emb, use_nof, sigma_only, compute_dtype) -> _Pass:
    if nerf_cfg.encoding != "pe":
        raise NotImplementedError("the render pass takes PE-encoded NeRFs")
    has_extra = (extra_emb is not None and not sigma_only
                 and nerf_cfg.extra_feat_type != "none")
    nerf_ws, p_extra = _nerf_fold(params[nerf_key], nerf_cfg, nerf_freqs,
                                  anneal_nerf,
                                  extra_emb if has_extra else None,
                                  sigma_only)
    nerf = _NerfSpec(depth=nerf_cfg.depth, width=nerf_cfg.width,
                     kc=3 * max(nerf_freqs, 1), skips=tuple(nerf_cfg.skips),
                     sigma_only=sigma_only, has_extra=has_extra,
                     logscale=nerf_logscale)
    nof, nof_ws, partials = None, [], []
    if use_nof:
        nof_ws, partials = _nof_fold(params["bw_NoF"], nof_cfg, nof_freqs,
                                     anneal_nof, ind_emb)
        nof = _NofSpec(depth=nof_cfg.depth, width=nof_cfg.width,
                       kc=3 * max(nof_freqs, 1), skips=tuple(nof_cfg.skips),
                       use_quat=nof_cfg.use_quat, logscale=nof_logscale)
    dtype = torch.bfloat16 if compute_dtype == torch.bfloat16 else torch.float32
    return _Pass(nerf, nof, dtype, nerf_ws, p_extra, nof_ws, partials)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _quat_warp(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``_nof_quat_fwd_t`` row-major: out (T, 9) = [v, s, t], x (T, 3)."""
    eps = 1e-8
    v, s, t = out[:, 0:3], out[:, 3:6], out[:, 6:9]
    d = x - s
    theta = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + eps * eps)
    w = torch.cos(theta)
    k = torch.sin(theta) / theta
    qv = -v * k
    t1 = _cross(qv, d) + w * d
    return d + 2.0 * _cross(qv, t1) + s + t


def _nof_tile(x, partials, ws, spec: _NofSpec, dt):
    """NoF warp of (T, 3) positions; partials are (T, W) fp32."""
    e = _pe_embed(x, spec.kc, spec.logscale, dt)
    layers, (whead, bhead) = _trunk_layers(ws, spec.depth, spec.skips)
    pit = iter(partials)
    h = None
    for wpe, wh, b in layers:
        z = matmul(e, wpe, dt) if wpe is not None else None
        if wh is not None:
            z = matmul(h, wh, dt) if z is None else z + matmul(h, wh, dt)
        if wpe is not None:
            z = z + next(pit)
        h = torch.relu(z + b.float()).to(dt)
    out = matmul(h, whead, dt) + bhead.float()
    if spec.use_quat:
        return _quat_warp(out, x)
    return out + x


def _nerf_tile(x, p_e, ws, spec: _NerfSpec, dt):
    """NeRF on (T, 3) positions -> (rgb (T, 3) | None, sigma (T,))."""
    e = _pe_embed(x, spec.kc, spec.logscale, dt)
    layers, rest = _trunk_layers(ws, spec.depth, spec.skips)
    h = None
    for wpe, wh, b in layers:
        z = matmul(e, wpe, dt) if wpe is not None else None
        if wh is not None:
            z = matmul(h, wh, dt) if z is None else z + matmul(h, wh, dt)
        h = torch.relu(z + b.float()).to(dt)
    wsig, bsig = rest[0], rest[1]
    sigma = (matmul(h, wsig.T, dt) + bsig.float())[:, 0]
    if spec.sigma_only:
        return None, sigma
    wf, bf, we, be, wr, br = rest[2:]
    hf = (matmul(h, wf, dt) + bf.float()).to(dt)
    ze = matmul(hf, we, dt) + be.float()
    if spec.has_extra:
        ze = ze + p_e
    he = torch.relu(ze).to(dt)
    return torch.sigmoid(matmul(he, wr, dt) + br.float()), sigma


def _pass_ref(op: _Pass, rays_o, rays_d, z_vals):
    n, s = z_vals.shape
    x = (rays_o[:, None, :] + rays_d[:, None, :] * z_vals[:, :, None]
         ).reshape(n * s, 3)
    if op.nof is not None:
        parts = [p.repeat_interleave(s, dim=0) for p in op.partials]
        x = _nof_tile(x, parts, op.nof_ws, op.nof, op.dtype)
    p_e = (op.p_extra.repeat_interleave(s, dim=0)
           if op.nerf.has_extra else None)
    rgb, sigma = _nerf_tile(x, p_e, op.nerf_ws, op.nerf, op.dtype)
    rgb_t = None if rgb is None else rgb.T.reshape(3, n, s)
    return sigma.reshape(n, s), rgb_t


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------

def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"render_pass: {msg}")


def _net_block(depth, width, kc, bands, layers, partials, heads):
    """One net's 80-int64 block of the kernel's argument array; every
    tensor already a pointer (0 for none)."""
    blk = [depth, width, kc, bands]
    pit = iter(partials)
    for l in range(_MAX_LAYERS):
        if l < len(layers):
            wpe, wh, b = layers[l]
            part = next(pit) if (wpe and partials) else 0
            blk += [wpe, wh, b, part]
        else:
            blk += [0, 0, 0, 0]
    return blk + list(heads) + [0] * (12 - len(heads))


def _launch(op: _Pass, rays_o, rays_d, z_vals):
    """One launch of the pass kernel on the current stream: positions
    ``o + d*z``, sigma (N, S) and unless sigma-only rgb (3, N, S). The
    weights go in the kernel's layout: bf16 slice images
    (``_args.wg_pack_all``, packed once a launch), fp32 row-tile
    operands."""
    n, s = z_vals.shape
    dev = z_vals.device
    od = torch.cat([rays_o, rays_d], dim=-1).float().contiguous()
    z = z_vals.float().contiguous()
    sigma = torch.empty((n, s), dtype=torch.float32, device=dev)
    rgb = (None if op.nerf.sigma_only
           else torch.empty((3, n, s), dtype=torch.float32, device=dev))
    from ._build import load_library
    dt = op.dtype
    nerf, nof = op.nerf, op.nof
    for spec in (nerf, nof):
        if spec is not None:
            _check(1 <= spec.depth <= _MAX_LAYERS,
                   f"depth {spec.depth} not in 1..{_MAX_LAYERS}")
            _check(2 <= spec.width <= _MAX_WIDTH,
                   f"width {spec.width} not in 2..{_MAX_WIDTH}")
    if nof is not None:
        _check(len(op.partials) == 1 + len([k for k in nof.skips
                                            if 0 < k < nof.depth]),
               "one NoF partial per PE-consuming layer")
        for p in op.partials:
            _check(tuple(p.shape) == (n, nof.width), f"partial {p.shape}")
    if nerf.has_extra:
        _check(tuple(op.p_extra.shape) == (n, nerf.width // 2),
               f"extra partial {tuple(op.p_extra.shape)}")

    ops = _args.Operands("render_pass", dev, dt)

    def vec(b):
        return ops.ptr(b.float().reshape(-1).contiguous())

    # every weight matrix of the launch, packed together (bf16: one buffer
    # of slice images), then handed out in the same order
    nof_layers, nof_rest = (_trunk_layers(op.nof_ws, nof.depth, nof.skips)
                            if nof is not None else ([], []))
    nerf_layers, rest = _trunk_layers(op.nerf_ws, nerf.depth, nerf.skips)
    heads_w = [] if nerf.sigma_only else [rest[2], rest[4], rest[6]]
    mats = ([w for wpe, wh, _ in nof_layers for w in (wpe, wh)]
            + nof_rest[:1]
            + [w for wpe, wh, _ in nerf_layers for w in (wpe, wh)] + heads_w)
    ptr = iter(_args.fwd_ops(ops, mats))
    args = [1 if dt == torch.bfloat16 else 0, n, s, int(nerf.sigma_only),
            int(nof is not None), int(nof is not None and nof.use_quat),
            ops.ptr(od), ops.ptr(z), ops.ptr(sigma), ops.ptr(rgb)]
    if nof is not None:
        layers = [(next(ptr), next(ptr), vec(b)) for _, _, b in nof_layers]
        whead, bhead = nof_rest
        _check(whead.shape[-1] == (9 if nof.use_quat else 3),
               f"NoF head {tuple(whead.shape)}")
        parts = [ops.ptr(p.float().contiguous()) for p in op.partials]
        args += _net_block(nof.depth, nof.width, nof.kc,
                           ops.bands(nof.kc, nof.logscale), layers, parts,
                           [next(ptr), vec(bhead), whead.shape[-1]])
    else:
        args += [0] * (4 + 4 * _MAX_LAYERS + 12)
    layers = [(next(ptr), next(ptr), vec(b)) for _, _, b in nerf_layers]
    heads = [vec(rest[0]), vec(rest[1])]  # the (1, W) sigma row, fp32
    if not nerf.sigma_only:
        p_extra = (ops.ptr(op.p_extra.float().contiguous())
                   if nerf.has_extra else 0)
        heads += [next(ptr), vec(rest[3]), next(ptr), vec(rest[5]), p_extra,
                  next(ptr), vec(rest[7])]
    args += _net_block(nerf.depth, nerf.width, nerf.kc,
                       ops.bands(nerf.kc, nerf.logscale), layers, [], heads)
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _args.call(lib.render_pass_launch, _args.as_array(args),
                    ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"render_pass kernel failed to launch: "
                           f"{lib.render_pass_error(rc).decode()} ({rc})")
    render_pass.launches += 1
    return sigma, rgb
    del ops  # the launch is queued on the stream the operands live on


# ---------------------------------------------------------------------------
# Public entry points (the signature of the JAX render_pass_fused)
# ---------------------------------------------------------------------------

def render_pass_ref(params: dict, nerf_key: str, nerf_cfg: NeRFConfig,
                    nof_cfg, nerf_freqs: int, nof_freqs: int,
                    nerf_logscale: bool, nof_logscale: bool,
                    anneal_nerf, anneal_nof, rays_o: torch.Tensor,
                    rays_d: torch.Tensor, z_vals: torch.Tensor, extra_emb,
                    ind_emb, use_nof: bool, sigma_only: bool,
                    compute_dtype=None):
    """Plain PyTorch version of :func:`render_pass` (any device)."""
    op = _fold(params, nerf_key, nerf_cfg, nof_cfg, nerf_freqs, nof_freqs,
               nerf_logscale, nof_logscale, anneal_nerf, anneal_nof,
               extra_emb, ind_emb, use_nof, sigma_only, compute_dtype)
    return _pass_ref(op, rays_o, rays_d, z_vals)


def render_pass(params: dict, nerf_key: str, nerf_cfg: NeRFConfig,
                nof_cfg, nerf_freqs: int, nof_freqs: int,
                nerf_logscale: bool, nof_logscale: bool,
                anneal_nerf, anneal_nof, rays_o: torch.Tensor,
                rays_d: torch.Tensor, z_vals: torch.Tensor, extra_emb,
                ind_emb, use_nof: bool, sigma_only: bool,
                compute_dtype=None):
    """One test-time render pass over whole rays.

    Args:
      rays_o, rays_d: (N, 3); z_vals: (N, S) sample depths.
      extra_emb: (N, E) per-ray NeRF extra embedding (None if sigma_only or
        extra_feat_type none); ind_emb: (N, E') per-ray NoF frame embedding.
      compute_dtype: torch.bfloat16 or None (fp32).

    Returns ``(sigma (N, S), rgb_t (3, N, S) | None)`` fp32. CUDA tensors
    run the kernel (any failure raises); CPU tensors run
    :func:`render_pass_ref`.
    """
    op = _fold(params, nerf_key, nerf_cfg, nof_cfg, nerf_freqs, nof_freqs,
               nerf_logscale, nof_logscale, anneal_nerf, anneal_nof,
               extra_emb, ind_emb, use_nof, sigma_only, compute_dtype)
    if z_vals.device.type == "cpu":
        return _pass_ref(op, rays_o, rays_d, z_vals)
    if z_vals.device.type != "cuda":
        raise ValueError(f"render_pass: no kernel for device {z_vals.device}")
    _check(z_vals.ndim == 2 and tuple(rays_o.shape) == (z_vals.shape[0], 3)
           and rays_d.shape == rays_o.shape,
           f"rays {tuple(rays_o.shape)} / {tuple(rays_d.shape)}, "
           f"z {tuple(z_vals.shape)}")
    return _launch(op, rays_o, rays_d, z_vals)


render_pass.launches = 0
