"""The test-time render pass: (o, d, z) -> optional bw-NoF warp -> NeRF ->
dense sigma and rgb, as one kernel.

Port of ``moco_flow_tpu/ops/megakernel.py``'s test-time pass
(``render_pass_fused`` / ``_pass_call``), on the operand folds of
``folds.py``:

- ``render_pass_ref`` is the plain PyTorch version, written from
  ``_nof_tile`` / ``_nerf_tile``: it rounds where they round.
- ``render_pass`` is the wrapper: on a CUDA tensor it launches the kernel of
  ``csrc/render_pass.cu`` (or raises); on a CPU tensor it computes
  ``render_pass_ref``. ``render_pass.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..nn.embedding import freq_bands
from ..nn.mlp import matmul
from ..nn.nerf import NeRFConfig
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


def _net_block(depth, width, kc, bands, layers, partials, heads, ptr):
    """One net's 80-int64 block of the kernel's argument array."""
    blk = [depth, width, kc, ptr(bands)]
    pit = iter(partials)
    for l in range(_MAX_LAYERS):
        if l < len(layers):
            wpe, wh, b = layers[l]
            part = next(pit) if (wpe is not None and partials) else None
            blk += [ptr(wpe), ptr(wh), ptr(b), ptr(part)]
        else:
            blk += [0, 0, 0, 0]
    return blk + list(heads) + [0] * (12 - len(heads))


def _launch(op: _Pass, rays_o, rays_d, z_vals):
    n, s = z_vals.shape
    dev = z_vals.device
    od = torch.cat([rays_o, rays_d], dim=-1).float().contiguous()
    z = z_vals.float().contiguous()
    sigma = torch.empty((n, s), dtype=torch.float32, device=dev)
    rgb = (None if op.nerf.sigma_only
           else torch.empty((3, n, s), dtype=torch.float32, device=dev))
    _launch_pass(op, n, s, dev, od, z, sigma, rgb)
    render_pass.launches += 1
    return sigma, rgb


def _launch_pass(op: _Pass, n: int, s: int, dev, od, z, sigma, rgb):
    """Queue one launch of the pass kernel on the current stream. The
    sample positions are ``o + d*z`` (``od`` (N, 6), ``z`` (N, S)); sigma
    goes to ``sigma`` (N*S values) and rgb to ``rgb`` (3, N*S) unless
    sigma-only."""
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

    keep = []  # every tensor whose pointer goes into the argument array

    def ptr(t):
        if t is None:
            return 0
        _check(t.device == dev, f"operand on {t.device}, rays on {dev}")
        _check(t.is_contiguous(), "operand not contiguous")
        keep.append(t)
        return t.data_ptr()

    if dt == torch.bfloat16:
        def mat(w):
            """(K, N) -> W^T zero-padded to (pad16(N), pad16(K)): the
            layout of the tensor-core kernel's B operand."""
            k, n = w.shape
            out = torch.zeros((-(-n // 16) * 16, -(-k // 16) * 16),
                              dtype=dt, device=dev)
            out[:n, :k] = w.T
            return out
    else:
        def mat(w):
            return w.float().contiguous()

    def vec(b):
        return b.float().contiguous()

    def layers_of(ws, depth, skips):
        layers, rest = _trunk_layers(ws, depth, skips)
        return [(None if wpe is None else mat(wpe),
                 None if wh is None else mat(wh), vec(b))
                for wpe, wh, b in layers], rest

    def bands_of(kc, logscale):
        return torch.from_numpy(freq_bands(kc // 3, logscale)).to(dev)

    args = [1 if dt == torch.bfloat16 else 0, n, s, int(nerf.sigma_only),
            int(nof is not None), int(nof is not None and nof.use_quat),
            ptr(od), ptr(z), ptr(sigma), ptr(rgb)]
    if nof is not None:
        layers, (whead, bhead) = layers_of(op.nof_ws, nof.depth, nof.skips)
        _check(whead.shape[-1] == (9 if nof.use_quat else 3),
               f"NoF head {tuple(whead.shape)}")
        parts = [p.float().contiguous() for p in op.partials]
        args += _net_block(nof.depth, nof.width, nof.kc,
                           bands_of(nof.kc, nof.logscale), layers, parts,
                           [ptr(mat(whead)), ptr(vec(bhead)),
                            whead.shape[-1]], ptr)
    else:
        args += [0] * (4 + 4 * _MAX_LAYERS + 12)
    layers, rest = layers_of(op.nerf_ws, nerf.depth, nerf.skips)
    heads = [ptr(mat(rest[0].T)), ptr(vec(rest[1]))]  # sigma (W, 1)
    if not nerf.sigma_only:
        wf, bf, we, be, wr, br = rest[2:]
        p_extra = op.p_extra.float().contiguous() if nerf.has_extra else None
        heads += [ptr(mat(wf)), ptr(vec(bf)), ptr(mat(we)), ptr(vec(be)),
                  ptr(p_extra), ptr(mat(wr)), ptr(vec(br))]
    args += _net_block(nerf.depth, nerf.width, nerf.kc,
                       bands_of(nerf.kc, nerf.logscale), layers, [], heads,
                       ptr)
    args.append(0)  # the kernel's xyz input: no caller reads positions
    arr = np.asarray(args, dtype=np.int64)
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.render_pass_launch(arr.ctypes.data_as(ctypes.c_void_p),
                                len(arr), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"render_pass kernel failed to launch: "
                           f"{lib.render_pass_error(rc).decode()} ({rc})")
    del keep  # the launch is queued on the stream the operands live on


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
