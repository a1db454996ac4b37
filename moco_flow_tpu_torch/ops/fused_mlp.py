"""The per-op NeRF and NoF MLPs on pre-embedded rows (``mlp_impl: pallas``).

Port of ``moco_flow_tpu/ops/fused_mlp.py``: the kernels ``_nerf_pallas`` and
``_nof_pallas`` and their custom VJPs ``_nerf_fused_vjp`` /
``_nof_fused_vjp``.

- ``nerf_pallas`` / ``nof_pallas`` are the kernels' wrappers: CUDA tensors
  launch ``csrc/fused_mlp.cu`` (or raise; #8 and #9 on the wgmma tile of
  ``csrc/wg_tile.cuh`` in bf16 and the split-TF32 product of
  ``csrc/row_tile.cuh`` in fp32, #9's weights split into TF32 hi and lo
  parts once a launch by ``_args.split_ops``), CPU tensors run the plain
  versions ``_nerf_pallas_ref`` / ``_nof_pallas_ref``, written from
  ``_nerf_tile_forward`` / ``_nof_tile_forward`` so that they round where
  those round: every product on operands cast to the compute dtype with fp32
  accumulation, the bias, the ReLU, the sigmoid and the quaternion warp in
  fp32 (``nerf_apply`` instead emits hidden layers in the compute dtype and
  adds their bias there). ``nerf_pallas.launches`` / ``nof_pallas.launches``
  count kernel launches.
- ``_NerfFusedVjp`` / ``_NofFusedVjp`` are the ``torch.autograd.Function``s:
  the forward is the kernel, the backward recomputes through the plain
  ``nerf_apply`` / ``nerf_sigma`` / ``nof_apply`` under autograd, as JAX's
  ``_nerf_bwd`` / ``_nof_bwd`` do, so the gradient is that of the plain MLP,
  not of the kernel's forward. It returns gradients for the parameters and
  for the embedded inputs (``x``, ``extra``; ``inputs``, ``xyz``).
- ``nerf_fused`` / ``nof_fused`` are the drop-in functions the renderer's
  funnels call.
"""

from __future__ import annotations

import torch

from ..nn.mlp import matmul
from ..nn.nerf import NeRFConfig, nerf_apply, nerf_sigma
from ..nn.nof import NoFConfig, nof_apply
from . import _args
from .folds import _cross
from .nerf_rays import _device, _storage

_HEADS = ("final", "extra", "rgb")


def _nerf_weights_flat(params: dict, sigma_only: bool) -> list:
    """``_nerf_weights_flat``: trunk (w, b) pairs, sigma, and unless
    ``sigma_only`` final, extra and rgb."""
    ws = []
    for layer in params["trunk"]:
        ws += [layer["w"], layer["b"]]
    ws += [params["sigma"]["w"], params["sigma"]["b"]]
    if not sigma_only:
        for k in _HEADS:
            ws += [params[k]["w"], params[k]["b"]]
    return ws


def _nerf_params(ws: list, depth: int, sigma_only: bool) -> dict:
    """The parameter dict of a flat list (the inverse of the above)."""
    pair = lambda i: {"w": ws[i], "b": ws[i + 1]}  # noqa: E731
    out = {"trunk": [pair(2 * i) for i in range(depth)],
           "sigma": pair(2 * depth)}
    if not sigma_only:
        for j, k in enumerate(_HEADS):
            out[k] = pair(2 * depth + 2 + 2 * j)
    return out


def _nof_weights_flat(params: dict) -> list:
    ws = []
    for layer in params["layers"]:
        ws += [layer["w"], layer["b"]]
    return ws + [params["head"]["w"], params["head"]["b"]]


def _nof_params(ws: list, depth: int) -> dict:
    return {"layers": [{"w": ws[2 * i], "b": ws[2 * i + 1]}
                       for i in range(depth)],
            "head": {"w": ws[2 * depth], "b": ws[2 * depth + 1]}}


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _trunk(inp, ws, depth: int, skips: tuple, k_in: int, dt):
    """The ReLU trunk of a tile: the skip as the split product
    ``inp @ W[:k_in] + h @ W[k_in:]``, biases and ReLU in fp32."""
    h = None
    for i in range(depth):
        w, b = ws[2 * i], ws[2 * i + 1].float()
        if i == 0:
            z = matmul(inp, w, dt)
        elif i in skips:
            z = matmul(inp, w[:k_in], dt) + matmul(h, w[k_in:], dt)
        else:
            z = matmul(h, w, dt)
        h = torch.relu(z + b)
    return h


def _nerf_pallas_ref(cfg: NeRFConfig, dt, x, extra, sigma_only: bool, ws):
    """``_nerf_tile_forward`` over all rows: x (n, in_channels_xyz), extra
    (n, E) or None -> (n, 4) [rgb, sigma] fp32, or (n, 1) sigma."""
    h = _trunk(x, ws, cfg.depth, cfg.skips, cfg.in_channels_xyz, dt)
    k = 2 * cfg.depth
    sigma = matmul(h, ws[k], dt) + ws[k + 1].float()
    if sigma_only:
        return sigma
    hf = matmul(h, ws[k + 2], dt) + ws[k + 3].float()
    we, be = ws[k + 4], ws[k + 5].float()
    if cfg.extra_feat_type != "none":
        z = matmul(hf, we[:cfg.width], dt) + matmul(extra, we[cfg.width:], dt)
    else:
        z = matmul(hf, we, dt)
    he = torch.relu(z + be)
    rgb = torch.sigmoid(matmul(he, ws[k + 6], dt) + ws[k + 7].float())
    return torch.cat([rgb, sigma], dim=-1)


def _quat_apply_rowvec(vlog: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """d rotated by the conjugate of exp(vlog): d + 2 q x (q x d + w d)."""
    eps = 1e-8
    theta = torch.sqrt(torch.sum(vlog * vlog, dim=-1, keepdim=True)
                       + eps * eps)
    w = torch.cos(theta)
    q_v = -vlog * (torch.sin(theta) / theta)
    return d + 2.0 * _cross(q_v, _cross(q_v, d) + w * d)


def _nof_pallas_ref(cfg: NoFConfig, dt, inputs, xyz, ws):
    """``_nof_tile_forward`` over all rows: inputs (n, in_dim), xyz (n, 3)
    -> warped (n, 3) fp32."""
    h = _trunk(inputs, ws, cfg.depth, cfg.skips, cfg.in_dim, dt)
    k = 2 * cfg.depth
    out = matmul(h, ws[k], dt) + ws[k + 1].float()
    if cfg.use_quat:
        v, s, t = out[:, 0:3], out[:, 3:6], out[:, 6:9]
        return _quat_apply_rowvec(v, xyz.float() - s) + s + t
    return out + xyz.float()


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _trunk_triples(ops, ws, depth: int, width: int, skips: tuple,
                   k_in: int) -> list:
    """The trunk's layers as (wpe, wh, b): the skip as the split product
    ``x @ W[:k_in] + h @ W[k_in:]``; shapes checked."""
    ops.check(1 <= depth <= _args.MAX_DEPTH,
              f"depth {depth} not in 1..{_args.MAX_DEPTH}")
    ops.check(2 <= width <= _args.MAX_WIDTH,
              f"width {width} not in 2..{_args.MAX_WIDTH}")
    ops.check(1 <= k_in <= _args.MAX_WIDTH,
              f"{k_in} inputs not in 1..{_args.MAX_WIDTH}")
    out = []
    for i in range(depth):
        w, b = ws[2 * i], ws[2 * i + 1]
        rows = k_in if i == 0 else (k_in + width if i in skips else width)
        ops.check(tuple(w.shape) == (rows, width),
                  f"layer {i} weight {tuple(w.shape)}, expected "
                  f"({rows}, {width})")
        if i == 0:
            out.append((w, None, b))
        elif i in skips:
            out.append((w[:k_in], w[k_in:], b))
        else:
            out.append((None, w, b))
    return out


def _mats(lins: list) -> list:
    """The matrices of (wpe, wh, b) layers, in order."""
    return [w for wpe, wh, _ in lins for w in (wpe, wh)]


def _lin_ptrs(ops, lins: list, ptrs: list) -> list:
    """(wpe, wh, b) layers as flat (wpe, wh, b) pointers: ``ptrs`` those of
    ``_mats(lins)``, packed in one gather."""
    ptr = iter(ptrs)
    return [x for _, _, b in lins for x in (next(ptr), next(ptr),
                                            ops.vec(b))]


def _padded(flat: list, depth: int) -> list:
    """A trunk's pointer triples padded to MAX_DEPTH layers."""
    return flat + [0, 0, 0] * (_args.MAX_DEPTH - depth)


def _nerf_launch(cfg: NeRFConfig, dt, x, extra, sigma_only: bool, ws):
    from ._build import load_library
    lib = load_library()
    dev, n, wd = x.device, x.shape[0], cfg.width
    ops = _args.Operands("nerf_pallas", dev, _storage(dt))
    ops.check(x.dim() == 2 and x.shape[1] == cfg.in_channels_xyz,
              f"x {tuple(x.shape)}, expected (n, {cfg.in_channels_xyz})")
    # the weights as (wpe, wh, b) layers; the matrices of the launch packed
    # together (bf16: one buffer of slice images) and handed out in order
    lins = _trunk_triples(ops, ws, cfg.depth, wd, cfg.skips,
                          cfg.in_channels_xyz)
    k = 2 * cfg.depth
    ops.check(tuple(ws[k].shape) == (wd, 1), f"sigma {tuple(ws[k].shape)}")
    ke = n_ext = 0
    if not sigma_only:
        n_ext = ws[k + 4].shape[1]
        if cfg.extra_feat_type != "none":
            ops.check(extra is not None and extra.shape == (n, cfg.extra_feat_dim),
                      f"extra {None if extra is None else tuple(extra.shape)}"
                      f", expected ({n}, {cfg.extra_feat_dim})")
            ke = cfg.extra_feat_dim
        we = ws[k + 4]
        ops.check(tuple(ws[k + 2].shape) == (wd, wd)
                  and tuple(we.shape) == (wd + ke, n_ext)
                  and tuple(ws[k + 6].shape) == (n_ext, 3),
                  "final / extra / rgb weights of another shape")
        heads = [(None, ws[k + 2], ws[k + 3]),
                 (we[wd:] if ke else None, we[:wd], ws[k + 5]),
                 (None, ws[k + 6], ws[k + 7])]
    else:
        heads = []
    flat = _lin_ptrs(ops, lins + heads,
                     _args.fwd_ops(ops, _mats(lins + heads)))
    trunk = _padded(flat[:3 * cfg.depth], cfg.depth)
    heads = ([0, ops.vec(ws[k]), ops.vec(ws[k + 1])]
             + (flat[3 * cfg.depth:] or [0, 0, 0] * 3))
    out = torch.empty((n, 1 if sigma_only else 4), dtype=torch.float32,
                      device=dev)
    arr = _args.as_array(
        [1 if dt == torch.bfloat16 else 0, n, cfg.in_channels_xyz, ke, n_ext,
         cfg.depth, wd, int(sigma_only), ops.ptr(x.float().contiguous()),
         ops.ptr(extra.float().contiguous()) if ke else 0, ops.ptr(out)]
        + trunk + heads)
    rc = _args.call(lib.fused_mlp_nerf_launch, arr,
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nerf_pallas kernel failed to launch: "
                           f"{lib.fused_mlp_error(rc).decode()} ({rc})")
    return out


def _nof_launch(cfg: NoFConfig, dt, inputs, xyz, ws):
    from ._build import load_library
    lib = load_library()
    dev, n = inputs.device, inputs.shape[0]
    ops = _args.Operands("nof_pallas", dev, _storage(dt))
    ops.check(inputs.dim() == 2 and inputs.shape[1] == cfg.in_dim,
              f"inputs {tuple(inputs.shape)}, expected (n, {cfg.in_dim})")
    ops.check(tuple(xyz.shape) == (n, 3), f"xyz {tuple(xyz.shape)}")
    ops.check(cfg.width % 2 == 0, f"width {cfg.width} not even")
    lins = _trunk_triples(ops, ws, cfg.depth, cfg.width, cfg.skips,
                          cfg.in_dim)
    n_out = 9 if cfg.use_quat else 3
    k = 2 * cfg.depth
    ops.check(tuple(ws[k].shape) == (cfg.width, n_out),
              f"head {tuple(ws[k].shape)}, expected ({cfg.width}, {n_out})")
    lins.append((None, ws[k], ws[k + 1]))
    # bf16: the wgmma tile's slice images; fp32: row-tile operands split
    # once into their TF32 hi and lo parts, the lo parts lo elements on
    if dt == torch.bfloat16:
        ptrs, lo = _args.fwd_ops(ops, _mats(lins)), 0
    else:
        ptrs, lo = _args.split_ops(ops, _mats(lins))
    flat = _lin_ptrs(ops, lins, ptrs)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    x = inputs.float().contiguous()
    if x.data_ptr() % 16:        # the bf16 kernel reads 16 bytes a load
        x = x.clone()
    arr = _args.as_array(
        [1 if dt == torch.bfloat16 else 0, n, cfg.in_dim, cfg.depth,
         cfg.width, n_out, int(cfg.use_quat), lo, ops.ptr(x),
         ops.ptr(xyz.float().contiguous()), ops.ptr(out)]
        + _padded(flat[:-3], cfg.depth) + flat[-3:])
    rc = _args.call(lib.fused_mlp_nof_launch, arr,
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"nof_pallas kernel failed to launch: "
                           f"{lib.fused_mlp_error(rc).decode()} ({rc})")
    return out


def nerf_pallas(cfg: NeRFConfig, dt, x, extra, sigma_only: bool, ws):
    """Kernel #8 (CUDA) or its plain version (CPU)."""
    if _device(x, "nerf_pallas") == "cpu":
        return _nerf_pallas_ref(cfg, dt, x, extra, sigma_only, ws)
    out = _nerf_launch(cfg, dt, x, extra, sigma_only, ws)
    nerf_pallas.launches += 1
    return out


def nof_pallas(cfg: NoFConfig, dt, inputs, xyz, ws):
    """Kernel #9 (CUDA) or its plain version (CPU)."""
    if _device(inputs, "nof_pallas") == "cpu":
        return _nof_pallas_ref(cfg, dt, inputs, xyz, ws)
    out = _nof_launch(cfg, dt, inputs, xyz, ws)
    nof_pallas.launches += 1
    return out


nerf_pallas.launches = 0
nof_pallas.launches = 0


# ---------------------------------------------------------------------------
# Autograd: the kernel forward, the plain MLP's backward
# ---------------------------------------------------------------------------

def _recompute_grads(fn, tensors, needs, g):
    """Gradients of ``fn(*leaves)`` under cotangent ``g`` for the tensors
    whose ``needs`` flag is set (None elsewhere), recomputed under
    autograd."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(nd)
                  for t, nd in zip(tensors, needs)]
        out = fn(*leaves)
        want = [t for t, nd in zip(leaves, needs) if nd and t is not None]
        got = iter(torch.autograd.grad(out, want, g, allow_unused=True)
                   if want else ())
    return [next(got) if nd and t is not None else None
            for t, nd in zip(leaves, needs)]


class _NerfFusedVjp(torch.autograd.Function):
    """Kernel #8 forward; backward through ``nerf_apply`` / ``nerf_sigma``
    (JAX's ``_nerf_fused_vjp``)."""

    @staticmethod
    def forward(ctx, cfg, sigma_only, dt, x, extra, *ws):
        ctx.cfg, ctx.sigma_only, ctx.dt = cfg, sigma_only, dt
        ctx.save_for_backward(x, extra, *ws)
        return nerf_pallas(cfg, dt, x, extra, sigma_only, ws)

    @staticmethod
    def backward(ctx, g):
        cfg, sigma_only, dt = ctx.cfg, ctx.sigma_only, ctx.dt

        def fn(x, extra, *ws):
            p = _nerf_params(list(ws), cfg.depth, sigma_only)
            if sigma_only:
                return nerf_sigma(p, x, cfg, dt)
            return nerf_apply(p, x, extra, cfg, dt)

        grads = _recompute_grads(fn, ctx.saved_tensors,
                                 ctx.needs_input_grad[3:], g)
        return (None, None, None, *grads)


class _NofFusedVjp(torch.autograd.Function):
    """Kernel #9 forward; backward through ``nof_apply`` (JAX's
    ``_nof_fused_vjp``)."""

    @staticmethod
    def forward(ctx, cfg, dt, inputs, xyz, *ws):
        ctx.cfg, ctx.dt = cfg, dt
        ctx.save_for_backward(inputs, xyz, *ws)
        return nof_pallas(cfg, dt, inputs, xyz, ws)

    @staticmethod
    def backward(ctx, g):
        cfg, dt = ctx.cfg, ctx.dt

        def fn(inputs, xyz, *ws):
            return nof_apply(_nof_params(list(ws), cfg.depth), inputs, xyz,
                             cfg, dt)

        grads = _recompute_grads(fn, ctx.saved_tensors,
                                 ctx.needs_input_grad[2:], g)
        return (None, None, *grads)


def _dtype(compute_dtype):
    return torch.bfloat16 if compute_dtype == torch.bfloat16 else None


def nerf_fused(params: dict, cfg: NeRFConfig, x: torch.Tensor,
               extra: torch.Tensor | None, sigma_only: bool,
               compute_dtype=None) -> torch.Tensor:
    """Drop-in for ``nerf_apply`` / ``nerf_sigma`` over a batch of embedded
    rows: x (n, in_channels_xyz), extra (n, E) per sample or None ->
    (n, 4) [rgb, sigma] or (n, 1)."""
    if sigma_only or cfg.extra_feat_type == "none":
        extra = None
    return _NerfFusedVjp.apply(cfg, sigma_only, _dtype(compute_dtype), x,
                               extra, *_nerf_weights_flat(params, sigma_only))


def nof_fused(params: dict, cfg: NoFConfig, inputs: torch.Tensor,
              xyz: torch.Tensor, compute_dtype=None) -> torch.Tensor:
    """Drop-in for ``nof_apply``: inputs (n, in_dim), xyz (n, 3) -> warped
    (n, 3)."""
    return _NofFusedVjp.apply(cfg, _dtype(compute_dtype), inputs, xyz,
                              *_nof_weights_flat(params))
