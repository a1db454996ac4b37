"""The NoF warp chain of the training step, forward and backward.

Port of ``moco_flow_tpu/ops/megakernel.py``'s ``nof_chain_rays_t`` and its
custom VJP ``_chain_op`` (kernels ``_chain_fwd_call`` and
``_chain_bwd_call``): up to five NoF evaluations per sample
(``_chain_stages``): bw@ind -> cano; fw@ind -> recon (local chain);
fw@chained -> bw@chained -> fw@ind -> chain_recon (global chain).

- ``_ChainOp`` is the ``torch.autograd.Function``. Its inputs are the
  transposed positions ``(3, N, S)``, the per-ray partials of the four
  partial sets (0 = bw@ind, 1 = fw@ind, 2 = fw@chained, 3 = bw@chained)
  and the folded bw and fw operands of ``folds._nof_fold`` (fp32 primals);
  it saves only those.
- ``chain_fwd`` / ``chain_bwd`` are the kernels' wrappers: CUDA tensors
  launch ``csrc/chain_bwd.cu`` (the forward as one row-tile pass that
  writes only its outputs, the backward as row-tile passes over a device
  scratch and long-K weight-gradient products, in chunks of whole rays
  above ``_args.SCRATCH_CAP``), or raise; CPU tensors run the plain
  versions ``_chain_fwd_ref`` / ``_chain_bwd_ref``, written from
  ``_nof_tile``, ``_nof_quat_bwd_t`` and ``_nof_bwd_tile``.
  ``chain_fwd.launches`` / ``chain_bwd.launches`` count kernel launches.
"""

from __future__ import annotations

import dataclasses

import torch

from ..nn.mlp import matmul
from ..nn.nof import NoFConfig
from . import _args
from .folds import (_cast_matrices, _cross, _NofSpec, _nof_fold, _pe_embed,
                    _trunk_layers)
from .nerf_rays import _device, _mm, _pe_grad, _rows, _storage
from .render_pass import _quat_warp

_MAX_SETS, _MAX_PE = 4, 4   # csrc/chain_bwd.cu kMaxSets, kMaxPe


@dataclasses.dataclass(frozen=True)
class _ChainSpec:
    nof: _NofSpec
    chain_local: bool
    chain_global: bool


def _chain_stages(spec: _ChainSpec):
    """(net, partial set) per stage."""
    stages = [("bw", 0)]
    if spec.chain_local:
        stages.append(("fw", 1))
    if spec.chain_global:
        stages += [("fw", 2), ("bw", 3), ("fw", 1)]
    return stages


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _nof_eval(x, parts, ws, spec: _NofSpec, st):
    """``_nof_tile`` on rows: x (T, 3), parts (T, W) per PE layer, ``ws``
    cast. Returns the warped rows and the residuals."""
    e = _pe_embed(x, spec.kc, spec.logscale, st)
    layers, (whead, bhead) = _trunk_layers(ws, spec.depth, spec.skips)
    pit = iter(parts)
    acts, h = [], None
    for wpe, wh, b in layers:
        z = matmul(e, wpe, st) if wpe is not None else None
        if wh is not None:
            z = matmul(h, wh, st) if z is None else z + matmul(h, wh, st)
        if wpe is not None:
            z = z + next(pit)
        h = torch.relu(z + b.float()).to(st)
        acts.append(h)
    out = matmul(h, whead, st) + bhead.float()
    warped = _quat_warp(out, x) if spec.use_quat else out + x
    return warped, (e, acts, out)


def _quat_vjp(out, x, g):
    """``_nof_quat_bwd_t`` on rows: (dout (T, 9), dx (T, 3))."""
    eps = 1e-8
    v, s = out[:, 0:3], out[:, 3:6]
    d = x - s
    theta = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + eps * eps)
    w = torch.cos(theta)
    k = torch.sin(theta) / theta
    qv = -v * k
    t1 = _cross(qv, d) + w * d
    dqv = _cross(t1, 2.0 * g)
    dt1 = _cross(2.0 * g, qv)
    dqv = dqv + _cross(d, dt1)
    dd = g + _cross(dt1, qv) + w * dt1
    dw = torch.sum(dt1 * d, dim=-1, keepdim=True)
    dv = -k * dqv
    dk = torch.sum(-v * dqv, dim=-1, keepdim=True)
    sin_t = k * theta
    dtheta = -sin_t * dw + dk * (w / theta - sin_t / (theta * theta))
    dv = dv + dtheta * v / theta
    return torch.cat([dv, g - dd, g], dim=-1), dd


def _nof_vjp(x, ws, spec: _NofSpec, st, g, res, n, s):
    """``_nof_bwd_tile`` with the forward's residuals: (dx, [d partial
    (N, W) per PE layer], [dW in the order of ws])."""
    e, acts, out = res
    layers, (whead, _) = _trunk_layers(ws, spec.depth, spec.skips)
    if spec.use_quat:
        dout, dx = _quat_vjp(out, x, g)
    else:
        dout, dx = g, g
    d9 = dout.to(st)
    head = [_mm(acts[-1].T, d9), dout.sum(dim=0, keepdim=True)]
    dh = _mm(d9, whead.T)
    de = None
    dparts, dlayers = [], [None] * spec.depth
    for i in range(spec.depth - 1, -1, -1):
        wpe, wh, _ = layers[i]
        dz = torch.where(acts[i].float() > 0.0, dh, 0.0).to(st)
        db = dz.float().sum(dim=0, keepdim=True)
        grads = []
        if wpe is not None:
            grads.append(_mm(e.T, dz))
            dparts.insert(0, dz.float().reshape(n, s, -1).sum(dim=1))
            de_i = _mm(dz, wpe.T)
            de = de_i if de is None else de + de_i
        if wh is not None:
            grads.append(_mm(acts[i - 1].T, dz))
            dh = _mm(dz, wh.T)
        dlayers[i] = grads + [db]
    dx = dx + _pe_grad(de, x, spec.kc, spec.logscale)
    return dx, dparts, [d for layer in dlayers for d in layer] + head


def _prepare(spec: _ChainSpec, dt, n_pe, xyz_t, parts, ws_bw, ws_fw):
    s = xyz_t.shape[2]
    sets = [[p.float().repeat_interleave(s, dim=0)
             for p in parts[k * n_pe:(k + 1) * n_pe]]
            for k in range(len(parts) // n_pe)]
    ws = {"bw": _cast_matrices(ws_bw, dt), "fw": _cast_matrices(ws_fw, dt)}
    return _rows(xyz_t), sets, ws


def _chain_fwd_ref(spec: _ChainSpec, dt, n_pe, xyz_t, parts, ws_bw, ws_fw):
    """-> (cano, recon?, chain_recon?), each (3, N, S)."""
    n, s = xyz_t.shape[1], xyz_t.shape[2]
    x, sets, ws = _prepare(spec, dt, n_pe, xyz_t, parts, ws_bw, ws_fw)
    outs, cur, cano = [], x, None
    for si, (net, ps) in enumerate(_chain_stages(spec)):
        cur, _ = _nof_eval(cur, sets[ps], ws[net], spec.nof, _storage(dt))
        if si == 0:
            cano = cur
            outs.append(cur)
        elif spec.chain_local and si == 1:
            outs.append(cur)
            cur = cano
    if spec.chain_global:
        outs.append(cur)
    return tuple(o.T.reshape(3, n, s) for o in outs)


def _chain_bwd_ref(spec: _ChainSpec, dt, n_pe, xyz_t, parts, ws_bw, ws_fw,
                   gs):
    """``_chain_bwd_tile`` over all rows: cotangents of the outputs ->
    (dxyz (3, N, S), [d partial (N, W)] in the order of ``parts``,
    [dW] for ws_bw then ws_fw)."""
    st = _storage(dt)
    n, s = xyz_t.shape[1], xyz_t.shape[2]
    x, sets, ws = _prepare(spec, dt, n_pe, xyz_t, parts, ws_bw, ws_fw)
    stages = _chain_stages(spec)
    inputs, residuals, cur, cano = [], [], x, None
    for si, (net, ps) in enumerate(stages):
        inputs.append(cur)
        cur, res = _nof_eval(cur, sets[ps], ws[net], spec.nof, st)
        residuals.append(res)
        if si == 0:
            cano = cur
        elif spec.chain_local and si == 1:
            cur = cano
    grow = [g.reshape(3, -1).T.float() for g in gs]
    dws = {"bw": [torch.zeros(w.shape, device=x.device) for w in ws_bw],
           "fw": [torch.zeros(w.shape, device=x.device) for w in ws_fw]}
    dsets = [[torch.zeros((n, p.shape[-1]), device=x.device) for p in st_]
             for st_ in sets]

    def warp_vjp(si, g):
        net, ps = stages[si]
        dx_, dps, dws_ = _nof_vjp(inputs[si], ws[net], spec.nof, st, g,
                                  residuals[si], n, s)
        dws[net] = [a + b for a, b in zip(dws[net], dws_)]
        dsets[ps] = [a + b for a, b in zip(dsets[ps], dps)]
        return dx_

    d_cano = grow[0]
    glob0 = 2 if spec.chain_local else 1
    if spec.chain_global:
        d = warp_vjp(glob0 + 2, grow[-1])
        d = warp_vjp(glob0 + 1, d)
        d_cano = d_cano + warp_vjp(glob0, d)
    if spec.chain_local:
        d_cano = d_cano + warp_vjp(1, grow[1])
    dx = warp_vjp(0, d_cano)
    return (dx.T.reshape(3, n, s), [p for st_ in dsets for p in st_],
            dws["bw"] + dws["fw"])


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _stage_args(spec: _ChainSpec, n_pe, n, parts, ops: _args.Operands):
    """stage_net[5], stage_set[5], in_src[5] (zero-padded), after checking
    the partials."""
    ops.check(1 <= n_pe <= _MAX_PE and len(parts) % n_pe == 0
              and len(parts) // n_pe <= _MAX_SETS,
              f"{len(parts)} partials in sets of {n_pe}")
    for p in parts:
        ops.check(tuple(p.shape) == (n, spec.nof.width), f"partial {p.shape}")
    stages = _chain_stages(spec)
    glob0 = 2 if spec.chain_local else 1
    in_src = [-1] + [0] * (len(stages) - 1)
    if spec.chain_global:
        in_src[glob0 + 1], in_src[glob0 + 2] = glob0, glob0 + 1
    pad = [0] * (5 - len(stages))
    return ([1 if net == "fw" else 0 for net, _ in stages] + pad
            + [ps for _, ps in stages] + pad + in_src + pad)


def _part_ptrs(parts, n_pe, ops: _args.Operands, view=lambda t: t):
    """[4][4] pointers of the partials (set k, PE layer j), 0 where absent."""
    out = []
    for k in range(_MAX_SETS):
        for j in range(_MAX_PE):
            q = k * n_pe + j
            out.append(ops.ptr(view(parts[q]))
                       if j < n_pe and q < len(parts) else 0)
    return out


def _by_slot(spec: _ChainSpec, ts, ops: _args.Operands):
    """Pointers of the outputs (or their cotangents) in the kernels' slots:
    0 cano, 1 recon, 2 chain_recon."""
    slots = [0] + [1] * spec.chain_local + [2] * spec.chain_global
    out = [0, 0, 0]
    for k, t in zip(slots, ts):
        out[k] = ops.ptr(t)
    return out


_NET_ARGS = 8 * _args.MAX_DEPTH + 5   # csrc/chain_bwd.cu kNetArgs


def _operands(spec: _ChainSpec, n_pe, n, parts, ws_bw, ws_fw, ops,
              backward: bool):
    """The parts of ``csrc/chain_bwd.cu``'s argument array that #3-#6
    share: (the chain's scalars, the stage table, the nets' block, the flat
    gradient's size). ``ws_fw`` None (the single warp #3 / #4): the fw
    net's operands are 0 and the gradient holds the bw net's alone."""
    nof = spec.nof
    w = nof.width
    ops.check(w % 32 == 0 and 32 <= w <= _args.MAX_WIDTH,
              f"width {w}: a multiple of 32 up to {_args.MAX_WIDTH}")
    body = _stage_args(spec, n_pe, n, parts, ops)

    def net(ws, off):
        return (_args.row_layers(ops, ws[:-2], off, nof.depth, nof.skips,
                                 backward)
                + _args.row_mat(ops, ws, off, len(ws) - 2, len(ws) - 1,
                                backward))

    off_bw, total = _args.offsets(ws_bw)
    nets = net(ws_bw, off_bw)
    if ws_fw is None:
        nets += [0] * _NET_ARGS
    else:
        off_fw, total = _args.offsets(ws_fw, total)
        nets += net(ws_fw, off_fw)
    head = [len(_chain_stages(spec)), int(nof.use_quat),
            int(spec.chain_local), int(spec.chain_global), n_pe, nof.depth,
            w, nof.kc, ws_bw[-2].shape[-1]]
    return head, body, nets, total


def _fwd_args(spec: _ChainSpec, dt, n_pe, xyz_t, parts, ws_bw, ws_fw,
              ops: _args.Operands):
    """The forward's argument array (the outputs in the cotangent slots)
    and its outputs, allocated."""
    nof = spec.nof
    n, s = xyz_t.shape[1], xyz_t.shape[2]
    head, body, nets, _ = _operands(spec, n_pe, n, parts, ws_bw, ws_fw, ops,
                                    backward=False)
    xyz = xyz_t.reshape(3, n * s).float().contiguous()
    n_out = 1 + int(spec.chain_local) + int(spec.chain_global)
    outs = [torch.empty((3, n, s), dtype=torch.float32, device=ops.device)
            for _ in range(n_out)]
    ptrs = ([ops.bands(nof.kc, nof.logscale), ops.ptr(xyz)]
            + _by_slot(spec, outs, ops) + [0, 0, 0]
            + _part_ptrs([p.float().contiguous() for p in parts], n_pe, ops)
            + [0] * (_MAX_SETS * _MAX_PE))
    arr = ops.array([1 if dt == torch.bfloat16 else 0, n, s] + head
                    + [_args.SPLIT_ROWS, 0, 0] + body + ptrs + nets)
    return arr, outs


def scratch_bytes(spec: _ChainSpec, dt, rows: int) -> int:
    """The backward's device scratch for ``rows`` rows (``csrc/
    chain_bwd.cu::layout``): per stage and row (rows padded to the 128-row
    tile) the input x (4 fp32), the packed PE, each activation, the head
    output (16 fp32), each layer's dz, the head cotangent (16) and its fp32
    value (16 fp32), in the storage type unless stated."""
    nof, t = spec.nof, 2 if dt == torch.bfloat16 else 4
    kp16 = -(-(3 + 2 * nof.kc) // 16) * 16
    per_row = (16 + t * kp16 + 2 * nof.depth * t * nof.width + 64 + t * 16
               + 64)
    return len(_chain_stages(spec)) * per_row * (-(-rows // 128) * 128)


def _fwd_launch(spec: _ChainSpec, dt, n_pe, xyz_t, parts, ws_bw, ws_fw,
                entry: str = "chain_fwd"):
    """#5, or with ``entry`` "nof_fwd" and one stage #3: the outputs."""
    from ._build import load_library
    lib = load_library()
    dev = xyz_t.device
    ops = _args.Operands(entry, dev, _storage(dt))
    arr, outs = _fwd_args(spec, dt, n_pe, xyz_t, parts, ws_bw, ws_fw, ops)
    rc = _args.call(getattr(lib, f"{entry}_launch"), arr,
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel failed to launch: "
                           f"{lib.chain_bwd_error(rc).decode()} ({rc})")
    return tuple(outs)


def _bwd_launch(spec: _ChainSpec, dt, n_pe, xyz_t, parts, ws_bw, ws_fw, gs,
                entry: str = "chain_bwd"):
    """#6, or with ``entry`` "nof_bwd", one stage and ``ws_fw`` None #4:
    (dxyz, [d partial], [dW])."""
    from ._build import load_library
    lib = load_library()
    nof = spec.nof
    n, s = xyz_t.shape[1], xyz_t.shape[2]
    dev = xyz_t.device
    ops = _args.Operands(entry, dev, _storage(dt))
    for g in gs:
        ops.check(tuple(g.shape) == (3, n, s), f"cotangent {tuple(g.shape)}")
    head, body, nets, total = _operands(spec, n_pe, n, parts, ws_bw, ws_fw,
                                        ops, backward=True)
    xyz = xyz_t.reshape(3, n * s).float().contiguous()
    gsc = [g.reshape(3, n * s).float().contiguous() for g in gs]
    pc = [p.float().contiguous() for p in parts]
    dx = torch.empty((3, n * s), dtype=torch.float32, device=dev)
    dparts = torch.empty((len(parts), n, nof.width), dtype=torch.float32,
                         device=dev)
    bands = ops.bands(nof.kc, nof.logscale)

    def make_args(r0, r1, part, scratch):
        """Arguments of rays [r0, r1) (csrc/chain_bwd.cu)."""
        a, b = r0 * s, r1 * s
        whole = (r0, r1) == (0, n)
        ptrs, after = [0] * (7 + 2 * _MAX_SETS * _MAX_PE), None
        if part is not None:
            dx_c = dx if whole else torch.empty((3, b - a), device=dev)
            rows = lambda t: t[r0:r1]  # noqa: E731
            ptrs = ([ops.ptr(xyz[:, a:b].contiguous())]
                    + _by_slot(spec, [g[:, a:b].contiguous() for g in gsc],
                               ops)
                    + [ops.ptr(dx_c), ops.ptr(part), ops.ptr(scratch)]
                    + _part_ptrs(pc, n_pe, ops, rows)
                    + _part_ptrs(list(dparts), n_pe, ops, rows))
            if not whole:
                after = lambda: dx[:, a:b].copy_(dx_c)  # noqa: E731
        return ops.array(
            [1 if dt == torch.bfloat16 else 0, r1 - r0, s] + head
            + [_args.SPLIT_ROWS, a // _args.SPLIT_ROWS, total] + body
            + [bands] + ptrs + nets), after

    dw = _args.run_chunks(ops, lib, entry, n, s, total, make_args,
                          error="chain_bwd_error")
    return (dx.view(3, n, s), list(dparts),
            _args.split(dw, list(ws_bw) + list(ws_fw or [])))


def chain_fwd(spec: _ChainSpec, dt, n_pe, xyz_t, parts, ws_bw, ws_fw):
    """Forward kernel #5 (CUDA) or its plain version (CPU)."""
    if _device(xyz_t, "chain_fwd") == "cpu":
        return _chain_fwd_ref(spec, dt, n_pe, xyz_t, parts, ws_bw, ws_fw)
    out = _fwd_launch(spec, dt, n_pe, xyz_t, parts, ws_bw, ws_fw)
    chain_fwd.launches += 1
    return out


def chain_bwd(spec: _ChainSpec, dt, n_pe, xyz_t, parts, ws_bw, ws_fw, gs):
    """Backward kernel #6 (CUDA) or its plain version (CPU)."""
    if _device(xyz_t, "chain_bwd") == "cpu":
        return _chain_bwd_ref(spec, dt, n_pe, xyz_t, parts, ws_bw, ws_fw, gs)
    out = _bwd_launch(spec, dt, n_pe, xyz_t, parts, ws_bw, ws_fw, gs)
    chain_bwd.launches += 1
    return out


chain_fwd.launches = 0
chain_bwd.launches = 0


class _ChainOp(torch.autograd.Function):
    """The whole warp chain with one backward (JAX's ``_chain_op``)."""

    @staticmethod
    def forward(ctx, spec, dt, n_pe, n_parts, xyz_t, *arrs):
        parts, ws = arrs[:n_parts], arrs[n_parts:]
        ws_bw, ws_fw = ws[:len(ws) // 2], ws[len(ws) // 2:]
        ctx.spec, ctx.dt, ctx.n_pe, ctx.n_parts = spec, dt, n_pe, n_parts
        ctx.save_for_backward(xyz_t, *arrs)
        return chain_fwd(spec, dt, n_pe, xyz_t, parts, ws_bw, ws_fw)

    @staticmethod
    def backward(ctx, *gs):
        xyz_t, *arrs = ctx.saved_tensors
        parts, ws = arrs[:ctx.n_parts], arrs[ctx.n_parts:]
        ws_bw, ws_fw = ws[:len(ws) // 2], ws[len(ws) // 2:]
        dx, dparts, dws = chain_bwd(ctx.spec, ctx.dt, ctx.n_pe, xyz_t, parts,
                                    ws_bw, ws_fw,
                                    [g.contiguous() for g in gs])
        return (None, None, None, None, dx, *dparts, *dws)


def nof_chain_rays_t(params: dict, cfg: NoFConfig, n_freqs: int,
                     logscale: bool, anneal, xyz_t: torch.Tensor,
                     ind_emb: torch.Tensor, chained_emb,
                     chain_local: bool, chain_global: bool,
                     compute_dtype=None):
    """The training NoF warp chain in one fused kernel, transposed xyz I/O.

    Args:
      xyz_t: (3, N, S); ind_emb / chained_emb: (N, E) per-ray embedded
        frame indices (chained_emb only needed when chain_global).

    Returns (cano, recon | None, chain_recon | None), each (3, N, S),
    differentiable in ``params``, ``xyz_t``, the embeddings and ``anneal``.
    """
    spec = _ChainSpec(
        nof=_NofSpec(depth=cfg.depth, width=cfg.width, kc=3 * max(n_freqs, 1),
                     skips=tuple(cfg.skips), use_quat=cfg.use_quat,
                     logscale=logscale),
        chain_local=chain_local, chain_global=chain_global)
    with_fw = chain_local or chain_global
    ws_bw, p_bw_ind = _nof_fold(params["bw_NoF"], cfg, n_freqs, anneal,
                                ind_emb)
    ws_fw, p_fw_ind = (_nof_fold(params["fw_NoF"], cfg, n_freqs, anneal,
                                 ind_emb) if with_fw else (ws_bw, p_bw_ind))
    sets = [p_bw_ind, p_fw_ind]
    if chain_global:
        _, p_fw_ch = _nof_fold(params["fw_NoF"], cfg, n_freqs, anneal,
                               chained_emb)
        _, p_bw_ch = _nof_fold(params["bw_NoF"], cfg, n_freqs, anneal,
                               chained_emb)
        sets += [p_fw_ch, p_bw_ch]
    parts = [p for st in sets for p in st]
    dt = torch.bfloat16 if compute_dtype == torch.bfloat16 else None
    outs = _ChainOp.apply(spec, dt, len(p_bw_ind), len(parts), xyz_t,
                          *parts, *ws_bw, *ws_fw)
    cano = outs[0]
    recon = outs[1] if chain_local else None
    chain_recon = outs[-1] if chain_global else None
    return cano, recon, chain_recon
