"""The single-warp NoF kernels' plain versions against the JAX package: the
port's ``nof_fused_rays`` on CPU tensors (``_nof_fwd_ref`` /
``_nof_bwd_ref`` behind ``_NofOp``) against ``nof_fused_rays`` of
``moco_flow_tpu.ops.megakernel`` and ``jax.grad`` through it, whose Pallas
kernels (``_nof_fwd_call`` / ``_nof_bwd_call``) run in interpret mode on
the CPU backend.

NoF 4x32 with the quaternion head and the 21-dim frame embedding, PE
annealing below one. Shapes: 3 rays x 7 samples, and one "ray" of 5000
or 4100 samples, longer than the 4096 after which both JAX and the port
re-chunk a single ray into 4096-sample rays. The loss is a fixed random
weighting of the warped positions; the gradients are compared for every
parameter leaf, the positions and the frame embedding. Two tests read
back what the CUDA kernels would be given, with no card: the one-stage
argument array of #3/#4 (the warp chain's with one stage) and the size of
the backward's device scratch.

Tolerances, relative to each array's largest magnitude: fp32 1e-5 (both
sides sum in fp32, in other orders; measured <= 8e-7). bf16 2e-4: both
sides round to bf16 at the same places, but over 5000 samples another
summation order flips a few bf16 roundings of hidden activations (measured
up to 8.5e-5); the test also measures the JAX package's own bf16-vs-fp32
gap on the same inputs and checks that it is at least 10x the bound (it is
5.8e-3 of the scale at 3 x 7), so the bf16 cases do test bf16 rounding.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu.nn.nof import NoFConfig as JNoFConfig, init_nof
from moco_flow_tpu.ops import megakernel as jmk
from moco_flow_tpu.train.checkpoint import _flatten as j_flatten
from moco_flow_tpu_torch.nn.nof import NoFConfig
from moco_flow_tpu_torch.ops import nof_rays
from moco_flow_tpu_torch.train.checkpoint import _flatten, params_from_jax

NOF = dict(depth=4, width=32, in_channels_xyz=21, skips=(2,),
           extra_feat_dim=21, use_quat=True)
TOL = {"fp32": 1e-5, "bf16": 2e-4}


@pytest.fixture(scope="module")
def params():
    return init_nof(jax.random.key(4), JNoFConfig(**NOF))


def _inputs(n, s, seed):
    rng = np.random.default_rng(seed)
    return {"xyz": rng.uniform(-1.0, 1.0, (n, s, 3)).astype(np.float32),
            "emb": rng.normal(size=(n, 21)).astype(np.float32),
            "w": rng.normal(size=(n, s, 3)).astype(np.float32),
            "anneal": np.array([1.0, 0.5, 0.0], np.float32)}


def _jax(params, inp, dt, n_freqs=3, use_anneal=True):
    cfg = JNoFConfig(**NOF)
    a = jnp.asarray(inp["anneal"]) if use_anneal else None

    def loss(p, x, e):
        out = jmk.nof_fused_rays(p, cfg, n_freqs, True, a, x, e,
                                 jnp.bfloat16 if dt == "bf16" else None)
        return jnp.sum(out * inp["w"]), out

    (_, out), (gp, gx, ge) = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(inp["xyz"]), jnp.asarray(inp["emb"]))
    res = {"out": np.asarray(out), "xyz": np.asarray(gx),
           "emb": np.asarray(ge)}
    res.update({f"param/{k}": np.asarray(v, np.float32)
                for k, v in j_flatten(gp).items()})
    return res


def _port(params, inp, dt, n_freqs=3, use_anneal=True):
    p = params_from_jax(params)
    leaves = _flatten(p, leaf=lambda t: t)
    for t in leaves.values():
        t.requires_grad_(True)
    x = torch.from_numpy(inp["xyz"]).requires_grad_(True)
    e = torch.from_numpy(inp["emb"]).requires_grad_(True)
    a = torch.from_numpy(inp["anneal"]) if use_anneal else None
    out = nof_rays.nof_fused_rays(p, NoFConfig(**NOF), n_freqs, True, a, x,
                                  e, torch.bfloat16 if dt == "bf16" else None)
    torch.sum(out * torch.from_numpy(inp["w"])).backward()
    res = {"out": out.detach().numpy(), "xyz": x.grad.numpy(),
           "emb": e.grad.numpy()}
    res.update({f"param/{k}": t.grad.numpy() for k, t in leaves.items()})
    return res


@pytest.mark.parametrize("case", [
    dict(n=3, s=7, dt="fp32"), dict(n=3, s=7, dt="bf16"),
    dict(n=1, s=5000, dt="fp32"), dict(n=1, s=5000, dt="bf16"),
    dict(n=3, s=7, dt="fp32", use_anneal=False),
    dict(n=3, s=7, dt="fp32", n_freqs=0),
], ids=["3x7-fp32", "3x7-bf16", "1x5000-fp32", "1x5000-bf16", "no-anneal",
        "raw-xyz"])
def test_nof_fused_rays_matches_jax(params, case):
    """Warped positions (N, S, 3) and the gradients of a weighted sum of
    them w.r.t. every NoF parameter, xyz and the frame embedding."""
    dt = case["dt"]
    kw = {k: case[k] for k in ("n_freqs", "use_anneal") if k in case}
    inp = _inputs(case["n"], case["s"], seed=case["s"])
    want = _jax(params, inp, dt, **kw)
    got = _port(params, inp, dt, **kw)
    ref32 = _jax(params, inp, "fp32", **kw) if dt == "bf16" else None
    assert set(got) == set(want)
    assert got["out"].shape == (case["n"], case["s"], 3)
    gap = 0.0
    for k in want:
        g, w = got[k], want[k]
        assert g.shape == w.shape and np.isfinite(g).all(), k
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(g - w).max())
        assert err <= TOL[dt] * scale, f"{k}: {err:.3e} > {TOL[dt] * scale:.3e}"
        if ref32 is not None:
            gap = max(gap, float(np.abs(w - ref32[k]).max()) / scale)
    if ref32 is not None:
        assert gap > 10 * TOL["bf16"], f"bf16 gap only {gap:.3e}"


def test_plain_versions_match_each_other_over_tilings(params):
    """The kernels' operands one level down: ``_nof_bwd_ref``'s per-ray
    partial gradient of one long ray equals the sum over the same rows cut
    into rays (what a tile-by-tile kernel adds), and ``_nof_fwd_ref`` warps
    rows independently of how they are grouped into rays."""
    from moco_flow_tpu_torch.ops.folds import _NofSpec, _nof_fold
    p = params_from_jax(params)
    cfg = NoFConfig(**NOF)
    inp = _inputs(1, 64, seed=9)
    x = torch.from_numpy(inp["xyz"])
    emb = torch.from_numpy(inp["emb"])
    ws, parts = _nof_fold(p, cfg, 3, torch.from_numpy(inp["anneal"]), emb)
    spec = _NofSpec(4, 32, 9, (2,), True, True)
    g = torch.from_numpy(inp["w"]).permute(2, 0, 1)
    one = x.permute(2, 0, 1)                            # (3, 1, 64)
    split = one.reshape(3, 4, 16)                       # 4 rays of 16
    parts4 = [q.expand(4, -1) for q in parts]
    o1 = nof_rays._nof_fwd_ref(spec, None, one, parts, ws)
    o4 = nof_rays._nof_fwd_ref(spec, None, split, parts4, ws)
    torch.testing.assert_close(o1.reshape(3, 64), o4.reshape(3, 64),
                               rtol=0, atol=0)
    b1 = nof_rays._nof_bwd_ref(spec, None, one, parts, ws, g)
    b4 = nof_rays._nof_bwd_ref(spec, None, split, parts4, ws,
                               g.reshape(3, 4, 16))
    torch.testing.assert_close(b1[0].reshape(3, 64), b4[0].reshape(3, 64),
                               rtol=0, atol=0)
    for d1, d4 in zip(b1[1], b4[1]):
        torch.testing.assert_close(d1[0], d4.sum(dim=0), rtol=1e-5,
                                   atol=1e-6)
    for d1, d4 in zip(b1[2], b4[2]):
        torch.testing.assert_close(d1, d4, rtol=0, atol=0)


def test_kernel_wrappers_reject_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA card has no kernel
    and no plain version: the wrappers raise instead of falling back."""
    meta = torch.empty((3, 1, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        nof_rays.nof_fwd(None, None, meta, [], [])
    with pytest.raises(ValueError, match="no kernel for device"):
        nof_rays.nof_bwd(None, None, meta, [], [], meta)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_nof_fused_rays_rechunks_as_jax(params, dt):
    """One ray of 4100 samples goes to the kernels as JAX sends it: 2 rays
    of 4096, the second zero-padded after its 4 samples, each with the
    same frame embedding; the output is sliced back to 4100. Outputs and
    every gradient against JAX's ``nof_fused_rays`` under TOL."""
    inp = _inputs(1, 4100, seed=41)
    seen = []
    apply = nof_rays._NofOp.apply

    def grab(spec, dt_, n_parts, xyz_t, *arrs):
        seen.append((xyz_t.detach().clone(),
                     [a.detach().clone() for a in arrs[:n_parts]]))
        return apply(spec, dt_, n_parts, xyz_t, *arrs)

    nof_rays._NofOp.apply = grab
    try:
        got = _port(params, inp, dt)
    finally:
        nof_rays._NofOp.apply = apply
    (xyz_t, parts), = seen
    assert tuple(xyz_t.shape) == (3, 2, 4096)
    flat = xyz_t.reshape(3, -1)
    assert torch.equal(flat[:, :4100].T, torch.from_numpy(inp["xyz"][0]))
    assert not flat[:, 4100:].any()
    for q in parts:
        assert tuple(q.shape) == (2, NOF["width"])
        assert torch.equal(q[0], q[1])
    xc, ec = nof_rays._rechunk(torch.from_numpy(inp["xyz"]),
                               torch.from_numpy(inp["emb"]))
    assert tuple(xc.shape) == (2, 4096, 3) and tuple(ec.shape) == (2, 21)
    want = _jax(params, inp, dt)
    assert set(got) == set(want)
    assert got["out"].shape == (1, 4100, 3)
    for k in want:
        g, w = got[k], want[k]
        assert g.shape == w.shape and np.isfinite(g).all(), k
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(g - w).max())
        assert err <= TOL[dt] * scale, f"{k}: {err:.3e} > {TOL[dt] * scale:.3e}"


def test_one_stage_arguments_and_scratch(params):
    """#3/#4 take the warp chain's argument array with one stage: read back
    at the offsets ``csrc/chain_bwd.cu::decode`` reads, it holds one stage
    (bw net, partial set 0, no input source), both chains off, the partials
    of set 0 only and a zero fw net; the gradient buffer holds the one
    net's operands. The backward's scratch (``nof_chain.scratch_bytes``,
    ``chain_bwd.cu::layout``) per row and stage: x 16 B, the packed PE
    padded to 16 columns, depth x width activations and as many dz, the
    head output 64 B, its cotangent 16 columns and its fp32 value 64 B."""
    from moco_flow_tpu_torch.ops import _args, nof_chain
    from moco_flow_tpu_torch.ops.folds import _NofSpec, _nof_fold
    p = params_from_jax(params)
    inp = _inputs(3, 7, seed=3)
    ws, parts = _nof_fold(p, NoFConfig(**NOF), 3,
                          torch.from_numpy(inp["anneal"]),
                          torch.from_numpy(inp["emb"]))
    spec = nof_chain._ChainSpec(_NofSpec(4, 32, 9, (2,), True, True),
                                False, False)
    ops = _args.Operands("nof_fwd", torch.device("cpu"), torch.float32)
    xyz_t = torch.from_numpy(inp["xyz"]).permute(2, 0, 1)
    arr, outs = nof_chain._fwd_args(spec, None, len(parts), xyz_t, parts,
                                    ws, None, ops)
    net_args = 8 * _args.MAX_DEPTH + 5
    assert len(arr) == 15 + 3 * 5 + 8 + 2 * 16 + 2 * net_args
    assert list(arr[:15]) == [0, 3, 7, 1, 1, 0, 0, 2, 4, 32, 9, 9,
                              _args.SPLIT_ROWS, 0, 0]
    assert list(arr[15:30]) == [0] * 5 + [0] * 5 + [-1, 0, 0, 0, 0]
    ptrs = arr[30:38]
    assert ptrs[0] != 0 and ptrs[1] != 0             # bands, xyz
    assert ptrs[2] == outs[0].data_ptr() and not ptrs[3:].any()
    part_ptrs = arr[38:54].reshape(4, 4)
    assert part_ptrs[0, :2].all() and not part_ptrs[0, 2:].any()
    assert not part_ptrs[1:].any() and not arr[54:70].any()
    bw, fw = arr[70:70 + net_args], arr[70 + net_args:]
    assert len(fw) == net_args and not fw.any()
    assert bw[:8 * 4].reshape(4, 8)[:, 4].all()      # the 4 layers' biases
    assert not bw[8 * 4:8 * 8].any()                 # no layers 4..7
    _, _, _, total = nof_chain._operands(spec, 2, 3, parts, ws, None, ops,
                                         backward=True)
    assert total == sum(w.numel() for w in ws)
    for dt, t in ((torch.bfloat16, 2), (None, 4)):
        per_row = 16 + t * 32 + 2 * 4 * 32 * t + 64 + t * 16 + 64
        assert nof_chain.scratch_bytes(spec, dt, 21) == 128 * per_row
        assert nof_chain.scratch_bytes(spec, dt, 300) == 384 * per_row
    # stage 2's 200,000 points as 49 rays of 4096 at the published NoF
    # (4x128, 5 frequencies): 2,320 B a row in bf16, 4,496 B in fp32
    full = nof_chain._ChainSpec(_NofSpec(4, 128, 15, (2,), True, True),
                                False, False)
    assert nof_chain.scratch_bytes(full, torch.bfloat16, 49 * 4096) == (
        49 * 4096 * 2320)
    assert nof_chain.scratch_bytes(full, None, 49 * 4096) == 49 * 4096 * 4496
    chain = nof_chain._ChainSpec(full.nof, True, True)
    assert nof_chain.scratch_bytes(chain, None, 128) == 5 * 128 * 4496
