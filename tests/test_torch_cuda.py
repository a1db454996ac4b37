"""The port's CUDA kernels (the render pass, the training step's NeRF and
warp-chain forwards and backwards, the single-warp NoF and the per-op MLPs)
against their plain PyTorch versions, on a GPU.

Marked ``cuda``; each test skips where no card is present. The file imports
neither JAX nor the JAX package, so it runs on the GPU machine too, where
``tests/conftest.py`` (which imports JAX) must be left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Shapes are the full published widths (NeRF 8x256 with the 5-dim frame
feature, bw-NoF 4x128) with a ragged ray count. Tolerances as in
chip_smoke.py: fp32 1e-4 abs/rel (both sum in fp32, in other orders); bf16
1e-3 abs / 1e-2 rel, the bf16-vs-fp32 gap test_torch_nn.py measures, since
another summation order may flip a bf16 rounding of a hidden activation
(measured on an H100: max |diff| 1.4e-4 of sigmas up to 0.035).
"""

import numpy as np
import pytest
import torch

from moco_flow_tpu_torch.nn.embedding import anneal_weights
from moco_flow_tpu_torch.nn.nerf import NeRFConfig, init_nerf
from moco_flow_tpu_torch.nn.nof import NoFConfig, init_nof
from moco_flow_tpu_torch.ops import nof_rays
from moco_flow_tpu_torch.ops.folds import _NofSpec, _nof_fold
from moco_flow_tpu_torch.ops.render_pass import render_pass, render_pass_ref
from moco_flow_tpu_torch.render.volume import EmbeddingSpec, embed_padded

TOL = {None: (1e-4, 1e-4), torch.bfloat16: (1e-3, 1e-2)}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("use_nof", [True, False], ids=["nof", "cano"])
@pytest.mark.parametrize("sigma_only", [True, False], ids=["coarse", "fine"])
def test_kernel_matches_plain(card, use_nof, sigma_only, dt):
    gen = torch.Generator().manual_seed(0)
    ncfg = NeRFConfig(extra_feat_type="ind", extra_feat_dim=5)
    fcfg = NoFConfig()
    params = {"coarse_NeRF": init_nerf(gen, ncfg, card),
              "bw_NoF": init_nof(gen, fcfg, card)}
    n, s = 300, 64
    o = torch.tensor([0.0, 0.0, 4.0]) + 0.05 * torch.randn(n, 3, generator=gen)
    d = torch.randn(n, 3, generator=gen)
    d[:, 2] = -d[:, 2].abs() - 1
    d = d / d.norm(dim=-1, keepdim=True)
    z = torch.sort(2.5 + 3 * torch.rand(n, s, generator=gen), -1).values
    ind = torch.rand(n, 1, generator=gen) * 2 - 1
    o, d, z, ind = (t.to(card) for t in (o, d, z, ind))
    extra = embed_padded(ind, EmbeddingSpec(2, in_channels=1), 5)
    ind_emb = embed_padded(ind, EmbeddingSpec(16, in_channels=1), 33)
    args = (params, "coarse_NeRF", ncfg, fcfg, 10, 5, True, True,
            anneal_weights(505000, 10, 5000, 1005000).to(card),
            anneal_weights(505000, 5, 5000, 1005000).to(card), o, d, z,
            None if sigma_only else extra, ind_emb, use_nof, sigma_only, dt)
    before = render_pass.launches
    ks, kr = render_pass(*args)
    rs, rr = render_pass_ref(*args)
    torch.cuda.synchronize()
    assert render_pass.launches == before + 1
    atol, rtol = TOL[dt]
    torch.testing.assert_close(ks, rs, atol=atol, rtol=rtol)
    if sigma_only:
        assert kr is None and rr is None
    else:
        torch.testing.assert_close(kr, rr, atol=atol, rtol=rtol)


def _rel_max(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def _nof_kernel_case(card, n, s, rechunk=False):
    """Full-width NoF operands for #3/#4 on n rays of s samples; with
    ``rechunk`` one ray of s samples as ``nof_fused_rays`` launches it (rays
    of 4096 samples, the padding's cotangent 0)."""
    gen = torch.Generator().manual_seed(n + s)
    fcfg = NoFConfig()
    p = init_nof(gen, fcfg, card)
    an = anneal_weights(505000, 5, 5000, 1005000).to(card)
    raw = {"emb": torch.randn(n, 33, generator=gen).to(card),
           "xyz": (0.6 * torch.randn(3, n, s, generator=gen)).to(card),
           "p": p, "an": an}
    emb, xyz = raw["emb"], raw["xyz"]
    g = torch.randn(3, n, s, generator=gen).to(card)
    if rechunk:
        x_rows, emb = nof_rays._rechunk(xyz.permute(1, 2, 0), emb)
        xyz = x_rows.permute(2, 0, 1).contiguous()
        g = nof_rays._rechunk(g.permute(1, 2, 0), emb)[0].permute(2, 0, 1)
        g = g.contiguous()
    ws, parts = _nof_fold(p, fcfg, 5, an, emb)
    return raw, _NofSpec(4, 128, 15, (2,), True, True), xyz, parts, ws, g


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,rechunk", [(1, 2000, False), (1, 5000, False),
                                         (37, 64, False), (1, 9000, True)],
                         ids=["ray2000", "ray5000", "37x64",
                              "ray9000-rechunked"])
def test_nof_kernels_match_plain(card, n, s, rechunk):
    """Kernels #3/#4 (fp32) at full NoF width: the warp within 1e-4 +
    1e-4|ref|; dxyz, d(partials) and every dW within 0.1 of each tensor's
    largest magnitude (chip_smoke.py's TRAIN_TOL: another summation order
    and ReLU flips at pre-activations within rounding of zero; measured
    below 1e-6 at these shapes). The 9000-sample ray goes in as
    ``nof_fused_rays`` re-chunks it (3 rays of 4096, zero-padded), and
    ``nof_fused_rays`` on the card warps it as those launches do."""
    raw, spec, xyz, parts, ws, g = _nof_kernel_case(card, n, s, rechunk)
    before = (nof_rays.nof_fwd.launches, nof_rays.nof_bwd.launches)
    out = nof_rays.nof_fwd(spec, None, xyz, parts, ws)
    kb = nof_rays.nof_bwd(spec, None, xyz, parts, ws, g)
    torch.cuda.synchronize()
    assert (nof_rays.nof_fwd.launches, nof_rays.nof_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(out, nof_rays._nof_fwd_ref(spec, None, xyz,
                                                          parts, ws),
                               atol=1e-4, rtol=1e-4)
    rb = nof_rays._nof_bwd_ref(spec, None, xyz, parts, ws, g)
    for a, b in zip([kb[0], *kb[1], *kb[2]], [rb[0], *rb[1], *rb[2]]):
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert _rel_max(a, b) <= 0.1
    if rechunk:
        assert tuple(xyz.shape) == (3, -(-s // 4096), 4096)
        assert not xyz.reshape(3, -1)[:, s:].any()
        warped = nof_rays.nof_fused_rays(raw["p"], NoFConfig(), 5, True,
                                         raw["an"],
                                         raw["xyz"].permute(1, 2, 0),
                                         raw["emb"])
        assert nof_rays.nof_fwd.launches == before[0] + 2
        assert torch.equal(warped, out.reshape(3, -1)[:, :s].T[None])


@pytest.mark.cuda
def test_nof_kernels_leave_chain_counts(card):
    """#3/#4 launch their own entry points: the warp chain's counters
    (#5/#6) do not move, #3/#4's move by one a call."""
    from moco_flow_tpu_torch.ops import nof_chain as nc
    _, spec, xyz, parts, ws, g = _nof_kernel_case(card, 2, 300)
    chain = (nc.chain_fwd.launches, nc.chain_bwd.launches)
    before = (nof_rays.nof_fwd.launches, nof_rays.nof_bwd.launches)
    for dt in (None, torch.bfloat16):
        nof_rays.nof_fwd(spec, dt, xyz, parts, ws)
        nof_rays.nof_bwd(spec, dt, xyz, parts, ws, g)
    torch.cuda.synchronize()
    assert (nc.chain_fwd.launches, nc.chain_bwd.launches) == chain
    assert (nof_rays.nof_fwd.launches, nof_rays.nof_bwd.launches) == (
        before[0] + 2, before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("sigma_only", [False, True],
                         ids=["full", "sigma-only"])
def test_fused_mlp_nerf_matches_plain(card, sigma_only, dt):
    """Kernel #8 (the per-op NeRF) at init_nerf.yaml's widths on a ragged
    row count (not a multiple of the kernel's row tile)."""
    from moco_flow_tpu_torch.ops import fused_mlp as fm
    gen = torch.Generator().manual_seed(3)
    cfg = NeRFConfig(extra_feat_type="dir", extra_feat_dim=27)
    ws = fm._nerf_weights_flat(init_nerf(gen, cfg, card), sigma_only)
    n = 3001
    x = (torch.rand(n, 63, generator=gen) * 2 - 1).to(card)
    e = None if sigma_only else (torch.rand(n, 27, generator=gen) * 2
                                 - 1).to(card)
    before = fm.nerf_pallas.launches
    got = fm.nerf_pallas(cfg, dt, x, e, sigma_only, ws)
    want = fm._nerf_pallas_ref(cfg, dt, x, e, sigma_only, ws)
    torch.cuda.synchronize()
    assert fm.nerf_pallas.launches == before + 1
    atol, rtol = TOL[dt]
    assert got.shape == (n, 1 if sigma_only else 4)
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("use_quat", [True, False], ids=["quat", "offset"])
@pytest.mark.parametrize("n", [1, 127, 129, 3001, 100003])
def test_fused_mlp_nof_matches_plain(card, n, use_quat, dt):
    """Kernel #9 (the per-op NoF) at c2f.yaml's widths, both heads, on row
    counts around the 128-row tile and a ragged 100,003; in bf16 also within
    the plain version's own bf16-vs-fp32 gap (max and mean)."""
    from moco_flow_tpu_torch.ops import fused_mlp as fm
    gen = torch.Generator().manual_seed(4)
    cfg = NoFConfig(use_quat=use_quat)
    ws = fm._nof_weights_flat(init_nof(gen, cfg, card))
    inp = (torch.rand(n, cfg.in_dim, generator=gen) * 2 - 1).to(card)
    xyz = (0.6 * torch.randn(n, 3, generator=gen)).to(card)
    before = fm.nof_pallas.launches
    got = fm.nof_pallas(cfg, dt, inp, xyz, ws)
    want = fm._nof_pallas_ref(cfg, dt, inp, xyz, ws)
    want32 = fm._nof_pallas_ref(cfg, None, inp, xyz, ws)
    torch.cuda.synchronize()
    assert fm.nof_pallas.launches == before + 1
    assert got.shape == (n, 3) and torch.isfinite(got).all()
    atol, rtol = TOL[dt]
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
    if dt is not None:
        err, gap = (got - want).abs(), (want - want32).abs()
        assert err.max() <= gap.max() and err.mean() <= gap.mean()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [None, torch.bfloat16], ids=["fp32", "bf16"])
def test_fused_mlp_nof_wide(card, dt):
    """#9 at a 256-wide NoF: four 64-column blocks of H and a 3-stage ring
    in bf16; 8-deep weight slices in fp32, where 16-deep hi + lo slices
    leave the 128-row tile too little shared memory."""
    from moco_flow_tpu_torch.ops import fused_mlp as fm
    gen = torch.Generator().manual_seed(5)
    cfg = NoFConfig(width=256)
    ws = fm._nof_weights_flat(init_nof(gen, cfg, card))
    n = 1000
    inp = (torch.rand(n, cfg.in_dim, generator=gen) * 2 - 1).to(card)
    xyz = (0.6 * torch.randn(n, 3, generator=gen)).to(card)
    got = fm.nof_pallas(cfg, dt, inp, xyz, ws)
    want = fm._nof_pallas_ref(cfg, dt, inp, xyz, ws)
    torch.cuda.synchronize()
    atol, rtol = TOL[dt]
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


# The backward kernels #2 (nerf_bwd) and #6 (chain_bwd) at small widths
# against their plain versions, under chip_smoke.py's TRAIN_TOL: gradients
# sum 10^3-10^4 signed terms in other orders, and a pre-activation within
# rounding of zero can take the other side of a ReLU, so the bound is on
# the largest (0.1) and the mean (0.01) difference relative to the tensor's
# largest and mean magnitude; in bf16, or else within the plain bf16
# version's own gap to the plain fp32 one.
TRAIN_TOL = (0.1, 1e-2)


def _flat(r):
    dp = r[1]
    dps = [] if dp is None else (list(dp) if isinstance(dp, list) else [dp])
    return [r[0]] + dps + list(r[2])


def _close_train(got, want, plain32, dt):
    err = (got.float() - want.float()).abs()
    w = want.float().abs()
    if (err.max() <= TRAIN_TOL[0] * w.max().clamp_min(1e-30)
            and err.mean() <= TRAIN_TOL[1] * w.mean().clamp_min(1e-30)):
        return True
    if dt is None:
        return False
    gap = (want.float() - plain32.float()).abs()
    return bool(err.max() <= gap.max() and err.mean() <= gap.mean())


def _small_nerf(card, n, s, sigma_only):
    from moco_flow_tpu_torch.ops.folds import _NerfSpec, _nerf_fold
    gen = torch.Generator().manual_seed(3)
    ncfg = NeRFConfig(depth=4, width=64, in_channels_xyz=27, skips=(2,),
                      extra_feat_type="ind", extra_feat_dim=5)
    params = init_nerf(gen, ncfg, card)
    xyz = (0.8 * torch.randn(3, n, s, generator=gen)).to(card)
    emb = torch.randn(n, 5, generator=gen).to(card)
    ws, p_e = _nerf_fold(params, ncfg, 4, None, None if sigma_only else emb,
                         sigma_only)
    spec = _NerfSpec(4, 64, 12, (2,), sigma_only, not sigma_only, True)
    g = (torch.randn(1 if sigma_only else 4, n, s, generator=gen)
         / (n * s) ** 0.5).to(card)
    return spec, xyz, p_e, ws, g


def _small_chain(card, n, s, local, glob):
    from moco_flow_tpu_torch.ops.nof_chain import _ChainSpec
    gen = torch.Generator().manual_seed(4)
    fcfg = NoFConfig(width=32, extra_feat_dim=9)
    bw, fw = init_nof(gen, fcfg, card), init_nof(gen, fcfg, card)
    xyz = (0.6 * torch.randn(3, n, s, generator=gen)).to(card)
    emb = torch.randn(n, 9, generator=gen).to(card)
    emb_c = torch.randn(n, 9, generator=gen).to(card)
    wsb, pb = _nof_fold(bw, fcfg, 5, None, emb)
    wsf, pf = _nof_fold(fw, fcfg, 5, None, emb)
    sets = [pb, pf]
    if glob:
        sets += [_nof_fold(fw, fcfg, 5, None, emb_c)[1],
                 _nof_fold(bw, fcfg, 5, None, emb_c)[1]]
    parts = [p for st in sets for p in st]
    spec = _ChainSpec(_NofSpec(4, 32, 15, (2,), True, True), local, glob)
    gs = [(torch.randn(3, n, s, generator=gen) / (n * s) ** 0.5).to(card)
          for _ in range(1 + int(local) + int(glob))]
    return spec, xyz, parts, wsb, wsf, gs


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("sigma_only", [True, False], ids=["coarse", "fine"])
def test_nerf_bwd_matches_plain(card, sigma_only, dt):
    from moco_flow_tpu_torch.ops import nerf_rays as nr
    spec, xyz, p_e, ws, g = _small_nerf(card, 300, 48, sigma_only)
    before = nr.nerf_bwd.launches
    got = nr.nerf_bwd(spec, dt, xyz, p_e, ws, g)
    want = nr._nerf_bwd_ref(spec, dt, xyz, p_e, ws, g)
    plain32 = nr._nerf_bwd_ref(spec, None, xyz, p_e, ws, g)
    torch.cuda.synchronize()
    assert nr.nerf_bwd.launches == before + 1
    for i, (a, b, p) in enumerate(zip(_flat(got), _flat(want),
                                      _flat(plain32))):
        assert a.shape == b.shape and torch.isfinite(a).all(), i
        assert _close_train(a, b, p, dt), i


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("chains", [(True, True), (True, False),
                                    (False, True)],
                         ids=["both", "local", "global"])
def test_chain_bwd_matches_plain(card, chains, dt):
    from moco_flow_tpu_torch.ops import nof_chain as nc
    spec, xyz, parts, wsb, wsf, gs = _small_chain(card, 200, 40, *chains)
    before = nc.chain_bwd.launches
    got = nc.chain_bwd(spec, dt, 2, xyz, parts, wsb, wsf, gs)
    want = nc._chain_bwd_ref(spec, dt, 2, xyz, parts, wsb, wsf, gs)
    plain32 = nc._chain_bwd_ref(spec, None, 2, xyz, parts, wsb, wsf, gs)
    torch.cuda.synchronize()
    assert nc.chain_bwd.launches == before + 1
    for i, (a, b, p) in enumerate(zip(_flat(got), _flat(want),
                                      _flat(plain32))):
        assert a.shape == b.shape and torch.isfinite(a).all(), i
        assert _close_train(a, b, p, dt), i


def _bwd_calls(card, which):
    from moco_flow_tpu_torch.ops import nerf_rays as nr
    from moco_flow_tpu_torch.ops import nof_chain as nc
    if which == "nerf":
        spec, xyz, p_e, ws, g = _small_nerf(card, 700, 64, False)
        return lambda dt: nr.nerf_bwd(spec, dt, xyz, p_e, ws, g)
    c = _small_chain(card, 700, 64, True, True)
    return lambda dt: nc.chain_bwd(c[0], dt, 2, *c[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("which", ["nerf", "chain"])
def test_bwd_deterministic(card, which, dt):
    """Two launches give the same bits: no float atomics, fixed K splits."""
    call = _bwd_calls(card, which)
    a, b = _flat(call(dt)), _flat(call(dt))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("which", ["nerf", "chain"])
def test_bwd_chunks_match_one_call(card, which, dt, monkeypatch):
    """A call above the scratch cap runs in chunks of whole rays and gives
    the bits of the same rows in one chunk."""
    from moco_flow_tpu_torch.ops import _args
    call = _bwd_calls(card, which)
    monkeypatch.setattr(_args, "SPLIT_ROWS", 1024)
    whole = _flat(call(dt))
    # 700 rays x 64 samples: chunks of 16 rays' multiples (1024 rows)
    monkeypatch.setattr(_args, "SCRATCH_CAP", 8 << 20)
    chunked = _flat(call(dt))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(whole, chunked))


# The forward kernels #1 (nerf_fwd) and #5 (chain_fwd) at full width (NeRF
# 8x256 with the 5-dim frame feature, NoF 4x128) on rows that are not a
# multiple of their 128-row tile: fp32 (the split TF32 product) within 1e-4
# + 1e-4|ref| of the plain version; bf16 within 1e-3 + 1e-2|ref|, or else
# within the plain bf16 version's own gap to the plain fp32 one; and the
# same bits from two launches.
FWD_ROWS = (37, 127)


def _full_nerf(card, sigma_only):
    from moco_flow_tpu_torch.ops.folds import _NerfSpec, _nerf_fold
    gen = torch.Generator().manual_seed(5)
    ncfg = NeRFConfig(extra_feat_type="ind", extra_feat_dim=5)
    params = init_nerf(gen, ncfg, card)
    n, s = FWD_ROWS
    xyz = (0.8 * torch.randn(3, n, s, generator=gen)).to(card)
    emb = torch.randn(n, 5, generator=gen).to(card)
    an = anneal_weights(505000, 10, 5000, 1005000).to(card)
    ws, p_e = _nerf_fold(params, ncfg, 10, an, None if sigma_only else emb,
                         sigma_only)
    spec = _NerfSpec(8, 256, 30, (4,), sigma_only, not sigma_only, True)
    return spec, xyz, p_e, ws


def _full_chain(card, local, glob):
    from moco_flow_tpu_torch.ops.nof_chain import _ChainSpec
    gen = torch.Generator().manual_seed(6)
    fcfg = NoFConfig()
    bw, fw = init_nof(gen, fcfg, card), init_nof(gen, fcfg, card)
    n, s = FWD_ROWS
    xyz = (0.6 * torch.randn(3, n, s, generator=gen)).to(card)
    emb = torch.randn(n, 33, generator=gen).to(card)
    emb_c = torch.randn(n, 33, generator=gen).to(card)
    an = anneal_weights(505000, 5, 5000, 1005000).to(card)
    wsb, pb = _nof_fold(bw, fcfg, 5, an, emb)
    wsf, pf = _nof_fold(fw, fcfg, 5, an, emb)
    sets = [pb, pf]
    if glob:
        sets += [_nof_fold(fw, fcfg, 5, an, emb_c)[1],
                 _nof_fold(bw, fcfg, 5, an, emb_c)[1]]
    parts = [p for st in sets for p in st]
    spec = _ChainSpec(_NofSpec(4, 128, 15, (2,), True, True), local, glob)
    return spec, xyz, parts, wsb, wsf


def _fwd_calls(card, which):
    """(kernel call, plain call), each dt -> list of outputs."""
    from moco_flow_tpu_torch.ops import nerf_rays as nr
    from moco_flow_tpu_torch.ops import nof_chain as nc
    if which.startswith("nerf"):
        c = _full_nerf(card, which == "nerf-sigma-only")
        return (lambda dt: [nr.nerf_fwd(c[0], dt, *c[1:])],
                lambda dt: [nr._nerf_fwd_ref(c[0], dt, *c[1:])])
    chains = {"chain-both": (True, True), "chain-local": (True, False),
              "chain-global": (False, True)}[which]
    c = _full_chain(card, *chains)
    return (lambda dt: list(nc.chain_fwd(c[0], dt, 2, *c[1:])),
            lambda dt: list(nc._chain_fwd_ref(c[0], dt, 2, *c[1:])))


FWD_CASES = ["nerf-full", "nerf-sigma-only", "chain-both", "chain-local",
             "chain-global"]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("which", FWD_CASES)
def test_fwd_matches_plain(card, which, dt):
    from moco_flow_tpu_torch.ops import nerf_rays as nr
    from moco_flow_tpu_torch.ops import nof_chain as nc
    kernel, plain = _fwd_calls(card, which)
    before = nr.nerf_fwd.launches + nc.chain_fwd.launches
    got, want, want32 = kernel(dt), plain(dt), plain(None)
    torch.cuda.synchronize()
    assert nr.nerf_fwd.launches + nc.chain_fwd.launches == before + 1
    atol, rtol = TOL[dt]
    for a, b, p in zip(got, want, want32):
        assert a.shape == b.shape and torch.isfinite(a).all()
        err = (a - b).abs()
        if bool((err <= atol + rtol * b.abs()).all()):
            continue
        gap = (b - p).abs()
        assert dt is not None
        assert err.max() <= gap.max() and err.mean() <= gap.mean()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("which", ["nerf-full", "nerf-sigma-only",
                                   "chain-both"])
def test_fwd_deterministic(card, which, dt):
    kernel, _ = _fwd_calls(card, which)
    a, b = kernel(dt), kernel(dt)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# The bf16 forward kernels #7 / #8 on the wgmma tile (csrc/wg_tile.cuh),
# their fp32 builds on the split-TF32 product (csrc/row_tile.cuh).

@pytest.mark.cuda
@pytest.mark.parametrize("rows,k,n", [(128, 256, 256), (128, 256, 128),
                                      (128, 256, 16), (128, 256, 8),
                                      (128, 63, 256), (128, 90, 128),
                                      (300, 33, 9)])
def test_wg_layer_probe(card, rows, k, n):
    """One product of the wgmma tile against the plain one: the same bf16
    operands, fp32 sums in another order (fp32 tolerance)."""
    from moco_flow_tpu_torch.ops.wg_probe import wg_layer, wg_layer_ref
    gen = torch.Generator().manual_seed(rows + k + n)
    a = torch.randn(rows, k, generator=gen).to(card)
    w = (torch.randn(k, n, generator=gen) / k ** 0.5).to(card)
    b = torch.randn(n, generator=gen).to(card)
    got, want = wg_layer(a, w, b), wg_layer_ref(a, w, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def _pass_case(card, n, s, use_nof, sigma_only):
    """Arguments of render_pass at c2f.yaml's widths (dt appended later)."""
    gen = torch.Generator().manual_seed(n * s)
    ncfg = NeRFConfig(extra_feat_type="ind", extra_feat_dim=5)
    fcfg = NoFConfig()
    params = {"coarse_NeRF": init_nerf(gen, ncfg, card),
              "bw_NoF": init_nof(gen, fcfg, card)}
    o = torch.tensor([0.0, 0.0, 4.0]) + 0.05 * torch.randn(n, 3, generator=gen)
    d = torch.randn(n, 3, generator=gen)
    d[:, 2] = -d[:, 2].abs() - 1
    d = d / d.norm(dim=-1, keepdim=True)
    z = torch.sort(2.5 + 3 * torch.rand(n, s, generator=gen), -1).values
    ind = torch.rand(n, 1, generator=gen) * 2 - 1
    o, d, z, ind = (t.to(card) for t in (o, d, z, ind))
    extra = embed_padded(ind, EmbeddingSpec(2, in_channels=1), 5)
    ind_emb = embed_padded(ind, EmbeddingSpec(16, in_channels=1), 33)
    return (params, "coarse_NeRF", ncfg, fcfg, 10, 5, True, True,
            anneal_weights(505000, 10, 5000, 1005000).to(card),
            anneal_weights(505000, 5, 5000, 1005000).to(card), o, d, z,
            None if sigma_only else extra, ind_emb, use_nof, sigma_only)


def _mlp_case(card, rows, sigma_only):
    from moco_flow_tpu_torch.ops import fused_mlp as fm
    gen = torch.Generator().manual_seed(rows)
    cfg = NeRFConfig(extra_feat_type="dir", extra_feat_dim=27)
    ws = fm._nerf_weights_flat(init_nerf(gen, cfg, card), sigma_only)
    x = (torch.rand(rows, 63, generator=gen) * 2 - 1).to(card)
    e = None if sigma_only else (torch.rand(rows, 27, generator=gen) * 2
                                 - 1).to(card)
    return cfg, x, e, sigma_only, ws


def _fwd_mlp_calls(card, which):
    """(kernel, plain) of #7 / #8 at 1000 x 127 rows (not a multiple of
    the 128-row tile), each dt -> list of outputs."""
    from moco_flow_tpu_torch.ops import fused_mlp as fm
    if which.startswith("pass"):
        args = _pass_case(card, 1000, 127, which != "pass-cano",
                          which == "pass-coarse")
        return (lambda dt: [t for t in render_pass(*args, dt)
                            if t is not None],
                lambda dt: [t for t in render_pass_ref(*args, dt)
                            if t is not None])
    cfg, x, e, so, ws = _mlp_case(card, 1000 * 127, which == "mlp-sigma-only")
    return (lambda dt: [fm.nerf_pallas(cfg, dt, x, e, so, ws)],
            lambda dt: [fm._nerf_pallas_ref(cfg, dt, x, e, so, ws)])


FWD_MLP_CASES = ["pass-fine", "pass-coarse", "pass-cano", "mlp-full",
                 "mlp-sigma-only"]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("which", FWD_MLP_CASES)
def test_fwd_mlp_ragged(card, which, dt):
    """#7 / #8 at a ragged row count within TOL; in bf16 also within the
    plain version's own bf16-vs-fp32 gap (max and mean)."""
    kernel, plain = _fwd_mlp_calls(card, which)
    got, want, want32 = kernel(dt), plain(dt), plain(None)
    torch.cuda.synchronize()
    atol, rtol = TOL[dt]
    for a, b, p in zip(got, want, want32):
        assert a.shape == b.shape and torch.isfinite(a).all()
        err = (a - b).abs()
        assert bool((err <= atol + rtol * b.abs()).all())
        if dt is not None:
            gap = (b - p).abs()
            assert err.max() <= gap.max() and err.mean() <= gap.mean()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("which", ["pass-fine", "mlp-full"])
def test_fwd_mlp_deterministic(card, which, dt):
    kernel, _ = _fwd_mlp_calls(card, which)
    a, b = kernel(dt), kernel(dt)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# The render-time models' shapes: the distilled student (4x128, skip 2;
# render/distill.py's default, and a width-48 one) through #7 and #8, and
# the hash-grid NeRF (2x64, no skips, 16 hash features in, a 'dir' extra of
# 27) through #8.
NEW_NERFS = {
    "student-4x128": NeRFConfig(depth=4, width=128, skips=(2,),
                                extra_feat_type="ind", extra_feat_dim=5),
    "student-6x48": NeRFConfig(depth=6, width=48, skips=(3,),
                               extra_feat_type="ind", extra_feat_dim=5),
    "hash-2x64": NeRFConfig(depth=2, width=64, in_channels_xyz=16,
                            skips=(), extra_feat_type="dir",
                            extra_feat_dim=27),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("sigma_only", [False, True],
                         ids=["full", "sigma-only"])
@pytest.mark.parametrize("net", list(NEW_NERFS))
def test_fused_mlp_nerf_new_shapes(card, net, sigma_only, dt):
    """#8 at the student's and the hash NeRF's widths on a ragged row
    count, within TOL; bf16 also within the plain version's bf16-vs-fp32
    gap."""
    from moco_flow_tpu_torch.ops import fused_mlp as fm
    cfg = NEW_NERFS[net]
    gen = torch.Generator().manual_seed(13)
    ws = fm._nerf_weights_flat(init_nerf(gen, cfg, card), sigma_only)
    n = 3001
    x = (torch.rand(n, cfg.in_channels_xyz, generator=gen) * 2
         - 1).to(card)
    e = None if sigma_only else (torch.rand(n, cfg.extra_feat_dim,
                                            generator=gen) * 2 - 1).to(card)
    before = fm.nerf_pallas.launches
    got = fm.nerf_pallas(cfg, dt, x, e, sigma_only, ws)
    want = fm._nerf_pallas_ref(cfg, dt, x, e, sigma_only, ws)
    want32 = fm._nerf_pallas_ref(cfg, None, x, e, sigma_only, ws)
    torch.cuda.synchronize()
    assert fm.nerf_pallas.launches == before + 1
    atol, rtol = TOL[dt]
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
    if dt is not None:
        assert (got - want).abs().max() <= (want - want32).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [None, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("sigma_only", [True, False], ids=["coarse", "fine"])
@pytest.mark.parametrize("net", ["student-4x128", "student-6x48"])
def test_render_pass_student_shapes(card, net, sigma_only, dt):
    """#7 with the bw warp at a student's widths, within TOL."""
    gen = torch.Generator().manual_seed(14)
    ncfg, fcfg = NEW_NERFS[net], NoFConfig()
    params = {"coarse_NeRF": init_nerf(gen, ncfg, card),
              "bw_NoF": init_nof(gen, fcfg, card)}
    n, s = 300, 64
    o = torch.tensor([0.0, 0.0, 4.0]) + 0.05 * torch.randn(n, 3, generator=gen)
    d = torch.randn(n, 3, generator=gen)
    d[:, 2] = -d[:, 2].abs() - 1
    d = d / d.norm(dim=-1, keepdim=True)
    z = torch.sort(2.5 + 3 * torch.rand(n, s, generator=gen), -1).values
    ind = torch.rand(n, 1, generator=gen) * 2 - 1
    o, d, z, ind = (t.to(card) for t in (o, d, z, ind))
    extra = embed_padded(ind, EmbeddingSpec(2, in_channels=1), 5)
    ind_emb = embed_padded(ind, EmbeddingSpec(16, in_channels=1), 33)
    args = (params, "coarse_NeRF", ncfg, fcfg, 10, 5, True, True,
            anneal_weights(505000, 10, 5000, 1005000).to(card),
            anneal_weights(505000, 5, 5000, 1005000).to(card), o, d, z,
            None if sigma_only else extra, ind_emb, True, sigma_only, dt)
    before = render_pass.launches
    ks, kr = render_pass(*args)
    rs, rr = render_pass_ref(*args)
    torch.cuda.synchronize()
    assert render_pass.launches == before + 1
    atol, rtol = TOL[dt]
    torch.testing.assert_close(ks, rs, atol=atol, rtol=rtol)
    if not sigma_only:
        torch.testing.assert_close(kr, rr, atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("reso", [256, 1080])
def test_rasterizer_matches_plain(card, reso):
    """The offline toolchain's rasterizer on the card against the same
    function on the CPU: the fp64 inside tests and depths are the same
    operations, so the coverage is equal; a pixel's colour sums three fp64
    terms in another order before its rounding to fp32 (1e-6)."""
    from moco_flow_tpu_torch.geometry.smpl import synthetic_smpl_data
    from moco_flow_tpu_torch.scripts import data_utils as du
    from moco_flow_tpu_torch.scripts.rasterizer import rasterize_mesh
    smpl = synthetic_smpl_data(6890)
    rng = np.random.default_rng(reso)
    pose = np.zeros(72, np.float32)
    pose[3:] = rng.normal(scale=0.1, size=69)
    # preprocess_data.py's camera (focal 2000 at 1080^2, orig_cam scale
    # 1), scaled to the size
    focal = 2000.0 * reso / 1080
    transl = np.array([0.0, 0.2, 2 * focal / reso], np.float32)
    verts = du.posed_vertices(smpl, pose, np.zeros(10), transl, card)
    colors = du.position_colors(verts)
    radius = float(np.linalg.norm(transl))
    for pos in du.sample_on_sphere(3, radius):
        c2w = du.look_at_pose(pos + transl, transl)
        args = (verts, smpl.faces, colors, c2w, focal, (reso / 2, reso / 2),
                (reso, reso))
        got = rasterize_mesh(*args, device=card).cpu()
        want = rasterize_mesh(*args, device="cpu")
        assert torch.equal(got[..., 3], want[..., 3])
        assert want[..., 3].sum() > 0.05 * reso * reso
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 5, 30, 31])
def test_median_matches_plain(card, n):
    """``median_stack`` on the card equals the CPU plain version (both
    sort; an even count truncates the mean of the two middle values)."""
    from moco_flow_tpu_torch.scripts.data_utils import median_stack
    gen = torch.Generator().manual_seed(n)
    stack = torch.randint(0, 256, (n, 150, 97, 3), generator=gen,
                          dtype=torch.uint8)
    want = median_stack(stack)
    assert torch.equal(median_stack(stack.to(card)).cpu(), want)
