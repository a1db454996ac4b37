"""The render-pass, single-warp NoF and per-op MLP CUDA kernels against
their plain PyTorch versions, on a GPU.

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


@pytest.mark.cuda
@pytest.mark.parametrize("n,s", [(1, 2000), (1, 5000), (37, 64)],
                         ids=["ray2000", "ray5000", "37x64"])
def test_nof_kernels_match_plain(card, n, s):
    """Kernels #3/#4 (fp32) at full NoF width: the warp within 1e-4 +
    1e-4|ref|; dxyz, d(partials) and every dW within 0.1 of each tensor's
    largest magnitude (chip_smoke.py's TRAIN_TOL: another summation order
    and ReLU flips at pre-activations within rounding of zero; measured
    below 1e-6 at these shapes)."""
    gen = torch.Generator().manual_seed(n + s)
    fcfg = NoFConfig()
    p = init_nof(gen, fcfg, card)
    an = anneal_weights(505000, 5, 5000, 1005000).to(card)
    ws, parts = _nof_fold(p, fcfg, 5, an,
                          torch.randn(n, 33, generator=gen).to(card))
    spec = _NofSpec(4, 128, 15, (2,), True, True)
    xyz = (0.6 * torch.randn(3, n, s, generator=gen)).to(card)
    g = torch.randn(3, n, s, generator=gen).to(card)
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
def test_fused_mlp_nof_matches_plain(card, use_quat, dt):
    """Kernel #9 (the per-op NoF) at c2f.yaml's widths, both heads."""
    from moco_flow_tpu_torch.ops import fused_mlp as fm
    gen = torch.Generator().manual_seed(4)
    cfg = NoFConfig(use_quat=use_quat)
    ws = fm._nof_weights_flat(init_nof(gen, cfg, card))
    n = 3001
    inp = (torch.rand(n, cfg.in_dim, generator=gen) * 2 - 1).to(card)
    xyz = (0.6 * torch.randn(n, 3, generator=gen)).to(card)
    got = fm.nof_pallas(cfg, dt, inp, xyz, ws)
    want = fm._nof_pallas_ref(cfg, dt, inp, xyz, ws)
    torch.cuda.synchronize()
    atol, rtol = TOL[dt]
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
