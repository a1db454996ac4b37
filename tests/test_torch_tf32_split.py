"""The fp32 tensor-core product of the forward kernels #1 (``nerf_fwd``), #5
(``chain_fwd``), #7 (``render_pass``), #8 (``nerf_pallas``) and #9
(``nof_pallas``), and of the backward passes of #2 (``nerf_bwd``), #4
(``nof_bwd``) and #6 (``chain_bwd``), emulated on the CPU.

The kernels' fp32 builds multiply on the tensor cores in TF32 with split
operands (``csrc/row_tile.cuh``): a = a_hi + a_lo and b = b_hi + b_lo, each
part rounded to TF32 (10 mantissa bits, round to nearest with ties away
from zero, ``cvt.rna.tf32.f32``), summing a_hi b_hi + a_hi b_lo + a_lo b_hi
in fp32 ("3xTF32"). The exact three-piece split (hi + mid + lo, six
products) is the fallback whose error is at fp32's level. Here every
product of the plain forwards ``_nerf_fwd_ref`` / ``_chain_fwd_ref`` /
``render_pass_ref`` (with the bw-NoF warp) / ``_nerf_pallas_ref`` (with
the ``dir`` extra) / ``_nof_pallas_ref`` (both heads) is replaced by the
emulated split product (the sigma row, a plain fp32 dot in the kernels,
excepted) at full width (NeRF 8x256, NoF 4x128; #8 at init_nerf.yaml's
model, #9 at c2f.yaml's NoF) on a few hundred seeded rows, and
the outputs are held against the fp32 plain versions: the two-piece split
within chip_smoke.py's ``TOL["fp32"]`` (1e-4 + 1e-4 |ref|), the three-piece
split within 1e-6 of the largest magnitude.
The backwards' plain versions ``_nerf_bwd_ref`` / ``_nof_bwd_ref`` /
``_chain_bwd_ref`` take the emulated product in every product, the weight
gradients' too (the kernels' fp32 builds run those on the same split
product, ``csrc/wgrad.cu``'s ``matrix_mma_kernel<float>``), and are
held against the plain versions in fp32 and fp64: the two-piece split
within ``tests/test_torch_cuda.py``'s ``_close_train`` rule of the fp32
one and, measured from the fp64 one, within BWD_FP32_FACTOR x the fp32
plain version's own distance (of a tensor's largest magnitude); one TF32
product a term leaves the ``_close_train`` rule.
The weight gradients' long-K accumulation is emulated as the kernel runs
it: K splits of ``SPLIT_ROWS`` rows, each in k-steps of 8 rows whose three
products are summed and then added to an fp32 running sum, the splits
summed in order; it stays within BWD_FP32_FACTOR x the in-order fp32 sum's
own distance from fp64, at a NeRF layer and at the NoF head.
``python -m pytest tests/test_torch_tf32_split.py -s`` prints the measured
errors.
"""

import pytest
import torch

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu_torch.nn.embedding import anneal_weights
from moco_flow_tpu_torch.nn.nerf import NeRFConfig, init_nerf
from moco_flow_tpu_torch.nn.nof import NoFConfig, init_nof
from moco_flow_tpu_torch.ops import (fused_mlp, nerf_rays, nof_chain,
                                     nof_rays, render_pass)
from moco_flow_tpu_torch.ops._args import SPLIT_ROWS
from moco_flow_tpu_torch.ops.folds import (_NerfSpec, _NofSpec, _nerf_fold,
                                           _nof_fold)
from moco_flow_tpu_torch.render.volume import EmbeddingSpec, embed_padded
from tests.test_torch_cuda import _close_train, _flat, _plain64

TOL_FP32 = (1e-4, 1e-4)      # chip_smoke.py TOL["fp32"]: atol, rtol
EXACT_REL = 1e-6             # three-piece split, of max |ref|
N_RAYS, N_SAMPLES = 48, 8    # 384 rows
BWD_FP32_FACTOR = 4.0        # split backward's distance from fp64 / fp32's


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, nearest, ties away from zero),
    as ``cvt.rna.tf32.f32``: add half of the 13 dropped bits to the
    magnitude, then clear them."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor, pieces: int) -> list:
    """x as ``pieces`` TF32 parts, largest first; each remainder exact."""
    out, r = [], x.float()
    for _ in range(pieces):
        p = tf32(r)
        out.append(p)
        r = r - p
    return out


# the products the kernels sum, as (a piece, b piece), small terms first
TERMS = {1: ((0, 0),),
         2: ((1, 0), (0, 1), (0, 0)),
         3: ((1, 1), (2, 0), (0, 2), (1, 0), (0, 1), (0, 0))}


def split_matmul(pieces: int):
    """``nn.mlp.matmul`` with fp32 products replaced by the split product;
    bf16 products and the (W, 1) sigma row keep the plain product."""
    plain = nerf_rays.matmul

    def mm(x, w, compute_dtype=None):
        if compute_dtype == torch.bfloat16 or w.shape[-1] == 1:
            return plain(x, w, compute_dtype)
        xs, ws = split(x, pieces), split(w, pieces)
        out = None
        for i, j in TERMS[pieces]:
            t = xs[i] @ ws[j]
            out = t if out is None else out + t
        return out
    return mm


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -(1.0 + 2 ** -11), 1.0 + 2 ** -12, 3.0e-3])
    got = tf32(x)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9,
                         -(1.0 + 2 ** -10), 1.0, got[5].item()])
    assert torch.equal(got[:5], want[:5])
    # 10 explicit mantissa bits, within half an ulp of 2^-10
    assert abs(got[5].item() - 3.0e-3) <= 3.0e-3 * 2 ** -11
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    hi, lo = split(x, 2)
    assert ((hi + lo - x).abs() <= x.abs() * 2 ** -21).all()


def _nerf(sigma_only: bool):
    gen = torch.Generator().manual_seed(11)
    cfg = NeRFConfig(extra_feat_type="ind", extra_feat_dim=5)
    params = init_nerf(gen, cfg, torch.device("cpu"))
    xyz = 0.8 * torch.randn(3, N_RAYS, N_SAMPLES, generator=gen)
    emb = torch.randn(N_RAYS, 5, generator=gen)
    an = anneal_weights(505000, 10, 5000, 1005000)
    ws, p_e = _nerf_fold(params, cfg, 10, an, None if sigma_only else emb,
                         sigma_only)
    spec = _NerfSpec(8, 256, 30, (4,), sigma_only, not sigma_only, True)
    return lambda: [nerf_rays._nerf_fwd_ref(spec, None, xyz, p_e, ws)]


def _chain():
    gen = torch.Generator().manual_seed(12)
    cfg = NoFConfig()
    cpu = torch.device("cpu")
    bw, fw = init_nof(gen, cfg, cpu), init_nof(gen, cfg, cpu)
    xyz = 0.6 * torch.randn(3, N_RAYS, N_SAMPLES, generator=gen)
    emb = torch.randn(N_RAYS, 33, generator=gen)
    emb_c = torch.randn(N_RAYS, 33, generator=gen)
    an = anneal_weights(505000, 5, 5000, 1005000)
    wsb, pb = _nof_fold(bw, cfg, 5, an, emb)
    wsf, pf = _nof_fold(fw, cfg, 5, an, emb)
    sets = [pb, pf, _nof_fold(fw, cfg, 5, an, emb_c)[1],
            _nof_fold(bw, cfg, 5, an, emb_c)[1]]
    parts = [p for st in sets for p in st]
    spec = nof_chain._ChainSpec(_NofSpec(4, 128, 15, (2,), True, True),
                                True, True)
    return lambda: list(nof_chain._chain_fwd_ref(spec, None, 2, xyz, parts,
                                                 wsb, wsf))


def _render_pass(sigma_only: bool):
    """#7 at c2f.yaml's widths with the bw-NoF warp."""
    gen = torch.Generator().manual_seed(13)
    ncfg = NeRFConfig(extra_feat_type="ind", extra_feat_dim=5)
    fcfg = NoFConfig()
    cpu = torch.device("cpu")
    params = {"coarse_NeRF": init_nerf(gen, ncfg, cpu),
              "bw_NoF": init_nof(gen, fcfg, cpu)}
    o = torch.tensor([0.0, 0.0, 4.0]) + 0.05 * torch.randn(N_RAYS, 3,
                                                           generator=gen)
    d = torch.randn(N_RAYS, 3, generator=gen)
    d[:, 2] = -d[:, 2].abs() - 1
    d = d / d.norm(dim=-1, keepdim=True)
    z = torch.sort(2.5 + 3 * torch.rand(N_RAYS, N_SAMPLES, generator=gen),
                   -1).values
    ind = torch.rand(N_RAYS, 1, generator=gen) * 2 - 1
    extra = embed_padded(ind, EmbeddingSpec(2, in_channels=1), 5)
    ind_emb = embed_padded(ind, EmbeddingSpec(16, in_channels=1), 33)
    args = (params, "coarse_NeRF", ncfg, fcfg, 10, 5, True, True,
            anneal_weights(505000, 10, 5000, 1005000),
            anneal_weights(505000, 5, 5000, 1005000), o, d, z,
            None if sigma_only else extra, ind_emb, True, sigma_only, None)
    return lambda: [t for t in render_pass.render_pass_ref(*args)
                    if t is not None]


def _nerf_pallas():
    """#8 at init_nerf.yaml's model: 63 inputs, the 27-wide ``dir``
    extra."""
    gen = torch.Generator().manual_seed(14)
    cfg = NeRFConfig(depth=8, width=256, in_channels_xyz=63, skips=(4,),
                     extra_feat_type="dir", extra_feat_dim=27)
    ws = fused_mlp._nerf_weights_flat(
        init_nerf(gen, cfg, torch.device("cpu")), False)
    x = torch.rand(N_RAYS * N_SAMPLES, 63, generator=gen) * 2 - 1
    e = torch.rand(N_RAYS * N_SAMPLES, 27, generator=gen) * 2 - 1
    return lambda: [fused_mlp._nerf_pallas_ref(cfg, None, x, e, False, ws)]


def _nof_pallas(use_quat: bool):
    """#9 at c2f.yaml's NoF (66 inputs, 4x128, skip 2) with the quaternion
    or the offset head."""
    gen = torch.Generator().manual_seed(15)
    cfg = NoFConfig(use_quat=use_quat)
    ws = fused_mlp._nof_weights_flat(init_nof(gen, cfg, torch.device("cpu")))
    inp = torch.rand(N_RAYS * N_SAMPLES, cfg.in_dim, generator=gen) * 2 - 1
    xyz = 0.6 * torch.randn(N_RAYS * N_SAMPLES, 3, generator=gen)
    return lambda: [fused_mlp._nof_pallas_ref(cfg, None, inp, xyz, ws)]


CASES = {"nerf": lambda: _nerf(False), "nerf-sigma-only": lambda: _nerf(True),
         "chain": _chain,
         "render-pass": lambda: _render_pass(False),
         "render-pass-sigma-only": lambda: _render_pass(True),
         "nerf-pallas": _nerf_pallas,
         "nof-pallas": lambda: _nof_pallas(True),
         "nof-pallas-offset": lambda: _nof_pallas(False)}
# the modules whose products the kernels' fp32 builds take in split TF32
SPLIT_MODULES = (nerf_rays, nof_chain, render_pass, fused_mlp)


@pytest.mark.parametrize("pieces", [2, 3], ids=["3xTF32", "three-piece"])
@pytest.mark.parametrize("case", list(CASES))
def test_split_product_error(case, pieces, monkeypatch):
    run = CASES[case]()
    with torch.no_grad():
        want = run()
        for mod in SPLIT_MODULES:
            monkeypatch.setattr(mod, "matmul", split_matmul(pieces))
        got = run()
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        err = (g - w).abs()
        rel = err.max().item() / w.abs().max().item()
        print(f"{case} {pieces}-piece split: max|diff| {err.max().item():.3e}"
              f" ({rel:.2e} of max|ref| {w.abs().max().item():.3f})")
        if pieces == 2:
            atol, rtol = TOL_FP32
            assert (err <= atol + rtol * w.abs()).all()
        else:
            assert rel <= EXACT_REL
        # the emulation does round: the split is not the fp32 product
        assert pieces == 3 or err.max().item() > 0.0


def test_plain_tf32_is_not_enough(monkeypatch):
    """One TF32 product a term (no split) leaves the warp chain's fp32
    tolerance: the split is what keeps #5's fp32 build in it."""
    run = _chain()
    with torch.no_grad():
        want = run()
        monkeypatch.setattr(nof_chain, "matmul", split_matmul(1))
        got = run()
    atol, rtol = TOL_FP32
    assert any(((g - w).abs() > atol + rtol * w.abs()).any()
               for g, w in zip(got, want))


def split_mm(pieces: int):
    """``nerf_rays._mm`` (the backwards' products of stored values) with
    the split product."""
    def mm(a, b):
        xs, ws = split(a, pieces), split(b, pieces)
        out = None
        for i, j in TERMS[pieces]:
            t = xs[i] @ ws[j]
            out = t if out is None else out + t
        return out
    return mm


def _nerf_bwd(sigma_only: bool, raw_xyz: bool = False):
    """#2 at c2f.yaml's NeRF, or (``raw_xyz``) at init_nerf.yaml's: 0 PE
    frequencies, the 27-wide ``dir`` extra."""
    gen = torch.Generator().manual_seed(16)
    cfg = NeRFConfig(extra_feat_type="dir" if raw_xyz else "ind",
                     extra_feat_dim=27 if raw_xyz else 5)
    params = init_nerf(gen, cfg, torch.device("cpu"))
    xyz = 0.8 * torch.randn(3, N_RAYS, N_SAMPLES, generator=gen)
    emb = torch.randn(N_RAYS, cfg.extra_feat_dim, generator=gen)
    n_freqs = 0 if raw_xyz else 10
    an = None if raw_xyz else anneal_weights(505000, 10, 5000, 1005000)
    ws, p_e = _nerf_fold(params, cfg, n_freqs, an,
                         None if sigma_only else emb, sigma_only)
    spec = _NerfSpec(8, 256, 3 * max(n_freqs, 1), (4,), sigma_only,
                     not sigma_only, True)
    g = (torch.randn(1 if sigma_only else 4, N_RAYS, N_SAMPLES,
                     generator=gen) / (N_RAYS * N_SAMPLES) ** 0.5)
    return nerf_rays._nerf_bwd_ref, (spec, None, xyz, p_e, ws, g)


def _chain_bwd():
    """#6 at c2f.yaml's NoFs, both chains."""
    gen = torch.Generator().manual_seed(17)
    cfg = NoFConfig()
    cpu = torch.device("cpu")
    bw, fw = init_nof(gen, cfg, cpu), init_nof(gen, cfg, cpu)
    xyz = 0.6 * torch.randn(3, N_RAYS, N_SAMPLES, generator=gen)
    emb = torch.randn(N_RAYS, 33, generator=gen)
    emb_c = torch.randn(N_RAYS, 33, generator=gen)
    an = anneal_weights(505000, 5, 5000, 1005000)
    wsb, pb = _nof_fold(bw, cfg, 5, an, emb)
    wsf, pf = _nof_fold(fw, cfg, 5, an, emb)
    sets = [pb, pf, _nof_fold(fw, cfg, 5, an, emb_c)[1],
            _nof_fold(bw, cfg, 5, an, emb_c)[1]]
    parts = [p for st in sets for p in st]
    spec = nof_chain._ChainSpec(_NofSpec(4, 128, 15, (2,), True, True),
                                True, True)
    gs = [torch.randn(3, N_RAYS, N_SAMPLES, generator=gen)
          / (N_RAYS * N_SAMPLES) ** 0.5 for _ in range(3)]
    return nof_chain._chain_bwd_ref, (spec, None, 2, xyz, parts, wsb, wsf,
                                      gs)


def _nof_bwd():
    """#4 at c2f.yaml's NoF."""
    gen = torch.Generator().manual_seed(18)
    cfg = NoFConfig()
    p = init_nof(gen, cfg, torch.device("cpu"))
    xyz = 0.6 * torch.randn(3, N_RAYS, N_SAMPLES, generator=gen)
    emb = torch.randn(N_RAYS, 33, generator=gen)
    ws, parts = _nof_fold(p, cfg, 5, anneal_weights(505000, 5, 5000, 1005000),
                          emb)
    g = (torch.randn(3, N_RAYS, N_SAMPLES, generator=gen)
         / (N_RAYS * N_SAMPLES) ** 0.5)
    return nof_rays._nof_bwd_ref, (_NofSpec(4, 128, 15, (2,), True, True),
                                   None, xyz, parts, ws, g)


BWD_CASES = {"nerf": lambda: _nerf_bwd(False),
             "nerf-sigma-only": lambda: _nerf_bwd(True),
             "nerf-raw-xyz": lambda: _nerf_bwd(False, raw_xyz=True),
             "chain": _chain_bwd, "nof": _nof_bwd}


def _split_bwd(fn, args, pieces: int, monkeypatch) -> list:
    with monkeypatch.context() as mp:
        for mod in (nerf_rays, nof_chain):
            mp.setattr(mod, "matmul", split_matmul(pieces))
            mp.setattr(mod, "_mm", split_mm(pieces))
        return _flat(fn(*args))


def _rel_max(got: list, want: list) -> float:
    """Largest max |got - want| / max |want| over the tensors."""
    return max(((g.double() - w.double()).abs().max()
                / w.double().abs().max().clamp_min(1e-30)).item()
               for g, w in zip(got, want))


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_split_backward_error(case, monkeypatch):
    fn, args = BWD_CASES[case]()
    with torch.no_grad():
        want, want64 = _flat(fn(*args)), _flat(_plain64(fn, *args))
        got = _split_bwd(fn, args, 2, monkeypatch)
    assert len(got) == len(want) == len(want64)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert _close_train(g, w, None, None)
    e_split, e_fp32 = _rel_max(got, want64), _rel_max(want, want64)
    print(f"{case} backward, 3xTF32: {_rel_max(got, want):.2e} of a "
          f"tensor's max|fp32 plain|; from fp64 {e_split:.2e}, the fp32 "
          f"plain version {e_fp32:.2e}")
    assert 0.0 < e_split <= BWD_FP32_FACTOR * e_fp32


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_plain_tf32_backward_is_not_enough(case, monkeypatch):
    """One TF32 product a term moves some gradient out of the rule the
    kernels' fp32 builds are held to."""
    fn, args = BWD_CASES[case]()
    with torch.no_grad():
        want = _flat(fn(*args))
        got = _split_bwd(fn, args, 1, monkeypatch)
    assert not all(_close_train(g, w, None, None) for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# The weight gradients' long-K product: dW = A^T D over every row of a call
# ---------------------------------------------------------------------------

def dw_split_emulated(a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """dW = a^T d as ``matrix_mma_kernel<float>`` sums it: per split of
    SPLIT_ROWS rows, k-steps of 8 rows; a k-step's a_hi d_lo + a_lo d_hi +
    a_hi d_hi is summed from zero (the tensor cores; here 8-deep fp32 sums,
    the three added in that order) and added to the split's fp32 running
    sum; the splits' partial rows are summed in order (``wgrad_reduce``)."""
    (ah, al), (dh, dl) = split(a, 2), split(d, 2)
    total = None
    for r0 in range(0, a.shape[0], SPLIT_ROWS):
        r1 = min(r0 + SPLIT_ROWS, a.shape[0])
        acc = torch.zeros(a.shape[1], d.shape[1])
        for b0 in range(r0, r1, 1024):      # 128 k-steps at a time
            b1 = min(b0 + 1024, r1)

            def steps(x):
                return x[b0:b1].reshape(-1, 8, x.shape[1])
            sa_h, sa_l = steps(ah).transpose(1, 2), steps(al).transpose(1, 2)
            s = torch.bmm(sa_h, steps(dl))
            s = s + torch.bmm(sa_l, steps(dh))
            s = s + torch.bmm(sa_h, steps(dh))
            for t in s:
                acc = acc + t
        total = acc if total is None else total + acc
    return total


def dw_in_order(a: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """dW = a^T d summed row by row in fp32 within each split, the splits
    summed in order (what the FFMA loop the kernel replaced did)."""
    total = None
    for r0 in range(0, a.shape[0], SPLIT_ROWS):
        acc = torch.zeros(a.shape[1], d.shape[1])
        for r in range(r0, min(r0 + SPLIT_ROWS, a.shape[0])):
            acc = acc + torch.outer(a[r], d[r])
        total = acc if total is None else total + acc
    return total


# (m, n) of a NeRF hidden layer and of the NoF's quaternion head, on two
# whole splits and a short third one (rows a multiple of the 128-row tile)
DW_CASES = {"nerf-256x256": (256, 256), "nof-head-128x9": (128, 9)}
DW_ROWS = 2 * SPLIT_ROWS + 31 * 128


@pytest.mark.parametrize("case", list(DW_CASES))
def test_split_weight_gradient_long_k(case):
    m, n = DW_CASES[case]
    gen = torch.Generator().manual_seed(19)
    a = torch.randn(DW_ROWS, m, generator=gen).relu()      # activations
    d = torch.randn(DW_ROWS, n, generator=gen) * 1e-3      # cotangents
    d[torch.rand(DW_ROWS, generator=gen) < 0.25] = 0.0     # masked rows
    want64 = a.double().T @ d.double()
    got, fp32 = dw_split_emulated(a, d), dw_in_order(a, d)
    scale = want64.abs().max()
    e_split = ((got.double() - want64).abs().max() / scale).item()
    e_fp32 = ((fp32.double() - want64).abs().max() / scale).item()
    print(f"dW {case} over {DW_ROWS} rows: split TF32 {e_split:.2e}, "
          f"in-order fp32 {e_fp32:.2e} of max|fp64|")
    assert 0.0 < e_split <= BWD_FP32_FACTOR * e_fp32
