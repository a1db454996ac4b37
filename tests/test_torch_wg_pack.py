"""The weight images of the bf16 forward kernels #7, #8 and #9
(``csrc/wg_tile.cuh``), built on the CPU by ``ops/_args.py::wg_pack``.

Each (K, N) weight becomes ceil(K / 64) slices of wg_width(N) rows of 64
bf16 (128 bytes), in the 128-byte swizzle that the wgmma descriptor names:
element (n, k) of W^T sits in slice k // 64, row n, 16-byte chunk
((k % 64) // 8) ^ (n % 8), position k % 8. Read back through that formula,
every image must give W^T zero-padded to (wg_width(N), 64 * slices), and
the padding must be exactly zero. Shapes: every product that #7, #8 and #9
pack at c2f.yaml's and init_nerf.yaml's widths, and ragged K.

The row-tile operands of the training kernels and of the fp32 forwards
(``row_ops``, one gather a launch) must be each matrix, or its transpose
read from the same values, in its product's layout: bf16 B^T zero-padded
to (pad16(N), pad16(K)), fp32 B zero-padded to (K, pad16(N)). #9's fp32
operands (``split_ops``) are those, split once into TF32 hi and lo parts:
hi + lo gives each weight within the split's error, both parts are TF32
values rounded as ``cvt.rna.tf32.f32`` rounds, and the padding is exactly
zero in both.
"""

import pytest
import torch

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu_torch.ops._args import (WG_K, Operands, row_ops,
                                          split_ops, tf32_split, wg_pack,
                                          wg_pack_all, wg_width)

SHAPES = {
    "nerf-pe-63x256": (63, 256),          # NeRF layer 0, the skip's PE rows
    "nerf-skip-63+256": (63 + 256, 256),  # the skip layer as one matrix
    "nerf-256x256": (256, 256),
    "extra-256+27x128": (256 + 27, 128),  # #8's extra layer as one matrix
    "extra-dir-27x128": (27, 128),
    "rgb-128x3": (128, 3),                # N padded to 8
    "nof-pe-33x128": (33, 128),
    "nof-128x128": (128, 128),
    "nof-head-128x9": (128, 9),           # N padded to 16
    "nof-pallas-in-66x128": (66, 128),    # #9: layer 0's, the skip's inputs
    "nof-offset-head-128x3": (128, 3),    # #9's offset head, N padded to 8
    "ragged-90x48": (90, 48),             # the golden fixture's width
    "ragged-1x1": (1, 1),
    "ragged-65x17": (65, 17),
}


def read_back(img: torch.Tensor) -> torch.Tensor:
    """W^T (padded) from the slice images, through the swizzle formula."""
    s, n_pad = img.shape[0], img.shape[1]
    flat = img.reshape(s, n_pad, WG_K)
    out = torch.empty((n_pad, s * WG_K), dtype=img.dtype)
    for n in range(n_pad):
        for k in range(s * WG_K):
            chunk = ((k % WG_K) // 8) ^ (n % 8)
            out[n, k] = flat[k // WG_K, n, chunk * 8 + k % 8]
    return out


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_wg_pack_reads_back(shape):
    k, n = shape
    gen = torch.Generator().manual_seed(k * 1000 + n)
    w = torch.randn(k, n, generator=gen)
    img = wg_pack(w)
    n_pad, slices = wg_width(n), -(-k // WG_K)
    assert img.dtype == torch.bfloat16 and img.is_contiguous()
    assert img.numel() * 2 == slices * n_pad * 128   # one bulk copy a slice
    want = torch.zeros((n_pad, slices * WG_K), dtype=torch.bfloat16)
    want[:n, :k] = w.T.to(torch.bfloat16)
    got = read_back(img)
    assert torch.equal(got, want)
    assert not got[n:].any() and not got[:, k:].any()


def test_wg_width():
    assert [wg_width(n) for n in (1, 3, 8, 9, 16, 17, 48, 100, 128, 129,
                                  256)] == [8, 8, 8, 16, 16, 32, 64, 128,
                                            128, 256, 256]
    for bad in (0, 257):
        with pytest.raises(ValueError):
            wg_width(bad)


def test_wg_pack_all_matches_each():
    """One launch's weights packed together: each image, at its offset, is
    that weight's own ``wg_pack`` image (also for sliced, non-contiguous
    weights), and the gather index is reused for the same shapes."""
    gen = torch.Generator().manual_seed(7)
    ws = [torch.randn(63, 256, generator=gen),
          torch.randn(256, 256, generator=gen),
          torch.randn(283, 128, generator=gen)[:256],
          torch.randn(283, 128, generator=gen)[256:],
          torch.randn(128, 3, generator=gen)]
    for _ in range(2):
        buf, offs = wg_pack_all(ws)
        assert buf.dtype == torch.bfloat16 and len(offs) == len(ws)
        for w, o in zip(ws, offs):
            img = wg_pack(w).reshape(-1)
            assert o % 512 == 0                     # whole 1 KB slices
            assert torch.equal(buf[o:o + img.numel()], img)
        ws = [w * 2 for w in ws]                    # new values, same shapes


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_row_ops_layout(dt):
    """One gather gives each matrix's and each transpose's row-tile operand
    (zero padding included), at offsets of whole 16-byte rows."""
    gen = torch.Generator().manual_seed(8)
    ws = [torch.randn(*SHAPES[k], generator=gen)
          for k in ("nof-pe-33x128", "nof-128x128", "nof-head-128x9",
                    "ragged-65x17")]
    mats = [(w, t) for w in ws for t in (False, True)] + [(ws[1], False)]
    buf, offs = row_ops(mats, dt)
    assert buf.dtype == dt
    pad = lambda x: -(-x // 16) * 16  # noqa: E731
    for (w, t), o in zip(mats, offs):
        b = w.T if t else w
        k, n = b.shape
        if dt == torch.bfloat16:
            want = torch.zeros((pad(n), pad(k)), dtype=dt)
            want[:n, :k] = b.T
        else:
            want = torch.zeros((k, pad(n)), dtype=dt)
            want[:, :n] = b
        want = want.reshape(-1)
        assert (o * buf.element_size()) % 16 == 0
        assert torch.equal(buf[o:o + want.numel()], want)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: the 13 dropped
    mantissa bits rounded to nearest, ties away from zero, written as the
    arithmetic on the magnitude (not the bit trick of ``tf32_split``)."""
    m, e = torch.frexp(x.double())           # x = m 2^e, 0.5 <= |m| < 1
    q = torch.floor(m.abs() * 2 ** 11 + 0.5) * torch.sign(m)
    return torch.ldexp(q / 2 ** 11, e).float()


def test_tf32_split_rounding():
    gen = torch.Generator().manual_seed(10)
    x = torch.cat([torch.randn(4096, generator=gen) * 10 ** torch.randint(
        -6, 6, (4096,), generator=gen).float(),
        torch.tensor([0.0, 1.0 + 2 ** -11, -(1.0 + 2 ** -11),
                      1.0 + 2 ** -12, 3.0e-3])])
    hi, lo = tf32_split(x)
    assert torch.equal(hi, _tf32(x)) and torch.equal(lo, _tf32(x - hi))
    assert torch.equal(hi[-4:-1], torch.tensor([1.0 + 2 ** -10,
                                                -(1.0 + 2 ** -10), 1.0]))
    assert ((hi.view(torch.int32) | lo.view(torch.int32)) & 0x1FFF == 0).all()
    assert ((hi + lo - x).abs() <= x.abs() * 2 ** -21).all()


@pytest.mark.parametrize("use_quat", [True, False], ids=["quat", "offset"])
def test_split_ops_reads_back(use_quat):
    """#9's fp32 operands at c2f.yaml's NoF: one buffer of hi parts in
    ``row_ops``' layout, then the lo parts at a fixed distance; None gives
    0."""
    gen = torch.Generator().manual_seed(11)
    k_in, w, n_out = 66, 128, 9 if use_quat else 3
    skip = torch.randn(k_in + w, w, generator=gen)
    ws = [torch.randn(k_in, w, generator=gen), None, None,
          torch.randn(w, w, generator=gen), skip[:k_in], skip[k_in:], None,
          torch.randn(w, w, generator=gen), None,
          torch.randn(w, n_out, generator=gen)]
    ops = Operands("nof_pallas", torch.device("cpu"), torch.float32)
    ptrs, lo = split_ops(ops, ws)
    buf = ops.keep[-1]
    assert buf.dtype == torch.float32 and buf.numel() == 2 * lo
    pad = lambda x: -(-x // 16) * 16  # noqa: E731
    assert lo == sum(m.shape[0] * pad(m.shape[1]) for m in ws
                     if m is not None)
    for m, p in zip(ws, ptrs):
        if m is None:
            assert p == 0
            continue
        o = (p - buf.data_ptr()) // 4
        assert (p - buf.data_ptr()) % 16 == 0
        k, n = m.shape
        hi = buf[o:o + k * pad(n)].view(k, pad(n))
        lo_part = buf[o + lo:o + lo + k * pad(n)].view(k, pad(n))
        assert not hi[:, n:].any() and not lo_part[:, n:].any()
        want_hi, want_lo = _tf32(m), _tf32(m - _tf32(m))
        assert torch.equal(hi[:, :n], want_hi)
        assert torch.equal(lo_part[:, :n], want_lo)
        assert ((hi[:, :n] + lo_part[:, :n] - m).abs()
                <= m.abs() * 2 ** -21).all()
