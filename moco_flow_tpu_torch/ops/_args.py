"""Argument arrays of the training kernels (``csrc/nerf_rays.cu``,
``csrc/chain_bwd.cu``) and of the forward MLP kernels.

The kernels take one int64 array over a plain C interface: integers as
they are, pointers as ``tensor.data_ptr()``. ``Operands`` keeps every tensor
whose pointer went into an array alive until the launch is queued, checks
device and contiguity, and lays out the flat fp32 weight-gradient buffer:
the gradient of the folded operand ``i`` sits at ``offset[i]``, in operand
order, so splitting the buffer by the operands' sizes gives the gradients
in the order autograd returns them.

The training kernels (#1-#6) take each weight, and in a backward its
transpose, as the B operand of a row-tile product (``row_ops``), all of a
launch built by one gather (``Operands.row``). The forward kernels #7 / #8
take their weights in their products' own layouts (``fwd_ops``): the
row-tile operands of the split-TF32 product in fp32 (``row_ops``), and in
bf16 the shared-memory images of the wgmma tile's weight slices
(``wg_pack``, ``wg_pack_all``), which one bulk copy each brings into
shared memory. #9 takes the same bf16 images, and in fp32 the row-tile
operands split once into their TF32 hi and lo parts (``split_ops``).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..nn.embedding import device_bands
from .folds import _trunk_layers

MAX_DEPTH = 8        # chain_bwd.cu / nerf_rays.cu kMaxDepth
MAX_WIDTH = 256      # pass_tile.cuh kMaxWidth
# The backward kernels #2 / #4 / #6 (row_tile.cuh, wgrad.cuh): rows per
# split of the long-K weight-gradient products (a multiple of the 128-row
# tile), and the most scratch one launch may take; a call above it runs in
# chunks of whole rays, each a whole number of splits, so it gives the same
# bits.
SPLIT_ROWS = 8192
SCRATCH_CAP = 4 << 30


class _Row:
    """A row-tile operand asked for with ``Operands.row``, built with the
    launch's others when its argument array is made (``Operands.array``)."""
    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i


class Operands:
    def __init__(self, name: str, device: torch.device, dtype: torch.dtype):
        self.name, self.device, self.dtype = name, device, dtype
        self.keep = []
        self.rows, self.row_ptrs = [], []

    def check(self, cond: bool, msg: str):
        if not cond:
            raise ValueError(f"{self.name}: {msg}")

    def ptr(self, t) -> int:
        if t is None:
            return 0
        self.check(t.device == self.device,
                   f"operand on {t.device}, samples on {self.device}")
        self.check(t.is_contiguous(), "operand not contiguous")
        self.keep.append(t)
        return t.data_ptr()

    def vec(self, b) -> int:
        return self.ptr(b.float().reshape(-1).contiguous())

    def row(self, w, transposed: bool = False) -> _Row:
        """The row-tile operand of a (K, N) matrix w or of its transpose
        (``row_ops``), built later with the launch's others."""
        self.rows.append((w, transposed))
        return _Row(len(self.rows) - 1)

    def array(self, args) -> np.ndarray:
        """``as_array`` of ``args``, their ``row`` operands built first, all
        that are not built yet in one gather."""
        new = self.rows[len(self.row_ptrs):]
        if new:
            buf, offs = row_ops(new, self.dtype)
            base = self.ptr(buf)
            self.row_ptrs += [base + buf.element_size() * o for o in offs]
        return as_array([self.row_ptrs[a.i] if isinstance(a, _Row) else a
                         for a in args])

    def bands(self, kc: int, logscale: bool) -> int:
        """The PE's frequency bands on the device, copied there once."""
        return self.ptr(device_bands(kc // 3, logscale, self.device))


def _pad16(x: int) -> int:
    return -(-x // 16) * 16


_ROW_GATHER = {}   # (shapes, requests, dtype, device) -> (index, offsets)
_ZERO = {}         # (dtype, device) -> a one-element zero


def row_ops(mats: list, dtype: torch.dtype) -> tuple:
    """The B operands (K, N) of a launch's row-tile products (row_tile.cuh)
    in one buffer of the storage type, and each one's offset in it
    (elements; each a multiple of 16 bytes): bf16 B^T zero-padded to
    (pad16(N), pad16(K)), fp32 B zero-padded to (K, pad16(N)). ``mats``
    holds (w, transposed): B is w, or w^T (a backward's input-gradient
    operand, read from the same values). One gather from the matrices'
    values: its index depends only on their shapes and is built once per
    set of shapes."""
    dev = mats[0][0].device
    srcs, seen, req = [], {}, []
    for w, t in mats:
        src = w.contiguous()
        key = (src.data_ptr(), tuple(src.shape), src.dtype)
        if key not in seen:
            seen[key] = len(srcs)
            srcs.append(src)
        req.append((seen[key], t))
    bf16 = dtype == torch.bfloat16
    key = (tuple(tuple(q.shape) for q in srcs), tuple(req), bf16, str(dev))
    if key not in _ROW_GATHER:
        bases, at = [], 0
        for q in srcs:
            bases.append(at)
            at += q.numel()
        zero, parts, offs, at = at, [], [], 0
        for si, t in req:
            rr, cc = srcs[si].shape
            k_, n_ = (cc, rr) if t else (rr, cc)
            k = torch.arange(k_, device=dev)[:, None]
            n = torch.arange(n_, device=dev)[None, :]
            flat = bases[si] + (n * cc + k if t else k * cc + n)  # B[k, n]
            if bf16:
                out = torch.full((_pad16(n_), _pad16(k_)), zero,
                                 dtype=torch.int64, device=dev)
                out[:n_, :k_] = flat.T
            else:
                out = torch.full((k_, _pad16(n_)), zero, dtype=torch.int64,
                                 device=dev)
                out[:, :n_] = flat
            parts.append(out.reshape(-1))
            offs.append(at)
            at += out.numel()
        _ROW_GATHER[key] = (torch.cat(parts), offs)
    idx, offs = _ROW_GATHER[key]
    zkey = (srcs[0].dtype, str(dev))
    if zkey not in _ZERO:
        _ZERO[zkey] = torch.zeros(1, dtype=srcs[0].dtype, device=dev)
    vals = torch.cat([q.reshape(-1) for q in srcs] + [_ZERO[zkey]])
    return torch.index_select(vals.to(dtype), 0, idx), offs


# The bf16 forward kernels #7 / #8 (csrc/wg_tile.cuh): a product's weights
# arrive as the shared-memory image of their slices, 64 deep (128 bytes of
# bf16 a row) and as wide as the wgmma, in the 128-byte swizzle.
WG_K = 64


def wg_width(n: int) -> int:
    """The wgmma width of a product with n outputs: the next of 8, 16, 32,
    64, 128, 256 (wg_tile.cuh ``width_of``)."""
    if not 1 <= n <= 256:
        raise ValueError(f"wgmma width: {n} outputs not in 1..256")
    return max(8, 1 << (n - 1).bit_length())


def _wg_image(t: torch.Tensor) -> torch.Tensor:
    """(n_pad, 64 s) rows of W^T (or of indices into them) -> the slice
    images (s, n_pad, 8, 8): slice s holds columns 64 s .. 64 s + 63, and
    the 16-byte chunk q of row n sits at chunk q ^ (n % 8)."""
    n_pad, s = t.shape[0], t.shape[1] // WG_K
    img = t.view(n_pad, s, 8, 8).permute(1, 0, 2, 3)      # (s, n, chunk, 8)
    rows = torch.arange(n_pad, device=t.device) % 8
    chunk = torch.arange(8, device=t.device)
    src = (chunk[None, :] ^ rows[:, None])[None, :, :, None]
    return torch.gather(img, 2, src.expand(s, n_pad, 8, 8)).contiguous()


def wg_pack(w: torch.Tensor) -> torch.Tensor:
    """A (K, N) weight as the slice images of ``csrc/wg_tile.cuh``: bf16
    (ceil(K / 64), wg_width(N), 8, 8), slice s holding W^T[:, 64 s : 64 s +
    64] zero-padded, with the 16-byte chunk q of row n stored at chunk
    q ^ (n % 8) (the 128-byte swizzle the wgmma descriptor names). The
    slices are contiguous, each the exact bytes one bulk copy brings."""
    k, n = w.shape
    wt = torch.zeros((wg_width(n), -(-k // WG_K) * WG_K),
                     dtype=torch.bfloat16, device=w.device)
    wt[:n, :k] = w.T
    return _wg_image(wt)


_WG_GATHER = {}   # (shapes, device) -> (gather index, offsets)


def wg_pack_all(ws: list) -> tuple:
    """The ``wg_pack`` images of every (K, N) weight of a launch in one bf16
    buffer, and each image's offset in it (elements; each image is a whole
    number of 1 KB slices). One gather from the weights' values: its index
    depends only on the shapes and is built once per set of shapes."""
    dev = ws[0].device
    key = (tuple(tuple(w.shape) for w in ws), str(dev))
    if key not in _WG_GATHER:
        zero = sum(w.numel() for w in ws)     # the index of an appended 0
        parts, offs, base, at = [], [], 0, 0
        for w in ws:
            k, n = w.shape
            src = torch.full((wg_width(n), -(-k // WG_K) * WG_K), zero,
                             dtype=torch.int64, device=dev)
            src[:n, :k] = (base + torch.arange(k, device=dev)[None, :] * n
                           + torch.arange(n, device=dev)[:, None])
            parts.append(_wg_image(src).reshape(-1))
            offs.append(at)
            at += parts[-1].numel()
            base += w.numel()
        _WG_GATHER[key] = (torch.cat(parts), offs)
    idx, offs = _WG_GATHER[key]
    vals = torch.cat([w.reshape(-1) for w in ws]
                     + [torch.zeros(1, dtype=ws[0].dtype, device=dev)])
    return torch.index_select(vals.to(torch.bfloat16), 0, idx), offs


def fwd_ops(ops: Operands, ws: list) -> list:
    """The (K, N) weights of a launch of the forward kernels #7 / #8 (None
    entries give 0): in bf16 pointers into one buffer of slice images
    (``wg_pack_all``), in fp32 into one of row-tile operands
    (``row_ops``)."""
    real = [w for w in ws if w is not None]
    if ops.dtype != torch.bfloat16 and real:
        buf, offs = row_ops([(w, False) for w in real], ops.dtype)
        base = ops.ptr(buf)
        it = iter([base + 4 * o for o in offs])
    elif real:
        buf, offs = wg_pack_all(real)
        base = ops.ptr(buf)
        it = iter([base + 2 * o for o in offs])
    return [0 if w is None else next(it) for w in ws]


def tf32_split(x: torch.Tensor) -> tuple:
    """fp32 x as (hi, lo), x = hi + lo, each rounded to TF32 as
    ``cvt.rna.tf32.f32`` rounds (10 mantissa bits, nearest, ties away from
    zero: half of the 13 dropped bits added to the magnitude, then cleared),
    the split of ``row_tile.cuh::tf32_split``; x - hi is exact."""
    def tf32(v):
        return ((v.contiguous().view(torch.int32) + 0x1000)
                & ~0x1FFF).view(torch.float32)
    hi = tf32(x.float())
    return hi, tf32(x.float() - hi)


def split_ops(ops: Operands, ws: list) -> tuple:
    """The fp32 (K, N) weights of #9 (None entries give 0) split once for
    its split-TF32 product (``row_tile.cuh::rt_mm_presplit``): one buffer of
    every matrix's TF32 hi part in ``row_ops``' layout, then every lo part
    in the same order. Returns the pointers to the hi parts and the lo
    parts' distance from them (elements)."""
    real = [w for w in ws if w is not None]
    buf, offs = row_ops([(w, False) for w in real], torch.float32)
    base = ops.ptr(torch.cat(tf32_split(buf)))
    it = iter([base + 4 * o for o in offs])
    return [0 if w is None else next(it) for w in ws], buf.numel()


def _fb(ops: Operands, w, backward: bool) -> list:
    """(forward operand, input-gradient operand, or 0 without backward), as
    ``Operands.row`` operands."""
    return [ops.row(w), ops.row(w, transposed=True) if backward else 0]


def row_mat(ops: Operands, ws, off, iw: int, ib: int,
            backward: bool = True) -> list:
    """A matrix (K, N) as (forward operand, input-gradient operand), its
    bias, and their gradient offsets: (f, b, bias, g_w, g_b)."""
    return _fb(ops, ws[iw], backward) + [ops.vec(ws[ib]), off[iw], off[ib]]


def row_layers(ops: Operands, ws, off, depth: int, skips: tuple,
               backward: bool = True) -> list:
    """8 trunk layers of (pe_f, pe_b, h_f, h_b, bias, g_pe, g_h, g_b); the
    input-gradient operands only with ``backward``."""
    ops.check(1 <= depth <= MAX_DEPTH, f"depth {depth} not in 1..{MAX_DEPTH}")
    idx, _ = _trunk_layers(list(range(len(ws))), depth, skips)
    blk = []
    for layer in range(MAX_DEPTH):
        if layer >= depth:
            blk += [0] * 8
            continue
        ipe, ih, ib = idx[layer]
        pe = [0, 0] if ipe is None else _fb(ops, ws[ipe], backward)
        h = [0, 0] if ih is None else _fb(ops, ws[ih], backward)
        blk += pe + h + [ops.vec(ws[ib]), 0 if ipe is None else off[ipe],
                         0 if ih is None else off[ih], off[ib]]
    return blk


def run_chunks(ops: Operands, lib, prefix: str, n: int, s: int, total: int,
               make_args, error: str | None = None) -> torch.Tensor:
    """Run a backward kernel (#2 ``nerf_bwd``, #4 ``nof_bwd``, #6
    ``chain_bwd``) over n rays of s samples in chunks of whole rays whose
    scratch fits SCRATCH_CAP, and sum the chunks' weight-gradient splits in
    order (``wgrad_reduce``). The library's ``<prefix>_scratch_bytes`` and
    ``<prefix>_launch`` run it, ``error`` (default ``<prefix>_error``) names
    its codes.

    ``make_args(r0, r1, part, scratch)`` returns the argument array of rays
    [r0, r1) and a function to call once that chunk is queued (or None);
    ``part`` and ``scratch`` are None when only the scratch size is asked.
    Returns the flat fp32 gradient (total,)."""
    err_fn = getattr(lib, error or f"{prefix}_error")

    def scratch_bytes(rays: int) -> int:
        b = call(getattr(lib, f"{prefix}_scratch_bytes"),
                 make_args(0, rays, None, None)[0])
        if b < 0:
            raise RuntimeError(f"{ops.name}: {err_fn(b).decode()} ({b})")
        return b

    q = SPLIT_ROWS // math.gcd(SPLIT_ROWS, s)  # rays in a whole number of splits
    whole = scratch_bytes(n)
    if whole <= SCRATCH_CAP:
        spans = [(0, n)]
    else:
        per = SCRATCH_CAP // scratch_bytes(q) * q
        if per == 0:
            raise RuntimeError(f"{ops.name}: {q} rays of {s} samples need "
                               f"{scratch_bytes(q)} bytes of scratch, above "
                               f"the cap of {SCRATCH_CAP}")
        spans = [(r, min(r + per, n)) for r in range(0, n, per)]
    rows_padded = -(-n * s // 128) * 128      # row tiles of 128
    n_split = -(-rows_padded // SPLIT_ROWS)
    part = torch.empty((n_split, total), dtype=torch.float32,
                       device=ops.device)
    first = whole if len(spans) == 1 else scratch_bytes(spans[0][1])
    scratch = torch.empty((first,), dtype=torch.uint8, device=ops.device)
    run_chunks.last = {"scratch_bytes": scratch.numel(), "chunks": len(spans)}
    run_chunks.max_scratch = max(run_chunks.max_scratch, scratch.numel())
    stream = torch.cuda.current_stream(ops.device).cuda_stream
    launch = getattr(lib, f"{prefix}_launch")
    for r0, r1 in spans:
        arr, after = make_args(r0, r1, part, scratch)
        rc = call(launch, arr, stream)
        if rc != 0:
            raise RuntimeError(f"{ops.name} kernel failed to launch: "
                               f"{err_fn(rc).decode()} ({rc})")
        if after is not None:
            after()
    dw = torch.empty((total,), dtype=torch.float32, device=ops.device)
    rc = lib.wgrad_reduce(part.data_ptr(), n_split, total, dw.data_ptr(),
                          stream)
    if rc != 0:
        raise RuntimeError(f"{ops.name}: wgrad_reduce failed ({rc})")
    return dw


# the last call's scratch and chunk count, and the largest scratch of any
# call (chip_smoke.py reports them)
run_chunks.last = None
run_chunks.max_scratch = 0


def offsets(ws, base: int = 0):
    """Offsets of each operand's gradient in the flat buffer, and the end."""
    out, o = [], base
    for w in ws:
        out.append(o)
        o += w.numel()
    return out, o


def as_array(args) -> np.ndarray:
    return np.asarray(args, dtype=np.int64)


def call(fn, arr: np.ndarray, *extra):
    return fn(arr.ctypes.data_as(ctypes.c_void_p), len(arr), *extra)


def split(flat: torch.Tensor, ws) -> list:
    """The flat gradient buffer as one tensor per operand, in order."""
    out, o = [], 0
    for w in ws:
        out.append(flat[o:o + w.numel()].view(w.shape))
        o += w.numel()
    return out
