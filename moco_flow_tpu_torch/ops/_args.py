"""Argument arrays of the training kernels (``csrc/mlp_tile.cuh``).

The kernels take one int64 array over a plain C interface: integers as
they are, pointers as ``tensor.data_ptr()``. ``Operands`` keeps every tensor
whose pointer went into an array alive until the launch is queued, checks
device and contiguity, and lays out the flat fp32 weight-gradient buffer:
the gradient of the folded operand ``i`` sits at ``offset[i]``, in operand
order, so splitting the buffer by the operands' sizes gives the gradients
in the order autograd returns them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..nn.embedding import freq_bands
from .folds import _trunk_layers

MAX_DEPTH = 8        # mlp_tile.cuh kMaxDepth
MAX_WIDTH = 256      # mlp_tile.cuh kMaxWidth


class Operands:
    def __init__(self, name: str, device: torch.device, dtype: torch.dtype):
        self.name, self.device, self.dtype = name, device, dtype
        self.keep = []

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

    def mat(self, w) -> list:
        """A (K, N) matrix in the storage type, and its transpose."""
        m = w.to(self.dtype)
        return [self.ptr(m.contiguous()), self.ptr(m.T.contiguous())]

    def vec(self, b) -> int:
        return self.ptr(b.float().reshape(-1).contiguous())

    def bands(self, kc: int, logscale: bool) -> int:
        return self.ptr(torch.from_numpy(freq_bands(kc // 3, logscale))
                        .to(self.device))


def offsets(ws, base: int = 0):
    """Offsets of each operand's gradient in the flat buffer, and the end."""
    out, o = [], base
    for w in ws:
        out.append(o)
        o += w.numel()
    return out, o


def net_block(ops: Operands, ws, off, depth: int, width: int, kc: int,
              skips: tuple, logscale: bool, with_head: bool) -> list:
    """read_net's block: depth, width, kc, n_out, bands, 8 layers of
    (wpe, wpe^T, wh, wh^T, b, g_wpe, g_wh, g_b), head (w, w^T, b, g_w, g_b).
    With ``with_head`` the two operands after the trunk are the head."""
    ops.check(1 <= depth <= MAX_DEPTH, f"depth {depth} not in 1..{MAX_DEPTH}")
    ops.check(2 <= width <= MAX_WIDTH, f"width {width} not in 2..{MAX_WIDTH}")
    idx, rest = _trunk_layers(list(range(len(ws))), depth, skips)
    n_out = ws[rest[0]].shape[-1] if with_head else 0
    blk = [depth, width, kc, n_out, ops.bands(kc, logscale)]
    for layer in range(MAX_DEPTH):
        if layer < depth:
            ipe, ih, ib = idx[layer]
            pe = ops.mat(ws[ipe]) if ipe is not None else [0, 0]
            h = ops.mat(ws[ih]) if ih is not None else [0, 0]
            blk += pe + h + [ops.vec(ws[ib]),
                             off[ipe] if ipe is not None else 0,
                             off[ih] if ih is not None else 0, off[ib]]
        else:
            blk += [0] * 8
    if with_head:
        iw, ib = rest[0], rest[1]
        blk += ops.mat(ws[iw]) + [ops.vec(ws[ib]), off[iw], off[ib]]
    else:
        blk += [0] * 5
    return blk


def mat_block(ops: Operands, ws, off, iw: int, ib: int) -> list:
    """read_mat's block: w, w^T, b, g_w, g_b."""
    return ops.mat(ws[iw]) + [ops.vec(ws[ib]), off[iw], off[ib]]


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


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
