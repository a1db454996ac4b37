"""One layer of the wgmma row tile (``csrc/wg_tile.cuh``), as a card-only
test entry point.

The bf16 forward kernels #7 (``render_pass``) and #8 (``nerf_pallas``) run
every product on this tile. ``wg_layer`` runs a single one, ``a @ w + b``
on bf16 operands with fp32 accumulation, through the same producer, ring,
descriptors and epilogue (``csrc/wg_probe.cu``), so a layout or descriptor
mistake shows on one product before it shows in a whole network. Tests and
``chip_smoke.py`` hold it against ``wg_layer_ref``; no main path calls it.
"""

from __future__ import annotations

import torch

from ..nn.mlp import matmul
from . import _args


def wg_layer_ref(a: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Plain version: (rows, K) @ (K, N) on bf16 operands, fp32 sum, + b."""
    return matmul(a, w, torch.bfloat16) + b.float()


def wg_layer(a: torch.Tensor, w: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
    """The kernel on CUDA tensors (K up to 256, N up to 256); the plain
    version on CPU tensors."""
    if a.device.type == "cpu":
        return wg_layer_ref(a, w, b)
    from ._build import load_library
    rows, k = a.shape
    n = w.shape[1]
    ops = _args.Operands("wg_layer", a.device, torch.bfloat16)
    ops.check(tuple(w.shape) == (k, n) and 1 <= k <= 256
              and tuple(b.shape) == (n,), f"a {tuple(a.shape)}, w "
              f"{tuple(w.shape)}, b {tuple(b.shape)}")
    out = torch.empty((rows, n), dtype=torch.float32, device=a.device)
    arr = _args.as_array([rows, k, n, ops.ptr(a.float().contiguous()),
                          ops.ptr(_args.wg_pack(w)), ops.vec(b),
                          ops.ptr(out)])
    lib = load_library()
    rc = _args.call(lib.wg_probe_launch, arr,
                    torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wg_layer kernel failed to launch ({rc})")
    return out
