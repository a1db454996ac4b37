"""Multiresolution hash-grid encoding of the NeRF's xyz (``encoding:
hashgrid``).

Port of ``moco_flow_tpu/nn/hashgrid.py``: L levels of F features each, one
stacked (L, T, F) table; each level's resolution is a host constant,
geometric from ``base_res`` to ``max_res``. A position in the
[-extent, extent] box (clamped onto it) picks its cell's 8 corners at each
level, densely indexed where the level's lattice fits in the table and
spatially hashed otherwise, and interpolates their features trilinearly in
fp32.

The encode is plain PyTorch: a gather from the table (``index_select``),
and through autograd an ``index_add`` into the table's gradient. JAX
computes it in XLA, outside any Pallas kernel (its module says why: no
vector gather in Mosaic), so there is no TPU kernel here to port; the MLP
behind it runs on the per-op NeRF kernel (#8).

torch has no uint32 multiply on CUDA. JAX's mod-2^32 hash is reproduced in
int64: each product ``coordinate * prime`` is below
(max_res + 1) * 2,654,435,761 < 2^63 and is masked to its low 32 bits
(``& 0xFFFFFFFF``) before the XORs, and the result is masked to
``table_size - 1``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# the spatial-hash primes of the JAX package (Teschner et al. 2003)
_PRIMES = (1, 2654435761, 805459861)
_LOW32 = 0xFFFFFFFF
# the 8 cell corners, (x, y, z)-major
_OFFSETS = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                     for z in (0, 1)], dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 8
    n_features: int = 2          # features per level
    log2_table_size: int = 16    # T = 2^this, per level
    base_res: int = 16
    max_res: int = 256
    extent: float = 1.5          # the world box [-extent, extent]^3

    @classmethod
    def from_dict(cls, d: dict | None) -> "HashGridConfig":
        d = d or {}
        return cls(
            n_levels=int(d.get("n_levels", 8)),
            n_features=int(d.get("n_features", 2)),
            log2_table_size=int(d.get("log2_table_size", 16)),
            base_res=int(d.get("base_res", 16)),
            max_res=int(d.get("max_res", 256)),
            extent=float(d.get("extent", 1.5)),
        )

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features

    def level_resolutions(self) -> np.ndarray:
        """Per-level grid resolutions, geometric from base_res to max_res."""
        if self.n_levels == 1:
            return np.array([self.base_res], dtype=np.int64)
        b = np.exp((np.log(self.max_res) - np.log(self.base_res))
                   / (self.n_levels - 1))
        return np.floor(self.base_res * b ** np.arange(self.n_levels)
                        ).astype(np.int64)


def init_hashgrid(gen: torch.Generator, cfg: HashGridConfig,
                  device: torch.device | str = "cpu") -> torch.Tensor:
    """(L, T, F) table, U(-1e-4, 1e-4), drawn from ``gen``."""
    t = torch.rand((cfg.n_levels, cfg.table_size, cfg.n_features),
                   generator=gen) * 2e-4 - 1e-4
    return t.to(device)


def _corner_indices(i0: torch.Tensor, res: int,
                    table_size: int) -> torch.Tensor:
    """(B, 3) int64 min-corner lattice coordinates -> (B, 8) table indices:
    dense linear indexing where the (res + 1)^3 lattice fits in the table,
    the XOR hash of the coordinates times the primes otherwise."""
    c = i0[:, None, :] + torch.from_numpy(_OFFSETS).to(i0.device)[None]
    n_verts = res + 1
    if n_verts ** 3 <= table_size:
        return (c[..., 0] * n_verts + c[..., 1]) * n_verts + c[..., 2]
    h = (c[..., 0] * _PRIMES[0]) & _LOW32
    h = h ^ ((c[..., 1] * _PRIMES[1]) & _LOW32)
    h = h ^ ((c[..., 2] * _PRIMES[2]) & _LOW32)
    return h & (table_size - 1)


def hashgrid_encode(table: torch.Tensor, x: torch.Tensor,
                    cfg: HashGridConfig) -> torch.Tensor:
    """Encode (B, 3) world positions through every level -> (B, L*F) fp32.
    Positions outside the box clamp to its boundary cell."""
    b_sz = x.shape[0]
    x01 = torch.clamp((x.float() / cfg.extent) * 0.5 + 0.5, 0.0, 1.0)
    feats = []
    for lvl, res in enumerate(cfg.level_resolutions()):
        res = int(res)
        pos = x01 * res
        # the truncation of a non-negative value is its floor
        i0 = torch.clamp(pos.to(torch.int32), 0, res - 1).long()
        frac = pos - i0.float()
        idx = _corner_indices(i0, res, cfg.table_size)          # (B, 8)
        corner = torch.index_select(table[lvl], 0, idx.reshape(-1)).reshape(
            b_sz, 8, cfg.n_features)
        wx = torch.stack([1.0 - frac[:, 0], frac[:, 0]], dim=1)
        wy = torch.stack([1.0 - frac[:, 1], frac[:, 1]], dim=1)
        wz = torch.stack([1.0 - frac[:, 2], frac[:, 2]], dim=1)
        w = (wx[:, :, None, None] * wy[:, None, :, None]
             * wz[:, None, None, :]).reshape(b_sz, 8)
        feats.append(torch.sum(w[..., None] * corner, dim=1))
    return torch.cat(feats, dim=-1)
