"""Neural motion Flow (NoF) MLP as plain functions over a parameter dict.

Port of ``moco_flow_tpu/nn/nof.py``: a D=4, W=128 MLP over positional-encoded
xyz and an embedded frame index, with a skip connection and either a direct
offset head or the log-quaternion head applied as ``(x - s) @ R + s + t``.
"""

from __future__ import annotations

import dataclasses

import torch

from .mlp import init_linear, linear, linear_relu
from .quaternion import log_quaternion_to_rotation_matrix


@dataclasses.dataclass(frozen=True)
class NoFConfig:
    depth: int = 4
    width: int = 128
    in_channels_xyz: int = 33
    skips: tuple = (2,)
    extra_feat_type: str = "ind"
    extra_feat_dim: int = 33
    use_quat: bool = True

    @property
    def in_dim(self) -> int:
        return self.in_channels_xyz + self.extra_feat_dim

    @classmethod
    def from_dict(cls, d: dict) -> "NoFConfig":
        return cls(
            depth=d.get("D", 4),
            width=d.get("W", 128),
            in_channels_xyz=d.get("in_channels_xyz", 33),
            skips=tuple(d.get("skips", (2,))),
            extra_feat_type=d.get("extra_feat_type", "ind"),
            extra_feat_dim=d.get("extra_feat_dim", 33),
            use_quat=d.get("use_quat", True),
        )


def init_nof(gen: torch.Generator, cfg: NoFConfig,
             device: torch.device | str = "cpu") -> dict:
    if cfg.extra_feat_type != "ind":
        raise ValueError(f"extra_feat_type {cfg.extra_feat_type} not supported")
    layers = []
    for i in range(cfg.depth):
        in_dim = cfg.in_dim if i == 0 else cfg.width
        if i in cfg.skips:
            in_dim = cfg.width + cfg.in_dim
        layers.append(init_linear(gen, in_dim, cfg.width, device))
    head_out = 9 if cfg.use_quat else 3
    return {"layers": layers,
            "head": init_linear(gen, cfg.width, head_out, device)}


def _head(params: dict, h: torch.Tensor, xyz: torch.Tensor, cfg: NoFConfig,
          compute_dtype=None) -> torch.Tensor:
    out = linear(params["head"], h, compute_dtype)
    if cfg.use_quat:
        v, s, t = out[..., 0:3], out[..., 3:6], out[..., 6:9]
        r = log_quaternion_to_rotation_matrix(v)
        # row-vector convention: (x - s) @ R + s + t
        rotated = torch.einsum("...i,...ij->...j", xyz - s, r)
        return rotated + s + t
    return out + xyz


def nof_apply_split(params: dict, xyz_emb: torch.Tensor, ind_emb: torch.Tensor,
                    n_samples: int, xyz: torch.Tensor, cfg: NoFConfig,
                    compute_dtype=None) -> torch.Tensor:
    """NoF forward with the per-ray frame embedding applied at ray rank.

    Args:
      xyz_emb: (N*S, in_channels_xyz) per-sample position embedding.
      ind_emb: (N, extra_feat_dim) per-ray index embedding.
      xyz: (N*S, 3) raw positions for the transform head.
    """
    cx, ce = cfg.in_channels_xyz, cfg.extra_feat_dim

    def dotp(x, w):
        y = x.float() @ w.float() if compute_dtype is None else \
            (x.to(compute_dtype).float() @ w.to(compute_dtype).float()
             ).to(compute_dtype)
        return y

    def bcast(per_ray):
        return per_ray.repeat_interleave(n_samples, dim=0)

    h = None
    for i in range(cfg.depth):
        w, b = params["layers"][i]["w"], params["layers"][i]["b"]
        if compute_dtype is not None:
            b = b.to(compute_dtype)
        if i == 0:
            h = torch.relu(dotp(xyz_emb, w[:cx]) + bcast(dotp(ind_emb, w[cx:]))
                           + b)
        elif i in cfg.skips:
            h = torch.relu(dotp(xyz_emb, w[:cx])
                           + bcast(dotp(ind_emb, w[cx:cx + ce]))
                           + dotp(h, w[cx + ce:]) + b)
        else:
            h = torch.relu(dotp(h, w) + b)
    return _head(params, h, xyz, cfg, compute_dtype)


def nof_apply(params: dict, inputs: torch.Tensor, xyz: torch.Tensor,
              cfg: NoFConfig, compute_dtype=None) -> torch.Tensor:
    """(B, in_channels_xyz + extra_feat_dim) embedded inputs, (B, 3)
    positions -> warped (B, 3); the skip concatenates the inputs before the
    hidden activation."""
    h = inputs
    for i in range(cfg.depth):
        if i in cfg.skips:
            h = torch.cat([inputs, h], dim=-1)
        h = linear_relu(params["layers"][i], h, compute_dtype)
    return _head(params, h, xyz, cfg, compute_dtype)
