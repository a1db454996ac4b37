"""Canonical NeRF MLP as plain functions over a parameter dict.

Port of ``moco_flow_tpu/nn/nerf.py``: a D=8, W=256 density trunk over
positional-encoded xyz with a skip connection, a sigma head, and an rgb
branch conditioned on an extra feature (frame index, view direction or
nothing). The xyz input is the sinusoidal PE (embedded outside the net)
or, with ``encoding: hashgrid``, the features of a trainable hash grid
(``nn/hashgrid.py``) whose table is the ``hash`` leaf of the parameters.
``nerf_apply`` takes a per-sample extra feature (the per-op route),
``nerf_apply_perray_extra`` a per-ray one.
"""

from __future__ import annotations

import dataclasses

import torch

from .hashgrid import HashGridConfig, init_hashgrid
from .mlp import init_linear, linear, linear_relu


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    depth: int = 8
    width: int = 256
    in_channels_xyz: int = 63
    skips: tuple = (4,)
    extra_feat_type: str = "none"  # none | ind | dir
    extra_feat_dim: int = 0
    encoding: str = "pe"   # 'pe' | 'hashgrid'
    hash: HashGridConfig | None = None

    @classmethod
    def from_dict(cls, d: dict) -> "NeRFConfig":
        encoding = d.get("encoding", "pe")
        hash_cfg = None
        in_xyz = d.get("in_channels_xyz", 63)
        if encoding == "hashgrid":
            hash_cfg = HashGridConfig.from_dict(d.get("hash"))
            in_xyz = hash_cfg.out_dim    # the MLP's input: L*F features
        elif encoding != "pe":
            raise ValueError(f"unknown NeRF encoding '{encoding}' "
                             "(expected 'pe' or 'hashgrid')")
        return cls(
            depth=d.get("D", 8),
            width=d.get("W", 256),
            in_channels_xyz=in_xyz,
            skips=tuple(d.get("skips", (4,))),
            extra_feat_type=d.get("extra_feat_type", "none"),
            extra_feat_dim=d.get("extra_feat_dim", 0),
            encoding=encoding,
            hash=hash_cfg,
        )


def init_nerf(gen: torch.Generator, cfg: NeRFConfig,
              device: torch.device | str = "cpu") -> dict:
    """Parameter dict with the JAX package's tree structure (``trunk`` list,
    ``sigma``, ``final``, ``extra``, ``rgb``, and the hash table ``hash``
    under ``encoding: hashgrid``), seeded from ``gen``; the table is drawn
    after the layers, so a PE model draws what it always drew."""
    if cfg.extra_feat_type not in ("none", "ind", "dir"):
        raise ValueError(f"extra_feat_type {cfg.extra_feat_type} not supported")
    trunk = []
    for i in range(cfg.depth):
        in_dim = cfg.in_channels_xyz if i == 0 else cfg.width
        if i in cfg.skips:
            in_dim = cfg.width + cfg.in_channels_xyz
        trunk.append(init_linear(gen, in_dim, cfg.width, device))
    extra_in = cfg.width + (cfg.extra_feat_dim
                            if cfg.extra_feat_type != "none" else 0)
    params = {
        "trunk": trunk,
        "sigma": init_linear(gen, cfg.width, 1, device),
        "final": init_linear(gen, cfg.width, cfg.width, device),
        "extra": init_linear(gen, extra_in, cfg.width // 2, device),
        "rgb": init_linear(gen, cfg.width // 2, 3, device),
    }
    if cfg.encoding == "hashgrid":
        params["hash"] = init_hashgrid(gen, cfg.hash, device)
    return params


SIGMA_BRANCH = ("trunk", "sigma", "final")


def sigma_branch_params(params: dict) -> dict:
    """The density half of a NeRF: the trunk, the sigma head, ``final``
    and, under ``encoding: hashgrid``, the hash table (the rgb branch is
    ``extra`` / ``rgb``). The stage 1 -> 3 hand-over
    (``train/checkpoint.py::transfer_pretrained_nerf``) moves only
    ``SIGMA_BRANCH``, as JAX's does."""
    out = {k: params[k] for k in SIGMA_BRANCH}
    if "hash" in params:
        out["hash"] = params["hash"]
    return out


def nerf_trunk(params: dict, x_emb: torch.Tensor, cfg: NeRFConfig,
               compute_dtype=None) -> torch.Tensor:
    if compute_dtype is not None:
        x_emb = x_emb.to(compute_dtype)
    h = x_emb
    for i in range(cfg.depth):
        if i in cfg.skips:
            h = torch.cat([x_emb, h], dim=-1)
        h = linear_relu(params["trunk"][i], h, compute_dtype)
    return h


def nerf_sigma(params: dict, x_emb: torch.Tensor, cfg: NeRFConfig,
               compute_dtype=None) -> torch.Tensor:
    """Density only, (B, 1)."""
    h = nerf_trunk(params, x_emb, cfg, compute_dtype)
    return linear(params["sigma"], h, compute_dtype)


def nerf_apply_perray_extra(params: dict, x_emb: torch.Tensor,
                            extra_emb: torch.Tensor | None, n_samples: int,
                            cfg: NeRFConfig, compute_dtype=None) -> torch.Tensor:
    """(N*S, in_channels_xyz) [+ per-ray (N, E)] -> (N*S, 4) rgb + sigma.

    The extra feature stays at ray rank: its weight rows are applied per ray
    and broadcast over the ray's ``n_samples`` samples."""
    h = nerf_trunk(params, x_emb, cfg, compute_dtype)
    sigma = linear(params["sigma"], h, compute_dtype)
    hf = linear(params["final"], h, compute_dtype, out_dtype=compute_dtype)
    we, be = params["extra"]["w"], params["extra"]["b"]
    if cfg.extra_feat_type != "none":
        assert extra_emb is not None
        w_f, w_e = we[:cfg.width], we[cfg.width:]
        per_ray = linear({"w": w_e, "b": torch.zeros_like(be)}, extra_emb,
                         compute_dtype, out_dtype=compute_dtype)
        bcast = per_ray.repeat_interleave(n_samples, dim=0)
        he = torch.relu(linear({"w": w_f, "b": be}, hf, compute_dtype,
                               out_dtype=compute_dtype) + bcast)
    else:
        he = torch.relu(linear(params["extra"], hf, compute_dtype))
    rgb = torch.sigmoid(linear(params["rgb"], he, compute_dtype))
    return torch.cat([rgb, sigma], dim=-1)


def nerf_apply(params: dict, x_emb: torch.Tensor,
               extra_emb: torch.Tensor | None, cfg: NeRFConfig,
               compute_dtype=None) -> torch.Tensor:
    """(B, in_channels_xyz) [+ per-sample (B, extra_feat_dim)] -> (B, 4)
    rgb + sigma, the extra feature concatenated to ``final``'s output (fp32)
    before the extra layer. ``x_emb`` is zero-padded to
    ``in_channels_xyz``."""
    h = nerf_trunk(params, x_emb, cfg, compute_dtype)
    sigma = linear(params["sigma"], h, compute_dtype)
    hf = linear(params["final"], h, compute_dtype)
    if cfg.extra_feat_type != "none":
        assert extra_emb is not None
        hf = torch.cat([hf, extra_emb.to(hf.dtype)], dim=-1)
    he = torch.relu(linear(params["extra"], hf, compute_dtype))
    rgb = torch.sigmoid(linear(params["rgb"], he, compute_dtype))
    return torch.cat([rgb, sigma], dim=-1)
