"""Model statics, parameters and render configs from config dicts.

Port of ``moco_flow_tpu/train/factory.py``. ``render_config`` reads
``mlp_impl`` (``model.mlp_impl``, or its argument) as a choice of kernels,
never of a kernel against its plain version (the device of the tensors
decides that: a CUDA tensor runs the kernel, a CPU tensor the plain
version): ``pallas`` takes the per-op route (kernels #8 / #9,
``ops/fused_mlp.py``); ``fused``, ``xla`` and ``auto`` take the whole-ray
kernels (#1-#7), since the port has no XLA route; the hybrids
``fused_nof`` / ``fused_nerf`` take the NoF on the whole-ray kernels and
the NeRF on rows (#8), or the reverse (#1 / #2 and #9). A hash-grid NeRF
(``encoding: hashgrid``) has no whole-ray kernel (JAX's has no fused
kernel for it either): ``fused``, ``fused_nerf`` and ``pallas`` raise as
JAX's do, and ``auto`` / ``xla`` resolve to ``fused_nof``, the port's
counterpart of JAX's all-XLA route for it: the NoF stays on the whole-ray
kernels like every other ``auto`` / ``xla`` config, and the NeRF goes to
#8.
"""

from __future__ import annotations

import torch

from ..nn.nerf import NeRFConfig, init_nerf
from ..nn.nof import NoFConfig, init_nof
from ..render.volume import EmbeddingSpec, ModelStatics, RenderConfig


def build_statics(model_cfg: dict) -> ModelStatics:
    """ModelStatics from the ``model:`` block."""
    def emb(name):
        return EmbeddingSpec.from_dict(model_cfg.get(name))

    coarse = NeRFConfig.from_dict(model_cfg["coarse_NeRF"]) \
        if model_cfg.get("coarse_NeRF") else NeRFConfig()
    fine = NeRFConfig.from_dict(model_cfg["fine_NeRF"]) \
        if model_cfg.get("fine_NeRF") and model_cfg.get("N_importance", 0) > 0 \
        else None
    nof = NoFConfig.from_dict(model_cfg["bw_NoF"]) \
        if model_cfg.get("bw_NoF") else None
    return ModelStatics(
        coarse=coarse, fine=fine, nof=nof,
        nerf_xyz=emb("nerf_embedding_xyz") or EmbeddingSpec(0),
        nerf_ind=emb("nerf_embedding_ind"),
        nerf_dir=emb("nerf_embedding_dir"),
        nof_xyz=emb("nof_embedding_xyz"),
        nof_ind=emb("nof_embedding_ind"),
    )


def init_params(gen: torch.Generator, statics: ModelStatics,
                with_nerf: bool = True, with_nof: bool = False,
                with_fw_nof: bool = False,
                device: torch.device | str = "cpu") -> dict:
    """Fresh parameters drawn from ``gen``; which networks exist follows the
    JAX package (fw_NoF only when chain losses are on)."""
    params = {}
    if with_nerf:
        params["coarse_NeRF"] = init_nerf(gen, statics.coarse, device)
        if statics.fine is not None:
            params["fine_NeRF"] = init_nerf(gen, statics.fine, device)
    if with_nof:
        assert statics.nof is not None
        params["bw_NoF"] = init_nof(gen, statics.nof, device)
        if with_fw_nof:
            params["fw_NoF"] = init_nof(gen, statics.nof, device)
    return params


_ROUTES = {"pallas": "pallas", "fused": "fused", "xla": "fused",
           "auto": "fused", "fused_nof": "fused_nof",
           "fused_nerf": "fused_nerf"}


def _uses_hashgrid(model_cfg: dict) -> bool:
    return any((model_cfg.get(k) or {}).get("encoding") == "hashgrid"
               for k in ("coarse_NeRF", "fine_NeRF"))


def render_config(model_cfg: dict, use_nof: bool = False,
                  chain_local: bool = False, chain_global: bool = False,
                  test_time: bool = False, perturb=None,
                  compute_dtype: str | None = None,
                  mlp_impl: str | None = None) -> RenderConfig:
    impl = mlp_impl or model_cfg.get("mlp_impl", "auto")
    if impl not in _ROUTES:
        raise ValueError(f"unknown mlp_impl {impl!r}")
    route = _ROUTES[impl]
    if _uses_hashgrid(model_cfg):
        if impl in ("fused", "fused_nerf", "pallas"):
            raise ValueError(
                f"mlp_impl={impl} has no hashgrid-encoding kernel path; use "
                "mlp_impl: xla (or auto) with encoding: hashgrid")
        # the NoF on the whole-ray kernels, the hash NeRF on rows (#8)
        route = "fused_nof"
    fine_budget = int(model_cfg.get("fine_budget", 0))
    coarse_probe = int(model_cfg.get("coarse_probe", 0))
    if not test_time:
        fine_budget = coarse_probe = 0
    elif (fine_budget or coarse_probe) and route != "fused":
        raise ValueError(
            f"fine_budget={fine_budget} / coarse_probe={coarse_probe} are "
            f"only implemented on the fused test-time route, but mlp_impl is "
            f"{impl!r}. Set them to 0 for an exact render, or use "
            "mlp_impl: fused.")
    return RenderConfig(
        n_samples=model_cfg.get("N_samples", 64),
        n_importance=model_cfg.get("N_importance", 0),
        use_disp=model_cfg.get("use_disp", False),
        perturb=model_cfg.get("perturb", 0.0) if perturb is None else perturb,
        noise_std=model_cfg.get("noise_std", 0.0),
        activation=model_cfg.get("nerf_activate_type", "relu"),
        use_nof=use_nof, chain_local=chain_local, chain_global=chain_global,
        test_time=test_time,
        compute_dtype=compute_dtype or model_cfg.get("compute_dtype",
                                                     "float32"),
        fine_budget=fine_budget,
        coarse_probe=coarse_probe,
        share_coarse_warps=bool(model_cfg.get("share_coarse_warps", True)),
        mlp_impl=route,
    )
