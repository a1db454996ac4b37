"""Volume renderer: the test-time branch and the training branch.

Port of ``moco_flow_tpu/render/volume.py``'s ``render_rays`` on the fused
path.

- Test time: stratified depths, a sigma-only coarse pass (optionally on a
  strided probe of the depths), deterministic importance sampling, the
  optional fine-sample budget, and the full fine pass. Each pass is one
  :func:`render_pass` call, so the (N, S, 3) sample and warp tensors never
  exist in device memory.
- Training (the transposed ``t_mode`` of the JAX package: every sample,
  warp and rgb tensor is (3, N, S)): jittered depths, the bw + fw NoF warp
  chain of :func:`nof_chain_rays_t` on the coarse samples, the coarse NeRF
  (:func:`nerf_fused_rays_t`), the coarse consensus terms, random
  importance depths, the chain on the new samples only, the depth merge of
  the two warped sets, the fine NeRF and the fine consensus terms. Random
  numbers come in a :class:`Draws` record.

A training render with the NoF but without a warp chain (the val step's)
warps each sample set once through the single-warp NoF kernel
(:func:`nof_warp`, :func:`nof_fused_rays`); with ``perturb == 0`` it draws
nothing and needs no ``Draws``. With ``noise_std > 0`` a training render
adds ``noise_std`` times the ``Draws``' standard normals to the raw sigmas
of each pass before the activation, in the coarse pass too; a render
without ``Draws`` (the val step's) adds none, where JAX's val step adds
noise from a fixed key.

``mlp_impl: pallas`` (``RenderConfig.mlp_impl``) takes the per-op route
instead, the JAX package's row-major branch (:func:`_render_rows`): the
sample and warp tensors are (N, S, 3), positions are embedded in PyTorch
and every MLP evaluation is one call of the per-op kernels (#8 the NeRF, #9
the NoF; ``ops/fused_mlp.py``) through the funnels :func:`_eval_nerf` and
:func:`_eval_nof`. It renders stage 1's training and val steps (no NoF),
stage 3's training and val steps (the bw warp and the chains as separate
NoF evaluations, the consensus terms on (N, S, 3) tensors) and the stage-3
test render (the bw warp of each sample set, a sigma-only coarse pass, the
fine pass on the depth-merged warps).

The hybrids take the same row-major branch, as JAX routes them (its
``t_mode`` is off for them), in training and at test time:
``mlp_impl: fused_nof`` runs the NoF warps on the whole-ray kernels (#3,
and the chains #5/#6 in training; the (N, S, 3) samples are moved to the
transposed (3, N, S) layout of :func:`nof_chain_rays_t` and back) and the
NeRF on embedded rows (#8); ``fused_nerf`` the NeRF on the transposed
whole-ray kernel #1/#2 (#1 alone at test time, the sigma-only coarse pass
included) and the NoF on rows (#9). Neither runs the test-time pass #7,
which only ``fused`` takes. A hash-grid NeRF (``encoding: hashgrid``) is
encoded in PyTorch (``nn/hashgrid.py``) and evaluated on rows (#8).
"""

from __future__ import annotations

import dataclasses

import torch

from ..nn.embedding import posenc
from ..nn.hashgrid import hashgrid_encode
from ..nn.nerf import NeRFConfig
from ..nn.nof import NoFConfig
from ..nn.losses import masked_mean
from ..ops.fused_mlp import nerf_fused, nof_fused
from ..ops.nerf_rays import nerf_fused_rays_t
from ..ops.nof_chain import nof_chain_rays_t
from ..ops.nof_rays import nof_fused_rays
from ..ops.render_pass import render_pass
from ..utils.logging import span
from .sampling import (compact_fine_samples, merge_cano_by_z,
                       merge_cano_by_z_t, sample_pdf, stratified_zvals,
                       unsort_by_pos)

@dataclasses.dataclass(frozen=True)
class EmbeddingSpec:
    """Positional-encoding spec (the annealing weights are passed apart)."""
    n_freqs: int
    logscale: bool = True
    in_channels: int = 3

    @classmethod
    def from_dict(cls, d: dict | None) -> "EmbeddingSpec | None":
        if d is None:
            return None
        return cls(n_freqs=d.get("N_freqs", 0),
                   logscale=d.get("logscale", True),
                   in_channels=d.get("in_channels", 3))


@dataclasses.dataclass(frozen=True)
class ModelStatics:
    """Every static model config of a stage-3 model."""
    coarse: NeRFConfig
    fine: NeRFConfig | None = None
    nof: NoFConfig | None = None
    nerf_xyz: EmbeddingSpec = EmbeddingSpec(10)
    nerf_ind: EmbeddingSpec | None = None
    nerf_dir: EmbeddingSpec | None = None
    nof_xyz: EmbeddingSpec | None = None
    nof_ind: EmbeddingSpec | None = None


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render-time options. There is no switch between a kernel and its
    plain version: the device of the rays decides (CUDA runs the kernel,
    the CPU the plain version). ``mlp_impl`` picks the kernels: 'pallas'
    the per-op route (#8 / #9), 'fused' the whole-ray kernels (#1-#7),
    'fused_nof' / 'fused_nerf' the hybrids (the NoF on #3-#6 and the NeRF
    on #8; the NeRF on #1 / #2 and the NoF on #9)."""
    n_samples: int = 64
    n_importance: int = 0
    use_disp: bool = False
    perturb: float = 0.0
    noise_std: float = 0.0
    activation: str = "relu"  # 'relu' | 'softplus'
    use_nof: bool = False
    chain_local: bool = False
    chain_global: bool = False
    test_time: bool = False
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
    share_coarse_warps: bool = True
    fine_budget: int = 0   # keep this many fine samples (0 = all, exact)
    coarse_probe: int = 0  # strided coarse probe size (0 = all, exact)
    mlp_impl: str = "fused"  # 'fused' | 'pallas' | 'fused_nof' | 'fused_nerf'

    @property
    def nof_fused(self) -> bool:
        return self.mlp_impl in ("fused", "fused_nof")

    @property
    def nerf_fused(self) -> bool:
        return self.mlp_impl in ("fused", "fused_nerf")

    @property
    def dtype(self):
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else None


def embed_padded(x: torch.Tensor, spec: EmbeddingSpec, target_dim: int,
                 weights: torch.Tensor | None = None) -> torch.Tensor:
    """posenc + zero-pad to the model's static input width."""
    emb = posenc(x, spec.n_freqs, spec.logscale, weights)
    pad = target_dim - emb.shape[-1]
    if pad < 0:
        raise ValueError(
            f"embedding width {emb.shape[-1]} exceeds target {target_dim}")
    if pad:
        emb = torch.cat([emb, emb.new_zeros((*emb.shape[:-1], pad))], dim=-1)
    return emb


def encode_nerf_xyz(nerf_params: dict, nerf_cfg: NeRFConfig,
                    statics: "ModelStatics", flat: torch.Tensor,
                    anneal: dict) -> torch.Tensor:
    """(M, 3) positions -> the NeRF's input features: the annealed
    sinusoidal PE, zero-padded to ``in_channels_xyz``, or the hash-grid
    features of ``nerf_params['hash']`` (``encoding: hashgrid``), through
    which the table's gradient flows."""
    if nerf_cfg.encoding == "hashgrid":
        return hashgrid_encode(nerf_params["hash"], flat, nerf_cfg.hash)
    return embed_padded(flat, statics.nerf_xyz, nerf_cfg.in_channels_xyz,
                        anneal.get("nerf_xyz"))


def _eval_nerf(params: dict, cfg: NeRFConfig, x_emb: torch.Tensor,
               extra_emb: torch.Tensor | None, sigma_only: bool,
               rcfg: "RenderConfig") -> torch.Tensor:
    """The per-op route's NeRF funnel: embedded rows through kernel #8."""
    return nerf_fused(params, cfg, x_emb, extra_emb, sigma_only,
                      compute_dtype=rcfg.dtype)


def _eval_nof(params: dict, cfg: NoFConfig, inputs: torch.Tensor,
              xyz: torch.Tensor, rcfg: "RenderConfig") -> torch.Tensor:
    """The per-op route's NoF funnel: embedded rows through kernel #9."""
    return nof_fused(params, cfg, inputs, xyz, compute_dtype=rcfg.dtype)


def nof_warp(params: dict, statics: "ModelStatics", anneal: dict,
             xyz: torch.Tensor, ind: torch.Tensor,
             rcfg: "RenderConfig") -> torch.Tensor:
    """Warp (N, S, 3) sample positions through one NoF, the frame index
    ``ind`` (N, 1) per ray: with the single-warp kernel (``fused``,
    ``fused_nof``), or under ``pallas`` / ``fused_nerf`` as embedded rows
    ``[xyz_emb, ind_emb]`` (the frame embedding broadcast to every sample)
    through :func:`_eval_nof`. Returns (N, S, 3)."""
    cfg = statics.nof
    ind_emb = embed_padded(ind, statics.nof_ind, cfg.extra_feat_dim)
    if rcfg.nof_fused:
        return nof_fused_rays(params, cfg, statics.nof_xyz.n_freqs,
                              statics.nof_xyz.logscale,
                              anneal.get("nof_xyz"), xyz, ind_emb,
                              compute_dtype=rcfg.dtype)
    n, s = xyz.shape[0], xyz.shape[1]
    flat = xyz.reshape(-1, 3)
    xyz_emb = embed_padded(flat, statics.nof_xyz, cfg.in_channels_xyz,
                           anneal.get("nof_xyz"))
    bc = ind_emb[:, None, :].expand(n, s, cfg.extra_feat_dim)
    inputs = torch.cat([xyz_emb, bc.reshape(-1, cfg.extra_feat_dim)], dim=-1)
    return _eval_nof(params, cfg, inputs, flat, rcfg).reshape(n, s, 3)


def _extra_embedding(nerf_cfg: NeRFConfig, statics: "ModelStatics",
                     ind: torch.Tensor, direction: torch.Tensor, n: int,
                     s: int) -> torch.Tensor | None:
    """The per-ray extra feature (frame-index or view-direction PE)
    broadcast to every sample, (N*S, E), or None."""
    if nerf_cfg.extra_feat_type == "ind":
        e = embed_padded(ind, statics.nerf_ind, nerf_cfg.extra_feat_dim)
    elif nerf_cfg.extra_feat_type == "dir":
        e = embed_padded(direction, statics.nerf_dir, nerf_cfg.extra_feat_dim)
    else:
        return None
    e = e[:, None, :].expand(n, s, nerf_cfg.extra_feat_dim)
    return e.reshape(-1, nerf_cfg.extra_feat_dim)


def composite(sigmas: torch.Tensor, z_vals: torch.Tensor,
              dir_norm: torch.Tensor, noise: torch.Tensor | None,
              activation: str, deltas: torch.Tensor | None = None):
    """sigma -> (alphas, weights) by the NeRF quadrature; ``deltas``
    overrides the adjacent-z spacing (compacted sample sets keep theirs)."""
    if deltas is None:
        deltas = z_vals[:, 1:] - z_vals[:, :-1]
        deltas = torch.cat([deltas, torch.full_like(deltas[:, :1], 1e10)],
                           dim=-1)
    deltas = deltas * dir_norm
    if noise is not None:
        sigmas = sigmas + noise
    act = torch.relu if activation == "relu" else torch.nn.functional.softplus
    alphas = 1.0 - torch.exp(-deltas * act(sigmas))
    shifted = torch.cat([torch.ones_like(alphas[:, :1]),
                         1.0 - alphas + 1e-10], dim=-1)
    weights = alphas * torch.cumprod(shifted, dim=-1)[:, :-1]
    return alphas, weights


def _composite_tail(rgbs, sigmas, z_vals, dir_norm, noise,
                    rcfg: RenderConfig, background, deltas=None,
                    transposed_rgb: bool = False):
    """Quadrature + weighted rgb/depth + background blend. ``rgbs`` is
    (3, N, S) when ``transposed_rgb`` (the pass's layout), else (N, S, 3)."""
    alphas, weights = composite(sigmas, z_vals, dir_norm, noise,
                                rcfg.activation, deltas=deltas)
    if transposed_rgb:
        rgb = torch.sum(weights[None] * rgbs, dim=-1).T
    else:
        rgb = torch.sum(weights[..., None] * rgbs, dim=-2)
    depth = torch.sum(weights * z_vals, dim=-1)
    if background is not None:
        rgb = rgb + background * (1.0 - torch.sum(weights, dim=-1,
                                                  keepdim=True))
    return rgb, depth, weights, alphas


def _fused_test_pass(params: dict, nerf_key: str, statics: ModelStatics,
                     anneal: dict, rays_o, rays_d, img_ind, z_vals,
                     dir_norm, background, use_nof: bool, weights_only: bool,
                     rcfg: RenderConfig, deltas=None):
    """One test-time pass through :func:`render_pass` and compositing."""
    nerf_cfg = statics.coarse if nerf_key == "coarse_NeRF" else (
        statics.fine or statics.coarse)
    if weights_only or nerf_cfg.extra_feat_type == "none":
        extra = None
    elif nerf_cfg.extra_feat_type == "ind":
        extra = embed_padded(img_ind, statics.nerf_ind,
                             nerf_cfg.extra_feat_dim)
    else:
        extra = embed_padded(rays_d, statics.nerf_dir,
                             nerf_cfg.extra_feat_dim)
    ind_emb = None
    nof_cfg = statics.nof
    if use_nof:
        ind_emb = embed_padded(img_ind, statics.nof_ind,
                               nof_cfg.extra_feat_dim)
    sigmas, rgbs = render_pass(
        params, nerf_key, nerf_cfg, nof_cfg,
        statics.nerf_xyz.n_freqs,
        statics.nof_xyz.n_freqs if statics.nof_xyz else 0,
        statics.nerf_xyz.logscale,
        statics.nof_xyz.logscale if statics.nof_xyz else True,
        anneal.get("nerf_xyz"), anneal.get("nof_xyz"),
        rays_o, rays_d, z_vals, extra, ind_emb,
        use_nof=use_nof, sigma_only=weights_only,
        compute_dtype=rcfg.dtype)
    if weights_only:
        alphas, weights = composite(sigmas, z_vals, dir_norm, None,
                                    rcfg.activation, deltas=deltas)
        return None, None, weights, alphas
    return _composite_tail(rgbs, sigmas, z_vals, dir_norm, None, rcfg,
                           background, deltas=deltas, transposed_rgb=True)


def nerf_inference(params: dict, nerf_cfg: NeRFConfig, statics: ModelStatics,
                   anneal: dict, xyz_t: torch.Tensor, ind: torch.Tensor,
                   direction: torch.Tensor, z_vals: torch.Tensor,
                   rcfg: RenderConfig, background=None,
                   weights_only: bool = False, noise=None):
    """A NeRF on every sample of a ray batch through the whole-ray kernel
    #1 (#2 its backward), then compositing; ``noise`` (N, S) is added to
    the raw sigmas.

    ``xyz_t``: (3, N, S) sample positions (the fused path's transposed
    layout). Returns ``(rgb, depth, weights, alphas)``; rgb and depth are
    None when ``weights_only``."""
    dir_norm = torch.linalg.norm(direction, dim=-1, keepdim=True)
    if weights_only or nerf_cfg.extra_feat_type == "none":
        extra = None
    elif nerf_cfg.extra_feat_type == "ind":
        extra = embed_padded(ind, statics.nerf_ind, nerf_cfg.extra_feat_dim)
    else:
        extra = embed_padded(direction, statics.nerf_dir,
                             nerf_cfg.extra_feat_dim)
    out_t = nerf_fused_rays_t(params, nerf_cfg, statics.nerf_xyz.n_freqs,
                              statics.nerf_xyz.logscale,
                              anneal.get("nerf_xyz"), xyz_t, extra,
                              sigma_only=weights_only,
                              compute_dtype=rcfg.dtype)
    if weights_only:
        alphas, weights = composite(out_t[0], z_vals, dir_norm, noise,
                                    rcfg.activation)
        return None, None, weights, alphas
    return _composite_tail(out_t[0:3], out_t[3], z_vals, dir_norm, noise,
                           rcfg, background, transposed_rgb=True)


def nerf_inference_rows(params: dict, nerf_cfg: NeRFConfig,
                        statics: ModelStatics, anneal: dict,
                        xyz: torch.Tensor, ind: torch.Tensor,
                        direction: torch.Tensor, z_vals: torch.Tensor,
                        rcfg: RenderConfig, background=None,
                        weights_only: bool = False, noise=None):
    """:func:`nerf_inference` on the row-major branch: ``xyz`` (N, S, 3) is
    embedded (and the extra feature broadcast to every sample) here, and the
    NeRF runs through :func:`_eval_nerf`; under ``fused_nerf`` it goes to
    :func:`nerf_inference` in the transposed layout instead."""
    if rcfg.nerf_fused:
        return nerf_inference(params, nerf_cfg, statics, anneal,
                              xyz.permute(2, 0, 1).contiguous(), ind,
                              direction, z_vals,
                              rcfg, background=background,
                              weights_only=weights_only, noise=noise)
    n, s = xyz.shape[0], xyz.shape[1]
    dir_norm = torch.linalg.norm(direction, dim=-1, keepdim=True)
    x_emb = encode_nerf_xyz(params, nerf_cfg, statics, xyz.reshape(-1, 3),
                            anneal)
    if weights_only:
        sigmas = _eval_nerf(params, nerf_cfg, x_emb, None, True, rcfg)
        alphas, weights = composite(sigmas.reshape(n, s), z_vals, dir_norm,
                                    noise, rcfg.activation)
        return None, None, weights, alphas
    extra = _extra_embedding(nerf_cfg, statics, ind, direction, n, s)
    out = _eval_nerf(params, nerf_cfg, x_emb, extra, False,
                     rcfg).reshape(n, s, 4)
    return _composite_tail(out[..., :3], out[..., 3], z_vals, dir_norm,
                           noise, rcfg, background)


def _consensus(disp_src: torch.Tensor, disp_rec: torch.Tensor,
               alphas: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Masked-mean consensus disparity: the per-sample mean |src - recon|
    over xyz (``axis`` 0 of (3, N, S) tensors, -1 of (N, S, 3) ones),
    masked by alpha >= 0.01."""
    per_sample = torch.mean(torch.abs(disp_src - disp_rec), dim=axis)
    return masked_mean(per_sample, alphas >= 0.01)


def _consensus_parts(parts, axis: int = 0) -> torch.Tensor:
    """:func:`_consensus` over the concatenation of ``parts`` (each
    ``(disp_src, disp_rec, alphas)``), as summed numerators and
    denominators, without concatenating."""
    num = den = tot = 0.0
    cnt = 0
    for src, rec, alphas in parts:
        per = torch.mean(torch.abs(src - rec), dim=axis)
        m = (alphas >= 0.01).to(per.dtype)
        num = num + torch.sum(per * m)
        den = den + torch.sum(m)
        tot = tot + torch.sum(per)
        cnt += per.numel()
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0),
                       tot / cnt)


def _consensus_names(rcfg: RenderConfig, use_nof: bool) -> list:
    """(warp key, result name) of the consensus terms a training render
    returns."""
    return [(k, f"nof_{name}_disp") for k, name, on in (
        ("recon", "local", rcfg.chain_local),
        ("chain_recon", "global", rcfg.chain_global))
        if use_nof and on and not rcfg.test_time]


def _fine_consensus(result: dict, consensus: list, rcfg: RenderConfig,
                    alphas_f, fine_pos, halves, whole, axis: int):
    """The fine pass's consensus terms. Under ``share_coarse_warps`` the
    fine alphas go back to concatenation order and the terms are summed over
    the coarse and new ``halves`` (each ``(xyz, warps)``), which is the
    consensus over the sorted union; otherwise over ``whole``."""
    if not consensus:
        return
    if rcfg.share_coarse_warps:
        alphas_cat = unsort_by_pos(fine_pos, alphas_f)
        alphas = (alphas_cat[:, :rcfg.n_samples],
                  alphas_cat[:, rcfg.n_samples:])
        for k, name in consensus:
            result[f"{name}_fine"] = _consensus_parts(
                [(xyz, w[k], a) for (xyz, w), a in zip(halves, alphas)],
                axis)
    else:
        xyz, w = whole
        for k, name in consensus:
            result[f"{name}_fine"] = _consensus(xyz, w[k], alphas_f, axis)


def _chained_ind(rays: torch.Tensor, rcfg: RenderConfig, use_nof: bool):
    """The chained-frame index column of a global-chain training render."""
    if not (use_nof and rcfg.chain_global and not rcfg.test_time):
        return None
    if rays.shape[-1] < 10:
        raise ValueError(f"chain_global needs 10-wide rays (got "
                         f"{rays.shape[-1]}): append the chained-frame "
                         "index column")
    return rays[:, 9:10]


def _chain_warps(params: dict, statics: ModelStatics, anneal: dict,
                 rcfg: RenderConfig, xyz_t: torch.Tensor, img_ind,
                 chained_ind) -> dict:
    """The bw warp and the chains that are on of (3, N, S) samples in one
    kernel (#5 / #6): ``cano``, ``recon`` and ``chain_recon`` (None where
    its chain is off), each (3, N, S)."""
    cfg = statics.nof
    ind_emb = embed_padded(img_ind, statics.nof_ind, cfg.extra_feat_dim)
    ch_emb = (embed_padded(chained_ind, statics.nof_ind, cfg.extra_feat_dim)
              if rcfg.chain_global else None)
    cano, recon, chain_recon = nof_chain_rays_t(
        params, cfg, statics.nof_xyz.n_freqs, statics.nof_xyz.logscale,
        anneal.get("nof_xyz"), xyz_t, ind_emb, ch_emb, rcfg.chain_local,
        rcfg.chain_global, compute_dtype=rcfg.dtype)
    return {"cano": cano, "recon": recon, "chain_recon": chain_recon}


def _check_train(rcfg: RenderConfig, draws):
    if draws is None and rcfg.perturb > 0:
        raise ValueError("a perturbed training render needs its Draws")


def _sigma_noise(rcfg: RenderConfig, draws, which: str):
    """``noise_std`` times the Draws' sigma noise of a pass (``coarse`` or
    ``fine``), or None: at test time, without noise, or without Draws."""
    if rcfg.noise_std <= 0 or rcfg.test_time or draws is None:
        return None
    noise = getattr(draws, f"sigma_noise_{which}")
    if noise is None:
        raise ValueError(f"noise_std > 0: the Draws carry no sigma noise of "
                         f"the {which} pass (draw them with noise_std)")
    return noise * rcfg.noise_std


def _render_rows(params: dict, statics: ModelStatics, anneal: dict,
                 rays: torch.Tensor, background, rcfg: RenderConfig,
                 draws) -> dict:
    """:func:`render_rays` on the JAX package's row-major branch, for the
    per-op route (``mlp_impl: pallas``) and the hybrids: every NoF
    evaluation is one :func:`nof_warp` (kernel #9; #3 under ``fused_nof``),
    every NeRF pass one :func:`nerf_inference_rows` (#8; #1 / #2 under
    ``fused_nerf``). In training with the NoF, each sample set runs the bw
    warp and the chains that are on (local: fw(cano); global: fw -> bw at
    the chained frame, then fw at the ray's frame), under ``fused_nof`` as
    one chain kernel (#5 / #6); under ``share_coarse_warps`` the fine pass
    warps only the new depths and depth-merges them with the coarse
    warps."""
    use_nof = rcfg.use_nof and statics.nof is not None
    if rcfg.fine_budget or rcfg.coarse_probe:
        raise ValueError("fine_budget / coarse_probe are implemented on the "
                         "fused test-time route only, not on mlp_impl: "
                         f"{rcfg.mlp_impl}")
    if not rcfg.test_time:
        _check_train(rcfg, draws)
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    img_ind = rays[:, 8:9]
    chained_ind = _chained_ind(rays, rcfg, use_nof)
    z_vals = stratified_zvals(near, far, rcfg.n_samples, rcfg.use_disp,
                              rcfg.perturb,
                              u=None if draws is None else draws.perturb)
    consensus = _consensus_names(rcfg, use_nof)

    def at(z):
        return rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]

    def warp(net, xyz, ind):
        return nof_warp(params[net], statics, anneal, xyz, ind, rcfg)

    chains = (use_nof and not rcfg.test_time
              and (rcfg.chain_local or rcfg.chain_global))

    def warp_stack(xyz):
        if chains and rcfg.nof_fused:
            # the whole chain in one kernel, on the transposed layout
            out = _chain_warps(params, statics, anneal, rcfg,
                               xyz.permute(2, 0, 1).contiguous(), img_ind,
                               chained_ind)
            return {k: v.permute(1, 2, 0) for k, v in out.items()
                    if v is not None}
        cano = warp("bw_NoF", xyz, img_ind)
        out = {"cano": cano}
        if rcfg.chain_local and not rcfg.test_time:
            out["recon"] = warp("fw_NoF", cano, img_ind)
        if chained_ind is not None:
            chained = warp("fw_NoF", cano, chained_ind)
            out["chain_recon"] = warp(
                "fw_NoF", warp("bw_NoF", chained, chained_ind), img_ind)
        return out

    result: dict = {}
    xyz_coarse = at(z_vals)
    warped_c = warp_stack(xyz_coarse) if use_nof else None
    # sigma-only coarse pass at test time when a fine pass follows
    coarse_weights_only = rcfg.n_importance > 0 and rcfg.test_time
    rgb_c, depth_c, weights_c, alphas_c = nerf_inference_rows(
        params["coarse_NeRF"], statics.coarse, statics, anneal,
        warped_c["cano"] if use_nof else xyz_coarse, img_ind, rays_d,
        z_vals, rcfg, background=background,
        weights_only=coarse_weights_only,
        noise=_sigma_noise(rcfg, draws, "coarse"))
    result["opacity_coarse"] = torch.sum(weights_c, dim=1)
    if not coarse_weights_only:
        result["rgb_coarse"] = rgb_c
        result["depth_coarse"] = depth_c
    for k, name in consensus:
        result[f"{name}_coarse"] = _consensus(xyz_coarse, warped_c[k],
                                              alphas_c, -1)
    if rcfg.n_importance <= 0:
        return result
    z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
    with span("render.sample_pdf"):
        z_fine = sample_pdf(z_mid, weights_c[:, 1:-1], rcfg.n_importance,
                            det=(rcfg.perturb == 0),
                            u=None if draws is None else draws.pdf).detach()
    fine_pos = xyz_new = warped_new = xyz_fine = warped_f = None
    if use_nof and rcfg.share_coarse_warps:
        # warp only the new samples and depth-merge them with the coarse
        # warps (the same networks on the same points)
        xyz_new = at(z_fine)
        warped_new = warp_stack(xyz_new)
        z_all, fine_input, fine_pos = merge_cano_by_z(
            z_vals, z_fine, warped_c["cano"], warped_new["cano"])
    else:
        z_all = torch.sort(torch.cat([z_vals, z_fine], dim=-1),
                           dim=-1).values
        xyz_fine = at(z_all)
        warped_f = warp_stack(xyz_fine) if use_nof else None
        fine_input = warped_f["cano"] if use_nof else xyz_fine
    rgb_f, depth_f, weights_f, alphas_f = nerf_inference_rows(
        params["fine_NeRF"], statics.fine or statics.coarse, statics,
        anneal, fine_input, img_ind, rays_d, z_all, rcfg,
        background=background, noise=_sigma_noise(rcfg, draws, "fine"))
    result["rgb_fine"] = rgb_f
    result["depth_fine"] = depth_f
    result["opacity_fine"] = torch.sum(weights_f, dim=1)
    _fine_consensus(result, consensus, rcfg, alphas_f, fine_pos,
                    ((xyz_coarse, warped_c), (xyz_new, warped_new)),
                    (xyz_fine, warped_f), -1)
    return result


def _render_train(params: dict, statics: ModelStatics, anneal: dict,
                  rays: torch.Tensor, background, rcfg: RenderConfig,
                  draws) -> dict:
    """The training branch of :func:`render_rays` (see the module note)."""
    _check_train(rcfg, draws)
    use_nof = rcfg.use_nof and statics.nof is not None
    chains = rcfg.chain_local or rcfg.chain_global
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    img_ind = rays[:, 8:9]
    chained_ind = _chained_ind(rays, rcfg, use_nof)
    z_vals = stratified_zvals(near, far, rcfg.n_samples, rcfg.use_disp,
                              rcfg.perturb,
                              u=None if draws is None else draws.perturb)
    o_t, d_t = rays_o.T, rays_d.T                               # (3, N)
    xyz_coarse = o_t[:, :, None] + d_t[:, :, None] * z_vals[None]

    def warp_stack(xyz_t):
        """bw warp + local / global chains of one sample set, (3, N, S);
        without a chain, the bw warp alone through the single-warp kernel
        (on the row-major layout, as JAX's chain-off branch)."""
        if not chains:
            cano = nof_warp(params["bw_NoF"], statics, anneal,
                            xyz_t.permute(1, 2, 0), img_ind, rcfg)
            return {"cano": cano.permute(2, 0, 1)}
        return _chain_warps(params, statics, anneal, rcfg, xyz_t, img_ind,
                            chained_ind)

    result: dict = {}
    warped_c = warp_stack(xyz_coarse) if use_nof else None
    rgb_c, depth_c, weights_c, alphas_c = nerf_inference(
        params["coarse_NeRF"], statics.coarse, statics, anneal,
        warped_c["cano"] if use_nof else xyz_coarse, img_ind, rays_d,
        z_vals, rcfg, background=background,
        noise=_sigma_noise(rcfg, draws, "coarse"))
    result["opacity_coarse"] = torch.sum(weights_c, dim=1)
    result["rgb_coarse"] = rgb_c
    result["depth_coarse"] = depth_c
    consensus = _consensus_names(rcfg, use_nof)
    for k, name in consensus:
        result[f"{name}_coarse"] = _consensus(xyz_coarse, warped_c[k],
                                              alphas_c)
    if rcfg.n_importance <= 0:
        return result

    z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
    with span("render.sample_pdf"):
        z_fine = sample_pdf(z_mid, weights_c[:, 1:-1], rcfg.n_importance,
                            det=(rcfg.perturb == 0),
                            u=None if draws is None else draws.pdf).detach()
    fine_pos = xyz_new = warped_new = xyz_fine = warped_f = None
    if use_nof and rcfg.share_coarse_warps:
        # the fine set is the coarse depths plus the new ones, and the warp
        # chain is the same networks for both passes: warp only the new
        # samples and depth-merge them with the coarse warps
        xyz_new = o_t[:, :, None] + d_t[:, :, None] * z_fine[None]
        warped_new = warp_stack(xyz_new)
        z_all, fine_input, fine_pos = merge_cano_by_z_t(
            z_vals, z_fine, warped_c["cano"], warped_new["cano"])
    else:
        z_all = torch.sort(torch.cat([z_vals, z_fine], dim=-1),
                           dim=-1).values
        xyz_fine = o_t[:, :, None] + d_t[:, :, None] * z_all[None]
        warped_f = warp_stack(xyz_fine) if use_nof else None
        fine_input = warped_f["cano"] if use_nof else xyz_fine
    rgb_f, depth_f, weights_f, alphas_f = nerf_inference(
        params["fine_NeRF"], statics.fine or statics.coarse, statics,
        anneal, fine_input, img_ind, rays_d, z_all, rcfg,
        background=background, noise=_sigma_noise(rcfg, draws, "fine"))
    result["rgb_fine"] = rgb_f
    result["depth_fine"] = depth_f
    result["opacity_fine"] = torch.sum(weights_f, dim=1)
    _fine_consensus(result, consensus, rcfg, alphas_f, fine_pos,
                    ((xyz_coarse, warped_c), (xyz_new, warped_new)),
                    (xyz_fine, warped_f), 0)
    return result


def render_rays(params: dict, statics: ModelStatics, anneal: dict,
                rays: torch.Tensor, background: torch.Tensor | None,
                rcfg: RenderConfig, draws=None) -> dict:
    """Render a batch of rays: at test time (``rcfg.test_time``), or the
    training branch with the random inputs of ``draws`` (a ``Draws``).

    Args:
      params: ``{'coarse_NeRF', 'fine_NeRF'?, 'bw_NoF'?}`` tensor dicts.
      anneal: ``{'nerf_xyz': (K,) | None, 'nof_xyz': (K,) | None}``.
      rays: (N, >=9) packed ``[o(3), d(3), near, far, ind]``, plus the
        chained-frame index as column 9 when training with chain_global.
      background: (N, 3) per-ray background or None.

    Returns per-ray ``opacity_coarse`` (and ``rgb_coarse``/``depth_coarse``
    when there is no fine pass or in training), ``rgb_fine``,
    ``depth_fine``, ``opacity_fine``; in training also the consensus
    scalars ``nof_local_disp_coarse`` / ``_fine`` and
    ``nof_global_disp_coarse`` / ``_fine`` of the chains that are on.
    """
    if rcfg.mlp_impl != "fused":
        return _render_rows(params, statics, anneal, rays, background, rcfg,
                            draws)
    if not rcfg.test_time:
        return _render_train(params, statics, anneal, rays, background,
                             rcfg, draws)
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    img_ind = rays[:, 8:9]
    z_vals = stratified_zvals(near, far, rcfg.n_samples, rcfg.use_disp,
                              rcfg.perturb)
    result: dict = {}
    use_nof = rcfg.use_nof and statics.nof is not None
    dir_norm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    coarse_weights_only = rcfg.n_importance > 0
    probe = (rcfg.coarse_probe
             if coarse_weights_only and rcfg.coarse_probe else 0)
    if probe and (probe > rcfg.n_samples or rcfg.n_samples % probe != 0):
        raise ValueError(
            f"coarse_probe={probe} must divide n_samples={rcfg.n_samples} "
            "(and be <= it)")
    z_c = z_vals[:, ::rcfg.n_samples // probe] if probe else z_vals
    rgb_c, depth_c, weights_c, _ = _fused_test_pass(
        params, "coarse_NeRF", statics, anneal, rays_o, rays_d, img_ind,
        z_c, dir_norm, background, use_nof, coarse_weights_only, rcfg)
    result["opacity_coarse"] = torch.sum(weights_c, dim=1)
    if not coarse_weights_only:
        result["rgb_coarse"] = rgb_c
        result["depth_coarse"] = depth_c
    if rcfg.n_importance > 0:
        z_mid = 0.5 * (z_c[:, :-1] + z_c[:, 1:])
        z_fine = sample_pdf(z_mid, weights_c[:, 1:-1], rcfg.n_importance,
                            det=(rcfg.perturb == 0))
        z_all = torch.sort(torch.cat([z_vals, z_fine], dim=-1), dim=-1).values
        deltas = None
        if rcfg.fine_budget:
            z_all, deltas = compact_fine_samples(
                z_all, z_mid, weights_c[:, 1:-1], rcfg.fine_budget)
        rgb_f, depth_f, weights_f, _ = _fused_test_pass(
            params, "fine_NeRF", statics, anneal, rays_o, rays_d, img_ind,
            z_all, dir_norm, background, use_nof, False, rcfg,
            deltas=deltas)
        result["rgb_fine"] = rgb_f
        result["depth_fine"] = depth_f
        result["opacity_fine"] = torch.sum(weights_f, dim=1)
    return result
