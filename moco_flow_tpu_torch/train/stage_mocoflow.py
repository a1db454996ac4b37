"""The stage-3 MoCo-Flow trainer.

Port of ``moco_flow_tpu/train/stage_mocoflow.py``: model build, PE
annealing from the step, both optimizers (their state in checkpoints in the
JAX ``opt_named`` form, with ``nof_opt_deleted`` beside the clock) and the
training step in every phase of the NoF-supervision schedule (``phase``):

- ``full`` (before the c2f start): the image and consensus losses, the NoF
  L1 supervision of both NoFs on the SMPL correspondences and the
  alpha-mask BCE, with the density frozen and the second (``nof``)
  optimizer stepping after ``moco`` on the same gradients (the reference's
  double update);
- ``none``: image and consensus losses; the ``nof`` optimizer is deleted at
  the first such step (the c2f start itself still freezes the density);
- ``msk``: ``none`` plus the alpha-mask BCE.

``build_model`` starts from the stage-1 NeRF's sigma branch
(``pretrained_nerf``) and the stage-2 NoFs (``pretrained_nof``) when the
config names them, as ``c2f.yaml`` does. Under ``mlp_impl: pallas`` every
step and the val step take the per-op route (kernels #8 / #9).

The datasets, checkpoints, chunked rendering, sequence evaluation and the
val step (a val frame with the chains off and ``perturb = 0``) are
``train/base.py``'s; ``visualize_batch`` (the canonical frame, orbit and
mesh) is ``train/vis.py``'s.
"""

from __future__ import annotations

import torch

from ..data.correspondence import sample_correspondences
from ..data.dataset import sample_train_rays
from ..data.draws import Draws, draw
from ..nn.embedding import anneal_weights
from ..nn.losses import image_loss, masked_bce, masked_loss
from ..nn.metrics import psnr
from ..nn.nerf import nerf_sigma
from ..parallel.mesh import FRAME_SAMPLING_POLICIES, sample_frame
from ..render.volume import encode_nerf_xyz, render_rays
from .base import BaseTrainer
from .checkpoint import (load_checkpoint, merge_into,
                         transfer_pretrained_nerf, transfer_pretrained_nof)
from .factory import build_statics, init_params, render_config
from .optim import make_optimizer, zero_grads_where
from .stage_nof import nof_points

_NOF_NETS = ("bw_NoF", "fw_NoF")


def _freeze_density(path: str) -> bool:
    """Frozen before the c2f start: the NeRFs' trunk and sigma head; the rgb
    branch (final / extra / rgb) keeps training."""
    parts = path.split("/")
    return len(parts) >= 2 and parts[0].endswith("NeRF") and \
        parts[1] in ("trunk", "sigma")


def _alpha(sigma: torch.Tensor, delta: float) -> torch.Tensor:
    """1 - exp(-delta softplus(sigma)), softplus as jax.nn.softplus."""
    return 1.0 - torch.exp(-delta * torch.logaddexp(sigma,
                                                    torch.zeros_like(sigma)))


class MoCoFlowTrainer(BaseTrainer):
    """The stage-3 model: both NeRFs and both NoFs, the ``moco`` and ``nof``
    optimizers, the phase schedule and the step; the shared half (device,
    checkpoints, data, rendering, the val step) is :class:`BaseTrainer`."""

    def __init__(self, config: dict, device: torch.device | str = "cuda",
                 seed: int = 0, smpl_data=None, scene=None):
        super().__init__(config, device=device, seed=seed,
                         smpl_data=smpl_data, scene=scene)
        self.opt_nof = None
        self.nof_opt_deleted = False

    def build_model(self, model_config: dict):
        loss_cfg = self.config.get("loss") or {}
        self.chain_local = bool(loss_cfg.get("chain_local", False))
        self.chain_global = bool(loss_cfg.get("chain_global", False))
        with_fw = self.chain_local or self.chain_global
        self.statics = build_statics(model_config)
        gen = torch.Generator().manual_seed(int(self.seed))
        self.params = init_params(gen, self.statics, with_nerf=True,
                                  with_nof=True, with_fw_nof=with_fw,
                                  device=self.device)
        # the hand-over from stages 1-2, then a stage-3 checkpoint, in
        # JAX's order
        if model_config.get("pretrained_nerf"):
            tree, _ = load_checkpoint(model_config["pretrained_nerf"])
            self.params = transfer_pretrained_nerf(self.params, tree)
            self.record_str("loaded pretrained NeRF sigma branch (fine->both)")
        else:
            self.record_str("NOT loading pretrained NeRF !!!")
        if model_config.get("pretrained_nof"):
            tree, _ = load_checkpoint(model_config["pretrained_nof"])
            self.params = transfer_pretrained_nof(self.params, tree)
            self.record_str("loaded pretrained NoFs")
        else:
            self.record_str("NOT loading pretrained NoF !!!")
        if model_config.get("pretrained_path"):
            tree, _ = load_checkpoint(model_config["pretrained_path"])
            self.params = merge_into(self.params, tree.get("params", tree))
        self.c2f = bool(model_config.get("coarse_to_fine", False))
        tcfg = self.config.get("trainer") or {}
        self.c2f_start = int(tcfg.get("coarse2fine_start_iter", 0))
        self.c2f_end = int(tcfg.get("coarse2fine_end_iter", 1))
        self.rcfg_train = render_config(
            model_config, use_nof=True, chain_local=self.chain_local,
            chain_global=self.chain_global)
        # val consumes rgb only: chains off (frame rays carry no chained
        # index), no jitter, so it draws nothing
        self.rcfg_val = render_config(model_config, use_nof=True,
                                      chain_local=False, chain_global=False,
                                      perturb=0.0)
        self.rcfg_test = render_config(model_config, use_nof=True,
                                       test_time=True, perturb=0.0)
        self.rcfg_test_cano = render_config(model_config, use_nof=False,
                                            test_time=True, perturb=0.0)
        w = {k: (loss_cfg.get(k) or {}) for k in ("img_loss", "nof_loss",
                                                   "msk_loss")}
        self.w = {"img": w["img_loss"].get("weight", 1.0),
                  "local": loss_cfg.get("nof_local_weight", 0.0),
                  "global": loss_cfg.get("nof_global_weight", 0.0),
                  "nof": w["nof_loss"].get("weight", 0.0),
                  "msk": w["msk_loss"].get("weight", 0.0)}
        self.img_loss_kind = w["img_loss"].get("type", "MSE")
        self.nof_loss_kind = w["nof_loss"].get("type", "L1")

    def anneal(self, step: int | None = None) -> dict:
        """PE annealing weights at ``step`` (default: the loaded step)."""
        step = self.step if step is None else step
        out = {}
        for name, spec in (("nerf_xyz", self.statics.nerf_xyz),
                           ("nof_xyz", self.statics.nof_xyz)):
            if spec is not None and spec.n_freqs > 0:
                w = (anneal_weights(step, spec.n_freqs, self.c2f_start,
                                    self.c2f_end)
                     if self.c2f else torch.ones(spec.n_freqs))
                out[name] = w.to(self.device)
        return out

    def extra_state(self) -> dict:
        return {"nof_opt_deleted": self.nof_opt_deleted}

    def load_extra_state(self, extra: dict):
        self.nof_opt_deleted = bool(extra.get("nof_opt_deleted", False))
        self.opt_nof = None

    def _correspondences(self, ds):
        return ds.correspondence_table

    def _opt_state_named(self) -> dict | None:
        if self.opt is None:              # no step since the load
            if self._opt_named is None:
                return None
            return {k: v for k, v in self._opt_named.items()
                    if not (self.nof_opt_deleted and k.startswith("['nof']"))}
        out = self.opt.state_named("['moco']")
        if self.opt_nof is not None:
            out.update(self.opt_nof.state_named("['nof']"))
        return out

    def configure_optimizers(self, optimizer_config: dict,
                             scheduler_config: dict | None):
        """The ``moco`` optimizer over every parameter and the ``nof`` one
        over the bw / fw NoFs, built at the first training step (and after
        each checkpoint load)."""
        self.opt_cfg = (optimizer_config, scheduler_config)
        self.opt = self.opt_nof = None

    def _optimizers(self):
        """The ``moco`` optimizer, and ``opt_nof`` unless it is deleted,
        with a loaded checkpoint's state."""
        if self.opt is not None:
            return self.opt
        named = self._named()
        for t in named.values():
            t.requires_grad_(True)
        opt_cfg, sched = self.opt_cfg
        self.opt = make_optimizer(list(named.values()), opt_cfg["moco"],
                                  sched, world_size=self.world_size,
                                  names=list(named))
        if not self.nof_opt_deleted:
            if "nof" not in opt_cfg:
                raise ValueError("a full / msk step before the nof "
                                 "optimizer's deletion needs optimizer.nof")
            nof = {k: t for k, t in named.items()
                   if k.split("/")[0] in _NOF_NETS}
            self.opt_nof = make_optimizer(list(nof.values()), opt_cfg["nof"],
                                          sched, world_size=self.world_size,
                                          names=list(nof))
        if self._opt_named is not None:
            self.opt.load_named(self._opt_named, "['moco']")
            if self.opt_nof is not None:
                self.opt_nof.load_named(self._opt_named, "['nof']")
            self._opt_named = None
        return self.opt

    def phase(self, step: int):
        """(nof_mode, freeze_density) of a global step."""
        freeze = step <= self.c2f_start
        if step < self.c2f_start:
            nof_mode = "full"
        elif step < self.c2f_end:
            nof_mode = "msk" if (step // 1000) % 10 == 0 else "none"
        else:
            nof_mode = "msk"
        return nof_mode, freeze

    def draw(self, step: int) -> Draws:
        """Every random input of ``step``, from a generator seeded with
        (seed, step) and, above world 1, the rank, so a resumed run draws
        what the run before it would have drawn."""
        mcfg = self.config["model"]
        policy = mcfg.get("frame_sampling", "uniform")
        if policy not in FRAME_SAMPLING_POLICIES:
            raise ValueError("model.frame_sampling must be one of "
                             f"{FRAME_SAMPLING_POLICIES}, got {policy!r}")
        gen = self._step_generator(step)
        frame = sample_frame(policy, self.seed, step, self.num_frames, gen,
                             self.dp_rank)
        rcfg = self.rcfg_train
        corr = self.phase(step)[0] != "none"
        return draw(gen, frame, self._valid_count[frame],
                    int(mcfg["N_rand"]), rcfg.n_samples, rcfg.n_importance,
                    self.num_frames, self.chain_global,
                    n_sampled=int(mcfg.get("N_sampled", 1000)) if corr else 0,
                    num_verts=int(self._corr.verts.shape[1]) if corr else 0,
                    noise_std=rcfg.noise_std)

    def _step_inputs(self, draws: Draws | None) -> dict:
        """The step's phase (the ``nof`` optimizer deleted at a ``none``
        step), its draws (or ``draws``), rays (with the chained frame's
        column under the global chain), pixels, backgrounds and, in a
        ``msk`` / ``full`` step, correspondences."""
        step = self.clock.step
        nof_mode, freeze = self.phase(step)
        if nof_mode == "none":
            self.nof_opt_deleted = True
            self.opt_nof = None
        if draws is None:
            draws = self.draw(step)
        draws = draws.to(self.device)
        rays, rgbs, bg = sample_train_rays(
            self._table, self._directions, self._images, self._bkgd, draws,
            self._rand_bkgd, self._has_alpha)
        if self.chain_global:
            cidx = (torch.tensor(float(draws.chained), device=self.device)
                    * 2.0 / self.num_frames - 1.0)
            rays = torch.cat([rays, torch.zeros_like(rays[:, :1]) + cidx],
                             dim=1)
        corr = None
        if nof_mode != "none":
            if self._corr is None or draws.cube is None:
                raise ValueError(
                    f"step {step} ({nof_mode!r}) needs the correspondence "
                    "table and the correspondence draws")
            corr = sample_correspondences(self._corr, draws.frame,
                                          draws.cube, draws.pick, draws.noise,
                                          thickness=0.2)
        return {"step": step, "nof_mode": nof_mode, "freeze": freeze,
                "draws": draws, "rays": rays, "rgbs": rgbs, "bg": bg,
                "corr": corr}

    def _step_losses(self, b: dict):
        """Every loss of the step's phase, and ``train_psnr`` beside
        them."""
        params, statics, rcfg, w = (self.params, self.statics,
                                    self.rcfg_train, self.w)
        draws, rgbs, corr = b["draws"], b["rgbs"], b["corr"]
        anneal = self.anneal(b["step"])
        norm_idx = self._table.norm_idx[draws.frame]
        res = render_rays(params, statics, anneal, b["rays"], b["bg"], rcfg,
                          draws=draws)
        losses = {"img_loss": image_loss(res, rgbs, self.img_loss_kind)
                  * w["img"]}
        for name, on in (("local", self.chain_local),
                         ("global", self.chain_global)):
            if on:
                v = res[f"nof_{name}_disp_coarse"]
                if f"nof_{name}_disp_fine" in res:
                    v = v + res[f"nof_{name}_disp_fine"]
                losses[f"nof_{name}"] = v * w[name]
        if corr is not None:   # a msk / full step
            query, cano, inside = corr["query"], corr["cano"], corr["inside"]
            bw = nof_points(params["bw_NoF"], statics, anneal, query,
                            norm_idx, rcfg)
            if b["nof_mode"] == "full":
                losses["nof_bw"] = masked_loss(
                    bw, cano, inside, self.nof_loss_kind) * w["nof"]
                if "fw_NoF" in params:
                    fw = nof_points(params["fw_NoF"], statics, anneal, cano,
                                    norm_idx, rcfg)
                    losses["nof_fw"] = masked_loss(
                        fw, query, inside, self.nof_loss_kind) * w["nof"]
            if w["msk"] > 0:
                # NoF-warped outside points must be empty in the canonical
                # field; the density is fp32 whatever the compute type, as
                # JAX's nerf_sigma without a compute dtype
                outside = ~inside
                sig = nerf_sigma(params["coarse_NeRF"], encode_nerf_xyz(
                    params["coarse_NeRF"], statics.coarse, statics, bw,
                    anneal), statics.coarse)
                msk = masked_bce(_alpha(sig[:, 0], 1.0 / rcfg.n_samples),
                                 outside, 0.0)
                if "fine_NeRF" in params and rcfg.n_importance > 0:
                    sig_f = nerf_sigma(params["fine_NeRF"], encode_nerf_xyz(
                        params["fine_NeRF"], statics.fine, statics, bw,
                        anneal), statics.fine)
                    a_f = _alpha(sig_f[:, 0], 1.0 / (rcfg.n_samples
                                                     + rcfg.n_importance))
                    msk = 0.5 * (msk + masked_bce(a_f, outside, 0.0))
                losses["alphas_mask"] = msk * w["msk"]
        typ = "rgb_fine" if "rgb_fine" in res else "rgb_coarse"
        return losses, {"train_psnr": psnr(res[typ].detach(), rgbs)}

    def _after_backward(self, b: dict):
        """The density freeze of the phase."""
        if b["freeze"]:
            zero_grads_where(self._named(), _freeze_density)

    def _after_optimizer(self):
        """The reference's double update: the ``nof`` optimizer on the same
        gradients and the updated parameters, until its deletion."""
        if self.opt_nof is not None:
            self.opt_nof.step()

    def step_records(self, step: int) -> dict:
        """JAX's step adds ``state/nerf`` (0 while the density is frozen)
        to its metrics and, on log steps, records the PE-annealing weights
        as histograms."""
        if self.logger is not None and self._log_step(step):
            for name, w in self.anneal(step).items():
                self.logger.histogram(f"weights/{name}", w.cpu(), step)
        return {"state/nerf": 0.0 if self.phase(step)[1] else 1.0}

    def visualize_batch(self, save_path=None):
        """After a val step: the canonical frame strip every
        ``vis_img_every_n_val`` vals, the canonical orbit and mesh every
        ``vis_mesh_video_every_n_val``."""
        from .vis import visualize_frame, visualize_mesh, visualize_spherical
        tcfg = self.config["trainer"]
        n_val = self.clock.step // max(tcfg.get("val_every_n_step", 1), 1)
        if n_val % tcfg.get("vis_img_every_n_val", 1) == 0:
            visualize_frame(self, -1, use_nof=False, save_path=save_path)
        if n_val % tcfg.get("vis_mesh_video_every_n_val", 5) == 0:
            visualize_spherical(self, -1, use_nof=False, save_path=save_path)
            visualize_mesh(self, -1, save_path=save_path)
