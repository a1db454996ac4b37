"""The stage-3 MoCo-Flow trainer: test-time rendering and the training step.

Port of ``moco_flow_tpu/train/stage_mocoflow.py`` and the parts of
``moco_flow_tpu/train/base.py`` it uses: model build, PE annealing from the
step, checkpoint save and load (parameters, the clock and
``nof_opt_deleted``), the val dataset, chunked full-frame rendering and
sequence evaluation, and the training step of the ``none`` phase of the
NoF-supervision schedule: frame and ray sampling, the chained-frame column,
the training render, the image and consensus losses, the backward through
the kernels and one Adam update.

The ``full`` / ``msk`` phases (NoF supervision, the mask loss, the density
freeze and the second optimizer) and the val step run the single-warp NoF
kernel, which is not ported yet: they raise and name their ROADMAP item.
Optimizer state is not checkpointed yet: a resumed run starts a fresh Adam.
"""

from __future__ import annotations

import os.path as osp

import numpy as np
import torch

from ..data.dataset import get_dataset, sample_train_rays
from ..data.draws import Draws, draw
from ..nn.embedding import anneal_weights
from ..nn.losses import image_loss
from ..nn.metrics import dssim, psnr, ssim
from ..parallel.mesh import FRAME_SAMPLING_POLICIES, sample_frame
from ..render.volume import RenderConfig, render_rays
from .base import TrainClock
from .checkpoint import _flatten, load_checkpoint, merge_into, save_checkpoint
from .factory import build_statics, init_params, render_config
from .optim import make_optimizer

# the phases and options of the JAX trainer that wait for later slices
_NOF_PHASES = ("ROADMAP 'Modules to port' item 1 (the msk/full phases: "
               "nof_points, kernels #3/#4, correspondences, the mask loss, "
               "the density freeze and the second optimizer)")
_VAL_STEP = ("ROADMAP 'Modules to port' item 1 (the val step renders with "
             "the chains off, through the single-warp NoF kernel #3)")


class MoCoFlowTrainer:
    """Holds a stage-3 model's parameters on ``device`` and renders with it.

    Args:
      config: the YAML config as a dict (``dataloader``, ``model``,
        ``loss``, ``trainer`` blocks).
      device: where parameters and renders live. There is no fallback: a
        CUDA device that is missing fails at the first tensor placed on it.
      seed: seeds the parameter init (overwritten by a checkpoint).
      scene: an in-memory ``SyntheticScene`` to use instead of reading
        ``dataloader.root_dir``.
    """

    def __init__(self, config: dict, device: torch.device | str = "cuda",
                 seed: int = 0, smpl_data=None, scene=None):
        self.config = config
        self.device = torch.device(device)
        self.seed = seed
        self.smpl_data = smpl_data
        self.scene = scene
        self.clock = TrainClock()
        self.params: dict = {}
        self.opt = None
        self.nof_opt_deleted = False
        self.save_dir = osp.join(config.get("save_dir", "./log"),
                                 config.get("exp_name", "exp"))
        self.job_dir = None   # the run's directory (train/__main__.py)

    @property
    def step(self) -> int:
        return self.clock.step

    @step.setter
    def step(self, value: int):
        self.clock.step = int(value)

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
        if model_config.get("pretrained_nerf") or \
                model_config.get("pretrained_nof"):
            raise NotImplementedError(
                "pretrained-weight surgery is a training step; load a "
                "stage-3 checkpoint with -r instead")
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

    def load_ckpt(self, path: str):
        """Parameters (``strict=False``), the clock and ``nof_opt_deleted``
        of a checkpoint. Optimizer state is not restored: the next training
        step starts a fresh optimizer on the loaded parameters."""
        tree, extra = load_checkpoint(path)
        self.params = merge_into(self.params, tree.get("params", tree))
        if "clock" in extra:
            self.clock.restore_checkpoint(extra["clock"])
        self.nof_opt_deleted = bool(extra.get("nof_opt_deleted", False))
        self.opt = None
        print(f"loaded checkpoint {path}")

    def save_ckpt(self, name: str | None = None, job_dir: str | None = None):
        """Parameters, clock and ``nof_opt_deleted`` as
        ``<job_dir>/ckpts/<name>.npz`` (+ ``.json``), the JAX format."""
        if name is None:
            name = f"epoch{self.clock.epoch}_iter{self.clock.step}"
        path = osp.join(job_dir or self.job_dir, "ckpts", name)
        save_checkpoint(path, {"params": self.params}, extra={
            "clock": self.clock.make_checkpoint(),
            "nof_opt_deleted": self.nof_opt_deleted})
        print(f"saved checkpoint {path}")
        return path

    def prepare_dataloader(self, data_config: dict):
        self.val_dataset = get_dataset(data_config, "val",
                                       smpl_data=self.smpl_data,
                                       scene=self.scene)
        self.num_frames = self.val_dataset.num_frames

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def prepare_train_data(self, data_config: dict):
        """The train dataset; its frame table, direction grid, images and
        background go to the trainer's device (:meth:`set_train_data`)."""
        ds = get_dataset(data_config, "train", smpl_data=self.smpl_data,
                         scene=self.scene)
        if ds.images is None:
            raise ValueError("the train dataset has no images")
        self.set_train_data(ds.table, ds.directions_flat, ds.images,
                            ds.bkgd_img, ds.rand_bkgd)

    def set_train_data(self, table, directions, images, bkgd_img,
                       rand_bkgd: bool):
        """Train on ``table`` (a ``FrameTable``), the (H*W, 3) direction
        grid, (F, H*W, C) uint8 ``images`` and the (H*W, 3) background."""
        self.num_frames = int(table.valid_count.shape[0])
        self._valid_count = [int(c) for c in table.valid_count]
        self._table = table.to(self.device)
        self._directions = directions.to(self.device)
        self._images = images.to(self.device)
        self._bkgd = bkgd_img.to(self.device)
        self._rand_bkgd = bool(rand_bkgd)
        self._has_alpha = images.shape[-1] == 4

    def configure_optimizers(self, optimizer_config: dict,
                             scheduler_config: dict | None):
        """The ``moco`` optimizer over every parameter. The ``nof`` one
        only steps in the ``full`` / ``msk`` phases before its deletion
        (``nof_opt_deleted``), which are not ported."""
        self.opt_cfg = (optimizer_config["moco"], scheduler_config)
        self.opt = None

    def _optimizer(self):
        if self.opt is None:
            leaves = list(_flatten(self.params, leaf=lambda t: t).values())
            for t in leaves:
                t.requires_grad_(True)
            self.opt = make_optimizer(leaves, *self.opt_cfg)
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
        (seed, step), so a resumed run draws what the run before it would
        have drawn."""
        mcfg = self.config["model"]
        policy = mcfg.get("frame_sampling", "uniform")
        if policy not in FRAME_SAMPLING_POLICIES:
            raise ValueError("model.frame_sampling must be one of "
                             f"{FRAME_SAMPLING_POLICIES}, got {policy!r}")
        gen = torch.Generator().manual_seed(
            int(self.seed) * 1_000_003 + int(step))
        frame = sample_frame(policy, self.seed, step, self.num_frames, gen)
        rcfg = self.rcfg_train
        return draw(gen, frame, self._valid_count[frame],
                    int(mcfg["N_rand"]), rcfg.n_samples, rcfg.n_importance,
                    self.num_frames, self.chain_global)

    def _losses(self, params, anneal, rays, rgbs, bg, draws: Draws):
        """The losses of the ``none`` phase, and the train PSNR."""
        res = render_rays(params, self.statics, anneal, rays, bg,
                          self.rcfg_train, draws=draws)
        losses = {"img_loss": image_loss(res, rgbs, self.img_loss_kind)
                  * self.w["img"]}
        for name, on in (("local", self.chain_local),
                         ("global", self.chain_global)):
            if on:
                v = res[f"nof_{name}_disp_coarse"]
                if f"nof_{name}_disp_fine" in res:
                    v = v + res[f"nof_{name}_disp_fine"]
                losses[f"nof_{name}"] = v * self.w[name]
        typ = "rgb_fine" if "rgb_fine" in res else "rgb_coarse"
        return losses, psnr(res[typ].detach(), rgbs)

    def train_step(self, draws: Draws | None = None) -> dict:
        """One training step at ``self.step`` (the clock is not ticked):
        draws (or the given ``draws``), rays, render, losses, backward and
        one optimizer update. Returns the losses and ``train_psnr`` as
        0-dim tensors."""
        step = self.clock.step
        nof_mode, freeze = self.phase(step)
        if nof_mode != "none" or freeze:
            raise NotImplementedError(
                f"step {step} is in the {nof_mode!r} phase"
                f"{' with the density frozen' if freeze else ''}: "
                f"{_NOF_PHASES}")
        self.nof_opt_deleted = True
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
        opt = self._optimizer()
        opt.zero_grad()
        losses, train_psnr = self._losses(self.params, self.anneal(step),
                                          rays, rgbs, bg, draws)
        sum(losses.values()).backward()
        opt.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["train_psnr"] = train_psnr
        return metrics

    def train_func(self) -> dict:
        """One training step; on log steps the metrics are read back and
        printed (a read every step would wait for the card every step)."""
        metrics = self.train_step()
        if self.clock.step % self.config["trainer"].get("log_freq", 100) == 0:
            metrics = {k: float(v) for k, v in metrics.items()}
            print(f"[step {self.clock.step}] " + " ".join(
                f"{k} {v:.6f}" for k, v in metrics.items()))
        self.losses = metrics
        return metrics

    def render_rays_chunked(self, rays: torch.Tensor, background,
                            rcfg: RenderConfig, anneal=None,
                            chunk: int | None = None) -> dict:
        """Render any number of rays in tiles of ``chunk`` (default
        ``model.chunk``). A tail tile is padded (repeating its last ray) up
        to the next power of two, at least 2048 and at most ``chunk``, so
        tile shapes come from a small fixed set; per-ray outputs of the
        padding are dropped."""
        if chunk is None:
            chunk = int(self.config["model"].get("chunk", 16384))
        n = rays.shape[0]
        if n == 0:
            raise ValueError("render_rays_chunked: no rays")
        rays = rays.to(self.device, torch.float32)
        bg = (torch.ones((n, 3)) if background is None else background).to(
            self.device, torch.float32)
        outs = []
        i = 0
        while i < n:
            rows = min(chunk, n - i)
            bucket = rows if rows == chunk else \
                min(chunk, max(2048, 1 << (rows - 1).bit_length()))
            tile, bgt = rays[i:i + rows], bg[i:i + rows]
            if bucket > rows:
                tile = torch.cat([tile, tile[-1:].expand(bucket - rows, -1)])
                bgt = torch.cat([bgt, bgt[-1:].expand(bucket - rows, -1)])
            outs.append((rows, render_rays(self.params, self.statics,
                                           anneal or {}, tile, bgt, rcfg)))
            i += rows
        return {k: torch.cat([o[k][:r] for r, o in outs])
                for k in outs[0][1]}

    def evaluate_sequence(self, max_frames: int | None = None,
                          chunk: int = 16384) -> dict:
        """Mean PSNR / SSIM / DSSIM over the val sequence at test time."""
        ds = self.val_dataset
        rcfg = self.rcfg_test
        n = ds.num_frames if max_frames is None else min(max_frames,
                                                         ds.num_frames)
        h, w = ds.size
        psnrs, ssims, dssims = [], [], []
        for idx in range(n):
            rgbs = ds.frame_rgbs(idx)
            if rgbs is None:
                continue
            res = self.render_rays_chunked(ds.frame_rays(idx), ds.bkgd_img,
                                           rcfg, anneal=self.anneal(),
                                           chunk=chunk)
            typ = "rgb_fine" if "rgb_fine" in res else "rgb_coarse"
            rgbs = rgbs.to(self.device)
            pred = res[typ].reshape(h, w, 3).permute(2, 0, 1)[None]
            gt = rgbs.reshape(h, w, 3).permute(2, 0, 1)[None]
            psnrs.append(float(psnr(res[typ], rgbs)))
            ssims.append(float(ssim(pred, gt)))
            dssims.append(float(dssim(pred, gt)))
        out = {"psnr": float(np.mean(psnrs)) if psnrs else float("nan"),
               "ssim": float(np.mean(ssims)) if ssims else float("nan"),
               "dssim": float(np.mean(dssims)) if dssims else float("nan"),
               "frames": len(psnrs)}
        if rcfg.fine_budget or rcfg.coarse_probe:
            out["eval_fine_budget"] = rcfg.fine_budget
            out["eval_coarse_probe"] = rcfg.coarse_probe
        return out
