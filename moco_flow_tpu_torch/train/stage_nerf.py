"""Stage 1: the canonical NeRF trainer.

Port of ``moco_flow_tpu/train/stage_nerf.py``: a coarse + fine NeRF
(``dir``-conditioned in ``init_nerf.yaml``) trained on random rays of a
uniformly drawn frame, with the image loss of both passes and the
optimizer of the config (``radam`` with ``steplr`` there). Under
``mlp_impl: pallas`` each step's coarse and fine passes each run kernel #8
(``ops/fused_mlp.py``) once. The val step, checkpoints and chunked
rendering are ``train/base.py``'s; ``visualize_batch`` (a val frame, the
canonical mesh and orbit) is ``train/vis.py``'s.
"""

from __future__ import annotations

import torch

from ..data.dataset import sample_train_rays
from ..data.draws import Draws, draw
from ..nn.losses import image_loss
from ..nn.metrics import psnr
from ..render.volume import render_rays
from .base import BaseTrainer
from .checkpoint import load_checkpoint, merge_into
from .factory import build_statics, init_params, render_config


class NeRFTrainer(BaseTrainer):
    """The stage-1 model: the coarse and fine NeRFs and one optimizer."""

    def build_model(self, model_config: dict):
        self.statics = build_statics(model_config)
        gen = torch.Generator().manual_seed(int(self.seed))
        self.params = init_params(gen, self.statics, device=self.device)
        loss = self.config.get("loss")
        self.loss_kind = (loss.get("type", "MSE") if isinstance(loss, dict)
                          else "MSE")
        self.rcfg_train = render_config(model_config)
        # deterministic val sampling, so jitter does not noise the val PSNR
        self.rcfg_val = render_config(model_config, perturb=0.0)
        self.rcfg_test = render_config(model_config, test_time=True,
                                       perturb=0.0)
        if model_config.get("pretrained_path"):
            tree, _ = load_checkpoint(model_config["pretrained_path"])
            self.params = merge_into(self.params, tree.get("params", tree))

    def draw(self, step: int) -> Draws:
        """Every random input of ``step`` (frame drawn uniformly, pixels,
        background, depth jitter, importance uniforms) from the step's
        generator (the rank's own above world 1)."""
        gen = self._step_generator(step)
        frame = int(torch.randint(0, self.num_frames, (), generator=gen))
        rcfg = self.rcfg_train
        return draw(gen, frame, self._valid_count[frame],
                    int(self.config["model"]["N_rand"]), rcfg.n_samples,
                    rcfg.n_importance, self.num_frames, chain_global=False,
                    noise_std=rcfg.noise_std)

    def _step_inputs(self, draws: Draws | None):
        """The step's draws (or ``draws``) and their rays, pixels and
        backgrounds."""
        if draws is None:
            draws = self.draw(self.clock.step)
        draws = draws.to(self.device)
        rays, rgbs, bg = sample_train_rays(
            self._table, self._directions, self._images, self._bkgd, draws,
            self._rand_bkgd, self._has_alpha)
        return draws, rays, rgbs, bg

    def _step_losses(self, batch):
        """The render's image loss of both passes, ``img_loss``, and the
        ``train_psnr`` beside it."""
        draws, rays, rgbs, bg = batch
        res = render_rays(self.params, self.statics, {}, rays, bg,
                          self.rcfg_train, draws=draws)
        loss = image_loss(res, rgbs, self.loss_kind)
        typ = "rgb_fine" if "rgb_fine" in res else "rgb_coarse"
        return {"img_loss": loss}, {"train_psnr": psnr(res[typ].detach(),
                                                       rgbs)}

    def visualize_batch(self, save_path=None):
        """After a val step: a frame drawn by ``val_rng`` every
        ``vis_img_every_n_val`` vals, the canonical mesh and orbit every
        ``vis_mesh_video_every_n_val``."""
        from .vis import visualize_frame, visualize_mesh, visualize_spherical
        tcfg = self.config["trainer"]
        n_val = self.clock.step // max(tcfg.get("val_every_n_step", 1), 1)
        if n_val % tcfg.get("vis_img_every_n_val", 1) == 0:
            idx = int(self.val_rng().integers(self.val_dataset.num_frames))
            visualize_frame(self, idx, use_nof=False, save_path=save_path)
        if n_val % tcfg.get("vis_mesh_video_every_n_val", 5) == 0:
            visualize_mesh(self, frame_idx=-1, save_path=save_path)
            visualize_spherical(self, frame_idx=-1, use_nof=False,
                                save_path=save_path)
