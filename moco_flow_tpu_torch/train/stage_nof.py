"""Stage 2: the NoF (motion flow) pretraining trainer.

Port of ``moco_flow_tpu/train/stage_nof.py``: the backward and forward NoFs
trained on SMPL frame correspondences with the bidirectional L1 over every
sampled point, inside and outside the body (``N_sampled`` cube points plus
``N_sampled`` near-surface points a step, at thickness 0.1), with the
optimizer of the config (``adam`` with ``steplr`` in ``init_nof.yaml``).
The val step scores a fresh 10,000-point set; ``visualize_batch`` does
nothing, as in JAX.

The render config is JAX's ``RenderConfig(use_nof=True)``: fp32 and no
jitter whatever the YAML's ``compute_dtype``. Each NoF evaluation of a
point set is one :func:`nof_points` call, which the port runs through the
single-warp kernels #3 / #4 (``ops/nof_rays.py``; the set re-chunked into
4096-sample rays).

``nof_points`` also serves stage 3's NoF supervision and mask loss.
"""

from __future__ import annotations

import torch

from ..data.correspondence import sample_correspondences
from ..data.dataset import NoFDataset, get_dataset
from ..data.draws import PointDraws, draw_points, draw_val_points
from ..nn.losses import l1
from ..parallel.mesh import FRAME_SAMPLING_POLICIES, sample_frame
from ..render.volume import RenderConfig, nof_warp
from .base import BaseTrainer
from .checkpoint import load_checkpoint, merge_into
from .factory import build_statics, init_params

VAL_POINTS = 10000


def nof_points(params_nof: dict, statics, anneal: dict, pts: torch.Tensor,
               norm_idx: torch.Tensor, rcfg: RenderConfig) -> torch.Tensor:
    """Warp (M, 3) points of the frame ``norm_idx`` (0-dim) through one NoF
    as a single ray of M samples. Returns (M, 3)."""
    return nof_warp(params_nof, statics, anneal, pts[None],
                    norm_idx.reshape(1, 1), rcfg)[0]


class NoFTrainer(BaseTrainer):
    """The stage-2 model: the bw and fw NoFs and one optimizer."""

    def prepare_dataloader(self, data_config: dict):
        """The train dataset (no images); the val step draws fresh points
        from the same frames."""
        self.train_dataset = get_dataset(data_config, "train",
                                         smpl_data=self.smpl_data,
                                         scene=self.scene)
        self.val_dataset = self.train_dataset
        self.num_frames = self.train_dataset.num_frames

    def prepare_train_data(self, data_config: dict):
        """The correspondence table and the frames' normalized indices on
        the trainer's device."""
        ds = self.train_dataset
        self.set_points(ds.correspondence_table, ds.table.norm_idx)

    def set_points(self, corr, norm_idx: torch.Tensor):
        """Train on ``corr`` (a ``CorrespondenceTable``) and the (F,)
        normalized frame indices."""
        self.num_frames = int(norm_idx.shape[0])
        self._corr = corr.to(self.device)
        self._norm_idx = norm_idx.to(self.device)

    def build_model(self, model_config: dict):
        self.statics = build_statics(model_config)
        gen = torch.Generator().manual_seed(int(self.seed))
        self.params = init_params(gen, self.statics, with_nerf=False,
                                  with_nof=True, with_fw_nof=True,
                                  device=self.device)
        self.rcfg = RenderConfig(use_nof=True)
        for key in ("pretrained_nof", "pretrained_path"):
            if model_config.get(key):
                tree, _ = load_checkpoint(model_config[key])
                self.params = merge_into(self.params,
                                         tree.get("params", tree))

    def _loss(self, params: dict, corr: dict, norm_idx) -> dict:
        """The bidirectional L1 over every sampled point: bw(query) against
        cano and fw(cano) against query."""
        query, cano = corr["query"], corr["cano"]
        bw = nof_points(params["bw_NoF"], self.statics, {}, query, norm_idx,
                        self.rcfg)
        fw = nof_points(params["fw_NoF"], self.statics, {}, cano, norm_idx,
                        self.rcfg)
        return {"nof_bw": l1(bw, cano), "nof_fw": l1(fw, query)}

    def _points(self, draws: PointDraws) -> dict:
        d = draws.to(self.device)
        return sample_correspondences(self._corr, d.frame, d.cube, d.pick,
                                      d.noise, thickness=NoFDataset.THICKNESS)

    def draw(self, step: int) -> PointDraws:
        """The frame of ``step`` by ``model.frame_sampling``, then its
        ``N_sampled`` points, from the step's generator (the rank's own
        above world 1)."""
        mcfg = self.config["model"]
        policy = mcfg.get("frame_sampling", "uniform")
        if policy not in FRAME_SAMPLING_POLICIES:
            raise ValueError("model.frame_sampling must be one of "
                             f"{FRAME_SAMPLING_POLICIES}, got {policy!r}")
        gen = self._step_generator(step)
        frame = sample_frame(policy, self.seed, step, self.num_frames, gen,
                             self.dp_rank)
        return draw_points(gen, frame, int(mcfg["N_sampled"]),
                           int(self._corr.verts.shape[1]))

    def _step_inputs(self, draws: PointDraws | None):
        """The step's draws (or ``draws``) and their correspondences."""
        if draws is None:
            draws = self.draw(self.clock.step)
        return draws, self._points(draws)

    def _step_losses(self, batch):
        """Both NoFs' L1 (``nof_bw``, ``nof_fw``); nothing beside them."""
        draws, corr = batch
        return self._loss(self.params, corr,
                          self._norm_idx[draws.frame]), {}

    def val_step(self, draws: PointDraws | None = None) -> dict:
        """The losses on a fresh 10,000-point set (:func:`draw_val_points`
        at the clock's step, or ``draws``): ``val_nof_bw``,
        ``val_nof_fw``."""
        if draws is None:
            draws = draw_val_points(self.clock.step, self.num_frames,
                                    int(self._corr.verts.shape[1]),
                                    VAL_POINTS)
        with torch.no_grad():
            losses = self._loss(self.params, self._points(draws),
                                self._norm_idx[draws.frame])
        return {f"val_{k}": float(v) for k, v in losses.items()}
