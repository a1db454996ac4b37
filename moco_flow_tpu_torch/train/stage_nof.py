"""Stage 2 (NoF pretraining), as far as stage 3 needs it.

Port of ``moco_flow_tpu/train/stage_nof.py``'s ``nof_points``: the warp of
a flat point set for one frame index, which the stage-3 step's NoF
supervision and mask loss run on the correspondence points. The stage-2
trainer itself waits for ROADMAP 'Modules to port' item 1 (the next
slice).
"""

from __future__ import annotations

import torch

from ..render.volume import RenderConfig, nof_warp


def nof_points(params_nof: dict, statics, anneal: dict, pts: torch.Tensor,
               norm_idx: torch.Tensor, rcfg: RenderConfig) -> torch.Tensor:
    """Warp (M, 3) points of the frame ``norm_idx`` (0-dim) through one NoF
    as a single ray of M samples. Returns (M, 3)."""
    return nof_warp(params_nof, statics, anneal, pts[None],
                    norm_idx.reshape(1, 1), rcfg)[0]
