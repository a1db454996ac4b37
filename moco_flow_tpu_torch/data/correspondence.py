"""SMPL frame correspondences: the NoF supervision of the stage-3 step.

Port of ``moco_flow_tpu/data/correspondence.py``. The table holds, for every
training frame, the posed SMPL vertices and the per-vertex src -> canonical
4x4 chain ``T_tgt @ inv(T_src)`` (canonical frame 0), built once. A step
draws ``num_sampled`` uniform points in the cube of half extent 1.5 and
``num_sampled`` near-surface points (random vertices plus N(0, thickness)
noise), finds each point's nearest vertex and maps it through that vertex's
chain. Every point is returned with a boolean ``inside`` (distance below
``thickness``) instead of being split into two sets, so shapes are static.
The random numbers are the step's ``Draws`` (``cube``, ``pick``, ``noise``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry.smpl import SMPLData, smpl_forward, smpl_vertex_transforms
from ..ops.knn import nearest_neighbor
from ..utils.logging import span


@dataclasses.dataclass
class CorrespondenceTable:
    verts: torch.Tensor        # (F, V, 3) posed vertices
    src_to_cano: torch.Tensor  # (F, V, 4, 4) per-vertex src -> canonical

    def to(self, device) -> "CorrespondenceTable":
        return CorrespondenceTable(self.verts.to(device),
                                   self.src_to_cano.to(device))


def build_correspondence_table(data: SMPLData, poses: torch.Tensor,
                               betas: torch.Tensor, tgt_frame: int = 0,
                               batch: int = 32) -> CorrespondenceTable:
    """The table of every frame of ``poses`` (F, 72) / ``betas`` (F, 10),
    in batches of ``batch`` frames."""
    verts, trans = [], []
    for i in range(0, poses.shape[0], batch):
        p, b = poses[i:i + batch], betas[i:i + batch]
        verts.append(smpl_forward(data, p, b))
        trans.append(smpl_vertex_transforms(data, p, b))
    verts = torch.cat(verts)
    trans = torch.cat(trans)                  # (F, V, 4, 4) rest -> posed
    inv_src = torch.linalg.inv(trans)         # posed -> rest
    src_to_cano = torch.einsum("vab,fvbc->fvac", trans[tgt_frame], inv_src)
    return CorrespondenceTable(verts=verts, src_to_cano=src_to_cano)


def sample_correspondences(table: CorrespondenceTable, frame: int,
                           cube: torch.Tensor, pick: torch.Tensor,
                           noise: torch.Tensor,
                           thickness: float = 0.2) -> dict:
    """Query points of ``frame`` and their canonical correspondences.

    Args:
      cube: (N, 3) uniform points in the cube; pick: (N,) vertex ids;
        noise: (N, 3) standard normal (the step's draws).

    Returns ``{'query': (2N, 3), 'cano': (2N, 3), 'inside': (2N,) bool}``.
    The whole call is the span ``data.correspondences``, and its KNN the
    span ``data.knn`` inside it (``utils/logging.py::span``).
    """
    with span("data.correspondences"):
        verts = table.verts[frame]            # (V, 3)
        chain = table.src_to_cano[frame]      # (V, 4, 4)
        surf = verts[pick] + noise * thickness
        query = torch.cat([cube, surf], dim=0)
        with span("data.knn"):
            dist, idx = nearest_neighbor(verts, query)
        homo = torch.cat([query, torch.ones_like(query[:, :1])], dim=-1)
        cano = torch.einsum("nab,nb->na", chain[idx], homo)[:, :3]
        return {"query": query, "cano": cano, "inside": dist < thickness}
