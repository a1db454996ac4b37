"""Loss functions of the stage-3 step.

Port of ``moco_flow_tpu/nn/losses.py``: the MSE / L1 image loss on the
coarse (+ fine) rgb and the masked mean behind the consensus terms.
``masked_loss`` and ``masked_bce`` (NoF supervision and the alpha-mask loss)
belong to the ``msk`` / ``full`` phases, ROADMAP 'Modules to port' item 1.
"""

from __future__ import annotations

import torch


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


_ELEMENTWISE = {"MSE": lambda p, t: (p - t) ** 2,
                "L1": lambda p, t: torch.abs(p - t)}


def image_loss(results: dict, target: torch.Tensor,
               kind: str = "MSE") -> torch.Tensor:
    """Coarse (+ fine) rgb loss."""
    fn = _ELEMENTWISE[kind]
    loss = torch.mean(fn(results["rgb_coarse"], target))
    if "rgb_fine" in results:
        loss = loss + torch.mean(fn(results["rgb_fine"], target))
    return loss


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``values`` where ``mask`` is nonzero; the plain mean if the
    mask is empty."""
    mask = mask.to(values.dtype)
    total = torch.sum(mask)
    safe = torch.where(total > 0, mask, torch.ones_like(mask))
    return torch.sum(values * safe) / torch.sum(safe)
