"""Loss functions of the stage-3 step.

Port of ``moco_flow_tpu/nn/losses.py``: the MSE / L1 image loss on the
coarse (+ fine) rgb, the masked mean behind the consensus terms, and the
masked L1 (NoF supervision) and masked BCE (alpha mask) of the ``full`` /
``msk`` phases. Masks select with static shapes: a masked mean, the plain
mean when the mask is empty.
"""

from __future__ import annotations

import torch


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def bce(pred: torch.Tensor, target: torch.Tensor,
        eps: float = 1e-7) -> torch.Tensor:
    """Binary cross entropy on probabilities, clamped to [eps, 1 - eps]."""
    p = torch.clamp(pred, eps, 1.0 - eps)
    return torch.mean(-(target * torch.log(p)
                        + (1.0 - target) * torch.log(1.0 - p)))


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


def masked_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                kind: str = "L1") -> torch.Tensor:
    """Masked-mean elementwise loss; ``mask`` broadcasts over the last
    axis."""
    elem = _ELEMENTWISE[kind](pred, target)
    return masked_mean(elem, mask[..., None].expand(elem.shape))


def masked_bce(pred: torch.Tensor, mask: torch.Tensor,
               target_value: float = 0.0, eps: float = 1e-7) -> torch.Tensor:
    """Masked BCE against a constant target (the alpha-mask loss)."""
    p = torch.clamp(pred, eps, 1.0 - eps)
    t = torch.full_like(p, target_value)
    elem = -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))
    mask = mask.reshape(mask.shape + (1,) * (elem.ndim - mask.ndim))
    return masked_mean(elem, mask.expand(elem.shape))
