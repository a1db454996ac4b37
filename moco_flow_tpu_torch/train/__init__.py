"""Trainer registry (port of ``moco_flow_tpu/train/__init__.py``)."""

from .base import BaseTrainer
from .stage_mocoflow import MoCoFlowTrainer
from .stage_nerf import NeRFTrainer


def get_trainer(config: dict, **kwargs) -> BaseTrainer:
    """The trainer of ``model.type``: ``nerf`` (stage 1) or ``moco_flow``
    (stage 3); ``kwargs`` go to its constructor."""
    kind = config["model"]["type"]
    if kind == "nerf":
        return NeRFTrainer(config, **kwargs)
    if kind == "moco_flow":
        return MoCoFlowTrainer(config, **kwargs)
    if kind == "nof":
        raise NotImplementedError(
            "stage 2 (the NoF pretraining, model.type 'nof') is not ported "
            "yet; ROADMAP 'Modules to port' item 1")
    raise ValueError(f"trainer for model type {kind!r} not found")


__all__ = ["BaseTrainer", "MoCoFlowTrainer", "NeRFTrainer", "get_trainer"]
