"""Trainer registry (port of ``moco_flow_tpu/train/__init__.py``)."""

from .base import BaseTrainer
from .stage_mocoflow import MoCoFlowTrainer
from .stage_nerf import NeRFTrainer
from .stage_nof import NoFTrainer

_TRAINERS = {"nerf": NeRFTrainer, "nof": NoFTrainer,
             "moco_flow": MoCoFlowTrainer}


def get_trainer(config: dict, **kwargs) -> BaseTrainer:
    """The trainer of ``model.type``: ``nerf`` (stage 1), ``nof`` (stage 2)
    or ``moco_flow`` (stage 3); ``kwargs`` go to its constructor."""
    kind = config["model"]["type"]
    if kind not in _TRAINERS:
        raise ValueError(f"trainer for model type {kind!r} not found")
    return _TRAINERS[kind](config, **kwargs)


__all__ = ["BaseTrainer", "MoCoFlowTrainer", "NeRFTrainer", "NoFTrainer",
           "get_trainer"]
