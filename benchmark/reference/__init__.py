"""The plain reference of the benchmark's training steps (``model.py``)."""

from .model import run_steps

__all__ = ["run_steps"]
