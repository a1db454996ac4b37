"""The training clock (epoch / minibatch / global step), checkpointed with
the parameters.

Port of ``moco_flow_tpu/utils/clock.py``'s ``TrainClock``; the training loop
that ticks it is ``train/__main__.py::train``.
"""

from __future__ import annotations


class TrainClock:
    def __init__(self):
        self.epoch = 1
        self.minibatch = 0
        self.step = 0

    def tick(self, step: int = 1):
        self.minibatch += 1
        self.step += step

    def tock(self):
        self.epoch += 1
        self.minibatch = 0

    def make_checkpoint(self) -> dict:
        return {"epoch": self.epoch, "minibatch": self.minibatch,
                "step": self.step}

    def restore_checkpoint(self, d: dict):
        self.epoch = d["epoch"]
        self.minibatch = d["minibatch"]
        self.step = d["step"]
