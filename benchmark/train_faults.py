"""Faults planted under the timed path of training steps (the kind
``train_step``), for the tests that show a broken step comes out not
``correct``, and for the readings that bound the limits.

Each wraps the trainer's ``train_step`` (the call the window drives):

- ``stale``: the step returns its state unchanged (the parameters are put
  back as they were before it);
- ``stale_part``: one part of the model is left unmoved (its parameters
  put back after each step), as an optimizer that dropped it would: the
  NoFs of a stage-3 model (fewer than half its leaves), the fine NeRF of a
  stage-1 one;
- ``half``: half of the batch left out, the mean taken over the rest (the
  step sees the first half of its rays);
- ``alter``: the step's answer altered where it is produced (its image loss
  reported 1% high).

A one-chip training cell has no exchange between chips to leave out.
"""

from __future__ import annotations

import dataclasses

import torch

from .reference.model import leaves

KINDS = ("stale", "stale_part", "half", "alter")


def _half(draws):
    n = draws.pixels.shape[0] // 2
    return dataclasses.replace(draws, pixels=draws.pixels[:n],
                               perturb=draws.perturb[:n], pdf=draws.pdf[:n])


def plant(trainer, kind: str) -> None:
    """Break ``trainer.train_step`` as ``kind`` says."""
    step = trainer.train_step

    def broken(draws=None):
        if kind == "half":
            return step(draws=_half(draws))
        if kind in ("stale", "stale_part"):
            named = leaves(trainer.params)
            if kind == "stale_part":
                part = ("bw_NoF", "fw_NoF") if "bw_NoF" in trainer.params \
                    else ("fine_NeRF",)
                named = {k: t for k, t in named.items()
                         if k.split("/")[0] in part}
            before = {k: t.detach().clone() for k, t in named.items()}
            out = step(draws=draws)
            with torch.no_grad():
                for k, t in named.items():
                    t.copy_(before[k])
            return out
        if kind == "alter":
            out = step(draws=draws)
            out["img_loss"] = out["img_loss"] * 1.01
            return out
        raise ValueError(f"unknown fault {kind!r}")

    trainer.train_step = broken
