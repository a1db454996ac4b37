"""The random inputs of one training step, drawn in one place.

JAX's threefry streams cannot be reproduced with torch, so the trainer draws
every random number of a step from one ``torch.Generator`` into a ``Draws``
record, and every function that consumes randomness takes the record. A test
can fill one from JAX's keys and hand both packages the same numbers.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Draws:
    frame: int                  # the training frame
    pixels: torch.Tensor        # (N,) int64 slots of the frame's valid-pixel table
    background: torch.Tensor    # (1, 3) random background colour
    chained: int | None         # the chained frame of the global chain
    perturb: torch.Tensor       # (N, S) uniforms of the depth jitter
    pdf: torch.Tensor           # (N, I) uniforms of the importance depths

    def to(self, device) -> "Draws":
        return dataclasses.replace(
            self, pixels=self.pixels.to(device),
            background=self.background.to(device),
            perturb=self.perturb.to(device), pdf=self.pdf.to(device))


def draw(gen: torch.Generator, frame: int, valid_count: int, n_rand: int,
         n_samples: int, n_importance: int, num_frames: int,
         chain_global: bool) -> Draws:
    """One step's draws for ``frame`` (drawn by the caller's frame policy)
    whose valid-pixel table holds ``valid_count`` pixels. Made on the CPU
    from ``gen``; move them with :meth:`Draws.to`."""
    pixels = torch.randint(0, valid_count, (n_rand,), generator=gen)
    background = torch.rand((1, 3), generator=gen)
    chained = (int(torch.randint(0, num_frames, (), generator=gen))
               if chain_global else None)
    perturb = torch.rand((n_rand, n_samples), generator=gen)
    pdf = torch.rand((n_rand, max(n_importance, 0)), generator=gen)
    return Draws(frame, pixels, background, chained, perturb, pdf)
