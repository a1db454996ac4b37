"""The random inputs of one training step, drawn in one place.

JAX's threefry streams cannot be reproduced with torch, so the trainer draws
every random number of a step from one ``torch.Generator`` into a ``Draws``
record, and every function that consumes randomness takes the record. A test
can fill one from JAX's keys and hand both packages the same numbers.

Stage 3's step draws a ``Draws`` (:func:`draw`); stage 2's step and val step
draw only correspondence points, a ``PointDraws`` (:func:`draw_points`,
:func:`draw_val_points`).
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
    # the correspondence draws, only in the full / msk phases
    cube: torch.Tensor | None = None    # (N_sampled, 3) uniform in +-1.5
    pick: torch.Tensor | None = None    # (N_sampled,) int64 vertex ids
    noise: torch.Tensor | None = None   # (N_sampled, 3) standard normal
    # the sigma noise of the coarse and fine passes (standard normals, scaled
    # by noise_std in the render), only with noise_std > 0
    sigma_noise_coarse: torch.Tensor | None = None   # (N, S)
    sigma_noise_fine: torch.Tensor | None = None     # (N, S + I)

    def to(self, device) -> "Draws":
        def mv(t):
            return None if t is None else t.to(device)
        return dataclasses.replace(
            self, pixels=mv(self.pixels), background=mv(self.background),
            perturb=mv(self.perturb), pdf=mv(self.pdf), cube=mv(self.cube),
            pick=mv(self.pick), noise=mv(self.noise),
            sigma_noise_coarse=mv(self.sigma_noise_coarse),
            sigma_noise_fine=mv(self.sigma_noise_fine))


@dataclasses.dataclass
class PointDraws:
    """The random inputs of one stage-2 point set."""
    frame: int
    cube: torch.Tensor          # (N_sampled, 3) uniform in +-1.5
    pick: torch.Tensor          # (N_sampled,) int64 vertex ids
    noise: torch.Tensor         # (N_sampled, 3) standard normal

    def to(self, device) -> "PointDraws":
        return dataclasses.replace(self, cube=self.cube.to(device),
                                   pick=self.pick.to(device),
                                   noise=self.noise.to(device))


def _corr(gen: torch.Generator, n_sampled: int, num_verts: int) -> dict:
    """The correspondence draws: cube points, vertex ids, surface noise."""
    return {"cube": torch.rand((n_sampled, 3), generator=gen) * 3.0 - 1.5,
            "pick": torch.randint(0, num_verts, (n_sampled,), generator=gen),
            "noise": torch.randn((n_sampled, 3), generator=gen)}


def draw_points(gen: torch.Generator, frame: int, n_sampled: int,
                num_verts: int) -> PointDraws:
    """A stage-2 step's draws for ``frame`` (drawn by the caller's frame
    policy): ``n_sampled`` cube points and surface picks over ``num_verts``
    SMPL vertices, from ``gen`` on the CPU."""
    return PointDraws(frame, **_corr(gen, n_sampled, num_verts))


def draw_val_points(step: int, num_frames: int, num_verts: int,
                    n_sampled: int = 10000) -> PointDraws:
    """The stage-2 val step's fresh point set: its frame drawn uniformly,
    then its points, from a generator seeded by (777, ``step``), as JAX's
    ``val_step`` seeds its key."""
    gen = torch.Generator().manual_seed(777 * 1_000_003 + int(step))
    frame = int(torch.randint(0, num_frames, (), generator=gen))
    return draw_points(gen, frame, n_sampled, num_verts)


def draw(gen: torch.Generator, frame: int, valid_count: int, n_rand: int,
         n_samples: int, n_importance: int, num_frames: int,
         chain_global: bool, n_sampled: int = 0,
         num_verts: int = 0, noise_std: float = 0.0) -> Draws:
    """One step's draws for ``frame`` (drawn by the caller's frame policy)
    whose valid-pixel table holds ``valid_count`` pixels; with
    ``n_sampled > 0`` also the correspondence draws over ``num_verts`` SMPL
    vertices; with ``noise_std > 0`` then the sigma noise of both passes
    (after every other draw, so a config without it draws what it always
    drew). Made on the CPU from ``gen``; move them with :meth:`Draws.to`."""
    pixels = torch.randint(0, valid_count, (n_rand,), generator=gen)
    background = torch.rand((1, 3), generator=gen)
    chained = (int(torch.randint(0, num_frames, (), generator=gen))
               if chain_global else None)
    perturb = torch.rand((n_rand, n_samples), generator=gen)
    pdf = torch.rand((n_rand, max(n_importance, 0)), generator=gen)
    corr = _corr(gen, n_sampled, num_verts) if n_sampled > 0 else {}
    if noise_std > 0:
        corr["sigma_noise_coarse"] = torch.randn((n_rand, n_samples),
                                                 generator=gen)
        if n_importance > 0:
            corr["sigma_noise_fine"] = torch.randn(
                (n_rand, n_samples + n_importance), generator=gen)
    return Draws(frame, pixels, background, chained, perturb, pdf, **corr)
