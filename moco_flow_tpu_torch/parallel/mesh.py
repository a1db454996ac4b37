"""The training frame of a step, on one device.

Port of ``sample_frame`` and ``epoch_perm_frame`` of
``moco_flow_tpu/parallel/mesh.py`` (``model.frame_sampling``). The JAX
package draws from its step key; here the draws come from the trainer's
``torch.Generator`` (``uniform``) or from a generator seeded with the run's
seed and the epoch (``epoch_perm``). Data parallelism over several cards
waits for a later slice.
"""

from __future__ import annotations

import torch

FRAME_SAMPLING_POLICIES = ("uniform", "sequential", "epoch_perm")


def epoch_perm_frame(seed: int, step_idx: int, num_frames: int) -> int:
    """Every consecutive block of ``num_frames`` steps visits each frame once,
    in an order shuffled per epoch (a pure function of seed and step)."""
    epoch = step_idx // num_frames
    gen = torch.Generator().manual_seed(
        (int(seed) * 1_000_003 + 0x5EED) * 1_000_003 + epoch)
    return int(torch.randperm(num_frames, generator=gen)[step_idx % num_frames])


def sample_frame(policy: str, seed: int, step_idx: int, num_frames: int,
                 gen: torch.Generator) -> int:
    """The frame of step ``step_idx`` under ``policy``: ``uniform`` (an iid
    draw from ``gen``), ``sequential`` (``step % num_frames``) or
    ``epoch_perm`` (:func:`epoch_perm_frame`)."""
    if policy == "uniform":
        return int(torch.randint(0, num_frames, (), generator=gen))
    if policy == "sequential":
        return step_idx % num_frames
    if policy == "epoch_perm":
        return epoch_perm_frame(seed, step_idx, num_frames)
    raise ValueError("model.frame_sampling must be one of "
                     f"{FRAME_SAMPLING_POLICIES}, got {policy!r}")
