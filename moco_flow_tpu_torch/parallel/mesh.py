"""The training frame of a step, per-rank draws and the gradient reduce.

Port of ``moco_flow_tpu/parallel/mesh.py``. ``sample_frame`` and
``epoch_perm_frame`` pick a step's frame (``model.frame_sampling``); the
JAX package draws from its step key, the port from the trainer's
``torch.Generator`` (``uniform``) or from a generator seeded with the run's
seed and the epoch (``epoch_perm``).

Data parallelism: every rank holds the whole model and draws its own
``N_rand`` rays (the global batch is ``N_rand`` times the world), so a rank
folds its index into the seeds of its draws (:func:`fold_rank_if`, the
counterpart of ``fold_key_if``), and one collective a step,
:func:`all_reduce_mean`, averages the gradients and the step's metrics over
the ranks (``pmean_if``). With ``rank=None`` (world 1) every draw is what it
was without data parallelism and no collective runs.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

FRAME_SAMPLING_POLICIES = ("uniform", "sequential", "epoch_perm")
_SEED_MOD = 1 << 63


def fold_rank_if(seed: int, rank: int | None) -> int:
    """A generator seed of its own for each rank from one shared ``seed``;
    ``seed`` itself with ``rank`` None (world 1)."""
    if rank is None:
        return int(seed)
    return (int(seed) * 1_000_003 + int(rank)) % _SEED_MOD


def epoch_perm_frame(seed: int, step_idx: int, num_frames: int,
                     rank: int | None = None) -> int:
    """Every consecutive block of ``num_frames`` steps visits each frame once,
    in an order shuffled per epoch (a pure function of seed and step); each
    rank shuffles its own order, as each JAX chip does."""
    epoch = step_idx // num_frames
    gen = torch.Generator().manual_seed(fold_rank_if(
        (int(seed) * 1_000_003 + 0x5EED) * 1_000_003 + epoch, rank))
    return int(torch.randperm(num_frames, generator=gen)[step_idx % num_frames])


def sample_frame(policy: str, seed: int, step_idx: int, num_frames: int,
                 gen: torch.Generator, rank: int | None = None) -> int:
    """The frame of step ``step_idx`` under ``policy``: ``uniform`` (an iid
    draw from ``gen``, which the caller seeds per rank), ``sequential``
    (``step % num_frames``, the same on every rank) or ``epoch_perm``
    (:func:`epoch_perm_frame`)."""
    if policy == "uniform":
        return int(torch.randint(0, num_frames, (), generator=gen))
    if policy == "sequential":
        return step_idx % num_frames
    if policy == "epoch_perm":
        return epoch_perm_frame(seed, step_idx, num_frames, rank)
    raise ValueError("model.frame_sampling must be one of "
                     f"{FRAME_SAMPLING_POLICIES}, got {policy!r}")


def all_reduce_mean(tensors, metrics: dict, world: int) -> dict:
    """Average the gradients of ``tensors`` and the ``metrics`` (0-dim
    tensors or floats) over the ranks in one collective: both are flattened
    into one fp32 buffer, summed over the ranks, divided by ``world`` and
    written back (the gradients in place). Returns the averaged metrics as
    0-dim tensors. At world 1 nothing runs and ``metrics`` come back as
    they are.

    A tensor without a gradient is left out; every rank runs the same
    phase of the same config, so the set is the same on every rank."""
    if world <= 1:
        return metrics
    grads = [t.grad for t in tensors if t.grad is not None]
    dev = grads[0].device if grads else next(
        (v.device for v in metrics.values() if torch.is_tensor(v)),
        torch.device("cpu"))
    keys = list(metrics)
    vals = [torch.as_tensor(metrics[k], dtype=torch.float32, device=dev)
            .reshape(1) for k in keys]
    buf = torch.cat([g.reshape(-1).float() for g in grads] + vals)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    buf.div_(world)
    off = 0
    for g in grads:
        n = g.numel()
        g.copy_(buf[off:off + n].view_as(g))
        off += n
    return {k: buf[off + i] for i, k in enumerate(keys)}


def broadcast_tensors(tensors):
    """Rank 0's values of ``tensors`` on every rank, in one broadcast of
    their bytes (each tensor's at an offset of a multiple of 16 bytes, so
    every dtype views its own). Every rank of the group calls it."""
    tensors = list(tensors)
    sizes = [t.numel() * t.element_size() for t in tensors]
    offs = [0]
    for n in sizes:
        offs.append(offs[-1] + -(-n // 16) * 16)
    buf = torch.zeros(offs[-1], dtype=torch.uint8, device=tensors[0].device)
    for t, o, n in zip(tensors, offs, sizes):
        buf[o:o + n] = t.detach().contiguous().reshape(-1).view(torch.uint8)
    dist.broadcast(buf, src=0)
    with torch.no_grad():
        for t, o, n in zip(tensors, offs, sizes):
            t.copy_(buf[o:o + n].view(t.dtype).view_as(t))
