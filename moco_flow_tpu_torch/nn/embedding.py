"""Sinusoidal positional encoding with coarse-to-fine frequency annealing.

Port of ``moco_flow_tpu/nn/embedding.py``: the block layout
``[x, sin(f_0 x)..sin(f_{K-1} x), cos(f_0 x)..cos(f_{K-1} x)]`` (a fixed
permutation of the reference's interleaved order, PARITY.md) and the
windowed annealing weights as a pure function of the step.
"""

from __future__ import annotations

import numpy as np
import torch


def freq_bands(n_freqs: int, logscale: bool = True) -> np.ndarray:
    """Frequency bands ``2^0 .. 2^{K-1}`` (log) or linear ``1 .. 2^{K-1}``."""
    if n_freqs <= 0:
        return np.zeros((0,), dtype=np.float32)
    if logscale:
        return (2.0 ** np.linspace(0.0, n_freqs - 1, n_freqs)).astype(np.float32)
    return np.linspace(1.0, 2.0 ** (n_freqs - 1), n_freqs).astype(np.float32)


_BANDS = {}   # (n_freqs, logscale, device) -> the bands there (device_bands)


def device_bands(n_freqs: int, logscale: bool, device) -> torch.Tensor:
    """:func:`freq_bands` as a tensor on ``device``, copied there once: a
    copy from pageable host memory waits for every kernel queued before
    it, which would hold the host back at each embedding of a step."""
    key = (n_freqs, bool(logscale), str(device))
    if key not in _BANDS:
        _BANDS[key] = torch.from_numpy(freq_bands(n_freqs, logscale)).to(
            device)
    return _BANDS[key]


def out_channels(in_channels: int, n_freqs: int) -> int:
    """Embedded width: ``in_channels * (2 * n_freqs + 1)``."""
    return in_channels * (2 * n_freqs + 1)


def posenc(x: torch.Tensor, n_freqs: int, logscale: bool = True,
           weights: torch.Tensor | None = None) -> torch.Tensor:
    """Positional-encode ``x`` (..., C) along the last axis.

    Returns ``(..., C * (2*n_freqs + 1))`` laid out ``[x, sin, cos]`` with the
    sin/cos blocks frequency-major; ``weights`` (n_freqs,) scales each
    frequency's sin and cos (None = all ones).
    """
    if n_freqs == 0:
        return x
    c = x.shape[-1]
    bands = device_bands(n_freqs, logscale, x.device)
    scaled = (x[..., None, :] * bands[:, None]).reshape(
        *x.shape[:-1], n_freqs * c)
    s, co = torch.sin(scaled), torch.cos(scaled)
    if weights is not None:
        w = weights.to(x.device, torch.float32).repeat_interleave(c)
        s = s * w
        co = co * w
    return torch.cat([x, s, co], dim=-1)


def anneal_weights(step: int, n_freqs: int, start_iter: int,
                   end_iter: int) -> torch.Tensor:
    """Windowed coarse-to-fine annealing weights (n_freqs,) at ``step``:
    frequency ``k`` gets ``clip((step-start)/delta - k, 0, 1)`` with
    ``delta = (end-start) // n_freqs``; all ones from ``end`` on."""
    if n_freqs == 0:
        return torch.zeros((0,), dtype=torch.float32)
    n_iters = end_iter - start_iter
    delta = max(n_iters // n_freqs, 1)
    cur = torch.tensor(float(min(max(step - start_iter, 0), n_iters)),
                       dtype=torch.float32)
    k = torch.arange(n_freqs, dtype=torch.float32)
    w = torch.clamp(cur / delta - k, 0.0, 1.0)
    if step >= end_iter:
        return torch.ones_like(w)
    return w
