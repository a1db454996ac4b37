"""Ray depth sampling: stratified coarse depths (jittered in training),
inverse-CDF importance depths, the fine-sample budget compaction, and the
depth merge of two warped sample sets.

Port of ``moco_flow_tpu/render/sampling.py``. The random draws of training
(the jitter and the pdf uniforms) are arguments: the caller draws them (the
trainer's ``Draws``), so a test can hand both packages the same numbers.
The JAX package sorts with gather-free variadic sorts and a custom VJP,
because a TPU has no fast gather; here a stable ``torch.sort`` and
``gather`` do the same, and autograd gives the backward.
"""

from __future__ import annotations

import torch


def stratified_zvals(near: torch.Tensor, far: torch.Tensor, n_samples: int,
                     use_disp: bool = False, perturb: float = 0.0,
                     u: torch.Tensor | None = None) -> torch.Tensor:
    """(N, n_samples) depths between ``near`` and ``far`` ((N, 1) each),
    each jittered within its stratum by ``perturb * u`` when ``perturb > 0``
    (``u``: (N, n_samples) uniforms in [0, 1))."""
    z_steps = torch.linspace(0.0, 1.0, n_samples, device=near.device)
    if not use_disp:
        z_vals = near * (1.0 - z_steps) + far * z_steps
    else:
        z_vals = 1.0 / (1.0 / near * (1.0 - z_steps) + 1.0 / far * z_steps)
    if perturb > 0:
        if u is None:
            raise ValueError("perturbed depths need their uniforms u")
        mids = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        upper = torch.cat([mids, z_vals[:, -1:]], dim=-1)
        lower = torch.cat([z_vals[:, :1], mids], dim=-1)
        z_vals = lower + (upper - lower) * (perturb * u)
    return z_vals


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_importance: int,
               det: bool = True, eps: float = 1e-5,
               u: torch.Tensor | None = None) -> torch.Tensor:
    """``n_importance`` samples from the piecewise-constant pdf over ``bins``
    (N, B+1) with ``weights`` (N, B): the reference's eps guard,
    right-searchsorted and zero-denominator fallback. ``det``: evenly
    spaced quantiles; else the quantiles are ``u`` (N, n_importance).

    Written, like the JAX version, as masked max/min reductions over the
    prefix mask ``cdf <= u`` instead of index gathers, so both agree on every
    tie."""
    if not det and u is None:
        raise ValueError("random pdf samples need their uniforms u")
    n_rays = weights.shape[0]
    weights = weights + eps
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)  # (N, B+1)
    if det:
        u = torch.linspace(0.0, 1.0, n_importance,
                           device=bins.device).expand(n_rays, n_importance)

    big = torch.finfo(cdf.dtype).max
    m = cdf[:, None, :] <= u[:, :, None]  # (N, I, B+1), a prefix mask
    zero = torch.zeros((), dtype=cdf.dtype, device=cdf.device)
    cdf_below = torch.amax(torch.where(m, cdf[:, None, :], zero), dim=-1)
    bins_below = torch.amax(torch.where(m, bins[:, None, :], -big), dim=-1)
    cdf_above = torch.amin(torch.where(m, big, cdf[:, None, :]), dim=-1)
    cdf_above = torch.minimum(cdf_above, cdf[:, -1:])
    bins_above = torch.amin(torch.where(m, big, bins[:, None, :]), dim=-1)
    bins_above = torch.minimum(bins_above, bins[:, -1:])

    denom = cdf_above - cdf_below
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bins_below + (u - cdf_below) / denom * (bins_above - bins_below)


def compact_fine_samples(z_all: torch.Tensor, bins: torch.Tensor,
                         weights: torch.Tensor, budget: int):
    """Keep the ``budget`` fine samples whose coarse bins carry the most
    compositing weight, re-sorted by depth, each with its ORIGINAL delta.

    Args:
      z_all: (N, S) sorted fine depths.
      bins: (N, B+1) coarse bin edges; weights: (N, B) their weights.

    Returns (z_k, deltas_k), each (N, budget), z-ascending.

    Both sorts are STABLE. The JAX version sorts with ``lax.sort``, which is
    stable, and equal scores are common (every sample of one bin shares the
    bin's weight, and out-of-range samples all score the dtype max): an
    unstable sort would keep a different subset among tied samples, and a
    cut budget would then drop other samples than the JAX package drops.
    """
    s = z_all.shape[1]
    budget = min(budget, s)
    deltas = torch.cat([z_all[:, 1:] - z_all[:, :-1],
                        torch.full_like(z_all[:, :1], 1e10)], dim=-1)
    zero = torch.zeros((), dtype=weights.dtype, device=weights.device)
    lo = torch.sum(torch.where(bins[:, None, :-1] <= z_all[:, :, None],
                               weights[:, None, :], zero), dim=-1)
    hi = torch.sum(torch.where(bins[:, None, 1:] <= z_all[:, :, None],
                               weights[:, None, :], zero), dim=-1)
    w_sample = lo - hi
    outside = (z_all < bins[:, :1]) | (z_all >= bins[:, -1:])
    score = torch.where(outside, torch.finfo(z_all.dtype).max, w_sample)
    order = torch.sort(-score, dim=-1, stable=True).indices[:, :budget]
    z_top = torch.gather(z_all, 1, order)
    d_top = torch.gather(deltas, 1, order)
    z_k, pos = torch.sort(z_top, dim=-1, stable=True)
    return z_k, torch.gather(d_top, 1, pos)


def merge_cano_by_z(z_a: torch.Tensor, z_b: torch.Tensor,
                    cano_a: torch.Tensor, cano_b: torch.Tensor):
    """:func:`merge_cano_by_z_t` on row-major warps ``cano_*`` ((N, S*, 3),
    the per-op route's layout): returns ``(z_all, cano (N, Sa+Sb, 3),
    pos)``."""
    keys = torch.cat([z_a, z_b], dim=-1)
    cat = torch.cat([cano_a, cano_b], dim=1)
    z_all, pos = torch.sort(keys, dim=-1, stable=True)
    cano = torch.gather(cat, 1, pos[..., None].expand_as(cat))
    return z_all, cano, pos


def merge_cano_by_z_t(z_a: torch.Tensor, z_b: torch.Tensor,
                      cano_a_t: torch.Tensor, cano_b_t: torch.Tensor):
    """Depth-merge two per-ray sample sets, permuting only the canonical
    warps ``cano_*_t`` ((3, N, S*), the fine NeRF's input) with them.

    Returns ``(z_all (N, Sa+Sb), cano (3, N, Sa+Sb), pos (N, Sa+Sb))``:
    ``pos`` is the pre-sort (concatenation) index of each sorted slot, so
    ``pos < Sa`` marks set a. The sort is stable, like ``lax.sort``."""
    keys = torch.cat([z_a, z_b], dim=-1)
    cat = torch.cat([cano_a_t, cano_b_t], dim=2)
    z_all, pos = torch.sort(keys, dim=-1, stable=True)
    cano = torch.gather(cat, 2, pos[None].expand_as(cat))
    return z_all, cano, pos


def unsort_by_pos(pos: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x`` (N, S) from sorted order back to concatenation order:
    ``out[pos[i]] = x[i]``, row-wise (``pos`` rows are permutations)."""
    rank = torch.argsort(pos, dim=-1, stable=True)
    return torch.gather(x, 1, rank)
