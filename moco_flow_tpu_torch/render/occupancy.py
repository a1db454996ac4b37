"""Occupancy-grid empty-space skipping: a per-frame grid and tightened ray
bounds.

Port of ``moco_flow_tpu/render/occupancy.py``. A cached observation-space
grid of each frame (canonical for frame -1) bounds the activated density a
ray can meet, so every pass's samples go to the part of a ray's
[near, far] that can hold density, and a ray that provably meets none is
not rendered at all.

1. ``build_occupancy_grid``: sigma (warped by the frame's bw NoF) on a
   supersampled lattice, max-pooled to the grid, activated and dilated by
   one cell; three builders: ``device`` (the default, ``train/vis.py``'s
   ``grid_sig_device`` / ``outer_bound_device``), the host oracle
   (``device=False``, through ``sigma_grid``) and ``builder="warp"``, the
   canonical grid pulled back through the frame's bw warp
   (``warp_grid_device``).
2. Tightening: probe the grid along a coarse subgrid of rays, integrate the
   per-cell bound (the tau integral), dilate in image space, pad by grid
   cells, upsample and rewrite the rays' near / far columns. Rays whose
   whole-span bound stays under ``tau_eps`` are marked empty.
   ``tighten_ray_bounds`` is the numpy oracle (``occ_impl: host``);
   ``tighten_ray_bounds_device`` the same math in torch ops on the rays'
   device, whose probe plan reads back a few scalars, never the rays.
3. Render as before: the stratified depths read the per-ray near / far.

Error bound: everything excluded (skipped rays and cut segments alike)
carries an optical-depth upper bound <= ``tau_eps``: probes read the
dilated per-cell max of the activated density. Probes outside the grid
cube read a measured bound of the outer region (``outer_sig``) out to
``outer_extent`` and +inf beyond it, so a field with density outside the
cube cannot be skipped rather than losing visible rays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class OccupancyGrid:
    """Host-side occupancy over the cube [-extent, extent]^3, index order
    (x, y, z).

    ``sig`` is the per-cell upper bound of the activated density
    (max-pooled over the supersampled lattice, then 3^3-max dilated);
    ``occ`` its thresholded bool view. A grid built from a bool mask gets
    ``sig = inf`` in occupied cells and 0 elsewhere. ``outer_sig`` bounds
    the activated density outside the cube out to ``outer_extent`` (probes
    beyond read +inf); a grid built from a mask keeps 0 / inf, "the field
    is the grid"."""
    occ: np.ndarray       # (R, R, R) bool
    extent: float
    threshold: float
    sig: np.ndarray | None = None  # (R, R, R) float32, dilated upper bound
    outer_sig: float = 0.0
    outer_extent: float = float("inf")

    def __post_init__(self):
        if self.sig is None:
            self.sig = np.where(self.occ, np.inf, 0.0).astype(np.float32)

    @property
    def resolution(self) -> int:
        return self.occ.shape[0]

    @property
    def cell(self) -> float:
        return 2.0 * self.extent / self.resolution

    @property
    def occupancy_fraction(self) -> float:
        return float(self.occ.mean())

    def device_sig(self, device) -> torch.Tensor:
        """Flattened ``sig`` on ``device`` (the device tightener's input),
        uploaded once a device."""
        cache = self.__dict__.setdefault("_device_sig", {})
        key = str(torch.device(device))
        if key not in cache:
            cache[key] = torch.from_numpy(
                np.ascontiguousarray(self.sig).reshape(-1)).to(device)
        return cache[key]

    def outer_sig_tensor(self, device) -> torch.Tensor:
        return torch.tensor(self.outer_sig, dtype=torch.float32,
                            device=device)


class DeviceOccupancyGrid:
    """An :class:`OccupancyGrid` whose bound ``sig_dev`` (R, R, R) and outer
    bound ``outer_sig_dev`` (0-d, or None for none) live on the device:
    building it reads nothing back; the host views (``sig``, ``occ``,
    ``occupancy_fraction``, ``outer_sig``) are fetched when asked for."""

    def __init__(self, sig_dev: torch.Tensor, extent: float,
                 threshold: float, outer_sig_dev: torch.Tensor | None = None,
                 outer_extent: float = float("inf")):
        self.sig_dev = sig_dev
        self.extent = float(extent)
        self.threshold = float(threshold)
        self.outer_sig_dev = outer_sig_dev
        self.outer_extent = float(outer_extent)
        self._sig_host = None

    @property
    def resolution(self) -> int:
        return int(self.sig_dev.shape[0])

    @property
    def cell(self) -> float:
        return 2.0 * self.extent / self.resolution

    def device_sig(self, device=None) -> torch.Tensor:
        return self.sig_dev.reshape(-1)

    def outer_sig_tensor(self, device=None) -> torch.Tensor:
        if self.outer_sig_dev is None:
            return torch.zeros((), dtype=torch.float32,
                               device=self.sig_dev.device)
        return self.outer_sig_dev.float()

    @property
    def sig(self) -> np.ndarray:
        if self._sig_host is None:
            self._sig_host = self.sig_dev.float().cpu().numpy()
        return self._sig_host

    @property
    def occ(self) -> np.ndarray:
        return self.sig > self.threshold

    @property
    def occupancy_fraction(self) -> float:
        return float(self.occ.mean())

    @property
    def outer_sig(self) -> float:
        return (0.0 if self.outer_sig_dev is None
                else float(self.outer_sig_dev))


def _dilate3d(occ: np.ndarray, steps: int = 1) -> np.ndarray:
    """3-D max-filter dilation by ``steps`` cells (full 3^3 neighbourhood);
    bool (binary dilation) or float (running max, padded with 0)."""
    out = occ
    reduce = np.logical_or if occ.dtype == bool else np.maximum
    for _ in range(steps):
        p = np.pad(out, 1) if occ.dtype == bool else \
            np.pad(out, 1, constant_values=0.0)
        acc = None
        for dx in (0, 1, 2):
            for dy in (0, 1, 2):
                for dz in (0, 1, 2):
                    s = p[dx:dx + out.shape[0],
                          dy:dy + out.shape[1],
                          dz:dz + out.shape[2]]
                    acc = s.copy() if acc is None else reduce(acc, s)
        out = acc
    return out


def _activate(sig: np.ndarray, rcfg) -> np.ndarray:
    """Raw sigma -> the activated density the renderer integrates (both
    activations are monotone, so pooling before activating is exact)."""
    if rcfg is not None and getattr(rcfg, "activation", None) == "softplus":
        return np.logaddexp(sig, 0.0)
    return np.maximum(sig, 0.0)


def build_occupancy_grid(trainer, frame_idx: int, resolution: int = 64,
                         supersample: int = 2, threshold: float = 5.0,
                         extent: float = 1.5, dilate: int = 1,
                         outer_factor: float = 2.0, device: bool = True,
                         builder: str = "direct", cano_grid=None):
    """Occupancy of sigma(bw_warp(x, frame)) (canonical sigma for frame -1)
    over [-extent, extent]^3.

    The threshold applies to the activated density (the trainer's test
    render config: relu or softplus). ``supersample``: sigma on a
    (resolution * supersample)^3 lattice, max-pooled, so sub-cell features
    set their cell. ``device=True`` (default) builds on the trainer's
    device and returns a :class:`DeviceOccupancyGrid`; ``device=False`` is
    the host oracle through ``sigma_grid`` and returns an
    :class:`OccupancyGrid`. ``builder="warp"`` with a ``cano_grid`` pulls
    the canonical grid back through the frame's bw warp, at supersample 1
    with one more dilation step, which covers the half-cell gap the
    supersampled max-pool would have resolved.
    """
    rcfg = getattr(trainer, "rcfg_test", None)
    activation = ("softplus" if rcfg is not None
                  and getattr(rcfg, "activation", None) == "softplus"
                  else "relu")

    if builder == "warp" and frame_idx != -1 and cano_grid is not None:
        from ..train.vis import warp_grid_device
        outer_extent = float(extent * outer_factor)
        sig, outer_sig = warp_grid_device(
            trainer, frame_idx, resolution, cano_grid,
            supersample=1, extent=extent, dilate=dilate + 1,
            outer_extent=outer_extent if outer_factor > 1.0 else None)
        return DeviceOccupancyGrid(sig, extent=float(extent),
                                   threshold=float(threshold),
                                   outer_sig_dev=outer_sig,
                                   outer_extent=(outer_extent
                                                 if outer_factor > 1.0
                                                 else float(extent)))

    if device:
        from ..train.vis import grid_sig_device, outer_bound_device
        sig = grid_sig_device(trainer, frame_idx, resolution,
                              supersample=supersample, extent=extent,
                              activation=activation, dilate=dilate,
                              fetch=False)
        outer_sig, outer_extent = None, float(extent)
        if outer_factor > 1.0:
            outer_extent = float(extent * outer_factor)
            outer_sig = outer_bound_device(trainer, frame_idx, resolution,
                                           extent, outer_extent, activation,
                                           fetch=False)
        return DeviceOccupancyGrid(sig, extent=float(extent),
                                   threshold=float(threshold),
                                   outer_sig_dev=outer_sig,
                                   outer_extent=outer_extent)

    from ..train.vis import sigma_grid

    n = resolution * supersample
    sig = sigma_grid(trainer, frame_idx, n_grid=n, extent=extent,
                     clip_negative=False)
    if supersample > 1:
        sig = sig.reshape(resolution, supersample, resolution, supersample,
                          resolution, supersample).max(axis=(1, 3, 5))
    sig = _activate(sig, rcfg)
    # sigma_grid's lattice is meshgrid(xy-indexed), axis order (y, x, z):
    # transposed to (x, y, z)
    sig = np.ascontiguousarray(sig.transpose(1, 0, 2).astype(np.float32))
    if dilate:
        sig = _dilate3d(sig, dilate)
    occ = sig > threshold

    # the measured bound outside the cube: a coarse dilated lattice over
    # [-outer_factor * extent, ..]^3 without the cells inside the cube
    outer_sig, outer_extent = 0.0, float(extent)
    if outer_factor > 1.0:
        outer_extent = float(extent * outer_factor)
        s_out = _activate(
            sigma_grid(trainer, frame_idx, n_grid=resolution,
                       extent=outer_extent, clip_negative=False), rcfg)
        s_out = _dilate3d(s_out.astype(np.float32), 1)
        c = np.linspace(-outer_extent, outer_extent, resolution,
                        dtype=np.float32)
        inner = ((np.abs(c)[:, None, None] <= extent)
                 & (np.abs(c)[None, :, None] <= extent)
                 & (np.abs(c)[None, None, :] <= extent))
        outer_sig = float(s_out[~inner].max()) if (~inner).any() else 0.0

    return OccupancyGrid(occ=np.ascontiguousarray(occ), extent=float(extent),
                         threshold=float(threshold), sig=sig,
                         outer_sig=outer_sig, outer_extent=outer_extent)


def _lookup(grid: OccupancyGrid, pts: np.ndarray) -> np.ndarray:
    """(..., 3) points -> bool occupied (False outside the grid)."""
    r = grid.resolution
    ids = np.floor((pts + grid.extent) / grid.cell).astype(np.int64)
    inb = np.all((ids >= 0) & (ids < r), axis=-1)
    ids = np.clip(ids, 0, r - 1)
    return grid.occ[ids[..., 0], ids[..., 1], ids[..., 2]] & inb


def _lookup_sig(grid: OccupancyGrid, pts: np.ndarray) -> np.ndarray:
    """(..., 3) points -> per-cell sigma upper bound. Three zones: the
    grid's dilated per-cell max inside it, ``outer_sig`` outside it but
    within the measured shell, +inf beyond the shell."""
    r = grid.resolution
    ids = np.floor((pts + grid.extent) / grid.cell).astype(np.int64)
    inb = np.all((ids >= 0) & (ids < r), axis=-1)
    ids = np.clip(ids, 0, r - 1)
    in_shell = np.all(np.abs(pts) <= grid.outer_extent, axis=-1)
    out_val = np.where(in_shell, np.float32(grid.outer_sig),
                       np.float32(np.inf))
    return np.where(inb, grid.sig[ids[..., 0], ids[..., 1], ids[..., 2]],
                    out_val)


def tighten_ray_bounds(grid: OccupancyGrid, rays: np.ndarray, size,
                       pad_cells: float = 2.0, max_coarse: int = 8,
                       tau_eps: float = 1e-3):
    """Rewrite rays' near / far (columns 6, 7) to the interval that holds
    all but ``tau_eps`` of the ray's optical-depth upper bound (numpy; the
    oracle of :func:`tighten_ray_bounds_device`).

    Each probe reads the dilated per-cell max of the activated density, so
    ``max(s_i, s_{i+1}) * dt`` bounds the integral of sigma over probe
    segment i (probe spacing <= one cell). A ray whose total bound is
    <= tau_eps is marked empty (``stats['empty_mask']``); otherwise near /
    far shrink to where the leading and trailing tails each hold
    <= tau_eps / 2.

    Args:
      rays: ``(H*W, >=9)`` packed rays in image order.
      size: ``(H, W)``.
      pad_cells: extra padding of the interval, in grid cells (on top of
        one probe spacing).
      max_coarse: probe every k-th pixel in x / y, k clamped so that the
        ray spacing at the far plane stays under one cell.
      tau_eps: optical-depth budget of everything excluded.

    Returns ``(rays_tightened, stats)``; rays with nothing to exclude keep
    their bounds bit for bit.
    """
    rays = np.asarray(rays)
    h, w = size
    o, d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6].copy(), rays[:, 7].copy()

    # angular pitch between horizontally adjacent rays -> the largest safe
    # probe stride: stride * pitch * t_far <= cell
    d0 = d[0] / np.linalg.norm(d[0])
    d1 = d[1] / np.linalg.norm(d[1])
    pitch = float(np.linalg.norm(np.cross(d0, d1))) + 1e-12
    safe = int(grid.cell / (pitch * float(far.max()) + 1e-12))
    coarse = int(np.clip(safe, 1, max_coarse))

    ys = np.arange(0, h, coarse)
    xs = np.arange(0, w, coarse)
    sub = (ys[:, None] * w + xs[None, :]).reshape(-1)
    o_s, d_s = o[sub], d[sub]
    n_s, f_s = near[sub], far[sub]

    # probe spacing along t <= one cell
    dn = np.linalg.norm(d_s, axis=-1)
    span = (f_s - n_s) * dn
    n_probe = int(np.clip(np.ceil(span.max() / grid.cell) + 1, 8, 512))
    if n_probe > 8:  # bucketed up to a multiple of 32, as _probe_plan
        n_probe = min(512, -(-n_probe // 32) * 32)
    ts = n_s[:, None] + (f_s - n_s)[:, None] * \
        np.linspace(0.0, 1.0, n_probe, dtype=np.float32)[None, :]
    pts = o_s[:, None, :] + d_s[:, None, :] * ts[..., None]
    s = _lookup_sig(grid, pts)                          # (S, P)

    # per-segment optical-depth bound; prefix[:, k] bounds [t_0, t_k]
    dt = (ts[:, 1:] - ts[:, :-1]) * dn[:, None]
    seg = np.maximum(s[:, 1:], s[:, :-1]) * dt          # (S, P-1)
    zcol = np.zeros((seg.shape[0], 1), np.float32)
    prefix = np.concatenate([zcol, np.cumsum(seg, axis=1)], axis=1)  # (S, P)
    # suffix[k] = mass in [t_k, t_P]: a reverse cumsum (total - prefix is
    # inf - inf = NaN for hard-occupied inf cells)
    suffix = np.concatenate(
        [np.cumsum(seg[:, ::-1], axis=1)[:, ::-1], zcol], axis=1)
    total = prefix[:, -1]

    half = 0.5 * tau_eps
    # the last probe whose leading mass is still <= eps / 2 (prefix[0] = 0
    # always is), and the first whose trailing mass is
    lead_ok = prefix <= half
    trail_ok = suffix <= half
    t_lo = np.take_along_axis(
        ts, (lead_ok.shape[1] - 1 - np.argmax(lead_ok[:, ::-1], axis=1)
             )[:, None], axis=1)[:, 0]
    t_hi = np.take_along_axis(
        ts, np.argmax(trail_ok, axis=1)[:, None], axis=1)[:, 0]

    ch, cw = len(ys), len(xs)

    # image-space 3x3 min / max dilation (covers rays between probe rays)
    def _erode_min(a):
        p = np.pad(a.reshape(ch, cw), 1, constant_values=np.inf)
        return np.min([p[i:i + ch, j:j + cw]
                       for i in (0, 1, 2) for j in (0, 1, 2)], axis=0)

    def _dilate_max(a):
        p = np.pad(a.reshape(ch, cw), 1, constant_values=0.0)
        return np.max([p[i:i + ch, j:j + cw]
                       for i in (0, 1, 2) for j in (0, 1, 2)], axis=0)

    t_lo = _erode_min(t_lo)
    t_hi = _dilate_max(np.where(total > 0, t_hi, 0.0))
    total_d = _dilate_max(total)

    # nearest upsample back to (h, w)
    up_y = np.minimum(np.arange(h) // coarse, ch - 1)
    up_x = np.minimum(np.arange(w) // coarse, cw - 1)
    t_lo_full = t_lo[up_y[:, None], up_x[None, :]].reshape(-1)
    t_hi_full = t_hi[up_y[:, None], up_x[None, :]].reshape(-1)
    total_full = total_d[up_y[:, None], up_x[None, :]].reshape(-1)

    pad_t = pad_cells * grid.cell + span.max() / max(n_probe - 1, 1)
    empty = total_full <= tau_eps
    new_near = np.clip(t_lo_full - pad_t, near, far)
    new_far = np.clip(t_hi_full + pad_t, near, far)
    new_near = np.where(empty, near, new_near)
    new_far = np.where(empty, far, new_far)

    out = rays.copy()
    out[:, 6] = new_near.astype(rays.dtype)
    out[:, 7] = new_far.astype(rays.dtype)
    stats = {
        "coarse": coarse,
        "n_probe": n_probe,
        "empty_frac": float(empty.mean()),
        "range_ratio": float(np.mean((new_far - new_near)
                                     / (far - near + 1e-12))),
        # per-ray "provably empty" (image-dilated, conservative): such a
        # ray changes its pixel by at most ~tau_eps and renders as pure
        # background (render_masked_image)
        "empty_mask": empty,
    }
    return out, stats


# ---------------------------------------------------------------------------
# Tightening on the rays' device
# ---------------------------------------------------------------------------

def _probe_plan(grid, rays: torch.Tensor, size, max_coarse: int):
    """The probe stride and count of :func:`tighten_ray_bounds`, from the
    first two directions, ``far.max()`` and the span maximum over the probe
    subset: two reads of a few scalars, never the rays. The scalar math is
    the numpy oracle's, on the same float32 values."""
    h, w = size
    head = torch.cat([rays[:2, 3:6].reshape(-1),
                      rays[:, 7].max().reshape(1)]).cpu().numpy()
    d = head[:6].reshape(2, 3)
    d0 = d[0] / np.linalg.norm(d[0])
    d1 = d[1] / np.linalg.norm(d[1])
    pitch = float(np.linalg.norm(np.cross(d0, d1))) + 1e-12
    safe = int(grid.cell / (pitch * float(head[6]) + 1e-12))
    coarse = int(np.clip(safe, 1, max_coarse))
    ys = torch.arange(0, h, coarse, device=rays.device)
    xs = torch.arange(0, w, coarse, device=rays.device)
    sub = (ys[:, None] * w + xs[None, :]).reshape(-1)
    rs = rays[sub]
    dn = torch.sqrt((rs[:, 3:6] * rs[:, 3:6]).sum(-1))
    span_max = float(((rs[:, 7] - rs[:, 6]) * dn).max())
    n_probe = int(np.clip(np.ceil(np.float32(span_max) / grid.cell) + 1,
                          8, 512))
    # bucketed up to a multiple of 32, as the JAX package does (its
    # compile-cache reuse); extra probes only tighten the bound, and the
    # bound depends on the count
    if n_probe > 8:
        n_probe = min(512, -(-n_probe // 32) * 32)
    return coarse, n_probe, sub, rs, dn, span_max


def tighten_ray_bounds_device(grid, rays: torch.Tensor, size,
                              pad_cells: float = 2.0, max_coarse: int = 8,
                              tau_eps: float = 1e-3):
    """:func:`tighten_ray_bounds` in torch ops on the rays' device: the same
    probe lattice, tau-integral bound, image-space dilation and padding.
    Returns ``(rays, stats)``: the tightened (N, C) float32 rays and, on
    the device, ``empty_mask`` (N,) bool, ``kept_count`` (0-d int64),
    ``empty_frac`` and ``range_ratio`` (0-d); ``coarse`` and ``n_probe``
    as ints."""
    rays = rays.float()
    dev = rays.device
    h, w = size
    coarse, n_probe, sub, rs, dn, span_max = _probe_plan(
        grid, rays, size, max_coarse)
    ch, cw = -(-h // coarse), -(-w // coarse)
    o_s, d_s = rs[:, 0:3], rs[:, 3:6]
    n_s, f_s = rs[:, 6], rs[:, 7]
    near, far = rays[:, 6], rays[:, 7]
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa
    extent, cell = f32(grid.extent), f32(grid.cell)
    r = grid.resolution

    lin = torch.from_numpy(np.linspace(0.0, 1.0, n_probe,
                                       dtype=np.float32)).to(dev)
    ts = n_s[:, None] + (f_s - n_s)[:, None] * lin[None, :]
    pts = o_s[:, None, :] + d_s[:, None, :] * ts[..., None]

    # the three-zone bound of _lookup_sig
    ids = torch.floor((pts + extent) / cell).to(torch.int64)
    inb = ((ids >= 0) & (ids < r)).all(dim=-1)
    ids = ids.clamp(0, r - 1)
    flat = (ids[..., 0] * r + ids[..., 1]) * r + ids[..., 2]
    vals = grid.device_sig(dev)[flat]
    in_shell = (pts.abs() <= f32(grid.outer_extent)).all(dim=-1)
    out_val = torch.where(in_shell, grid.outer_sig_tensor(dev),
                          f32(float("inf")))
    s = torch.where(inb, vals, out_val)                 # (S, P)

    dt = (ts[:, 1:] - ts[:, :-1]) * dn[:, None]
    seg = torch.maximum(s[:, 1:], s[:, :-1]) * dt       # (S, P-1)
    zcol = torch.zeros((seg.shape[0], 1), dtype=torch.float32, device=dev)
    prefix = torch.cat([zcol, torch.cumsum(seg, dim=1)], dim=1)
    suffix = torch.cat([torch.cumsum(seg.flip(1), dim=1).flip(1), zcol],
                       dim=1)
    total = prefix[:, -1]

    half = 0.5 * tau_eps
    lead_ok = (prefix <= half).to(torch.uint8)
    trail_ok = (suffix <= half).to(torch.uint8)
    # argmax of a bool row: the first True (torch's argmax gives the first
    # maximal index, as numpy's)
    lo_idx = n_probe - 1 - torch.argmax(lead_ok.flip(1), dim=1)
    hi_idx = torch.argmax(trail_ok, dim=1)
    t_lo = torch.gather(ts, 1, lo_idx[:, None])[:, 0]
    t_hi = torch.gather(ts, 1, hi_idx[:, None])[:, 0]

    def _erode_min(a):
        p = torch.nn.functional.pad(a.reshape(1, ch, cw), (1, 1, 1, 1),
                                    value=float("inf"))[0]
        return torch.stack([p[i:i + ch, j:j + cw] for i in (0, 1, 2)
                            for j in (0, 1, 2)]).amin(dim=0)

    def _dilate_max(a):
        p = torch.nn.functional.pad(a.reshape(1, ch, cw), (1, 1, 1, 1),
                                    value=0.0)[0]
        return torch.stack([p[i:i + ch, j:j + cw] for i in (0, 1, 2)
                            for j in (0, 1, 2)]).amax(dim=0)

    t_lo = _erode_min(t_lo)
    t_hi = _dilate_max(torch.where(total > 0, t_hi, torch.zeros_like(t_hi)))
    total_d = _dilate_max(total)

    up_y = torch.clamp(torch.arange(h, device=dev) // coarse, max=ch - 1)
    up_x = torch.clamp(torch.arange(w, device=dev) // coarse, max=cw - 1)
    t_lo_full = t_lo[up_y[:, None], up_x[None, :]].reshape(-1)
    t_hi_full = t_hi[up_y[:, None], up_x[None, :]].reshape(-1)
    total_full = total_d[up_y[:, None], up_x[None, :]].reshape(-1)

    pad_t = f32(pad_cells * grid.cell + np.float32(span_max)
                / max(n_probe - 1, 1))
    empty = total_full <= tau_eps
    new_near = torch.minimum(torch.maximum(t_lo_full - pad_t, near), far)
    new_far = torch.minimum(torch.maximum(t_hi_full + pad_t, near), far)
    new_near = torch.where(empty, near, new_near)
    new_far = torch.where(empty, far, new_far)

    out = torch.cat([rays[:, :6], new_near[:, None], new_far[:, None],
                     rays[:, 8:]], dim=1)
    stats = {"coarse": coarse, "n_probe": n_probe,
             "empty_frac": empty.float().mean(),
             "range_ratio": ((new_far - new_near)
                             / (far - near + 1e-12)).mean(),
             "empty_mask": empty,
             "kept_count": (~empty).sum()}
    return out, stats
