"""Triangle-mesh rasterizer on the device.

Port of ``scripts/rasterizer.py`` (the numpy loop over faces that renders
the init_nerf views and the fixture frames): a z-buffered barycentric
rasterizer of a mesh with per-vertex colours into RGBA, with the loop's
semantics kept exactly:

- pixel centres at +0.5; a face's box is ``floor(min)`` .. ``ceil(max)``
  inclusive, clipped to the image;
- a face is drawn only when all three camera depths exceed 1e-6 and its
  screen-space ``|det|`` is at least 1e-12; a pixel is inside when
  ``l0 = 1 - l1 - l2``, ``l1`` and ``l2`` are all ``>= 0``;
- perspective-correct depth ``1 / max(l0/z0 + l1/z1 + l2/z2, 1e-12)`` and
  colour weights ``l_i / z_i`` normalised by their sum;
- alpha 1 wherever any face covers the pixel.

The per-vertex projection and the per-face boxes, edges and determinants
are O(V + F) and are computed on the host in numpy, in the dtypes the
caller's arrays have, as the loop computes them. The rest runs in PyTorch
in fp64 on ``device``, on faces whose boxes hold at most ``CHUNK`` pixels
at a time: each (face, box row) is cut to the span between the face's
edge crossings, widened by ``SPAN_MARGIN`` pixels (a long thin face's box
is mostly outside it), and every pixel of the spans goes through the
loop's exact inside test, barycentrics, depth, z-buffer and colours.

The z-buffer. The loop keeps its buffer in fp32 but compares each face's
fp64 depth against it, in face order: a face replaces the stored one when
its depth is strictly below the stored fp32 value. Here every covered
pixel's winner follows from three order-free reductions, with ``r`` a
candidate's depth rounded to fp32 and ``M`` the pixel's least ``r``:

1. every face the loop can end on has ``r == M`` (the stored value only
   falls, and a face replaces it only from below);
2. the first such face in face order always replaces what is stored then;
3. after it, another such face replaces the stored ``M`` exactly when its
   fp64 depth is below ``M``, and nothing else does.

So the winner is the last face after the first with ``r == M`` whose depth
is below ``M``, else the first. This is the loop's result at every pixel,
near-ties within fp32 rounding included. The fp64 arithmetic is the loop's,
operation for operation, so the coverage is the numpy version's bit for
bit; a pixel's colour is a 3-term dot product whose summation order may
differ from numpy's BLAS in the last fp64 bit before it is rounded to fp32.
"""

from __future__ import annotations

import numpy as np
import torch

# box pixels of the faces set up at once (their spans hold fewer)
CHUNK = 1 << 24
# a span reaches this many pixels past an edge's computed crossing; edges
# whose v-extent is below SPAN_TAU of the face's largest edge component
# do not cut spans
SPAN_MARGIN = 1.0
SPAN_TAU = 1e-4


def _face_setup(verts, faces, c2w4, focal, center, size) -> tuple:
    """Host side, in the loop's dtypes: for the faces the loop draws, in
    face order, (fp64 ``[a_u, a_v, (b-a)_u, (b-a)_v, (c-a)_u, (c-a)_v, det,
    z_0, z_1, z_2]``, int64 ``[x0, y0, box width, box height, face]``)."""
    h, w = size
    cx, cy = center
    w2c = np.linalg.inv(c2w4)
    cam = (w2c[:3, :3] @ verts.T + w2c[:3, 3:4]).T
    cam[:, 1:] *= -1
    z = cam[:, 2]
    u = focal * cam[:, 0] / np.maximum(z, 1e-6) + cx
    v = focal * cam[:, 1] / np.maximum(z, 1e-6) + cy
    tu, tv = u[faces], v[faces]                      # (F, 3)
    x0 = np.clip(np.floor(tu.min(1)), 0, w).astype(np.int64)
    x1 = np.clip(np.ceil(tu.max(1)) + 1, 0, w).astype(np.int64)
    y0 = np.clip(np.floor(tv.min(1)), 0, h).astype(np.int64)
    y1 = np.clip(np.ceil(tv.max(1)) + 1, 0, h).astype(np.int64)
    e1u, e1v = tu[:, 1] - tu[:, 0], tv[:, 1] - tv[:, 0]
    e2u, e2v = tu[:, 2] - tu[:, 0], tv[:, 2] - tv[:, 0]
    det = e1u * e2v - e2u * e1v
    keep = ((z > 1e-6)[faces].all(axis=1) & (x0 < x1) & (y0 < y1)
            & ~(np.abs(det) < 1e-12))
    f = np.flatnonzero(keep)
    reals = np.concatenate([np.stack([tu[f, 0], tv[f, 0], e1u[f], e1v[f],
                                      e2u[f], e2v[f], det[f]], 1),
                            z[faces[f]]], 1).astype(np.float64)
    ints = np.stack([x0[f], y0[f], (x1 - x0)[f], (y1 - y0)[f], f], 1)
    return reals, ints


def _row_spans(reals: torch.Tensor, ints: torch.Tensor) -> tuple:
    """Every (face, box row) pair's span of pixels that can be inside the
    face: (face index into the set-up, row, first pixel, width). Along a
    row each ``l_i * det`` is affine in x, zero at an edge's crossing; a
    span is the box row cut to the crossings, widened by ``SPAN_MARGIN``
    pixels, so it holds every pixel that the exact test accepts. An edge
    whose v-extent is below ``SPAN_TAU`` times the face's largest edge
    component does not cut (its crossing is ill-conditioned)."""
    dev = reals.device
    x0, y0, bw, bh = ints[:, :4].unbind(1)
    k = torch.repeat_interleave(torch.arange(len(ints), device=dev), bh)
    row = y0[k] + torch.arange(k.numel(), device=dev) - (
        torch.cumsum(bh, 0) - bh)[k]
    au, av, e1u, e1v, e2u, e2v, det = reals[:, :7][k].unbind(1)
    yl = row.double() + 0.5 - av
    sgn = torch.sign(det)
    scale = torch.stack([e1u.abs(), e1v.abs(), e2u.abs(), e2v.abs()],
                        1).amax(1)
    lo = (x0[k] + 0.5).double()
    hi = (x0 + bw)[k].double() - 0.5
    # (slope of sign(det) * l_i * det in x, the crossing's x - au)
    for slope, edge, num in ((e2v, e2v, e2u * yl),
                             (-e1v, e1v, e1u * yl),
                             (e1v - e2v, e2v - e1v, det - yl * (e1u - e2u))):
        cuts = slope.abs() >= SPAN_TAU * scale
        cross = au + num / torch.where(cuts, edge, torch.ones_like(edge))
        lo = torch.where(cuts & (sgn * slope > 0),
                         torch.maximum(lo, cross - SPAN_MARGIN), lo)
        hi = torch.where(cuts & (sgn * slope < 0),
                         torch.minimum(hi, cross + SPAN_MARGIN), hi)
    first = torch.ceil(lo - 0.5).long()
    width = (torch.floor(hi - 0.5).long() - first + 1).clamp_(min=0)
    return k, row, first, width


def _candidates(reals: torch.Tensor, ints: torch.Tensor, w: int) -> tuple:
    """The inside pixels of the set-up faces ``reals`` / ``ints``: (pixel,
    face, depth, the three weights ``l_i / z_i``), on their device."""
    dev = reals.device
    kr, row, first, width = _row_spans(reals, ints)
    j = torch.repeat_interleave(torch.arange(len(kr), device=dev), width)
    px = first[j] + torch.arange(j.numel(), device=dev) - (
        torch.cumsum(width, 0) - width)[j]
    py = row[j]
    k = kr[j]
    xs = px.double() + 0.5
    ys = py.double() + 0.5
    au, av, e1u, e1v, e2u, e2v, det = reals[:, :7][k].unbind(1)
    l1 = ((xs - au) * e2v - e2u * (ys - av)) / det
    l2 = (e1u * (ys - av) - (xs - au) * e1v) / det
    l0 = 1.0 - l1 - l2
    inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
    k = k[inside]
    z = reals[k, 7:]
    wgt = torch.stack([l0[inside], l1[inside], l2[inside]], -1) / z
    depth = 1.0 / torch.clamp((wgt[:, 0] + wgt[:, 1]) + wgt[:, 2],
                              min=1e-12)
    return py[inside] * w + px[inside], ints[k, 4], depth, wgt


def rasterize_mesh(verts, faces, colors, c2w4, focal: float, center, size,
                   bkgd: float = 1.0, device="cuda") -> torch.Tensor:
    """Render a triangle mesh; (H, W, 4) float32 RGBA in [0, 1] on
    ``device`` (alpha = coverage).

    Args:
      verts: (V, 3) world-space vertices, numpy or a tensor (read on the
        host for the projection).
      faces: (F, 3) int triangle indices, numpy or a tensor.
      colors: (V, 3) per-vertex colours in [0, 1], numpy or a tensor.
      c2w4: (4, 4) camera-to-world, numpy (the camera looks along its -z;
        the projective y/z flip of ``geometry/camera.py``).
      focal, center, size: pinhole intrinsics and (H, W).
      device: where the faces x pixels work runs.
    """
    h, w = size
    dev = torch.device(device)
    host = [x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x) for x in (verts, faces)]
    reals, ints = _face_setup(host[0], host[1], np.asarray(c2w4), focal,
                              center, size)
    cols = torch.as_tensor(colors, device=dev).double()
    tri = torch.as_tensor(host[1], device=dev).long()
    sizes = ints[:, 2] * ints[:, 3]
    ends = np.cumsum(sizes)
    parts, lo = [], 0
    while lo < len(sizes):
        hi = max(int(np.searchsorted(ends, ends[lo] - sizes[lo] + CHUNK,
                                     side="right")), lo + 1)
        parts.append(_candidates(torch.from_numpy(reals[lo:hi]).to(dev),
                                 torch.from_numpy(ints[lo:hi]).to(dev), w))
        lo = hi
    img = torch.full((h * w, 3), float(bkgd), dtype=torch.float32,
                     device=dev)
    alpha = torch.zeros(h * w, dtype=torch.float32, device=dev)
    if parts:
        pix, face, depth, wgt = (torch.cat(p) for p in zip(*parts))
        r = depth.float().double()
        m = torch.full((h * w,), float("inf"), dtype=torch.float64,
                       device=dev).scatter_reduce_(0, pix, r, "amin")[pix]
        tie = r == m
        first = torch.full((h * w,), int(tri.shape[0]), dtype=torch.long,
                           device=dev).scatter_reduce_(
            0, pix[tie], face[tie], "amin")[pix]
        later = tie & (face > first) & (depth < m)
        last = torch.full((h * w,), -1, dtype=torch.long,
                          device=dev).scatter_reduce_(
            0, pix[later], face[later], "amax")[pix]
        win = face == torch.where(last >= 0, last, first)
        pix, face, wgt = pix[win], face[win], wgt[win]
        wgt = wgt / ((wgt[:, 0] + wgt[:, 1]) + wgt[:, 2])[:, None]
        tri_col = cols[tri[face]]                       # (n, 3 verts, 3)
        img[pix] = (wgt[:, :, None] * tri_col).sum(1).float()
        alpha[pix] = 1.0
    return torch.cat([img, alpha[:, None]], -1).reshape(h, w, 4)
