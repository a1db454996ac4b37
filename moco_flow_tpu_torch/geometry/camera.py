"""Cameras, rays and AABB utilities.

Port of ``moco_flow_tpu/geometry/camera.py`` with the reference's
conventions: pinhole directions with OpenGL-style y/z sign flips and no
half-pixel offset, normalized world-space directions, and near/far from the
camera-to-AABB-corner distances, and the valid-ray mask of the training
rays: the filled convex hull of the projected AABB corners. The JAX package
fills it with OpenCV (``cv2.convexHull`` + ``cv2.fillConvexPoly``); the port
has no OpenCV, so the hull is a monotone chain and the fill follows
``fillConvexPoly``'s own rasterization (8-connected edge lines, clipped as
``clipLine`` clips them, and a 16.16 fixed-point scanline fill), so the two
masks agree pixel for pixel.
"""

from __future__ import annotations

import numpy as np
import torch


def rescale_aabb(aabb: np.ndarray, scale=(1, 1, 1), offset=(0, 0, 0)) -> np.ndarray:
    """Scale an AABB about its center, then pad by ``offset``."""
    aabb = np.asarray(aabb, np.float64).copy()
    center = (aabb[1] + aabb[0]) / 2
    aabb = (aabb - center) * np.asarray(scale) + center
    aabb[0] -= np.asarray(offset)
    aabb[1] += np.asarray(offset)
    return aabb


def aabb_corners(aabb: np.ndarray) -> np.ndarray:
    """(2, 3) min/max -> (8, 3) corner vertices."""
    lo, hi = np.asarray(aabb)[0], np.asarray(aabb)[1]
    return np.array([[x, y, z] for x in (lo[0], hi[0])
                     for y in (lo[1], hi[1]) for z in (lo[2], hi[2])],
                    dtype=np.float64)


def ray_directions(h: int, w: int, focal, center) -> torch.Tensor:
    """Per-pixel camera-space directions (H, W, 3):
    ``[(i-cx)/fx, -(j-cy)/fx, -1]`` (fx for both axes, no +0.5 offset)."""
    fx = focal[0] if hasattr(focal, "__len__") else focal
    i = torch.arange(w, dtype=torch.float32)[None, :].expand(h, w)
    j = torch.arange(h, dtype=torch.float32)[:, None].expand(h, w)
    return torch.stack([(i - float(center[0])) / float(fx),
                        -(j - float(center[1])) / float(fx),
                        -torch.ones_like(i)], dim=-1)


def rays_from_pose(directions: torch.Tensor, c2w: torch.Tensor):
    """World-space (rays_o, rays_d), each (H*W, 3), from camera-space
    directions and a (3, 4) camera-to-world matrix; directions normalized."""
    rays_d = directions @ c2w[:, :3].T
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rays_o = c2w[:, 3].expand(rays_d.shape)
    return rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)


def near_far_from_aabb(corners: np.ndarray, cam_origin: np.ndarray):
    """near/far = min/max camera-to-corner distance."""
    d = np.sqrt(np.sum((corners - cam_origin) ** 2, axis=-1))
    return float(d.min()), float(d.max())


def make_rays(directions: torch.Tensor, c2w: torch.Tensor, near: float,
              far: float, idx: float) -> torch.Tensor:
    """Packed per-pixel rays (H*W, 9): [o, d, near, far, normalized idx]."""
    rays_o, rays_d = rays_from_pose(directions, c2w)
    ones = torch.ones_like(rays_o[:, :1])
    return torch.cat([rays_o, rays_d, near * ones, far * ones, idx * ones],
                     dim=1)


def project_points(pts_world: np.ndarray, c2w4: np.ndarray,
                   intrinsics: np.ndarray) -> np.ndarray:
    """World points -> integer pixel coords (N, 2), with the reference's y/z
    sign flip into the projective frame (truncated toward zero)."""
    pts = np.asarray(pts_world, np.float64).T  # (3, N)
    homo = np.vstack([pts, np.ones((1, pts.shape[1]))])
    cam = np.linalg.inv(np.asarray(c2w4, np.float64)) @ homo
    cam = cam[:3] / cam[3]
    cam[1:] *= -1
    pix = np.asarray(intrinsics, np.float64) @ cam
    pix = pix[:2] / pix[2]
    return pix.T.astype(np.int32)


def convex_hull(pts: np.ndarray) -> np.ndarray:
    """Vertices (K, 2) of the convex hull of integer points, in order
    (Andrew's monotone chain; collinear points dropped)."""
    p = sorted(set(map(tuple, np.asarray(pts, np.int64).tolist())))
    if len(p) <= 2:
        return np.asarray(p, np.int64)

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def half(points):
        out = []
        for q in points:
            while len(out) >= 2 and cross(out[-2], out[-1], q) <= 0:
                out.pop()
            out.append(q)
        return out

    lower, upper = half(p), half(p[::-1])
    return np.asarray(lower[:-1] + upper[:-1], np.int64)


_XY_SHIFT = 16


def _clip_line(w: int, h: int, p1, p2):
    """Clip the segment p1-p2 to the image as OpenCV's ``clipLine`` does;
    None if it misses the image."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return None if (c1 | c2) else ((x1, y1), (x2, y2))


def _draw_line(mask: np.ndarray, p1, p2):
    """An 8-connected line, left to right, as OpenCV's ``LineIterator``."""
    h, w = mask.shape
    clipped = _clip_line(w, h, p1, p2)
    if clipped is None:
        return
    (x1, y1), (x2, y2) = clipped
    if x2 < x1:
        (x1, y1), (x2, y2) = (x2, y2), (x1, y1)
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        mask[y, x] = True
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if vert:
            y += sy
            x += int(minor)
        else:
            x += 1
            y += sy * int(minor)


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def fill_convex(size, hull: np.ndarray) -> np.ndarray:
    """Boolean (H, W) mask of a filled convex polygon with integer
    vertices: OpenCV's ``fillConvexPoly`` (8-connected, no subpixel shift),
    i.e. every edge drawn as an 8-connected line plus a scanline fill
    between the polygon's left and right edges walked in 16.16 fixed
    point."""
    h, w = size
    mask = np.zeros((h, w), bool)
    v = [tuple(int(c) for c in p) for p in np.asarray(hull).reshape(-1, 2)]
    n = len(v)
    if n == 0:
        return mask
    xs = [p[0] for p in v]
    ys = [p[1] for p in v]
    imin = ys.index(min(ys))
    p0 = v[-1]
    for p in v:
        _draw_line(mask, p0, p)
        p0 = p
    ymin, ymax = min(ys), min(max(ys), h - 1)
    if n < 3 or max(xs) < 0 or max(ys) < 0 or min(xs) >= w or ymin >= h:
        return mask
    one, half = 1 << _XY_SHIFT, 1 << (_XY_SHIFT - 1)
    edge = [{"idx": imin, "ye": ymin, "di": 1, "x": -one, "dx": 0},
            {"idx": imin, "ye": ymin, "di": n - 1, "x": -one, "dx": 0}]
    edges = n
    y = ymin
    while True:
        for e in edge:
            if y < e["ye"]:
                continue
            idx0 = e["idx"]
            idx = (idx0 + e["di"]) % n
            while True:
                go = edges > 0
                edges -= 1
                if not go:
                    break
                ty = v[idx][1]
                if ty > y:
                    x_s, x_e = v[idx0][0] << _XY_SHIFT, v[idx][0] << _XY_SHIFT
                    e.update(ye=ty, x=x_s, idx=idx,
                             dx=_cdiv((x_e - x_s) * 2 + (ty - y),
                                      2 * (ty - y)))
                    break
                idx0 = idx
                idx = (idx + e["di"]) % n
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            xx1 = (edge[left]["x"] + half) >> _XY_SHIFT
            xx2 = (edge[right]["x"] + half) >> _XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                mask[y, max(xx1, 0):min(xx2, w - 1) + 1] = True
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break
    return mask


def valid_rays_mask(size, aabb_verts: np.ndarray, c2w4: np.ndarray,
                    intrinsics: np.ndarray) -> np.ndarray:
    """Boolean (H*W,) mask of the pixels inside the convex hull of the
    projected AABB corners."""
    pix = project_points(aabb_verts, c2w4, intrinsics)
    return fill_convex(tuple(size), convex_hull(pix)).reshape(-1)


class Camera:
    """Pinhole camera with precomputed per-pixel directions (on the CPU)."""

    def __init__(self, size, intrinsics: np.ndarray):
        self.size = tuple(size)
        self.K = np.asarray(intrinsics, np.float64)
        focal = [self.K[0][0], self.K[1][1]]
        center = [self.K[0][2], self.K[1][2]]
        self.directions = ray_directions(self.size[0], self.size[1], focal,
                                         center)

    def valid_rays_mask(self, aabb_verts: np.ndarray,
                        c2w4: np.ndarray) -> np.ndarray:
        return valid_rays_mask(self.size, aabb_verts, c2w4, self.K)

    def make_rays(self, aabb_verts: np.ndarray, c2w4: np.ndarray,
                  idx: float) -> torch.Tensor:
        near, far = near_far_from_aabb(aabb_verts, np.asarray(c2w4)[:3, 3])
        c2w = torch.as_tensor(np.asarray(c2w4)[:3, :4], dtype=torch.float32)
        return make_rays(self.directions, c2w, near, far, idx)
