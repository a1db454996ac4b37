"""Novel-view camera poses (host numpy).

Port of ``moco_flow_tpu/geometry/poses.py``: the spherical orbit (3
elevation rings x 30 azimuths) of free-viewpoint renders and the bullet-time
track.
"""

from __future__ import annotations

import numpy as np


def _translate_z(t: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def _rotate_x(phi: float) -> np.ndarray:
    c, s = np.cos(phi), np.sin(phi)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def _rotate_y(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, -s, s, c
    return m


def pose_spherical(theta_deg: float, phi_deg: float, radius: float,
                   offset=(0, 0, 0), vec_up=None) -> np.ndarray:
    """Camera-to-world matrix on a sphere looking at the origin
    (ref vis_utils.py:46-108, NeRF-style)."""
    c2w = _translate_z(radius)
    c2w = _rotate_x(np.deg2rad(phi_deg)) @ c2w
    c2w = _rotate_y(np.deg2rad(theta_deg)) @ c2w
    swap = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                    dtype=np.float32)
    c2w = swap @ c2w
    if vec_up is not None:
        vec_up = np.asarray(vec_up, np.float32)
        vec_up = vec_up / np.linalg.norm(vec_up)
        vec_1 = np.array([vec_up[0], -vec_up[2], vec_up[1]], np.float32)
        vec_2 = np.cross(vec_up, vec_1)
        trans = np.eye(4, dtype=np.float32)
        trans[:3, 0], trans[:3, 1], trans[:3, 2] = vec_1, vec_2, vec_up
        c2w = trans @ c2w
    if offset is not None:
        c2w[:3, 3] += np.asarray(offset, np.float32)
    return c2w


def create_spheric_poses(num: int = 30, radius: float = 2.0,
                         center=(0, 0, 0), vec_up=None) -> np.ndarray:
    """(3*num, 4, 4): three elevation rings at 0/-15/-30 degrees
    (ref vis_utils.py:110-119)."""
    angles = np.linspace(0, 360, num + 1)[:-1]
    rings = [np.stack([pose_spherical(a, phi, radius, center, vec_up)
                       for a in angles])
             for phi in (0.0, -15.0, -30.0)]
    return np.concatenate(rings, axis=0)


def create_bullet_effect_poses(radius: float = 2.0, move_dist: float = 0.5,
                               init_angle: float = 0.0) -> np.ndarray:
    """Bullet-time track: orbit at fixed radius, zoom in, zoom back out
    (ref vis_utils.py:121-130)."""
    angles = np.linspace(0, 360, 41)[:-1]
    p0 = np.stack([pose_spherical(a + init_angle, 0, radius) for a in angles])
    r_in = np.linspace(radius, radius - move_dist, 41)[:-1]
    p1 = np.stack([pose_spherical(a + init_angle, 0, r)
                   for a, r in zip(angles, r_in)])
    r_out = np.linspace(radius - move_dist, radius + move_dist, 41)[:-1]
    p2 = np.stack([pose_spherical(a + init_angle, 0, r)
                   for a, r in zip(angles, r_out)])
    return np.concatenate([p0, p1, p2], axis=0)
