"""Synthetic test scene.

Port of ``moco_flow_tpu/data/synthetic.py``: the same seeded SMPL-like body,
poses and soft-shaded splat images, in the JSON schema of the reference
preprocessing (``train.json``/``val.json`` with gender, image size, focal,
camera_c, D and per-frame file_path/camera_pose/pose/betas/transl).

The scene is returned in memory (meta + uint8 RGBA images); PNG and JSON
files are written only when a directory is given (``utils/image.py``'s PNG
writer).
"""

from __future__ import annotations

import dataclasses
import json
import os
import os.path as osp

import numpy as np
import torch

from ..geometry.smpl import SMPLData, smpl_forward, synthetic_smpl_data
from ..utils.image import write_png


@dataclasses.dataclass
class SyntheticScene:
    smpl: SMPLData
    meta: dict            # the val.json / train.json content
    images: np.ndarray    # (F, H, W, 4) uint8 RGBA, as the PNGs hold them


class _NumpyEncoder(json.JSONEncoder):
    def default(self, o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (np.floating, np.integer)):
            return o.item()
        return super().default(o)


def make_synthetic_scene(root_dir: str | None = None, n_frames: int = 4,
                         size: int = 64, focal: float = 80.0,
                         cam_dist: float = 4.0, seed: int = 0,
                         smpl: SMPLData | None = None,
                         pose_scale: float = 0.15,
                         blob_sigma2: float = 18.0) -> SyntheticScene:
    """Build the scene; with ``root_dir`` also write train.json / val.json /
    images/*.png there (the JAX package's on-disk layout)."""
    rng = np.random.default_rng(seed)
    smpl = smpl or synthetic_smpl_data(256, seed=seed)
    h = w = size
    cx = cy = size / 2.0
    # fixed diag(1,-1,-1,1) camera; transl moves the person
    camera_pose = np.diag([1.0, -1.0, -1.0, 1.0])
    poses = np.zeros((n_frames, 72), np.float32)
    poses[:, 3:] = rng.normal(scale=pose_scale, size=(n_frames, 69))
    betas = np.zeros((n_frames, 10), np.float32)
    verts = smpl_forward(smpl, torch.from_numpy(poses),
                         torch.from_numpy(betas)).numpy()

    frames, images = [], []
    for i in range(n_frames):
        transl = np.array([0.0, 0.0, cam_dist], np.float32)
        c2w = camera_pose.copy()
        c2w[:3, 3] -= transl
        w2c = np.linalg.inv(c2w)
        pts = verts[i]
        cam = (w2c[:3, :3] @ pts.T + w2c[:3, 3:4])
        cam[1:] *= -1  # projective flip
        u = focal * cam[0] / cam[2] + cx
        v = focal * cam[1] / cam[2] + cy
        yy, xx = np.mgrid[0:h, 0:w]
        sel = np.arange(0, len(pts), 4)
        d2 = ((xx[None] - u[sel, None, None]) ** 2
              + (yy[None] - v[sel, None, None]) ** 2)
        blobs = np.exp(-d2 / blob_sigma2)
        colors = 0.25 + 0.75 * (pts[sel] - pts.min(0)) / (
            np.ptp(pts, axis=0) + 1e-6)
        img = np.zeros((h, w, 4), np.float32)
        img[..., :3] = np.max(blobs[..., None] * colors[:, None, None, :],
                              axis=0)
        img[..., 3] = blobs.max(axis=0)
        images.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
        frames.append({"file_path": f"{i:04d}.png",
                       "camera_pose": camera_pose, "pose": poses[i],
                       "betas": betas[i], "transl": transl})

    meta = {"gender": "neutral", "image_height": h, "image_width": w,
            "camera_focal": focal, "camera_c": np.array([cx, cy]),
            "D": np.zeros(5), "frames": frames}
    scene = SyntheticScene(smpl=smpl, meta=meta, images=np.stack(images))
    if root_dir is not None:
        os.makedirs(osp.join(root_dir, "images"), exist_ok=True)
        for fr, im in zip(frames, scene.images):
            write_png(osp.join(root_dir, "images", fr["file_path"]), im)
        for name in ("train.json", "val.json"):
            with open(osp.join(root_dir, name), "w") as f:
                json.dump(meta, f, cls=_NumpyEncoder)
    return scene
