"""Datasets: per-frame cameras, rays and target images.

Port of ``moco_flow_tpu/data/dataset.py``: JSON meta with interval
subsampling, per-frame AABBs from SMPL forward kinematics rescaled by the
config factors, the camera recentered by ``-transl`` (person at the origin),
normalized frame indices, full-frame rays and composited targets (val mode),
and for training the per-frame ``FrameTable`` with its padded valid-pixel
table (the filled convex hull of the projected AABB) and
``sample_train_rays``, which picks a step's rays with the pixel slots and
background of a ``Draws`` record, and the SMPL correspondence table of the
train frames (NoF supervision, built at first use), and in val mode the
90 spherical novel-view poses. ``NoFDataset`` is stage 2's: the same frames
without images. Frames are PNGs read and resized by ``utils/image.py`` (as
Pillow's ``BILINEAR`` resizes them in JAX).

Tensors live on the CPU; the trainer moves the table and the images to its
device once, and each val frame's rays as it renders them.
"""

from __future__ import annotations

import dataclasses
import json
import os.path as osp

import numpy as np
import torch

from ..geometry.camera import (Camera, aabb_corners, near_far_from_aabb,
                               rescale_aabb)
from ..geometry.poses import create_spheric_poses
from ..geometry.smpl import SMPLData, load_smpl_data, smpl_forward
from ..utils.image import read_png, resize_bilinear
from .correspondence import CorrespondenceTable, build_correspondence_table
from .draws import Draws


@dataclasses.dataclass
class FrameTable:
    """Per-frame camera and sampling state."""
    c2w: torch.Tensor          # (F, 3, 4) float32
    near: torch.Tensor         # (F,)
    far: torch.Tensor          # (F,)
    norm_idx: torch.Tensor     # (F,) frame index normalized to [-1, 1)
    valid_idx: torch.Tensor    # (F, MAXV) int64 valid-pixel ids, padded by wrapping
    valid_count: torch.Tensor  # (F,) int64

    def to(self, device) -> "FrameTable":
        return FrameTable(**{f.name: getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)})


def _load_meta(root_dir: str, mode: str, interval: int) -> dict:
    with open(osp.join(root_dir, mode + ".json")) as f:
        meta = json.load(f)
    meta["frames"] = meta["frames"][::interval]
    return meta


def _intrinsics(meta: dict, size) -> np.ndarray:
    """Intrinsics rescaled from the capture resolution to ``size``."""
    h_ori, w_ori = meta["image_height"], meta["image_width"]
    sy, sx = size[0] / h_ori, size[1] / w_ori
    f = meta["camera_focal"]
    cx, cy = meta["camera_c"]
    return np.array([[f * sy, 0, cx * sy], [0, f * sx, cy * sx], [0, 0, 1]])


def sample_train_rays(table: FrameTable, directions: torch.Tensor,
                      images: torch.Tensor, bkgd_img: torch.Tensor,
                      draws: Draws, rand_bkgd: bool, has_alpha: bool):
    """A step's rays of frame ``draws.frame`` at the valid-pixel slots
    ``draws.pixels``.

    Args:
      directions: (H*W, 3) camera-space direction grid.
      images: (F, H*W, C) uint8, C in {3, 4}.
      bkgd_img: (H*W, 3) background (unused with ``rand_bkgd``).

    Returns (rays (N, 9), rgbs (N, 3), background (N, 3)), on the device of
    ``table``.
    """
    frame = draws.frame
    n_rand = draws.pixels.shape[0]
    pix = table.valid_idx[frame, draws.pixels]
    c2w = table.c2w[frame]
    dirs = directions[pix] @ c2w[:, :3].T
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    origin = c2w[:, 3].expand(dirs.shape)
    ones = torch.ones((n_rand, 1), dtype=torch.float32, device=dirs.device)
    rays = torch.cat([origin, dirs, table.near[frame] * ones,
                      table.far[frame] * ones, table.norm_idx[frame] * ones],
                     dim=1)
    raw = images[frame, pix].float() / 255.0
    if rand_bkgd:
        bg = draws.background.expand(n_rand, 3)
    else:
        bg = bkgd_img[pix]
    if has_alpha:
        alpha = raw[:, 3:4]
        rgbs = raw[:, :3] * alpha + bg * (1.0 - alpha)
    else:
        rgbs = raw[:, :3]
    return rays, rgbs, bg


class MoCoFlowDataset:
    """One video sequence in a mode of JAX's: ``<mode>.json`` is read for
    the part before a ``/`` (``train/vis`` reads ``train.json``, the part
    after is ``vis_mode``); every mode but ``val`` builds the frame table,
    and only ``val`` the spherical poses.

    ``meta`` / ``images`` ((F, H, W, C) uint8) take the place of the JSON
    file and the PNGs when the scene is held in memory; otherwise both are
    read from ``root_dir``. Without ``load_images`` the dataset holds no
    images."""

    def __init__(self, root_dir: str, imgs_dir: str, size, aabb, bkgd,
                 interval: int = 1, mode: str = "val",
                 smpl_data: SMPLData | None = None, meta: dict | None = None,
                 images: np.ndarray | None = None, load_images: bool = True):
        self.root_dir = root_dir
        self.imgs_dir = imgs_dir
        self.size = tuple(size)
        self.aabb_cfg = aabb
        self.bkgd = bkgd
        self.mode = mode.split("/")[0]
        self.vis_mode = mode.split("/")[1] if "/" in mode else None
        if meta is None:
            self.meta = _load_meta(root_dir, self.mode, interval)
        else:
            self.meta = dict(meta, frames=list(meta["frames"])[::interval])
            if images is not None:
                images = images[::interval]
        self.num_frames = len(self.meta["frames"])
        self.smpl = smpl_data if smpl_data is not None else load_smpl_data(
            self.meta.get("gender", "neutral"))
        self.camera = Camera(self.size, _intrinsics(self.meta, self.size))
        self._build_frames()
        self.images = None
        self.has_alpha = False
        if load_images:
            self._load_images(images)
        self._build_background()
        if self.mode == "val":
            fr0 = self.meta["frames"][0]
            radius = float(np.sqrt(((np.asarray(fr0["camera_pose"])[:3, 3]
                                     - np.asarray(fr0["transl"])) ** 2).sum()))
            self.spherical_poses = create_spheric_poses(
                radius=radius, center=[0, 0, 0], vec_up=[0, -1, 0])

    def _build_frames(self):
        frames = self.meta["frames"]
        poses = torch.as_tensor(np.stack(
            [np.asarray(fr["pose"], np.float32).reshape(-1) for fr in frames]))
        betas = torch.as_tensor(np.stack(
            [np.asarray(fr["betas"], np.float32) for fr in frames]))
        self._verts = smpl_forward(self.smpl, poses, betas).numpy()
        self._poses, self._betas = poses, betas
        self._corr_table = None
        if self.mode != "val":
            self._build_table()

    @property
    def correspondence_table(self) -> CorrespondenceTable:
        """Posed vertices and src -> canonical chains of every frame
        (canonical frame 0), on the CPU."""
        if self._corr_table is None:
            self._corr_table = build_correspondence_table(
                self.smpl, self._poses, self._betas, tgt_frame=0)
        return self._corr_table

    def _build_table(self):
        """The FrameTable: recentered cameras, near/far from the AABB
        corners, and each frame's valid pixels (padded to the longest list
        by repeating its own)."""
        n = self.num_frames
        c2ws, nears, fars, masks = [], [], [], []
        for i in range(n):
            corners = self.frame_aabb_corners(i)
            c2w4 = self.frame_c2w4(i)
            near, far = near_far_from_aabb(corners, c2w4[:3, 3])
            c2ws.append(c2w4[:3, :4])
            nears.append(near)
            fars.append(far)
            masks.append(self.camera.valid_rays_mask(corners, c2w4))
        masks = np.stack(masks)
        counts = masks.sum(axis=1)
        maxv = int(counts.max())
        valid_idx = np.zeros((n, maxv), np.int64)
        for i in range(n):
            idx = np.flatnonzero(masks[i])
            valid_idx[i, :len(idx)] = idx
            if len(idx) and len(idx) < maxv:
                valid_idx[i, len(idx):] = idx[np.arange(maxv - len(idx))
                                              % len(idx)]
        self.masks = masks
        self.table = FrameTable(
            c2w=torch.as_tensor(np.stack(c2ws), dtype=torch.float32),
            near=torch.as_tensor(np.asarray(nears), dtype=torch.float32),
            far=torch.as_tensor(np.asarray(fars), dtype=torch.float32),
            norm_idx=torch.as_tensor(np.arange(n) * 2.0 / n - 1.0,
                                     dtype=torch.float32),
            valid_idx=torch.as_tensor(valid_idx),
            valid_count=torch.as_tensor(counts.astype(np.int64)))

    @property
    def directions_flat(self) -> torch.Tensor:
        return self.camera.directions.reshape(-1, 3)

    def _load_images(self, images: np.ndarray | None):
        h, w = self.size
        if images is None:
            imgs = []
            for fr in self.meta["frames"]:
                path = osp.join(self.root_dir, self.imgs_dir, fr["file_path"])
                if not osp.exists(path):
                    imgs = []
                    break
                im = read_png(path)
                if im.shape[:2] != (h, w):
                    im = resize_bilinear(im, (h, w))
                imgs.append(im)
            images = np.stack(imgs) if imgs else None
        if images is not None:
            if tuple(images.shape[1:3]) != (h, w):
                raise ValueError(f"in-memory images are {images.shape[1:3]}, "
                                 f"the dataset size is {(h, w)}")
            self.has_alpha = images.shape[-1] == 4
            self.images = torch.as_tensor(
                np.ascontiguousarray(images)).reshape(len(images), h * w, -1)

    def _build_background(self):
        h, w = self.size
        self.rand_bkgd = self.bkgd == "rand"
        if isinstance(self.bkgd, (int, float)):
            self.bkgd_img = torch.full((h * w, 3), float(self.bkgd))
        elif self.rand_bkgd:
            self.bkgd_img = torch.ones((h * w, 3))
        elif isinstance(self.bkgd, str):
            im = resize_bilinear(read_png(self.bkgd), (h, w))
            arr = im.astype(np.float32)[..., :3] / 255.0
            self.bkgd_img = torch.as_tensor(arr.reshape(h * w, 3))
        else:
            raise ValueError(f"background must be float, path or 'rand': "
                             f"{self.bkgd}")

    def frame_aabb_corners(self, idx: int) -> np.ndarray:
        aabb = np.stack([self._verts[idx].min(0), self._verts[idx].max(0)])
        return aabb_corners(rescale_aabb(aabb, self.aabb_cfg[0],
                                         self.aabb_cfg[1]))

    def frame_c2w4(self, idx: int) -> np.ndarray:
        fr = self.meta["frames"][idx]
        c2w4 = np.asarray(fr["camera_pose"], np.float64).copy()
        c2w4[:3, 3] -= np.asarray(fr["transl"])
        return c2w4

    def frame_rays(self, idx: int, c2w4: np.ndarray | None = None):
        """All rays (H*W, 9) of one frame, or of a novel view ``c2w4`` of
        that frame's body."""
        corners = self.frame_aabb_corners(idx)
        pose = self.frame_c2w4(idx) if c2w4 is None else np.asarray(c2w4)
        norm_idx = idx * 2.0 / self.num_frames - 1.0
        return self.camera.make_rays(corners, pose, norm_idx)

    def frame_mask(self, idx: int, c2w4: np.ndarray | None = None,
                   scale: int = 1):
        """(H*W,) bool: the pixels inside the projected AABB hull of one
        frame (or of the novel view ``c2w4``), the mask that JAX's
        ``frame_rays`` returns beside the rays; at ``scale`` x the size,
        that of ``frame_rays_scaled``."""
        pose = self.frame_c2w4(idx) if c2w4 is None else np.asarray(c2w4)
        return self._camera(scale).valid_rays_mask(
            self.frame_aabb_corners(idx), pose)

    def _camera(self, scale: int) -> Camera:
        """The camera at ``scale`` x the dataset size (intrinsics scaled),
        one a scale."""
        if scale == 1:
            return self.camera
        cams = self.__dict__.setdefault("_scaled_cams", {})
        if scale not in cams:
            k = np.asarray(self.camera.K, np.float64).copy()
            k[0, :] *= scale
            k[1, :] *= scale
            cams[scale] = Camera((self.size[0] * scale,
                                  self.size[1] * scale), k)
        return cams[scale]

    def frame_rays_scaled(self, idx: int, scale: int,
                          c2w4: np.ndarray | None = None) -> torch.Tensor:
        """:meth:`frame_rays` at ``scale`` x the dataset size, from the same
        camera with its intrinsics scaled: production frame sizes without
        decoding images (no GT pairs with them). The mask is
        ``frame_mask(idx, c2w4, scale)``."""
        pose = self.frame_c2w4(idx) if c2w4 is None else np.asarray(c2w4)
        return self._camera(scale).make_rays(
            self.frame_aabb_corners(idx), pose,
            idx * 2.0 / self.num_frames - 1.0)

    def frame_rgbs(self, idx: int, bkgd: torch.Tensor | None = None):
        """Composited (H*W, 3) target image of one frame, or None."""
        if self.images is None:
            return None
        raw = self.images[idx].float() / 255.0
        bg = self.bkgd_img if bkgd is None else bkgd
        if self.has_alpha:
            a = raw[:, 3:4]
            return raw[:, :3] * a + bg * (1.0 - a)
        return raw[:, :3]


class NoFDataset(MoCoFlowDataset):
    """Stage 2's dataset: the frames' SMPL bodies, frame table and
    correspondence table, without images (JAX's ``NoFDataset``: size
    (8, 8), aabb ``[[1.2] * 3, [0] * 3]``, correspondences drawn at
    ``THICKNESS``)."""

    THICKNESS = 0.1

    def __init__(self, root_dir: str, interval: int = 1, mode: str = "train",
                 smpl_data: SMPLData | None = None, meta: dict | None = None):
        super().__init__(root_dir, imgs_dir="", size=(8, 8),
                         aabb=[[1.2, 1.2, 1.2], [0, 0, 0]], bkgd=1.0,
                         interval=interval, mode=mode, smpl_data=smpl_data,
                         meta=meta, load_images=False)


def get_dataset(data_config: dict, mode: str,
                smpl_data: SMPLData | None = None, scene=None):
    """Dataset factory (``type``: ``moco_flow`` or stage 2's ``nof``);
    ``scene`` (a ``SyntheticScene``) supplies meta, images and body in
    memory."""
    kind = data_config["type"]
    if kind == "nof":
        return NoFDataset(
            data_config.get("root_dir"),
            interval=data_config.get("interval", 1), mode=mode,
            smpl_data=smpl_data if scene is None else scene.smpl,
            meta=None if scene is None else scene.meta)
    if kind != "moco_flow":
        raise ValueError(f"dataset type {kind!r} not valid")
    size = data_config["val_size"] if mode.startswith("val") and \
        "val_size" in data_config else data_config["size"]
    return MoCoFlowDataset(
        data_config.get("root_dir"), data_config.get("imgs_dir", "images"),
        size, data_config["aabb"], data_config.get("bkgd", 1.0),
        interval=data_config.get("interval", 1), mode=mode,
        smpl_data=smpl_data if scene is None else scene.smpl,
        meta=None if scene is None else scene.meta,
        images=None if scene is None else scene.images)
