"""Preprocessing utilities: video -> frames, masks, background, meta JSON
and the init_nerf renders.

Port of ``scripts/data_utils.py``: video clipping (cv2, imported where it
is used), RobustVideoMatting matting (``torch.hub``, gated: it needs the
network or a cached hub checkpoint), the largest-region mask cleanup, the
per-pixel median background (on the device), Fibonacci-sphere viewpoints,
look-at poses, VIBE pkl -> ``train.json`` / ``val.json`` (camera
``transl = [cx_w, cy_w, 2f/(s*W)]`` from ``orig_cam``, or the pkl's
``transls``, and the fixed ``diag(1,-1,-1,1)`` camera pose), and the
init_nerf views of the frame-0 posed SMPL in a position colour map, posed
by ``geometry/smpl.py`` and drawn by ``rasterizer.py`` on the device.
PNGs are read and written by ``utils/image.py``; the JSON files are
byte-equal to the JAX scripts' (same encoder, ``indent=4``).
"""

from __future__ import annotations

import contextlib
import json
import os
import os.path as osp
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..geometry.smpl import load_smpl_data, smpl_forward
from ..utils.image import read_png, write_png
from .rasterizer import rasterize_mesh

# rows of the frame stack sorted at once by median_background
MEDIAN_ROWS = 64
# host threads that encode create_init_nerf_data's PNGs
PNG_WORKERS = 4


class NumpyEncoder(json.JSONEncoder):
    def default(self, o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (np.floating, np.integer)):
            return o.item()
        return super().default(o)


# -- video / mask -----------------------------------------------------------

def clip_video(video_path: str, out_dir: str, start: int = 0,
               end: int | None = None, size=None) -> int:
    """Decode a video to RGB PNG frames ``0000.png``.. (cv2 decodes and
    resizes, as in the JAX script); returns the frame count."""
    import cv2
    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    i = n = 0
    while True:
        ok, frame = cap.read()
        if not ok or (end is not None and i >= end):
            break
        if i >= start:
            if size is not None:
                frame = cv2.resize(frame, (size[1], size[0]))
            write_png(osp.join(out_dir, f"{n:04d}.png"),
                      np.ascontiguousarray(frame[..., ::-1]))
            n += 1
        i += 1
    cap.release()
    return n


def keep_largest_region(mask: np.ndarray) -> np.ndarray:
    """The largest 8-connected foreground component of ``mask > 0`` as
    uint8 (cv2's ``connectedComponentsWithStats``: labels in raster order,
    the first of equally large components)."""
    from scipy import ndimage
    m = (mask > 0).astype(np.uint8)
    labels, num = ndimage.label(m, structure=np.ones((3, 3), np.int64))
    if num == 0:
        return m
    largest = 1 + int(np.argmax(np.bincount(labels.ravel())[1:]))
    return (labels == largest).astype(np.uint8)


def run_matting(imgs_dir: str, out_dir: str, threshold: float = 0.4,
                device="cuda"):
    """Alpha-matte every frame with RobustVideoMatting (``torch.hub``) on
    ``device``: RGBA PNGs whose alpha is the thresholded, largest-region
    matte. Needs the network or a cached hub checkpoint; raises a clear
    error otherwise."""
    try:
        model = torch.hub.load("PeterL1n/RobustVideoMatting", "mobilenetv3")
    except Exception as e:  # no network and no cached checkpoint
        raise RuntimeError(
            "RobustVideoMatting unavailable (torch.hub needs network or a "
            "cached checkpoint). Provide precomputed alpha masks instead.") from e
    os.makedirs(out_dir, exist_ok=True)
    model = model.eval().to(device)
    rec = [None] * 4
    with torch.no_grad():
        for name in sorted(os.listdir(imgs_dir)):
            img = read_png(osp.join(imgs_dir, name))[..., :3]
            src = torch.from_numpy(img).to(device).permute(2, 0, 1)[None]
            fgr, pha, *rec = model(src.float() / 255, *rec,
                                   downsample_ratio=0.25)
            alpha = (pha[0, 0].cpu().numpy() > threshold).astype(np.uint8)
            alpha = keep_largest_region(alpha)
            write_png(osp.join(out_dir, name),
                      np.dstack([img, alpha[..., None] * 255]).astype(
                          np.uint8))


def median_stack(stack: torch.Tensor) -> torch.Tensor:
    """Per-pixel median over the frames of a (N, H, W, C) uint8 stack, as
    ``np.median(stack, 0).astype(np.uint8)``: for an even N the mean of the
    two middle values, truncated. Sorts ``MEDIAN_ROWS`` rows at a time on
    the stack's device."""
    n = stack.shape[0]
    out = torch.empty(stack.shape[1:], dtype=torch.uint8,
                      device=stack.device)
    for r in range(0, stack.shape[1], MEDIAN_ROWS):
        srt = stack[:, r:r + MEDIAN_ROWS].sort(dim=0).values
        hi = srt[n // 2].to(torch.int16)
        lo = srt[(n - 1) // 2].to(torch.int16)
        out[r:r + MEDIAN_ROWS] = ((lo + hi) // 2).to(torch.uint8)
    return out


def median_background(imgs_dir: str, masks_dir: str | None, out_path: str,
                      device="cuda") -> np.ndarray:
    """Per-pixel median over the frames' RGB -> the static background
    estimate, written to ``out_path`` and returned ((H, W, 3) uint8).
    ``masks_dir`` is not read, as in the JAX script."""
    stack = np.stack([read_png(osp.join(imgs_dir, name))[..., :3]
                      for name in sorted(os.listdir(imgs_dir))])
    bg = median_stack(torch.from_numpy(stack).to(device)).cpu().numpy()
    write_png(out_path, bg)
    return bg


# -- viewpoints -------------------------------------------------------------

def sample_on_sphere(num: int, radius: float) -> np.ndarray:
    """Fibonacci-spiral points on a sphere."""
    i = np.arange(num) + 0.5
    phi = np.arccos(1 - 2 * i / num)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return radius * np.stack([np.cos(theta) * np.sin(phi),
                              np.sin(theta) * np.sin(phi),
                              np.cos(phi)], axis=-1)


def look_at_pose(eye: np.ndarray, target: np.ndarray,
                 up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Camera-to-world looking from ``eye`` at ``target``, -z forward."""
    eye = np.asarray(eye, np.float64)
    fwd = eye - np.asarray(target, np.float64)  # camera z points away
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(np.asarray(up, np.float64), fwd)
    if np.linalg.norm(right) < 1e-8:
        right = np.array([1.0, 0.0, 0.0])
    right = right / np.linalg.norm(right)
    true_up = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, true_up, fwd, eye
    return c2w


# -- VIBE pkl -> MoCo-Flow JSON --------------------------------------------

def _load_vibe(pkl_path: str) -> dict:
    """The one person of a VIBE output pkl (joblib's format where joblib is
    installed, else a plain pickle). The pkl is a trusted file that the
    user's own VIBE run or ``convert_snapshot_gt`` wrote."""
    try:
        import joblib
        with open(pkl_path, "rb") as f:
            out = joblib.load(f)
    except ImportError:
        import pickle
        with open(pkl_path, "rb") as f:
            out = pickle.load(f)
    if len(out) != 1:
        raise ValueError(f"{pkl_path}: expected a single-person VIBE output, "
                         f"got {len(out)} people")
    return out[list(out.keys())[0]]


def _vibe_transl(person: dict, frame_id: int, focal: float, w: int):
    if "orig_cam" in person:
        cam = person["orig_cam"][frame_id]
        return np.array([cam[2], cam[3], 2 * focal / (cam[0] * w)])
    return np.asarray(person["transls"][frame_id])


def _write_meta(folder: str, meta: dict):
    for name in ("train.json", "val.json"):
        with open(osp.join(folder, name), "w") as f:
            json.dump(meta, f, indent=4, cls=NumpyEncoder)


def create_moco_flow_data(pkl_path: str, size, focal: float = 2000.0,
                          c=None, gender: str = "neutral") -> dict:
    """VIBE output -> ``train.json`` / ``val.json`` next to the pkl."""
    person = _load_vibe(pkl_path)
    h, w = size
    cam_c = np.array([w / 2, h / 2] if c is None else c)
    camera_pose = np.diag([1.0, -1.0, -1.0, 1.0])
    meta = {"gender": gender, "image_height": h, "image_width": w,
            "camera_focal": focal, "camera_c": cam_c, "D": np.zeros(5),
            "frames": []}
    for frame_id in person["frame_ids"]:
        meta["frames"].append({
            "file_path": f"{frame_id:04d}.png",
            "camera_pose": camera_pose,
            "pose": np.asarray(person["pose"][frame_id]),
            "betas": np.asarray(person["betas"][frame_id]),
            "transl": _vibe_transl(person, frame_id, focal, w),
        })
    _write_meta(osp.dirname(pkl_path), meta)
    return meta


@contextlib.contextmanager
def _fp32_matmuls():
    """cuBLAS in fp32 (TF32 off) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def posed_vertices(smpl, pose, betas, transl, device) -> np.ndarray:
    """(V, 3) float32 vertices of one pose on the host: ``smpl_forward`` on
    ``device`` in fp32 (TF32 off), plus ``transl``."""
    with _fp32_matmuls():
        verts = smpl_forward(
            smpl, torch.as_tensor(np.asarray(pose, np.float32),
                                  device=device)[None],
            torch.as_tensor(np.asarray(betas, np.float32),
                            device=device)[None])[0]
    return verts.cpu().numpy() + np.asarray(transl, np.float32)


def position_colors(verts: np.ndarray) -> np.ndarray:
    """The position colour map: each vertex's place in the body's box."""
    lo, hi = verts.min(0), verts.max(0)
    return (verts - lo) / (hi - lo + 1e-8)


def rgba_bytes(rgba: torch.Tensor) -> np.ndarray:
    """(H, W, 4) float RGBA in [0, 1] -> uint8, truncating as numpy's
    ``(rgba * 255).astype(np.uint8)``."""
    return (rgba * 255).to(torch.uint8).cpu().numpy()


def create_init_nerf_data(pkl_path: str, size, focal: float = 2000.0,
                          c=None, gender: str = "neutral",
                          num_images: int = 120, smpl_data=None,
                          device="cuda") -> dict:
    """Render ``num_images`` views of the frame-0 posed SMPL in the position
    colour map from Fibonacci-sphere points around it (radius ``|transl|``)
    -> ``init_nerf/{images/*.png, train.json, val.json}`` beside the pkl.
    The body is posed and the views are drawn on ``device``."""
    person = _load_vibe(pkl_path)
    save_folder = osp.dirname(pkl_path)
    h, w = size
    cam_c = [w / 2, h / 2] if c is None else list(c)
    pose0 = np.asarray(person["pose"][0], np.float32)
    betas0 = np.asarray(person["betas"][0], np.float32)
    transl0 = _vibe_transl(person, 0, focal, w).astype(np.float32)

    smpl = smpl_data if smpl_data is not None else load_smpl_data(gender)
    verts = posed_vertices(smpl, pose0, betas0, transl0, device)
    colors = torch.as_tensor(position_colors(verts), device=device)

    meta = {"gender": gender, "image_height": h, "image_width": w,
            "camera_focal": focal, "camera_c": np.asarray(cam_c),
            "D": np.zeros(5), "frames": []}
    out_imgs = osp.join(save_folder, "init_nerf", "images")
    os.makedirs(out_imgs, exist_ok=True)
    radius = float(np.sqrt((transl0 ** 2).sum()))
    # the PNGs are encoded on host threads (zlib releases the GIL) while
    # the device draws the next views
    with ThreadPoolExecutor(PNG_WORKERS) as pool:
        writes = []
        for frame_id, pos in enumerate(sample_on_sphere(num_images,
                                                        radius)):
            c2w = look_at_pose(pos + transl0, transl0)
            rgba = rasterize_mesh(verts, smpl.faces, colors, c2w, focal,
                                  cam_c, (h, w), bkgd=1.0, device=device)
            writes.append(pool.submit(
                write_png, osp.join(out_imgs, f"{frame_id:04d}.png"),
                rgba_bytes(rgba)))
            meta["frames"].append({
                "file_path": f"{frame_id:04d}.png",
                "camera_pose": c2w,
                "pose": pose0, "betas": betas0, "transl": transl0,
            })
        for done in writes:
            done.result()
    _write_meta(osp.join(save_folder, "init_nerf"), meta)
    return meta
