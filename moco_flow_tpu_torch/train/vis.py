"""Visualization: rendered frames, free-viewpoint views, mesh extraction.

Port of ``moco_flow_tpu/train/vis.py`` (its views, ``sigma_grid`` and
``visualize_mesh``): GT | pred | depth frame strips (with a novel view),
spherical-orbit, per-frame and bullet-time views, and sigma-grid
marching-cubes meshes, canonical or warped into a posed frame by the bw NoF
(kernel #3 on the card), and the occupancy grids' sigma lattices
(``grid_sig_device``, ``outer_bound_device``, ``warp_grid_device``, built on
the device for ``render/occupancy.py``). Views render through the trainer's
``render_views_pipelined``, as in JAX: only the rays inside the projected
AABB hull (and with occupancy, those its grid keeps), the background
elsewhere. Frames are PNGs (``utils/image.py``);
the port has no mp4 encoder, so a video is its directory of PNGs, which
``log.txt`` says once a run. In a data-parallel run every rank renders
(its share of each view's tiles) and rank 0 writes images and meshes.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np
import torch

from ..nn.nerf import nerf_sigma
from ..parallel.multihost import is_main
from ..render.volume import RenderConfig, encode_nerf_xyz
from ..utils.image import JET, write_png
from .stage_nof import nof_points


def colorize_depth(depth: np.ndarray) -> np.ndarray:
    """(H, W) depth -> (H, W, 3) JET colormap in [0, 1], as JAX's (cv2's
    ``COLORMAP_JET`` on the min-max normalized depth)."""
    x = np.nan_to_num(np.asarray(depth))
    mi, ma = x.min(), x.max()
    x = (x - mi) / (ma - mi + 1e-8)
    x = (255 * x).astype(np.uint8)
    return JET[x].astype(np.float32) / 255.0


def save_image(path: str, img: np.ndarray):
    """Write ``img`` (float in [0, 1]) as a PNG: on rank 0 only, as JAX's
    process 0; every rank computes what it shows."""
    if not is_main():
        return
    os.makedirs(osp.dirname(path), exist_ok=True)
    write_png(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))


def save_video(trainer, path: str):
    """JAX writes an mp4 where imageio has an ffmpeg backend and otherwise
    leaves the PNGs; the port has no encoder and leaves the PNGs."""
    if not getattr(trainer, "_video_noted", False):
        trainer._video_noted = True
        trainer.record_str(f"save_video: no mp4 encoder in the port; {path} "
                           "and every video after it stay as their PNG "
                           "frames")


def decode_results(res: dict, img_size):
    h, w = img_size
    typ = "fine" if "rgb_fine" in res else "coarse"
    img = res[f"rgb_{typ}"].reshape(h, w, 3).float().cpu().numpy()
    depth = colorize_depth(
        res[f"depth_{typ}"].reshape(h, w).float().cpu().numpy())
    return img, depth


def _test_rcfg(trainer, use_nof: bool):
    if not use_nof and hasattr(trainer, "rcfg_test_cano"):
        return trainer.rcfg_test_cano
    return trainer.rcfg_test


def _render_views(trainer, dataset, views, use_nof=True):
    """Render ``views`` = [(idx, c2w4, white_bkgd), ...] in order through
    ``trainer.render_views_pipelined``; yields (img, depth)."""
    def jobs():
        for idx, c2w4, white in views:
            rays = dataset.frame_rays(idx, c2w4=c2w4)
            bg = (torch.ones_like(dataset.bkgd_img) if white
                  else dataset.bkgd_img)
            yield (rays, idx if use_nof else -1, bg,
                   dataset.frame_mask(idx, c2w4=c2w4))

    rcfg = _test_rcfg(trainer, use_nof)
    for out in trainer.render_views_pipelined(jobs(), rcfg,
                                              anneal=trainer.anneal()):
        yield decode_results(out, dataset.size)


def _render_view(trainer, dataset, idx, c2w4=None, white_bkgd=False,
                 use_nof=True):
    return next(_render_views(trainer, dataset, [(idx, c2w4, white_bkgd)],
                              use_nof=use_nof))


def _name(frame_idx: int) -> str:
    return f"frame_{frame_idx}" if frame_idx != -1 else "canonical"


def _out_dir(trainer, save_path, kind: str) -> str:
    return osp.join(save_path or trainer.config.log_dir,
                    f"{kind}_epoch_{trainer.clock.epoch}_step_"
                    f"{trainer.clock.step}")


def visualize_frame(trainer, frame_idx: int, use_nof=True,
                    vis_novel_view=True, save_path=None, save_tb=True):
    """GT | pred | depth (| novel | novel depth) strip of one frame; frame
    -1 renders the canonical space. The novel view is a spherical pose drawn
    by ``trainer.val_rng()``, on a white background."""
    ds = trainer.val_dataset
    idx = frame_idx if frame_idx != -1 else 0
    nof = use_nof and frame_idx != -1
    img, depth = _render_view(trainer, ds, idx, use_nof=nof)
    panels = []
    gt = ds.frame_rgbs(idx)
    if gt is not None:
        panels.append(gt.reshape(*ds.size, 3).numpy())
    panels += [img, depth]
    if vis_novel_view and hasattr(ds, "spherical_poses"):
        pose = ds.spherical_poses[int(trainer.val_rng().integers(
            len(ds.spherical_poses)))]
        nimg, ndepth = _render_view(trainer, ds, idx, c2w4=pose,
                                    white_bkgd=True, use_nof=nof)
        panels += [nimg, ndepth]
    strip = np.concatenate(panels, axis=1)
    name = _name(frame_idx)
    save_image(osp.join(_out_dir(trainer, save_path, "images"),
                        f"{name}.png"), strip)
    if save_tb and trainer.logger is not None:
        trainer.logger.image(name, strip, trainer.clock.step)
    return strip


def _save_strips(trainer, rendered, img_dir: str):
    for i, (img, depth) in enumerate(rendered):
        save_image(osp.join(img_dir, f"{i:04d}.png"),
                   np.concatenate([img, depth], axis=1))


def visualize_spherical(trainer, frame_idx: int, use_nof=True,
                        save_path=None):
    """The 90-view orbit of one frame (or canonical for -1)."""
    ds = trainer.val_dataset
    idx = frame_idx if frame_idx != -1 else 0
    nof = use_nof and frame_idx != -1
    img_dir = osp.join(_out_dir(trainer, save_path, "spherical_videos"),
                       f"{_name(frame_idx)}_images")
    views = [(idx, pose, True) for pose in ds.spherical_poses]
    _save_strips(trainer, _render_views(trainer, ds, views, use_nof=nof),
                 img_dir)
    save_video(trainer, img_dir.replace("_images", "_video.mp4"))


def visualize_video(trainer, vis_novel_view=True, save_path=None):
    """Every frame of the sequence: GT | pred | depth (| a novel view)."""
    ds = trainer.val_dataset
    img_dir = osp.join(_out_dir(trainer, save_path, "videos"), "images")
    novel = vis_novel_view and hasattr(ds, "spherical_poses")
    views = []
    for idx in range(ds.num_frames):
        views.append((idx, None, False))
        if novel:
            views.append((idx, ds.spherical_poses[idx % len(
                ds.spherical_poses)], True))
    rendered = _render_views(trainer, ds, views, use_nof=True)
    for idx in range(ds.num_frames):
        img, depth = next(rendered)
        panels = []
        gt = ds.frame_rgbs(idx)
        if gt is not None:
            panels.append(gt.reshape(*ds.size, 3).numpy())
        panels += [img, depth]
        if novel:
            panels += list(next(rendered))
        save_image(osp.join(img_dir, f"{idx:04d}.png"),
                   np.concatenate(panels, axis=1))
    save_video(trainer, osp.join(osp.dirname(img_dir), "video.mp4"))


def visualize_bullet_time(trainer, frame_idx: int, save_path=None,
                          radius: float | None = None,
                          move_dist: float = 0.5):
    """Bullet-time track around one frozen frame: orbit, zoom in, zoom out
    (``geometry.poses.create_bullet_effect_poses``, 120 views)."""
    from ..geometry.poses import create_bullet_effect_poses
    ds = trainer.val_dataset
    idx = frame_idx if frame_idx != -1 else 0
    nof = frame_idx != -1
    if radius is None:
        radius = float(np.linalg.norm(ds.frame_c2w4(idx)[:3, 3]))
    poses = create_bullet_effect_poses(radius=radius, move_dist=move_dist)
    img_dir = osp.join(_out_dir(trainer, save_path, "bullet"),
                       f"{_name(frame_idx)}_images")
    views = [(idx, pose, True) for pose in poses]
    _save_strips(trainer, _render_views(trainer, ds, views, use_nof=nof),
                 img_dir)
    save_video(trainer, img_dir.replace("_images", "_video.mp4"))


# ---------------------------------------------------------------------------
# Mesh extraction
# ---------------------------------------------------------------------------

def sigma_grid(trainer, frame_idx: int, n_grid: int = 256,
               extent: float = 1.5, chunk: int = 65536,
               clip_negative: bool = True) -> np.ndarray:
    """Sigma on an n_grid^3 lattice over [-extent, extent]^3 (positions
    warped to canonical by the bw NoF for frame != -1), in tiles of
    ``chunk`` points on the trainer's device: fp32 ``nerf_sigma`` of the
    fine NeRF (the coarse one without it), the warp through
    ``stage_nof.nof_points`` (the single-warp kernel #3 on the card, one
    launch a tile). ``clip_negative=False`` returns raw sigma."""
    params, statics = trainer.params, trainer.statics
    anneal = trainer.anneal()
    use_fine = "fine_NeRF" in params
    nerf_name = "fine_NeRF" if use_fine else "coarse_NeRF"
    nerf_cfg = statics.fine if use_fine and statics.fine else statics.coarse
    warp = frame_idx != -1 and "bw_NoF" in params
    dev = trainer.device
    norm_idx = torch.tensor(
        frame_idx * 2.0 / max(getattr(trainer, "num_frames", 1), 1) - 1.0,
        dtype=torch.float32, device=dev)
    lin = np.linspace(-extent, extent, n_grid, dtype=np.float32)
    xyz = np.stack(np.meshgrid(lin, lin, lin), -1).reshape(-1, 3)
    xyz = torch.from_numpy(xyz).to(dev)
    out = torch.empty(len(xyz), dtype=torch.float32, device=dev)
    rcfg = RenderConfig(use_nof=True)
    with torch.no_grad():
        for i in range(0, len(xyz), chunk):
            pts = xyz[i:i + chunk]
            if warp:
                pts = nof_points(params["bw_NoF"], statics, anneal, pts,
                                 norm_idx, rcfg)
            emb = encode_nerf_xyz(params[nerf_name], nerf_cfg, statics, pts,
                                  anneal)
            out[i:i + chunk] = nerf_sigma(params[nerf_name], emb,
                                          nerf_cfg)[:, 0]
    sig = out.cpu().numpy()
    if clip_negative:
        sig = np.maximum(sig, 0)
    return sig.reshape(n_grid, n_grid, n_grid)


def _norm_idx(trainer, frame_idx: int) -> torch.Tensor:
    return torch.tensor(
        frame_idx * 2.0 / max(getattr(trainer, "num_frames", 1), 1) - 1.0,
        dtype=torch.float32, device=trainer.device)


def _lattice(n: int, extent: float, chunk: int, dev, tile_fn):
    """(n, n, n) values of ``tile_fn`` over the lattice of [-extent,
    extent]^3 in (x, y, z) order, built on ``dev`` from the flat cell index
    in tiles of ``chunk`` points (the last one repeating the final
    point)."""
    ext = torch.tensor(extent, dtype=torch.float32, device=dev)
    step = 2.0 * ext / (n - 1)
    tiles = -(-n ** 3 // chunk)
    out = torch.empty(tiles * chunk, dtype=torch.float32, device=dev)
    with torch.no_grad():
        for t in range(tiles):
            f = torch.clamp(t * chunk + torch.arange(chunk, device=dev),
                            max=n ** 3 - 1)
            ijk = torch.stack([f // (n * n), (f // n) % n, f % n], dim=-1)
            out[t * chunk:(t + 1) * chunk] = tile_fn(
                ijk.to(torch.float32) * step - ext)
    return out[:n ** 3].reshape(n, n, n)


def _max_dilate(sig: torch.Tensor, steps: int) -> torch.Tensor:
    """``steps`` 3^3 max filters, padded with -inf (JAX's reduce_window)."""
    for _ in range(steps):
        sig = torch.nn.functional.max_pool3d(sig[None, None], 3, 1, 1)[0, 0]
    return sig


def _pool(sig: torch.Tensor, r: int, s: int) -> torch.Tensor:
    if s > 1:
        sig = sig.reshape(r, s, r, s, r, s).amax(dim=(1, 3, 5))
    return sig


def _outside(sig: torch.Tensor, extent: float,
             outer_extent: float) -> torch.Tensor:
    """Max of an (r, r, r) lattice over the outer cube without the points
    inside [-extent, extent]^3, as one 0-d tensor."""
    r = sig.shape[0]
    c = torch.from_numpy(np.abs(np.linspace(
        -outer_extent, outer_extent, r, dtype=np.float32))).to(sig.device)
    inside = ((c[:, None, None] <= extent) & (c[None, :, None] <= extent)
              & (c[None, None, :] <= extent))
    return torch.where(inside, torch.full_like(sig, -float("inf")),
                       sig).max()


def _grid_builders(trainer, frame_idx: int, resolution: int,
                   supersample: int, activation: str, dilate: int,
                   chunk: int):
    """The occupancy grid's sigma lattice, built on the trainer's device:
    the lattice from the flat cell index, the warp through
    ``stage_nof.nof_points`` (kernel #3 on the card, one launch a tile), the
    fp32 ``nerf_sigma`` of the fine NeRF (plain GEMMs, as ``sigma_grid``),
    then max-pool, activation and dilation. Nothing is read back.

    Returns ``(grid_fn, outer_fn)``:
      grid_fn(norm_idx, extent) -> (r, r, r) float32 in (x, y, z) order,
        the pooled, activated, dilated upper bound;
      outer_fn(norm_idx, extent, outer_extent) -> 0-d: the largest
        activated, dilated sigma outside [-extent, extent]^3 on an r^3
        lattice over the outer cube.
    """
    params, statics = trainer.params, trainer.statics
    anneal = trainer.anneal()
    use_fine = "fine_NeRF" in params
    nerf_name = "fine_NeRF" if use_fine else "coarse_NeRF"
    nerf_cfg = statics.fine if use_fine and statics.fine else statics.coarse
    warp = frame_idx != -1 and "bw_NoF" in params
    dev = trainer.device
    rcfg = RenderConfig(use_nof=True)

    def raw_lattice(norm_idx, extent, n):
        def tile(pts):
            if warp:
                pts = nof_points(params["bw_NoF"], statics, anneal, pts,
                                 norm_idx, rcfg)
            emb = encode_nerf_xyz(params[nerf_name], nerf_cfg, statics, pts,
                                  anneal)
            return nerf_sigma(params[nerf_name], emb, nerf_cfg)[:, 0]
        return _lattice(n, extent, chunk, dev, tile)

    def activate_dilate(sig, n_dilate):
        sig = (torch.logaddexp(sig, torch.zeros_like(sig))
               if activation == "softplus" else torch.clamp(sig, min=0.0))
        return _max_dilate(sig, n_dilate)

    def grid_fn(norm_idx, extent):
        sig = raw_lattice(norm_idx, extent, resolution * supersample)
        return activate_dilate(_pool(sig, resolution, supersample), dilate)

    def outer_fn(norm_idx, extent, outer_extent):
        sig = activate_dilate(raw_lattice(norm_idx, outer_extent,
                                          resolution), 1)
        return _outside(sig, extent, outer_extent)

    return grid_fn, outer_fn


def _warp_grid_builders(trainer, resolution: int, supersample: int,
                        dilate: int, chunk: int):
    """The warp-pullback grid (``occ_builder: warp``): a frame's bound is
    the canonical grid's bound at the bw-warped lattice point,
    ``sig_obs(x) = C_sig[cell(bw(x, frame))]``, one NoF evaluation and one
    gather a point in place of the trunk. Points that warp outside the
    canonical cube read its measured outer bound (within its shell) or
    +inf.

    Returns ``(grid_fn, outer_fn)``:
      grid_fn(norm_idx, extent, cano) -> (r, r, r) float32
      outer_fn(norm_idx, extent, outer_extent, cano) -> 0-d
    with ``cano`` the canonical grid (an ``OccupancyGrid`` or
    ``DeviceOccupancyGrid``).
    """
    params, statics = trainer.params, trainer.statics
    anneal = trainer.anneal()
    dev = trainer.device
    rcfg = RenderConfig(use_nof=True)

    def lookup_cano(y, c_sig, cano):
        """The three-zone canonical bound (the tightener's zones)."""
        c_r = c_sig.shape[0]
        c_ext = torch.tensor(cano.extent, dtype=torch.float32, device=dev)
        cell = 2.0 * c_ext / c_r
        ids = torch.floor((y + c_ext) / cell).to(torch.int64)
        inb = ((ids >= 0) & (ids < c_r)).all(dim=-1)
        ids = ids.clamp(0, c_r - 1)
        vals = c_sig.reshape(-1)[(ids[..., 0] * c_r + ids[..., 1]) * c_r
                                 + ids[..., 2]]
        in_shell = (y.abs() <= cano.outer_extent).all(dim=-1)
        inf = torch.full_like(vals, float("inf"))
        return torch.where(inb, vals, torch.where(
            in_shell, cano.outer_sig_tensor(dev), inf))

    def pullback_lattice(norm_idx, extent, n, cano):
        c_sig = getattr(cano, "sig_dev", None)
        if c_sig is None:
            c_sig = torch.from_numpy(np.asarray(cano.sig, np.float32)).to(dev)
        return _lattice(n, extent, chunk, dev, lambda pts: lookup_cano(
            nof_points(params["bw_NoF"], statics, anneal, pts, norm_idx,
                       rcfg), c_sig, cano))

    def grid_fn(norm_idx, extent, cano):
        sig = pullback_lattice(norm_idx, extent, resolution * supersample,
                               cano)
        # the canonical bound is already activated
        return _max_dilate(_pool(sig, resolution, supersample), dilate)

    def outer_fn(norm_idx, extent, outer_extent, cano):
        sig = _max_dilate(pullback_lattice(norm_idx, outer_extent,
                                           resolution, cano), 1)
        return _outside(sig, extent, outer_extent)

    return grid_fn, outer_fn


def warp_grid_device(trainer, frame_idx: int, resolution: int, cano_grid,
                     supersample: int = 2, extent: float = 1.5,
                     dilate: int = 1, chunk: int = 131072,
                     outer_extent: float | None = None):
    """The warp-pullback grid of a frame (see :func:`_warp_grid_builders`):
    ``(sig (r, r, r), outer_sig 0-d | None)`` on the device."""
    grid_fn, outer_fn = _warp_grid_builders(trainer, resolution, supersample,
                                            dilate, chunk)
    norm_idx = _norm_idx(trainer, frame_idx)
    sig = grid_fn(norm_idx, extent, cano_grid)
    outer_sig = None
    if outer_extent is not None:
        outer_sig = outer_fn(norm_idx, extent, outer_extent, cano_grid)
    return sig, outer_sig


def grid_sig_device(trainer, frame_idx: int, resolution: int,
                    supersample: int = 2, extent: float = 1.5,
                    activation: str = "relu", dilate: int = 1,
                    chunk: int = 131072, fetch: bool = True):
    """The occupancy sigma lattice on the device (see
    :func:`_grid_builders`); ``fetch=False`` returns the (r, r, r) device
    tensor, ``fetch=True`` a numpy array."""
    grid_fn, _ = _grid_builders(trainer, frame_idx, resolution, supersample,
                                activation, dilate, chunk)
    sig = grid_fn(_norm_idx(trainer, frame_idx), extent)
    return sig if not fetch else sig.cpu().numpy()


def outer_bound_device(trainer, frame_idx: int, resolution: int,
                       extent: float, outer_extent: float,
                       activation: str = "relu", chunk: int = 131072,
                       fetch: bool = True):
    """The largest activated density outside the grid cube: a 0-d device
    tensor with ``fetch=False``, else a float."""
    _, outer_fn = _grid_builders(trainer, frame_idx, resolution,
                                 supersample=1, activation=activation,
                                 dilate=1, chunk=chunk)
    out = outer_fn(_norm_idx(trainer, frame_idx), extent, outer_extent)
    return out if not fetch else float(out)


def visualize_mesh(trainer, frame_idx: int, n_grid: int = 256,
                   sigma_threshold: float = 10.0, save_path=None,
                   extent: float = 1.5):
    """Sigma grid -> marching cubes -> OBJ, with the reference's xy swap,
    winding flip and rescale to [-extent, extent]. Returns the OBJ's path,
    or None for an empty field. Every rank computes the grid; rank 0 runs
    marching cubes and writes (the others return None)."""
    from ..ops.mcubes import export_obj, marching_cubes
    sigma = sigma_grid(trainer, frame_idx, n_grid=n_grid, extent=extent)
    if not is_main():
        return None
    verts, tris = marching_cubes(sigma, sigma_threshold)
    if len(verts) == 0:
        trainer.record_str("visualize_mesh: empty sigma field, skipping")
        return None
    verts = verts[:, [1, 0, 2]]
    tris = tris[:, [0, 2, 1]]
    verts = verts / n_grid * (2 * extent) - extent
    name = f"{frame_idx}" if frame_idx != -1 else "canonical"
    out = osp.join(_out_dir(trainer, save_path, "mesh"), f"{name}.obj")
    export_obj(verts, tris, out)
    return out
