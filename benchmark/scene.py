"""Inputs that the benchmark makes from ``--seed`` on the device: the scene
tables that a dataset would hand a trainer, the correspondence table, and
the weights.

- the scene (:func:`make_scene`): cameras, near / far, the valid-pixel
  table, the direction grid, RGBA frames, the background, and the posed
  body's vertices with their per-vertex transforms to the canonical frame;
- the weights (:func:`make_weights`), as ``torch.nn.Linear`` draws them, in
  one call.

The program and the reference get the very same tensors. Seeds are mixed
with a stream id (``SCENE``, ``WEIGHTS``, ``DRAWS``, ``HOST``), so no two
uses of one seed share a stream.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def seed_of(*parts: int) -> int:
    """A 63-bit seed mixed from whole numbers of any size."""
    words = np.random.SeedSequence([int(p) for p in parts]).generate_state(2)
    return (int(words[0]) << 31 ^ int(words[1])) & (2 ** 63 - 1)


def device_gen(device, *parts: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_of(*parts))


# stream ids, so that no two uses of one seed share a stream
SCENE, WEIGHTS, DRAWS, HOST = 1, 2, 3, 4


FRAME_CHUNK = 16


def _rotations(axis_angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3)."""
    theta = axis_angle.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    k = axis_angle / theta
    kx, ky, kz = k.unbind(-1)
    zero = torch.zeros_like(kx)
    kmat = torch.stack([zero, -kz, ky, kz, zero, -kx, -ky, kx, zero],
                       -1).reshape(*k.shape[:-1], 3, 3)
    s, c = torch.sin(theta)[..., None], torch.cos(theta)[..., None]
    eye = torch.eye(3, device=k.device).expand_as(kmat)
    return eye + s * kmat + (1 - c) * kmat @ kmat


def make_scene(cfg: dict, seed: int, device) -> dict:
    """The scene tables of ``cfg`` from ``seed``, on ``device``.

    A body of ``num_verts`` points on an ellipsoid of half extents
    ``body_extent`` (m), cut into 24 parts by height and side, each part
    turned about its centre by a rotation of ``pose_scale`` rad a frame; a
    camera ``cam_dist`` m in front of it with focal ``focal`` px at the
    dataloader's ``size``; each frame's box is the posed body's, scaled by
    the dataloader's ``aabb``; its valid pixels are the box's projected
    rectangle; its RGBA frame a soft ellipse of seeded colour waves."""
    sc, dl = cfg["scene"], cfg["dataloader"]
    h, w = dl["size"]
    n_f, n_v = int(cfg["num_frames"]), int(sc["num_verts"])
    gen = device_gen(device, seed, SCENE)
    ext = torch.tensor(sc["body_extent"], device=device)
    rest = torch.randn((n_v, 3), generator=gen, device=device)
    rest = rest / rest.norm(dim=-1, keepdim=True) * ext
    band = ((rest[:, 1] + ext[1]) / (2 * ext[1]) * 12).long().clamp(0, 11)
    part = band * 2 + (rest[:, 0] > 0).long()                     # (V,)
    centres = torch.zeros((24, 3), device=device).index_add_(
        0, part, rest) / torch.bincount(part, minlength=24).clamp_min(
            1)[:, None].float()
    rot = _rotations(torch.randn((n_f, 24, 3), generator=gen, device=device)
                     * float(sc["pose_scale"]))                   # (F, 24, 3, 3)
    eye4 = torch.eye(4, device=device)
    posed = eye4.repeat(n_f, 24, 1, 1)                            # rest -> frame
    posed[..., :3, :3] = rot
    posed[..., :3, 3] = centres - (rot @ centres[..., None])[..., 0]
    verts = (rot[:, part] @ rest[..., None])[..., 0] + posed[:, part, :3, 3]
    inv = eye4.repeat(n_f, 24, 1, 1)                              # frame -> rest
    inv[..., :3, :3] = rot.transpose(-1, -2)
    inv[..., :3, 3] = -(inv[..., :3, :3] @ posed[..., :3, 3, None])[..., 0]
    src_to_cano = posed[0][None] @ inv                            # (F, 24, 4, 4)
    src_to_cano = src_to_cano[:, part]                            # (F, V, 4, 4)

    scale = torch.tensor(dl["aabb"][0], device=device)
    pad = torch.tensor(dl["aabb"][1], device=device)
    lo, hi = verts.amin(1), verts.amax(1)                         # (F, 3)
    mid, half = (lo + hi) / 2, (hi - lo) / 2 * scale + pad
    lo, hi = mid - half, mid + half
    cam = torch.tensor([0.0, 0.0, float(sc["cam_dist"])], device=device)
    corners = torch.stack([torch.stack([lo[:, 0] if i & 4 else hi[:, 0],
                                        lo[:, 1] if i & 2 else hi[:, 1],
                                        lo[:, 2] if i & 1 else hi[:, 2]], -1)
                           for i in range(8)], 1)                 # (F, 8, 3)
    rel = corners - cam
    near = (cam[2] - hi[:, 2]).clamp_min(0.1)
    far = rel.norm(dim=-1).amax(1)
    f = float(sc["focal"])
    cx, cy = w / 2.0, h / 2.0
    u = cx + f * rel[..., 0] / -rel[..., 2] - 0.5
    v = cy - f * rel[..., 1] / -rel[..., 2] - 0.5
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]

    def box(i):
        return ((xs >= u[i].min()) & (xs <= u[i].max()) & (ys >= v[i].min())
                & (ys <= v[i].max())).reshape(-1)

    counts = torch.stack([box(i).sum() for i in range(n_f)])
    maxv = int(counts.max())
    valid_idx = torch.empty((n_f, maxv), dtype=torch.int64, device=device)
    for i in range(n_f):
        idx = torch.nonzero(box(i))[:, 0]
        valid_idx[i] = idx[torch.arange(maxv, device=device) % len(idx)]

    dirs = torch.stack([(xs + 0.5 - cx).float().expand(h, w) / f,
                        -(ys + 0.5 - cy).float().expand(h, w) / f,
                        -torch.ones((h, w), device=device)], -1).reshape(-1, 3)
    c2w = torch.zeros((n_f, 3, 4), device=device)
    c2w[:, :, :3] = torch.eye(3, device=device)
    c2w[:, :, 3] = cam
    ru, rv = f * ext[0] / cam[2], f * ext[1] / cam[2]
    phases = torch.rand((n_f, 3), generator=gen, device=device) * 2 * math.pi
    r2 = ((xs - cx) / ru) ** 2 + ((ys - cy) / rv) ** 2              # (H, W)
    alpha = (torch.sigmoid((1.0 - r2) * 8.0).clamp(0, 1) * 255).round()
    wave = (xs * 0.013 + ys * 0.007).float()
    freq = torch.tensor([1.0, 1.3, 1.7], device=device)[None, :, None, None]
    images = torch.empty((n_f, h * w, 4), dtype=torch.uint8, device=device)
    images[..., 3] = alpha.to(torch.uint8).reshape(1, -1)
    for i in range(0, n_f, FRAME_CHUNK):       # a few frames at a time
        rgb = 0.5 + 0.4 * torch.sin(wave[None, None]
                                    + phases[i:i + FRAME_CHUNK, :, None,
                                             None] * freq)
        images[i:i + FRAME_CHUNK, :, :3] = (rgb.clamp(0, 1) * 255).round().to(
            torch.uint8).permute(0, 2, 3, 1).reshape(-1, h * w, 3)

    bkgd = dl["bkgd"]
    rand_bkgd = bkgd == "rand"
    bkgd_img = torch.full((h * w, 3), 1.0 if rand_bkgd else float(bkgd),
                          device=device)
    return {"c2w": c2w, "near": near, "far": far,
            "norm_idx": torch.arange(n_f, device=device) * 2.0 / n_f - 1.0,
            "valid_idx": valid_idx, "valid_count": counts,
            "directions": dirs, "images": images, "bkgd": bkgd_img,
            "rand_bkgd": rand_bkgd, "verts": verts,
            "src_to_cano": src_to_cano}


def make_weights(params: dict, cfg: dict, seed: int, device):
    """Fill every layer ``{'w': (in, out), 'b': (out,)}`` of ``params`` in
    place with ``U(-1/sqrt(in), 1/sqrt(in))`` from one draw on ``device``,
    and add ``weights.sigma_bias_offset`` to the NeRFs' sigma bias."""
    layers = []

    def walk(tree, name=""):
        if isinstance(tree, dict) and "w" in tree and "b" in tree:
            layers.append((name, tree))
            return
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            walk(v, f"{name}/{k}")

    walk(params)
    total = sum(t["w"].numel() + t["b"].numel() for _, t in layers)
    u = torch.rand((total,), generator=device_gen(device, seed, WEIGHTS),
                   device=device) * 2 - 1
    off = 0
    offset = float(cfg.get("weights", {}).get("sigma_bias_offset", 0.0))
    with torch.no_grad():
        for name, t in layers:
            bound = 1.0 / math.sqrt(t["w"].shape[0])
            for key in ("w", "b"):
                k = t[key].numel()
                t[key].copy_(u[off:off + k].view_as(t[key]) * bound)
                off += k
            if name.endswith("NeRF/sigma"):
                t["b"].add_(offset)
