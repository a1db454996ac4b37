"""Convert a PyTorch MoCo-Flow reference checkpoint (.pth) to the .npz +
JSON-sidecar format that both packages read, and back.

Port of ``scripts/convert_ref_ckpt.py``:

    python -m moco_flow_tpu_torch.scripts.convert_ref_ckpt \
        ref_ckpts/epoch10_iter200000.pth out_dir/epoch10_iter200000 \
        [--extra_pe_channels 1] [--nof_in_channels_xyz 33] \
        [--config stage.yaml] [--reverse]

The reference saves ``{net_key}_net`` torch state dicts, per-optimizer
state and a clock dict; the .npz holds the '/'-flattened parameter tree
and the sidecar the clock (``train/checkpoint.py``). Network weights and
the clock convert exactly; the optimizers' state does not (torch Adam
moments keyed by parameter id against named leaves), so a resumed run
re-warms its optimizer, as the reference's own ``load_pretrained`` does.

Layout (PARITY.md): ``nn.Linear`` stores (out, in), the tree (in, out), so
weights are transposed; the positional encoding here is the block layout
``[x, sin_0..sin_{K-1}, cos_0..cos_{K-1}]``, a fixed permutation of the
reference's interleaved ``[x, sin_0, cos_0, sin_1, ...]``, so the rows of
first (and skip) layers are permuted to match, and the converted model is
numerically the same on the same scene. ``--config`` reads the NoF's
``in_channels_xyz`` and the NeRF's ``extra_feat_type`` from a stage YAML
with ``utils/config.py``. The output loads with ``-r`` / auto-resume, or
as ``pretrained_nerf`` / ``pretrained_nof`` of a stage-3 config.
"""

from __future__ import annotations

import argparse
import re

import numpy as np
import torch

from ..train.checkpoint import load_checkpoint, save_checkpoint
from ..utils.config import load_yaml


def block_perm(c: int, k: int) -> np.ndarray:
    """Permutation p with ``block_layout[i] == interleaved[p[i]]`` for a PE
    of ``c`` input channels and ``k`` frequencies (identity channels first)."""
    perm = list(range(c))
    perm += [c + 2 * kk * c + cc for kk in range(k) for cc in range(c)]
    perm += [c + (2 * kk + 1) * c + cc for kk in range(k) for cc in range(c)]
    return np.asarray(perm)


def pe_perm(dim: int, channels: int) -> np.ndarray | None:
    """Interleaved->block row permutation for a PE of ``dim`` total channels
    over ``channels`` raw inputs; None (identity) when ``dim`` is not a PE
    shape (e.g. a raw feature)."""
    if channels <= 0 or (dim - channels) % (2 * channels) != 0:
        return None
    k = (dim - channels) // (2 * channels)
    return block_perm(channels, k) if k > 0 else None


def _wT(sd: dict, name: str) -> np.ndarray:
    return sd[name + ".weight"].detach().cpu().numpy().T.copy()


def _b(sd: dict, name: str) -> np.ndarray:
    return sd[name + ".bias"].detach().cpu().numpy().copy()


def _permute_rows(w: np.ndarray, perm: np.ndarray | None,
                  lo: int, hi: int) -> np.ndarray:
    if perm is None:
        return w
    out = w.copy()
    out[lo:hi] = w[lo:hi][perm]
    return out


def convert_nerf(sd: dict, extra_pe_channels: int = 1) -> dict:
    """Reference ``NeRF.state_dict()`` -> parameter tree
    (reference models/nerf.py:27-58: xyz_encoding_{i}.0, xyz_encoding_final,
    extra_encoding.0, sigma, rgb.0)."""
    depth = max(int(m.group(1)) for k in sd
                if (m := re.match(r"xyz_encoding_(\d+)\.0\.weight", k)))
    width = sd["xyz_encoding_1.0.weight"].shape[0]
    cx = sd["xyz_encoding_1.0.weight"].shape[1]
    perm_xyz = pe_perm(cx, 3)

    trunk = []
    for i in range(depth):
        w = _wT(sd, f"xyz_encoding_{i + 1}.0")
        if w.shape[0] == cx:             # first layer: raw PE input
            w = _permute_rows(w, perm_xyz, 0, cx)
        elif w.shape[0] == width + cx:   # skip layer: [PE, hidden] concat
            w = _permute_rows(w, perm_xyz, 0, cx)
        trunk.append({"w": w, "b": _b(sd, f"xyz_encoding_{i + 1}.0")})

    we = _wT(sd, "extra_encoding.0")
    ce = we.shape[0] - width             # 0 for extra_feat_type 'none'
    if ce > 0:
        we = _permute_rows(we, pe_perm(ce, extra_pe_channels), width,
                           width + ce)
    return {
        "trunk": trunk,
        "sigma": {"w": _wT(sd, "sigma"), "b": _b(sd, "sigma")},
        "final": {"w": _wT(sd, "xyz_encoding_final"),
                  "b": _b(sd, "xyz_encoding_final")},
        "extra": {"w": we, "b": _b(sd, "extra_encoding.0")},
        "rgb": {"w": _wT(sd, "rgb.0"), "b": _b(sd, "rgb.0")},
    }


def convert_nof(sd: dict, in_channels_xyz: int = 33,
                xyz_pe_channels: int = 3, ind_pe_channels: int = 1) -> dict:
    """Reference ``NoF.state_dict()`` -> parameter tree (reference
    models/nof.py: nof_encoding_{i}.0, nof_encoding_final). The NoF input is
    [PE(xyz), PE(ind)]; both PE segments are row-permuted. The xyz/ind split
    point cannot be recovered from the first-layer shape alone (it sees the
    concatenated width, and both segments have odd PE widths), so
    ``in_channels_xyz`` must come from the config — 33 (= 3+6*5) in every
    shipped MoCo-Flow config (reference configs/.../c2f.yaml fw_NoF)."""
    depth = max(int(m.group(1)) for k in sd
                if (m := re.match(r"nof_encoding_(\d+)\.0\.weight", k)))
    width = sd["nof_encoding_1.0.weight"].shape[0]
    total = sd["nof_encoding_1.0.weight"].shape[1]

    cx = in_channels_xyz
    ce = total - cx
    if ce < 0:
        raise ValueError(f"NoF first-layer input dim {total} is smaller "
                         f"than in_channels_xyz={cx}")
    perm_xyz = pe_perm(cx, xyz_pe_channels)
    perm_ind = pe_perm(ce, ind_pe_channels) if ce > 0 else None

    layers = []
    for i in range(depth):
        w = _wT(sd, f"nof_encoding_{i + 1}.0")
        if w.shape[0] in (total, width + total):  # first or skip layer
            w = _permute_rows(w, perm_xyz, 0, cx)
            w = _permute_rows(w, perm_ind, cx, cx + ce)
        layers.append({"w": w, "b": _b(sd, f"nof_encoding_{i + 1}.0")})
    return {"layers": layers,
            "head": {"w": _wT(sd, "nof_encoding_final"),
                     "b": _b(sd, "nof_encoding_final")}}


def _inv(perm: np.ndarray | None) -> np.ndarray | None:
    return None if perm is None else np.argsort(perm)


def _unpermute_rows(w: np.ndarray, perm: np.ndarray | None,
                    lo: int, hi: int) -> np.ndarray:
    return _permute_rows(w, _inv(perm), lo, hi)


def reverse_nerf(p: dict, extra_pe_channels: int = 1) -> dict:
    """NeRF parameter tree -> reference ``NeRF.state_dict()`` tensor
    dict (block->interleaved PE rows, (in,out)->(out,in) transpose)."""
    cx = np.asarray(p["trunk"][0]["w"]).shape[0]
    width = np.asarray(p["trunk"][0]["w"]).shape[1]
    perm_xyz = pe_perm(cx, 3)
    sd = {}

    def put(name, w, b):
        sd[name + ".weight"] = torch.from_numpy(
            np.asarray(w, np.float32).T.copy())
        sd[name + ".bias"] = torch.from_numpy(np.asarray(b, np.float32).copy())

    for i, lin in enumerate(p["trunk"]):
        w = np.asarray(lin["w"], np.float32)
        if w.shape[0] in (cx, width + cx):
            w = _unpermute_rows(w, perm_xyz, 0, cx)
        put(f"xyz_encoding_{i + 1}.0", w, lin["b"])
    put("xyz_encoding_final", p["final"]["w"], p["final"]["b"])
    we = np.asarray(p["extra"]["w"], np.float32)
    ce = we.shape[0] - width
    if ce > 0:
        we = _unpermute_rows(we, pe_perm(ce, extra_pe_channels), width,
                             width + ce)
    put("extra_encoding.0", we, p["extra"]["b"])
    put("sigma", p["sigma"]["w"], p["sigma"]["b"])
    put("rgb.0", p["rgb"]["w"], p["rgb"]["b"])
    return sd


def reverse_nof(p: dict, in_channels_xyz: int = 33,
                xyz_pe_channels: int = 3, ind_pe_channels: int = 1) -> dict:
    """NoF parameter tree -> reference ``NoF.state_dict()``."""
    cx = in_channels_xyz
    total = np.asarray(p["layers"][0]["w"]).shape[0]
    width = np.asarray(p["layers"][0]["w"]).shape[1]
    ce = total - cx
    perm_xyz = pe_perm(cx, xyz_pe_channels)
    perm_ind = pe_perm(ce, ind_pe_channels) if ce > 0 else None
    sd = {}

    def put(name, w, b):
        sd[name + ".weight"] = torch.from_numpy(
            np.asarray(w, np.float32).T.copy())
        sd[name + ".bias"] = torch.from_numpy(np.asarray(b, np.float32).copy())

    for i, lin in enumerate(p["layers"]):
        w = np.asarray(lin["w"], np.float32)
        if w.shape[0] in (total, width + total):
            w = _unpermute_rows(w, perm_xyz, 0, cx)
            w = _unpermute_rows(w, perm_ind, cx, cx + ce)
        put(f"nof_encoding_{i + 1}.0", w, lin["b"])
    put("nof_encoding_final", p["head"]["w"], p["head"]["b"])
    return sd


def reverse_checkpoint(tree: dict, extra: dict, extra_pe_channels: int = 1,
                       nof_in_channels_xyz: int = 33) -> tuple:
    """A checkpoint's (tree, extra) -> reference save_dict {name_net: state_dict, clock}
    loadable by the reference's load_ckpt/load_pretrained_model
    (trainer/base.py:301-327, trainer_moco_flow.py:47-57)."""
    params = tree.get("params", tree)
    out, skipped = {}, []
    for name, p in params.items():
        if "NeRF" in name:
            if "hash" in p:
                skipped.append(f"{name}.hash")  # no reference counterpart
                p = {k: v for k, v in p.items() if k != "hash"}
            out[name + "_net"] = reverse_nerf(p, extra_pe_channels)
        elif "NoF" in name:
            out[name + "_net"] = reverse_nof(p, nof_in_channels_xyz)
        else:
            skipped.append(name)
    if "opt_named" in tree:
        skipped.append("opt_named")   # optimizer state: not convertible
    out["clock"] = extra.get("clock", {"epoch": 0, "minibatch": 0, "step": 0})
    return out, skipped


def _strip_module(sd: dict) -> dict:
    """Drop a DDP 'module.' prefix if present (reference saves .module
    state dicts, but be tolerant of raw DDP dumps)."""
    return {(k[7:] if k.startswith("module.") else k): v
            for k, v in sd.items()}


def convert_checkpoint(ckpt: dict, extra_pe_channels: int = 1,
                       nof_in_channels_xyz: int = 33) -> tuple:
    """Reference save_dict -> (tree, extra, skipped_keys) for
    save_checkpoint."""
    params = {}
    skipped = []
    for key, val in ckpt.items():
        if key.endswith("_net"):
            name = key[:-4]
            sd = _strip_module(val)
            if "NeRF" in name:
                params[name] = convert_nerf(sd, extra_pe_channels)
            elif "NoF" in name:
                params[name] = convert_nof(sd, nof_in_channels_xyz)
            else:
                skipped.append(key)
        elif key != "clock":
            skipped.append(key)   # optimizers/schedulers: not convertible
    extra = {"clock": ckpt.get("clock", {"epoch": 0, "minibatch": 0,
                                         "step": 0})}
    return {"params": params}, extra, skipped


def config_channels(path: str) -> dict:
    """``nof_in_channels_xyz`` / ``extra_pe_channels`` that a stage YAML
    sets (its bw or fw NoF's ``in_channels_xyz``; 3 PE channels for a
    NeRF with ``extra_feat_type: dir``)."""
    model = load_yaml(path)["model"]
    out = {}
    nof_cfg = model.get("bw_NoF") or model.get("fw_NoF")
    if nof_cfg and "in_channels_xyz" in nof_cfg:
        out["nof_in_channels_xyz"] = nof_cfg["in_channels_xyz"]
    nerf_cfg = model.get("fine_NeRF") or model.get("coarse_NeRF")
    if nerf_cfg and nerf_cfg.get("extra_feat_type") == "dir":
        out["extra_pe_channels"] = 3
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Convert a PyTorch reference .pth to .npz + sidecar "
                    "(or back with --reverse)")
    ap.add_argument("src", help="reference .pth checkpoint "
                                "(--reverse: an .npz checkpoint)")
    ap.add_argument("dst", help="output path WITHOUT extension "
                                "(--reverse: output .pth path)")
    ap.add_argument("--reverse", action="store_true",
                    help="convert an .npz checkpoint to a reference .pth")
    ap.add_argument("--extra_pe_channels", type=int, default=1,
                    help="raw channels under the NeRF extra-feature PE "
                         "(1 for 'ind' — the MoCo-Flow configs; 3 for 'dir')")
    ap.add_argument("--nof_in_channels_xyz", type=int, default=33,
                    help="NoF xyz PE width (fw_NoF.in_channels_xyz in the "
                         "stage config; 33 in every shipped config)")
    ap.add_argument("--config", default=None,
                    help="stage config YAML — reads fw_NoF/bw_NoF "
                         "in_channels_xyz and the NeRF extra_feat_type "
                         "instead of the two flags above")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.config:
        vars(args).update(config_channels(args.config))

    if args.reverse:
        tree, extra = load_checkpoint(args.src)
        save_dict, skipped = reverse_checkpoint(
            tree, extra, args.extra_pe_channels, args.nof_in_channels_xyz)
        dst = args.dst if args.dst.endswith(".pth") else args.dst + ".pth"
        torch.save(save_dict, dst)
        nets = ", ".join(sorted(k for k in save_dict if k.endswith("_net")))
        print(f"converted [{nets}] + clock -> {dst}")
    else:
        # a reference checkpoint holds its clock and optimizer state as
        # Python objects; the file is the user's own, as in the reference
        ckpt = torch.load(args.src, map_location="cpu", weights_only=False)
        tree, extra, skipped = convert_checkpoint(
            ckpt, args.extra_pe_channels, args.nof_in_channels_xyz)
        save_checkpoint(args.dst, tree, extra=extra)
        nets = ", ".join(sorted(tree["params"]))
        print(f"converted [{nets}] + clock -> {args.dst}.npz")
    if skipped:
        print(f"skipped (framework-specific, re-initialized on load): "
              f"{', '.join(sorted(skipped))}")


if __name__ == "__main__":
    main()
