"""Checkpoints in the JAX package's format, and the bridge between the two
packages' parameters.

Port of ``moco_flow_tpu/train/checkpoint.py``: one ``.npz`` of '/'-flattened
tree paths (``coarse_NeRF/trunk/0/w``) plus a JSON sidecar of non-array
state, written atomically. A checkpoint written by either package loads in
the other. ``params_from_jax`` / ``params_to_jax`` move a parameter tree
between numpy (what the JAX package saves and accepts) and tensors.
``transfer_pretrained_nerf`` / ``transfer_pretrained_nof`` hand the stage-1
and stage-2 finals to stage 3.
"""

from __future__ import annotations

import glob
import json
import os
import re

import numpy as np
import torch

from ..nn.nerf import SIGMA_BRANCH


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _flatten(tree, prefix="", leaf=_to_numpy) -> dict:
    """Nested dicts/lists -> {'a/0/b': leaf(value)}."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/", leaf))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/", leaf))
    else:
        out[prefix[:-1]] = leaf(tree)
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(re.fullmatch(r"\d+", k) for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def _map_leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(v, fn) for v in tree]
    return fn(tree)


def params_from_jax(tree, device: torch.device | str = "cpu") -> dict:
    """A JAX parameter pytree (numpy or JAX arrays) -> the same tree of
    tensors on ``device`` (float arrays as float32)."""
    def conv(a):
        t = torch.from_numpy(np.array(a))
        return (t.float() if t.is_floating_point() else t).to(device)
    return _map_leaves(tree, conv)


def params_to_jax(params) -> dict:
    """Inverse of :func:`params_from_jax`: the tree of numpy arrays the JAX
    package takes (``jnp.asarray`` each leaf, or pass it to its
    ``save_checkpoint``)."""
    return _map_leaves(params, _to_numpy)


def save_checkpoint(path: str, tree, extra: dict | None = None) -> None:
    """Atomically write ``tree`` (tensors or arrays) + ``extra`` (JSON-able)
    as ``path.npz`` + ``path.json``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(tree)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path + ".npz")
    if extra is not None:
        with open(path + ".json.tmp", "w") as f:
            json.dump(extra, f)
        os.replace(path + ".json.tmp", path + ".json")


def load_checkpoint(path: str):
    """-> (tree of numpy arrays, extra dict)."""
    if path.endswith(".npz"):
        path = path[:-4]
    with np.load(path + ".npz") as data:
        tree = _unflatten({k: data[k] for k in data.files})
    extra = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            extra = json.load(f)
    return tree, extra


def merge_into(params, loaded, strict: bool = False):
    """Overlay ``loaded`` onto the tensor tree ``params`` where paths and
    shapes match (the reference's ``strict=False`` load); a loaded leaf takes
    the device and dtype of the tensor it replaces."""
    flat_p = _flatten(params, leaf=lambda t: t)
    flat_l = _flatten(loaded)
    out = {}
    for k, cur in flat_p.items():
        if k in flat_l and tuple(flat_l[k].shape) == tuple(cur.shape):
            out[k] = torch.from_numpy(np.array(flat_l[k])).to(cur.device,
                                                              cur.dtype)
        else:
            if strict and k not in flat_l:
                raise KeyError(f"checkpoint missing {k}")
            out[k] = cur
    return _unflatten(out)


def ckpt_step(path: str) -> int:
    """Step of a checkpoint: from the ``_iterN`` name, else the sidecar."""
    m = re.search(r"_iter(\d+)", os.path.basename(path))
    if m:
        return int(m.group(1))
    try:
        with open(path + ".json") as f:
            return int(json.load(f).get("clock", {}).get("step", -1))
    except (OSError, ValueError):
        return -1


def find_latest_checkpoint(pattern: str) -> str | None:
    """Newest checkpoint by iteration under a glob like
    ``save_dir/exp_name/*/ckpts/*.npz``."""
    candidates = [p[:-4] for p in glob.glob(pattern) if p.endswith(".npz")]
    candidates = [p for p in candidates if ckpt_step(p) >= 0]
    if not candidates:
        return None
    return max(candidates, key=ckpt_step)


# -- the stage hand-over -----------------------------------------------------

def _onto(cur, loaded, path: str):
    """``loaded`` (a tree of arrays) as tensors on the device and dtype of
    the tensor tree ``cur``, whose shapes it must have."""
    flat_c = _flatten(cur, leaf=lambda t: t)
    flat_l = _flatten(loaded)
    if set(flat_c) != set(flat_l):
        raise KeyError(f"{path}: the checkpoint holds {sorted(flat_l)}, the "
                       f"model {sorted(flat_c)}")
    out = {}
    for k, t in flat_c.items():
        if tuple(flat_l[k].shape) != tuple(t.shape):
            raise ValueError(f"{path}/{k}: checkpoint shape "
                             f"{tuple(flat_l[k].shape)}, model "
                             f"{tuple(t.shape)}")
        out[k] = torch.from_numpy(np.array(flat_l[k])).to(t.device, t.dtype)
    return _unflatten(out)


def transfer_pretrained_nerf(params: dict, ckpt_tree: dict) -> dict:
    """The stage-1 checkpoint's *fine* NeRF sigma branch (trunk, sigma head,
    ``final``) into both stage-3 NeRFs; ``extra`` / ``rgb`` keep their fresh
    init, and so does a ``hash`` table (JAX's code moves only these three,
    whatever its docstring says), which stays trainable."""
    src = ckpt_tree.get("params", ckpt_tree).get("fine_NeRF")
    if src is None:
        raise KeyError("checkpoint has no fine_NeRF parameters")
    out = dict(params)
    for name in ("coarse_NeRF", "fine_NeRF"):
        if name in out:
            tgt = dict(out[name])
            for k in SIGMA_BRANCH:
                tgt[k] = _onto(tgt[k], src[k], f"{name}/{k}")
            out[name] = tgt
    return out


def transfer_pretrained_nof(params: dict, ckpt_tree: dict) -> dict:
    """``bw_NoF`` / ``fw_NoF`` of a stage-2 checkpoint, where the stage-3
    model has them."""
    src = ckpt_tree.get("params", ckpt_tree)
    out = dict(params)
    for name in ("bw_NoF", "fw_NoF"):
        if name in out and name in src:
            out[name] = _onto(out[name], src[name], name)
    return out
