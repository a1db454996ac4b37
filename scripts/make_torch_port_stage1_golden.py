#!/usr/bin/env python
"""Write tests/fixtures/torch_port_stage1_golden.npz: stage-1 (canonical
NeRF) training steps and a val step of the JAX package at small widths, for
checking the PyTorch port's stage 1 where JAX is not installed.

The JAX ``NeRFTrainer`` is built on a one-device mesh from
``stage1_config``: ``init_nerf.yaml``'s model narrowed to NeRF 4x32 (skip
2, ``N_freqs: 0`` positions padded to 15 inputs, a ``dir`` extra of 27),
softplus, 32 rays x (8 + 8) samples, ``mlp_impl: pallas`` (its Pallas
kernels run interpreted on the CPU), fp32, ``radam`` with ``steplr``, the
background ``rand``; on the 32x32 synthetic scene of 2 frames, with
sharpened sigma heads. It takes three steps from step 0 and then a val
step. The fixture holds the config (JSON), the parameters before the steps,
after the second and after the third, the optimizer state after the second
(``opt_named``, the checkpointed form), the scene's frame table, direction
grid, images and background, each step's random draws (recomputed from the
step keys as the JAX step derives them), JAX's ``img_loss`` and
``train_psnr`` per step, and the val metrics. ``chip_smoke.py`` replays it
on a GPU; ``tests/test_torch_stage1.py`` checks that it still matches the
JAX package and that the port's plain path replays it.

    JAX_PLATFORMS=cpu python scripts/make_torch_port_stage1_golden.py [--out PATH]
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import os.path as osp
import sys
import tempfile

import numpy as np

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIXTURE = osp.join(ROOT, "tests", "fixtures", "torch_port_stage1_golden.npz")
N_STEPS = 3
CKPT_AFTER = 2      # the checkpointed state: after the second step
SCENE = {"n_frames": 2, "size": 32, "focal": 40.0}
SIGMA_SCALE, SIGMA_BIAS = 10.0, 0.3


def stage1_config(root: str | None, save_dir: str) -> dict:
    """configs/people_snapshot/male-3-casual/init_nerf.yaml narrowed to
    fixture size, on the per-op route (mlp_impl: pallas)."""
    nerf = {"type": "NeRF", "D": 4, "W": 32, "in_channels_xyz": 15,
            "skips": [2], "extra_feat_type": "dir", "extra_feat_dim": 27}
    return {
        "save_dir": save_dir, "exp_name": "init_nerf_tiny",
        "dataloader": {"type": "moco_flow", "root_dir": root,
                       "imgs_dir": "images", "size": [32, 32],
                       "val_size": [32, 32],
                       "aabb": [[1.2, 1.2, 1.2], [0, 0, 0]], "bkgd": "rand",
                       "interval": 1},
        "model": {
            "type": "nerf", "pretrained_path": None, "N_rand": 32,
            "chunk": 2048, "N_samples": 8, "N_importance": 8,
            "use_disp": False, "perturb": 1.0, "noise_std": 0.0,
            "nerf_activate_type": "softplus", "compute_dtype": "float32",
            "mlp_impl": "pallas",
            "nerf_embedding_xyz": {"type": "Embedding", "in_channels": 3,
                                   "N_freqs": 0, "logscale": True},
            "nerf_embedding_dir": {"type": "Embedding", "in_channels": 3,
                                   "N_freqs": 4, "logscale": True},
            "nerf_embedding_ind": None,
            "coarse_NeRF": nerf, "fine_NeRF": dict(nerf)},
        "loss": {"type": "MSE"},
        "optimizer": {"type": "radam", "lr": 1e-3, "weight_decay": 0},
        "scheduler": {"type": "steplr", "decay_step": [100000],
                      "decay_gamma": 0.5},
        "trainer": {"num_iters": N_STEPS, "val_every_n_step": 0,
                    "save_every_n_step": 0, "log_freq": 50},
    }


def jax_draws(seed: int, step: int, table, n_rand: int, n_samples: int,
              n_importance: int) -> dict:
    """The random inputs of one JAX stage-1 step, derived from its key
    exactly as ``NeRFTrainer.build_steps`` and ``render_rays`` derive them
    (one device)."""
    import jax
    key = jax.random.fold_in(jax.random.key(seed), step)
    k_f, k_r, k_render = jax.random.split(key, 3)
    num_frames = int(table.valid_count.shape[0])
    frame = int(jax.random.randint(k_f, (), 0, num_frames))
    k_pix, k_bg = jax.random.split(k_r)
    k_perturb, _, k_pdf, _ = jax.random.split(k_render, 4)
    return {
        "frame": np.int64(frame),
        "pixels": np.asarray(jax.random.randint(
            k_pix, (n_rand,), 0, table.valid_count[frame]), np.int64),
        "background": np.asarray(jax.random.uniform(k_bg, (1, 3))),
        "perturb": np.asarray(jax.random.uniform(k_perturb,
                                                 (n_rand, n_samples))),
        "pdf": np.asarray(jax.random.uniform(k_pdf, (n_rand, n_importance))),
    }


def jax_trainer(cfg: dict, smpl):
    """The JAX ``NeRFTrainer`` of ``cfg`` on one device, sigma heads
    sharpened: a freshly drawn NeRF is empty or dense everywhere; this one
    stops some rays and lets others through."""
    import jax.numpy as jnp
    from moco_flow_tpu.parallel.mesh import make_mesh
    from moco_flow_tpu.train import get_trainer
    from moco_flow_tpu.utils.config import Config
    jt = get_trainer(Config(copy.deepcopy(cfg), mode="train"),
                     smpl_data=smpl, mesh=make_mesh(1))
    params = dict(jt.params)
    for net in ("coarse_NeRF", "fine_NeRF"):
        head = params[net]["sigma"]
        params[net] = dict(params[net], sigma={
            "w": head["w"] * SIGMA_SCALE,
            "b": jnp.full_like(head["b"], SIGMA_BIAS)})
    jt.params = params
    return jt


def golden_arrays() -> dict:
    """Everything the fixture holds, computed with the JAX package."""
    from moco_flow_tpu.data.synthetic import make_synthetic_scene
    from moco_flow_tpu.train.checkpoint import _flatten

    tmp = tempfile.mkdtemp()
    root = osp.join(tmp, "scene")
    smpl = make_synthetic_scene(root, **SCENE)
    cfg = stage1_config(root, osp.join(tmp, "log"))
    jt = jax_trainer(cfg, smpl)
    ds = jt.train_dataset
    # the config without this run's temporary paths (a replay reads the
    # frame table from the fixture and the val frames from the port's
    # in-memory scene)
    out = {"config_json": np.asarray(json.dumps(stage1_config("scene",
                                                              "log")))}
    out.update({f"params0/{k}": np.array(v)
                for k, v in _flatten(jt.params).items()})
    for name in ("c2w", "near", "far", "norm_idx", "valid_idx",
                 "valid_count"):
        out[f"table/{name}"] = np.asarray(getattr(ds.table, name))
    out["directions"] = np.asarray(ds.directions_flat)
    out["images"] = np.asarray(ds.images)
    out["bkgd_img"] = np.asarray(ds.bkgd_img)
    out["rand_bkgd"] = np.asarray(ds.rand_bkgd)
    m = cfg["model"]
    for i in range(N_STEPS):
        draws = jax_draws(0, jt.clock.step, ds.table, m["N_rand"],
                          m["N_samples"], m["N_importance"])
        out.update({f"draws/{i}/{k}": v for k, v in draws.items()})
        metrics = jt.train_step()
        out.update({f"metrics/{i}/{k}": np.asarray(v, np.float32)
                    for k, v in metrics.items()})
        jt.clock.tick()
        if i + 1 == CKPT_AFTER:
            out.update({f"opt{CKPT_AFTER}/{k}": np.asarray(v) for k, v in
                        jt._opt_named_leaves(jt.opt_state).items()})
            out.update({f"params{CKPT_AFTER}/{k}": np.array(v)
                        for k, v in _flatten(jt.params).items()})
    out.update({f"params{N_STEPS}/{k}": np.array(v)
                for k, v in _flatten(jt.params).items()})
    out.update({f"val/{k}": np.asarray(v, np.float32)
                for k, v in jt.val_step().items()})
    return out


def load(path: str = FIXTURE) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def prefixed(arrs: dict, prefix: str) -> dict:
    """The arrays under ``prefix/`` as {rest: array}."""
    return {k[len(prefix) + 1:]: v for k, v in arrs.items()
            if k.startswith(prefix + "/")}


def port_draws(arrs: dict, i: int):
    """The fixture's draws of step ``i`` as a port ``Draws``."""
    import torch
    from moco_flow_tpu_torch.data.draws import Draws
    d = {k: torch.from_numpy(np.asarray(v))
         for k, v in prefixed(arrs, f"draws/{i}").items()}
    return Draws(frame=int(d["frame"]), pixels=d["pixels"].long(),
                 background=d["background"], chained=None,
                 perturb=d["perturb"], pdf=d["pdf"])


def port_trainer(arrs: dict, device, scene=None):
    """The port's ``NeRFTrainer`` on the fixture's data at step 0 with the
    initial parameters; with ``scene`` (the port's in-memory synthetic
    scene) also its val dataset."""
    import torch
    from moco_flow_tpu_torch.data.dataset import FrameTable
    from moco_flow_tpu_torch.train.checkpoint import (_unflatten,
                                                      params_from_jax)
    from moco_flow_tpu_torch.train.stage_nerf import NeRFTrainer
    cfg = json.loads(str(arrs["config_json"]))
    tr = NeRFTrainer(cfg, device=device, scene=scene)
    tr.build_model(cfg["model"])
    if scene is not None:
        tr.prepare_dataloader(cfg["dataloader"])
    table = FrameTable(**{k: torch.from_numpy(arrs[f"table/{k}"])
                          for k in ("c2w", "near", "far", "norm_idx")},
                       valid_idx=torch.from_numpy(
                           arrs["table/valid_idx"]).long(),
                       valid_count=torch.from_numpy(
                           arrs["table/valid_count"]).long())
    tr.set_train_data(table, torch.from_numpy(arrs["directions"]),
                      torch.from_numpy(arrs["images"]),
                      torch.from_numpy(arrs["bkgd_img"]),
                      bool(arrs["rand_bkgd"]))
    tr.configure_optimizers(cfg["optimizer"], cfg.get("scheduler"))
    tr.params = params_from_jax(_unflatten(prefixed(arrs, "params0")),
                                device)
    return tr


def port_replay(arrs: dict, device, scene=None, steps: int = N_STEPS):
    """The fixture's first ``steps`` steps through the port with its draws,
    then (with ``scene``) the val step: ``([metrics {name: float} per
    step], val metrics or None, trainer)``. Imports only the port."""
    tr = port_trainer(arrs, device, scene)
    metrics = []
    for i in range(steps):
        m = tr.train_step(draws=port_draws(arrs, i))
        metrics.append({k: float(v) for k, v in m.items()})
        tr.clock.tick()
    return metrics, None if scene is None else tr.val_step(), tr


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=FIXTURE)
    args = p.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    arrs = golden_arrays()
    os.makedirs(osp.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **arrs)
    print(f"wrote {args.out} ({osp.getsize(args.out)} bytes, "
          f"{len(arrs)} arrays)")


if __name__ == "__main__":
    main()
