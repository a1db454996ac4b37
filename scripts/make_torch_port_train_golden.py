#!/usr/bin/env python
"""Write tests/fixtures/torch_port_train_golden.npz: two stage-3 training
steps of the JAX package at small widths, for checking the PyTorch port's
training step where JAX is not installed.

The JAX ``MoCoFlowTrainer`` is built on a one-device mesh with
``mlp_impl: fused`` (its Pallas kernels run interpreted on the CPU) from
``__graft_entry__._tiny_moco_config`` with narrowed widths (NeRF 4x32,
NoF 4x32, 32 rays x (8 + 8) samples), on the 32x32 synthetic scene of
2 frames, with its clock at step 6000: the ``none`` phase of the
NoF-supervision schedule, where the step runs the NeRF and warp-chain
kernels only. The fixture holds the config (JSON), the parameters before
the steps, the scene's frame table, direction grid, images and background,
each step's random draws (recomputed from the step keys as the JAX step
derives them), and JAX's loss terms, ``train_psnr`` and parameters after
each step, and the parameters after the last. ``chip_smoke.py`` replays
the two steps through the port on a GPU and compares; ``tests/test_torch_train_step.py`` checks that the file
still matches the JAX package and that the port's plain path replays it.

    JAX_PLATFORMS=cpu python scripts/make_torch_port_train_golden.py [--out PATH]
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
FIXTURE = osp.join(ROOT, "tests", "fixtures", "torch_port_train_golden.npz")
STEP = 6000        # (6000 // 1000) % 10 = 6: the 'none' phase
N_STEPS = 2
SCENE = {"n_frames": 2, "size": 32, "focal": 40.0}
SIGMA_SCALE, SIGMA_BIAS = 10.0, 0.3


def train_config(root: str | None, save_dir: str) -> dict:
    """``_tiny_moco_config`` narrowed to fixture size."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from __graft_entry__ import _tiny_moco_config
    cfg = _tiny_moco_config(root, save_dir)
    m = cfg["model"]
    m["mlp_impl"] = "fused"
    m["nerf_embedding_xyz"]["N_freqs"] = 4
    m["nof_embedding_xyz"]["N_freqs"] = 3
    for k in ("coarse_NeRF", "fine_NeRF"):
        m[k] = dict(m[k], D=4, W=32, skips=[2], in_channels_xyz=27)
    for k in ("fw_NoF", "bw_NoF"):
        m[k] = dict(m[k], D=4, W=32, in_channels_xyz=21)
    cfg["trainer"]["num_iters"] = STEP + N_STEPS
    return cfg


def jax_draws(seed: int, step: int, table, n_rand: int, n_samples: int,
              n_importance: int) -> dict:
    """The random inputs of one JAX training step, derived from its key
    exactly as ``_make_step_variant`` and ``render_rays`` derive them
    (``frame_sampling: uniform``, one device)."""
    import jax
    key = jax.random.fold_in(jax.random.key(seed), step)
    k_f, k_r, k_chain, _, k_render = jax.random.split(key, 5)
    num_frames = int(table.valid_count.shape[0])
    frame = int(jax.random.randint(k_f, (), 0, num_frames))
    k_pix, k_bg = jax.random.split(k_r)
    count = table.valid_count[frame]
    k_perturb, _, k_pdf, _ = jax.random.split(k_render, 4)
    return {
        "frame": np.int64(frame),
        "pixels": np.asarray(jax.random.randint(k_pix, (n_rand,), 0, count),
                             np.int64),
        "background": np.asarray(jax.random.uniform(k_bg, (1, 3))),
        "chained": np.int64(jax.random.randint(k_chain, (), 0, num_frames)),
        "perturb": np.asarray(jax.random.uniform(k_perturb,
                                                 (n_rand, n_samples))),
        "pdf": np.asarray(jax.random.uniform(k_pdf, (n_rand, n_importance))),
    }


def sharpen(params: dict) -> dict:
    """Sharpened sigma heads: a freshly drawn NeRF is empty or dense
    everywhere; this one stops some rays and lets others through, so the
    consensus masks and the compositing weights are not trivial."""
    import jax.numpy as jnp
    out = dict(params)
    for net in ("coarse_NeRF", "fine_NeRF"):
        head = params[net]["sigma"]
        out[net] = dict(params[net], sigma={
            "w": head["w"] * SIGMA_SCALE,
            "b": jnp.full_like(head["b"], SIGMA_BIAS)})
    return out


def golden_arrays() -> dict:
    """Everything the fixture holds, computed with the JAX package."""
    from moco_flow_tpu.data.synthetic import make_synthetic_scene
    from moco_flow_tpu.parallel.mesh import make_mesh
    from moco_flow_tpu.train import get_trainer
    from moco_flow_tpu.train.checkpoint import _flatten
    from moco_flow_tpu.utils.config import Config

    tmp = tempfile.mkdtemp()
    root = osp.join(tmp, "scene")
    smpl = make_synthetic_scene(root, **SCENE)
    cfg = train_config(root, osp.join(tmp, "log"))
    jt = get_trainer(Config(copy.deepcopy(cfg), mode="train"),
                     smpl_data=smpl, mesh=make_mesh(1))
    jt.params = sharpen(jt.params)
    jt.clock.step = STEP
    ds = jt.train_dataset
    # the config without this run's temporary paths (the replay reads the
    # frame table from the fixture, never the scene's files)
    out = {"config_json": np.asarray(json.dumps(train_config("scene",
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
                    for k, v in metrics.items() if k != "state/nerf"})
        jt.clock.tick()
    out.update({f"params{N_STEPS}/{k}": np.array(v)
                for k, v in _flatten(jt.params).items()})
    return out


def port_replay(arrs: dict, device) -> list:
    """The fixture's steps through the port's trainer on ``device``, with
    the fixture's draws: ``([metrics {name: float} per step], params
    {path: numpy} after the last step)``. Imports only the port (no JAX)."""
    import torch
    from moco_flow_tpu_torch.data.dataset import FrameTable
    from moco_flow_tpu_torch.data.draws import Draws
    from moco_flow_tpu_torch.train.checkpoint import (
        _flatten, _unflatten, params_from_jax)
    from moco_flow_tpu_torch.train.stage_mocoflow import MoCoFlowTrainer

    cfg = json.loads(str(arrs["config_json"]))
    tr = MoCoFlowTrainer(cfg, device=device)
    tr.build_model(cfg["model"])
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
    tr.params = params_from_jax(_unflatten(
        {k[len("params0/"):]: v for k, v in arrs.items()
         if k.startswith("params0/")}), device)
    tr.clock.step = STEP
    out = []
    for i in range(N_STEPS):
        d = {k.split("/")[-1]: v for k, v in arrs.items()
             if k.startswith(f"draws/{i}/")}
        draws = Draws(frame=int(d["frame"]),
                      pixels=torch.from_numpy(d["pixels"]).long(),
                      background=torch.from_numpy(d["background"]),
                      chained=int(d["chained"]),
                      perturb=torch.from_numpy(d["perturb"]),
                      pdf=torch.from_numpy(d["pdf"]))
        metrics = tr.train_step(draws=draws)
        out.append({k: float(v) for k, v in metrics.items()})
        tr.clock.tick()
    return out, _flatten(tr.params)


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
