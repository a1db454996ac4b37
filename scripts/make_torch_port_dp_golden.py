#!/usr/bin/env python
"""Write tests/fixtures/torch_port_dp_golden.npz: data-parallel training
steps of the JAX package on a two-device mesh (``make_mesh(2)``), in all
three stages at small widths, for checking the PyTorch port's data
parallelism where JAX is not installed.

Each stage's JAX trainer is the one of its single-device fixture, built on
``make_mesh(2)`` of the CPU's devices (run with
``--xla_force_host_platform_device_count=2`` or more):

- ``s3``: the ``MoCoFlowTrainer`` of ``make_torch_port_train_golden.py``
  (``mlp_impl: fused``, NeRF 4x32, NoF 4x32, both chains, 32 rays x (8 +
  8) samples, ``N_sampled`` 64, c2f start 5000, sharpened sigma heads), two
  ``full`` steps from step 4996 (the density frozen, the ``nof``
  optimizer's second update on the same gradients);
- ``s1``: the ``NeRFTrainer`` of ``make_torch_port_stage1_golden.py``
  (``mlp_impl: pallas``, radam), one step from step 0;
- ``s2``: the ``NoFTrainer`` of ``make_torch_port_stage2_golden.py``
  (adam), two steps from step 0.

The clock ticks by the world (2) a step, as JAX's loop does. Each rank's
draws are recomputed from ``fold_in(fold_in(key(seed), step), rank)``, as
``fold_key_if`` folds the chip's index into the step key. Held per stage:
the config (JSON), the data the step reads (frame table, directions,
images, background, correspondence table), the parameters before the
steps, each rank's draws, JAX's loss terms (the mean over the chips) per
step and the parameters after the steps.
``tests/test_torch_dp.py`` replays them on two gloo ranks on the CPU and
``chip_smoke.py`` on two ranks on one card.

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=2 \\
        python scripts/make_torch_port_dp_golden.py [--out PATH]
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
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from scripts import make_torch_port_stage1_golden as g1  # noqa: E402
from scripts import make_torch_port_stage2_golden as g2  # noqa: E402
from scripts.make_torch_port_phases_golden import (  # noqa: E402
    unflatten_prefix)
from scripts.make_torch_port_train_golden import (  # noqa: E402
    SCENE, sharpen, train_config)

FIXTURE = osp.join(ROOT, "tests", "fixtures", "torch_port_dp_golden.npz")
WORLD = 2
# stage -> (first step, steps)
RUNS = {"s3": (4996, 2), "s1": (0, 1), "s2": (0, 2)}


def rank_key(seed: int, step: int, rank: int):
    """The key of ``rank``'s step under ``dp_jit``: the step key with the
    chip's index folded in (``fold_key_if``)."""
    import jax
    return jax.random.fold_in(
        jax.random.fold_in(jax.random.key(seed), step), rank)


def _ray_draws(k_f, k_r, k_render, table, n_rand: int, n_samples: int,
               n_importance: int) -> dict:
    import jax
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


def s3_draws(seed: int, step: int, rank: int, table, m: dict,
             num_verts: int) -> dict:
    """A rank's draws of a stage-3 step (``_make_step_variant``'s five
    splits, ``sample_correspondences``' three)."""
    import jax
    k_f, k_r, k_chain, k_corr, k_render = jax.random.split(
        rank_key(seed, step, rank), 5)
    out = _ray_draws(k_f, k_r, k_render, table, m["N_rand"], m["N_samples"],
                     m["N_importance"])
    out["chained"] = np.int64(jax.random.randint(
        k_chain, (), 0, int(table.valid_count.shape[0])))
    k_cube, k_vert, k_noise = jax.random.split(k_corr, 3)
    n = m["N_sampled"]
    out.update({
        "cube": np.asarray(jax.random.uniform(k_cube, (n, 3), minval=-1.5,
                                              maxval=1.5)),
        "pick": np.asarray(jax.random.randint(k_vert, (n,), 0, num_verts),
                           np.int64),
        "noise": np.asarray(jax.random.normal(k_noise, (n, 3)))})
    return out


def s1_draws(seed: int, step: int, rank: int, table, m: dict) -> dict:
    """A rank's draws of a stage-1 step (``NeRFTrainer``'s three splits)."""
    import jax
    k_f, k_r, k_render = jax.random.split(rank_key(seed, step, rank), 3)
    return _ray_draws(k_f, k_r, k_render, table, m["N_rand"],
                      m["N_samples"], m["N_importance"])


def s2_draws(seed: int, step: int, rank: int, num_frames: int, n: int,
             num_verts: int) -> dict:
    """A rank's draws of a stage-2 step (``NoFTrainer``'s two splits)."""
    import jax
    k_f, k_c = jax.random.split(rank_key(seed, step, rank))
    frame = int(jax.random.randint(k_f, (), 0, num_frames))
    return {"frame": np.int64(frame), **g2._points(k_c, n, num_verts)}


def _data(out: dict, pre: str, ds, corr=None):
    for name in ("c2w", "near", "far", "norm_idx", "valid_idx",
                 "valid_count"):
        out[f"{pre}/table/{name}"] = np.asarray(getattr(ds.table, name))
    if getattr(ds, "images", None) is not None:
        out[f"{pre}/directions"] = np.asarray(ds.directions_flat)
        out[f"{pre}/images"] = np.asarray(ds.images)
        out[f"{pre}/bkgd_img"] = np.asarray(ds.bkgd_img)
        out[f"{pre}/rand_bkgd"] = np.asarray(ds.rand_bkgd)
    if corr is not None:
        out[f"{pre}/corr/verts"] = np.asarray(corr.verts)
        out[f"{pre}/corr/src_to_cano"] = np.asarray(corr.src_to_cano)


def _run(out: dict, pre: str, jt, draws_of):
    """The stage's steps on the mesh: each rank's draws, the metrics and
    the parameters after the steps."""
    from moco_flow_tpu.train.checkpoint import _flatten
    start, n_steps = RUNS[pre]
    jt.clock.step = start
    out.update({f"{pre}/params0/{k}": np.array(v)
                for k, v in _flatten(jt.params).items()})
    for i in range(n_steps):
        for r in range(WORLD):
            out.update({f"{pre}/draws/{r}/{i}/{k}": v
                        for k, v in draws_of(jt.clock.step, r).items()})
        out.update({f"{pre}/metrics/{i}/{k}": np.asarray(v, np.float32)
                    for k, v in jt.train_step().items()
                    if k != "state/nerf"})
        jt.clock.tick(WORLD)
    out.update({f"{pre}/params{n_steps}/{k}": np.array(v)
                for k, v in _flatten(jt.params).items()})


def golden_arrays() -> dict:
    """Everything the fixture holds, computed with the JAX package."""
    from moco_flow_tpu.data.synthetic import make_synthetic_scene
    from moco_flow_tpu.parallel.mesh import make_mesh
    from moco_flow_tpu.train import get_trainer
    from moco_flow_tpu.utils.config import Config

    tmp = tempfile.mkdtemp()
    root = osp.join(tmp, "scene")
    smpl = make_synthetic_scene(root, **SCENE)
    out = {"world": np.asarray(WORLD)}

    cfg = train_config(root, osp.join(tmp, "log3"))
    jt = get_trainer(Config(copy.deepcopy(cfg), mode="train"),
                     smpl_data=smpl, mesh=make_mesh(WORLD))
    assert jt.world_size == WORLD
    jt.params = sharpen(jt.params)
    ds, corr = jt.train_dataset, jt.train_dataset.correspondence_table
    out["s3/config_json"] = np.asarray(json.dumps(train_config("scene",
                                                               "log")))
    _data(out, "s3", ds, corr)
    nv = int(corr.verts.shape[1])
    _run(out, "s3", jt, lambda step, r: s3_draws(0, step, r, ds.table,
                                                 cfg["model"], nv))

    cfg = g1.stage1_config(root, osp.join(tmp, "log1"))
    jt = get_trainer(Config(copy.deepcopy(cfg), mode="train"),
                     smpl_data=smpl, mesh=make_mesh(WORLD))
    jt.params = sharpen(jt.params)
    ds = jt.train_dataset
    out["s1/config_json"] = np.asarray(json.dumps(g1.stage1_config(
        "scene", "log")))
    _data(out, "s1", ds)
    _run(out, "s1", jt, lambda step, r: s1_draws(0, step, r, ds.table,
                                                 cfg["model"]))

    cfg = g2.stage2_config(root, osp.join(tmp, "log2"))
    jt = get_trainer(Config(copy.deepcopy(cfg), mode="train"),
                     smpl_data=smpl, mesh=make_mesh(WORLD))
    ds, corr = jt.train_dataset, jt.train_dataset.correspondence_table
    out["s2/config_json"] = np.asarray(json.dumps(g2.stage2_config(
        "scene", "log")))
    _data(out, "s2", ds, corr)
    nv, n = int(corr.verts.shape[1]), cfg["model"]["N_sampled"]
    _run(out, "s2", jt, lambda step, r: s2_draws(0, step, r, ds.num_frames,
                                                 n, nv))
    return out


def load(path: str = FIXTURE) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


# -- replays through the port (no JAX) ----------------------------------------

def _draws(d: dict):
    """Drawn arrays as the port's ``Draws`` (the correspondence draws where
    the stage-3 step has them)."""
    import torch
    from moco_flow_tpu_torch.data.draws import Draws
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    corr = {k: t.get(k) for k in ("cube", "pick", "noise")}
    if corr["pick"] is not None:
        corr["pick"] = corr["pick"].long()
    return Draws(frame=int(t["frame"]), pixels=t["pixels"].long(),
                 background=t["background"],
                 chained=int(t["chained"]) if "chained" in t else None,
                 perturb=t["perturb"], pdf=t["pdf"], **corr)


def port_trainer(arrs: dict, stage: str, device):
    """The port's trainer of ``stage`` on the fixture's data at the run's
    first step, with the initial parameters and fresh optimizers (each
    stage's single-device fixture builds it); in a process group it takes
    the group's world and rank."""
    from scripts import make_torch_port_phases_golden as gp
    sub = unflatten_prefix(arrs, stage)
    start = RUNS[stage][0]
    if stage == "s3":
        tr = gp.port_trainer(sub, device, start, False)
    elif stage == "s1":
        tr = g1.port_trainer(sub, device)
    else:
        tr = g2.port_stage2_trainer(sub, device)
    tr.clock.step = start
    return tr


def rank_draws(arrs: dict, stage: str, rank: int, i: int):
    """Rank ``rank``'s draws of step ``i`` of ``stage`` as the port's
    ``Draws`` / ``PointDraws``."""
    pre = f"{stage}/draws/{rank}/{i}"
    if stage == "s2":
        return g2.port_points(arrs, pre)
    return _draws(unflatten_prefix(arrs, pre))


def port_run(arrs: dict, stage: str, rank: int, device):
    """The stage's steps through the port on this rank with its draws
    (the process group's world, or world 1 outside one):
    ``([metrics {name: float} per step], params {path: numpy} after the
    steps)``. Imports only the port."""
    from moco_flow_tpu_torch.train.checkpoint import _flatten
    tr = port_trainer(arrs, stage, device)
    metrics = []
    for i in range(RUNS[stage][1]):
        m = tr.train_step(draws=rank_draws(arrs, stage, rank, i))
        metrics.append({k: float(v) for k, v in m.items()})
        tr.clock.tick(tr.world_size)
    return metrics, _flatten(tr.params)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=FIXTURE)
    args = p.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={WORLD}").strip()
    arrs = golden_arrays()
    os.makedirs(osp.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **arrs)
    print(f"wrote {args.out} ({osp.getsize(args.out)} bytes, "
          f"{len(arrs)} arrays)")


if __name__ == "__main__":
    main()
