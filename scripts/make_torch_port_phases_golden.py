#!/usr/bin/env python
"""Write tests/fixtures/torch_port_phases_golden.npz: the stage-3 training
step of the JAX package in its ``full`` / ``none`` + freeze / ``msk``
variants and one val step, at small widths, for checking the PyTorch port
where JAX is not installed.

The JAX ``MoCoFlowTrainer`` is the one of
``scripts/make_torch_port_train_golden.py`` (``mlp_impl: fused``, NeRF 4x32,
NoF 4x32, 32 rays x (8 + 8) samples, N_sampled 64, c2f start 5000, the
32x32 synthetic scene of 2 frames, sharpened sigma heads). Runs:

- ``full``: from the initial parameters at step 4998 with fresh optimizer
  state, steps 4998 and 4999 (``full``, density frozen, both optimizers),
  a checkpoint (parameters and ``opt_named``, both optimizers), then step
  5000 (``none`` with the density still frozen; the ``nof`` optimizer is
  deleted);
- ``msk``: from the initial parameters at step 10000 with the ``nof``
  optimizer deleted, steps 10000 and 10001;
- ``val``: the val step at the clock and parameters the ``msk`` run ends
  with.

The fixture holds the config (JSON), the initial parameters, the frame
table, directions, images and background, the correspondence table
(posed vertices and src -> canonical chains), each step's draws (recomputed
from the step keys as the JAX step derives them, the correspondence draws
from ``k_corr``'s three splits) and the correspondences they give, JAX's
loss terms and ``train_psnr`` per step, the parameters after each run's
steps, the checkpoint's ``opt_named`` state, and the val metrics.
``chip_smoke.py`` replays it on a GPU; ``tests/test_torch_train_phases.py``
checks that it still matches the JAX package and that the port's plain
path replays it.

    JAX_PLATFORMS=cpu python scripts/make_torch_port_phases_golden.py [--out PATH]
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

from scripts.make_torch_port_train_golden import (  # noqa: E402
    SCENE, jax_draws, sharpen, train_config)

FIXTURE = osp.join(ROOT, "tests", "fixtures", "torch_port_phases_golden.npz")
# run name -> (first step, steps, nof optimizer deleted at the start)
RUNS = {"full": (4998, 3, False), "msk": (10000, 2, True)}
CKPT_AFTER = 2          # the full run's checkpoint: after its 2nd step
THICKNESS = 0.2


def config() -> dict:
    return train_config("scene", "log")


def jax_corr_draws(seed: int, step: int, n_sampled: int,
                   num_verts: int) -> dict:
    """The correspondence draws of a JAX step: ``k_corr``'s three splits,
    as ``sample_correspondences`` draws them."""
    import jax
    key = jax.random.fold_in(jax.random.key(seed), step)
    k_corr = jax.random.split(key, 5)[3]
    k_cube, k_vert, k_noise = jax.random.split(k_corr, 3)
    return {
        "cube": np.asarray(jax.random.uniform(
            k_cube, (n_sampled, 3), minval=-1.5, maxval=1.5)),
        "pick": np.asarray(jax.random.randint(k_vert, (n_sampled,), 0,
                                              num_verts), np.int64),
        "noise": np.asarray(jax.random.normal(k_noise, (n_sampled, 3)))}


def golden_arrays() -> dict:
    """Everything the fixture holds, computed with the JAX package."""
    import jax
    import jax.numpy as jnp
    from moco_flow_tpu.data.correspondence import sample_correspondences
    from moco_flow_tpu.data.synthetic import make_synthetic_scene
    from moco_flow_tpu.parallel.mesh import make_mesh
    from moco_flow_tpu.train import get_trainer
    from moco_flow_tpu.train.checkpoint import _flatten
    from moco_flow_tpu.utils.config import Config

    tmp = tempfile.mkdtemp()
    root = osp.join(tmp, "scene")
    smpl = make_synthetic_scene(root, **SCENE)
    cfg = train_config(root, osp.join(tmp, "log"))

    def trainer(step, deleted):
        jt = get_trainer(Config(copy.deepcopy(cfg), mode="train"),
                         smpl_data=smpl, mesh=make_mesh(1))
        jt.params = sharpen(jt.params)
        jt.clock.step = step
        jt.nof_opt_deleted = deleted
        return jt

    jt = trainer(*RUNS["full"][::2])
    ds = jt.train_dataset
    corr_table = ds.correspondence_table
    out = {"config_json": np.asarray(json.dumps(config()))}
    out.update({f"params0/{k}": np.array(v)
                for k, v in _flatten(jt.params).items()})
    for name in ("c2w", "near", "far", "norm_idx", "valid_idx",
                 "valid_count"):
        out[f"table/{name}"] = np.asarray(getattr(ds.table, name))
    out["directions"] = np.asarray(ds.directions_flat)
    out["images"] = np.asarray(ds.images)
    out["bkgd_img"] = np.asarray(ds.bkgd_img)
    out["rand_bkgd"] = np.asarray(ds.rand_bkgd)
    out["corr/verts"] = np.asarray(corr_table.verts)
    out["corr/src_to_cano"] = np.asarray(corr_table.src_to_cano)
    m = cfg["model"]
    nv = int(corr_table.verts.shape[1])
    for run, (start, n_steps, deleted) in RUNS.items():
        if run != "full":
            jt = trainer(start, deleted)
        for i in range(n_steps):
            step = jt.clock.step
            pre = f"{run}/{i}"
            draws = jax_draws(0, step, ds.table, m["N_rand"],
                              m["N_samples"], m["N_importance"])
            draws.update(jax_corr_draws(0, step, m["N_sampled"], nv))
            out.update({f"draws/{pre}/{k}": v for k, v in draws.items()})
            key = jax.random.fold_in(jax.random.key(0), step)
            corr = sample_correspondences(
                corr_table, jnp.asarray(int(draws["frame"])),
                jax.random.split(key, 5)[3], num_sampled=m["N_sampled"],
                thickness=THICKNESS)
            out.update({f"corr/{pre}/{k}": np.asarray(v)
                        for k, v in corr.items()})
            metrics = jt.train_step()
            out.update({f"metrics/{pre}/{k}": np.asarray(v, np.float32)
                        for k, v in metrics.items() if k != "state/nerf"})
            out[f"deleted/{pre}"] = np.asarray(jt.nof_opt_deleted)
            jt.clock.tick()
            if run == "full" and i + 1 == CKPT_AFTER:
                out.update({f"ckpt_opt/{k}": np.asarray(v) for k, v in
                            jt._opt_named_leaves(jt.opt_state).items()})
                out.update({f"params_ckpt/{k}": np.array(v)
                            for k, v in _flatten(jt.params).items()})
        out.update({f"params_{run}/{k}": np.array(v)
                    for k, v in _flatten(jt.params).items()})
    out["val/step"] = np.asarray(jt.clock.step)
    out.update({f"val/{k}": np.asarray(v, np.float32)
                for k, v in jt.val_step().items()})
    return out


def load() -> dict:
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


def unflatten_prefix(arrs: dict, prefix: str) -> dict:
    """The arrays under ``prefix/`` as {rest: array}."""
    return {k[len(prefix) + 1:]: v for k, v in arrs.items()
            if k.startswith(prefix + "/")}


def port_draws(arrs: dict, pre: str):
    """The fixture's draws of step ``pre`` (``run/i``) as a port ``Draws``."""
    import torch
    from moco_flow_tpu_torch.data.draws import Draws
    d = unflatten_prefix(arrs, f"draws/{pre}")
    t = {k: torch.from_numpy(np.asarray(d[k])) for k in
         ("pixels", "background", "perturb", "pdf", "cube", "pick", "noise")}
    return Draws(frame=int(d["frame"]), pixels=t["pixels"].long(),
                 background=t["background"], chained=int(d["chained"]),
                 perturb=t["perturb"], pdf=t["pdf"], cube=t["cube"],
                 pick=t["pick"].long(), noise=t["noise"])


def port_trainer(arrs: dict, device, step: int, deleted: bool, scene=None):
    """The port's trainer on the fixture's data at ``step``, with the
    initial parameters and fresh optimizers (the ``nof`` one deleted if
    ``deleted``); with ``scene`` (the port's in-memory synthetic scene) also
    its val dataset."""
    import torch
    from moco_flow_tpu_torch.data.correspondence import CorrespondenceTable
    from moco_flow_tpu_torch.data.dataset import FrameTable
    from moco_flow_tpu_torch.train.checkpoint import (_unflatten,
                                                      params_from_jax)
    from moco_flow_tpu_torch.train.stage_mocoflow import MoCoFlowTrainer
    cfg = json.loads(str(arrs["config_json"]))
    tr = MoCoFlowTrainer(cfg, device=device, scene=scene)
    tr.build_model(cfg["model"])
    if scene is not None:
        tr.prepare_dataloader(cfg["dataloader"])
    table = FrameTable(**{k: torch.from_numpy(arrs[f"table/{k}"])
                          for k in ("c2w", "near", "far", "norm_idx")},
                       valid_idx=torch.from_numpy(
                           arrs["table/valid_idx"]).long(),
                       valid_count=torch.from_numpy(
                           arrs["table/valid_count"]).long())
    corr = CorrespondenceTable(torch.from_numpy(arrs["corr/verts"]),
                               torch.from_numpy(arrs["corr/src_to_cano"]))
    tr.set_train_data(table, torch.from_numpy(arrs["directions"]),
                      torch.from_numpy(arrs["images"]),
                      torch.from_numpy(arrs["bkgd_img"]),
                      bool(arrs["rand_bkgd"]), corr=corr)
    tr.configure_optimizers(cfg["optimizer"], cfg.get("scheduler"))
    tr.params = params_from_jax(_unflatten(unflatten_prefix(arrs,
                                                            "params0")),
                                device)
    tr.clock.step = step
    tr.nof_opt_deleted = deleted
    return tr


def port_run(arrs: dict, run: str, device, scene=None):
    """A run's steps through the port with the fixture's draws:
    ``([metrics {name: float} per step], [nof_opt_deleted per step],
    trainer)``. Imports only the port (no JAX)."""
    start, n_steps, deleted = RUNS[run]
    tr = port_trainer(arrs, device, start, deleted, scene)
    metrics, dels = [], []
    for i in range(n_steps):
        m = tr.train_step(draws=port_draws(arrs, f"{run}/{i}"))
        metrics.append({k: float(v) for k, v in m.items()})
        dels.append(tr.nof_opt_deleted)
        tr.clock.tick()
    return metrics, dels, tr


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=FIXTURE)
    args = p.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    arrs = golden_arrays()
    os.makedirs(osp.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **arrs)
    print(f"wrote {args.out} ({osp.getsize(args.out)} bytes, "
          f"{len(arrs)} arrays)")


if __name__ == "__main__":
    main()
