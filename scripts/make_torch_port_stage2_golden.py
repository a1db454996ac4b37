#!/usr/bin/env python
"""Write tests/fixtures/torch_port_stage2_golden.npz: stage 2 (the NoF
pretraining) of the JAX package, and its stage-3 step under ``mlp_impl:
pallas``, at small widths, for checking the PyTorch port where JAX is not
installed.

- **Stage 2.** JAX's ``NoFTrainer`` built on a one-device mesh from
  ``stage2_config``: ``init_nof.yaml``'s model (xyz PE of 0 bands padded to
  33 inputs, the frame PE of 16 bands, quaternion head) narrowed to NoF
  4x32, ``N_sampled`` 64, ``adam`` with ``steplr``, on the 32x32 synthetic
  scene of 2 frames. Three steps from step 0, then the val step (a fresh
  10,000-point set). Held: the config (JSON), the parameters before the
  steps, after the second and after the third, ``opt_named`` after the
  second, the correspondence table and normalized frame indices, each
  step's draws (frame, cube, pick, noise, recomputed from the step key as
  JAX's step derives them) and the correspondences they give, the losses,
  and the val step's draws and losses.
- **Stage 3 under pallas.** JAX's ``MoCoFlowTrainer`` of
  ``scripts/make_torch_port_phases_golden.py`` (NeRF 4x32, NoF 4x32, both
  chains, 32 rays x (8 + 8) samples, ``N_sampled`` 64) with ``mlp_impl:
  pallas`` (its Pallas kernels run interpreted on the CPU): one ``none``
  step at 6000 and one ``msk`` step at 10000, the ``nof`` optimizer
  deleted, each from the initial parameters, then the val step after the
  ``msk`` step. Held under ``s3/``: the config, the initial parameters, the
  draws, the losses, the parameters after each step and the val metrics
  (the frame table, images and correspondence table are the phases
  fixture's).

``chip_smoke.py`` replays both on a GPU in fp32;
``tests/test_torch_stage2.py`` and ``tests/test_torch_pallas_train.py``
check that the fixture still matches the JAX package and that the port's
plain path replays it.

    JAX_PLATFORMS=cpu python scripts/make_torch_port_stage2_golden.py [--out PATH]
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

from scripts.make_torch_port_phases_golden import (  # noqa: E402
    jax_corr_draws, unflatten_prefix)
from scripts.make_torch_port_train_golden import (  # noqa: E402
    SCENE, jax_draws, sharpen, train_config)

FIXTURE = osp.join(ROOT, "tests", "fixtures", "torch_port_stage2_golden.npz")
N_STEPS = 3
CKPT_AFTER = 2
VAL_POINTS = 10000
THICKNESS = 0.1
# stage-3 pallas steps: run -> (step, nof optimizer deleted)
S3_RUNS = {"none": 6000, "msk": 10000}


def stage2_config(root: str | None, save_dir: str) -> dict:
    """configs/people_snapshot/male-3-casual/init_nof.yaml narrowed to
    fixture size (NoF 4x32, N_sampled 64)."""
    nof = {"type": "NoF", "D": 4, "W": 32, "in_channels_xyz": 33,
           "skips": [2], "extra_feat_type": "ind", "extra_feat_dim": 33,
           "use_quat": True}
    return {
        "save_dir": save_dir, "exp_name": "init_nof_tiny",
        "dataloader": {"type": "nof", "root_dir": root, "interval": 1},
        "model": {
            "type": "nof", "pretrained_path": None, "pretrained_nof": None,
            "N_sampled": 64,
            "nof_embedding_xyz": {"type": "Embedding", "in_channels": 3,
                                  "N_freqs": 0, "logscale": True},
            "nof_embedding_ind": {"type": "Embedding", "in_channels": 1,
                                  "N_freqs": 16, "logscale": True},
            "fw_NoF": nof, "bw_NoF": dict(nof)},
        "loss": {"type": "L1"},
        "optimizer": {"type": "adam", "lr": 1e-3, "weight_decay": 0},
        "scheduler": {"type": "steplr", "decay_step": [300000],
                      "decay_gamma": 0.5},
        "trainer": {"num_iters": N_STEPS, "val_every_n_step": 0,
                    "save_every_n_step": 0, "log_freq": 50},
    }


def s3_config() -> dict:
    """The phases fixture's stage-3 config on the per-op route."""
    cfg = train_config("scene", "log")
    cfg["model"]["mlp_impl"] = "pallas"
    return cfg


def _points(key, n: int, num_verts: int) -> dict:
    import jax
    k_cube, k_vert, k_noise = jax.random.split(key, 3)
    return {"cube": np.asarray(jax.random.uniform(
                k_cube, (n, 3), minval=-1.5, maxval=1.5)),
            "pick": np.asarray(jax.random.randint(k_vert, (n,), 0,
                                                  num_verts), np.int64),
            "noise": np.asarray(jax.random.normal(k_noise, (n, 3)))}


def jax_stage2_draws(seed: int, step: int, num_frames: int, n: int,
                     num_verts: int) -> dict:
    """A JAX stage-2 step's draws, from its key as ``NoFTrainer``'s step
    derives them (``frame_sampling: uniform``, one device)."""
    import jax
    key = jax.random.fold_in(jax.random.key(seed), step)
    k_f, k_c = jax.random.split(key)
    frame = int(jax.random.randint(k_f, (), 0, num_frames))
    return {"frame": np.int64(frame), **_points(k_c, n, num_verts)}


def jax_val_draws(step: int, num_frames: int, num_verts: int) -> dict:
    """The draws of JAX's stage-2 ``val_step`` at ``step``."""
    import jax
    key = jax.random.fold_in(jax.random.key(777), step)
    k_f, k_c = jax.random.split(key)
    frame = int(jax.random.randint(k_f, (), 0, num_frames))
    return {"frame": np.int64(frame),
            **_points(k_c, VAL_POINTS, num_verts)}


def _stage2(out: dict, root: str, tmp: str, smpl):
    import jax
    import jax.numpy as jnp
    from moco_flow_tpu.data.correspondence import sample_correspondences
    from moco_flow_tpu.parallel.mesh import make_mesh
    from moco_flow_tpu.train import get_trainer
    from moco_flow_tpu.train.checkpoint import _flatten
    from moco_flow_tpu.utils.config import Config

    cfg = stage2_config(root, osp.join(tmp, "log2"))
    jt = get_trainer(Config(copy.deepcopy(cfg), mode="train"),
                     smpl_data=smpl, mesh=make_mesh(1))
    ds = jt.train_dataset
    table = ds.correspondence_table
    out["config_json"] = np.asarray(json.dumps(stage2_config("scene",
                                                             "log")))
    out.update({f"params0/{k}": np.array(v)
                for k, v in _flatten(jt.params).items()})
    for name in ("c2w", "near", "far", "norm_idx", "valid_idx",
                 "valid_count"):
        out[f"table/{name}"] = np.asarray(getattr(ds.table, name))
    out["corr/verts"] = np.asarray(table.verts)
    out["corr/src_to_cano"] = np.asarray(table.src_to_cano)
    nv = int(table.verts.shape[1])
    n = cfg["model"]["N_sampled"]
    for i in range(N_STEPS):
        step = jt.clock.step
        d = jax_stage2_draws(0, step, ds.num_frames, n, nv)
        out.update({f"draws/{i}/{k}": v for k, v in d.items()})
        key = jax.random.fold_in(jax.random.key(0), step)
        corr = sample_correspondences(table, jnp.asarray(int(d["frame"])),
                                      jax.random.split(key)[1],
                                      num_sampled=n, thickness=THICKNESS)
        out.update({f"corr/{i}/{k}": np.asarray(v) for k, v in corr.items()})
        out.update({f"metrics/{i}/{k}": np.asarray(v, np.float32)
                    for k, v in jt.train_step().items()})
        jt.clock.tick()
        if i + 1 == CKPT_AFTER:
            out.update({f"opt{CKPT_AFTER}/{k}": np.asarray(v) for k, v in
                        jt._opt_named_leaves(jt.opt_state).items()})
            out.update({f"params{CKPT_AFTER}/{k}": np.array(v)
                        for k, v in _flatten(jt.params).items()})
    out.update({f"params{N_STEPS}/{k}": np.array(v)
                for k, v in _flatten(jt.params).items()})
    out["val/step"] = np.asarray(jt.clock.step)
    out.update({f"val/draws/{k}": v for k, v in jax_val_draws(
        jt.clock.step, ds.num_frames, nv).items()})
    out.update({f"val/{k}": np.asarray(v, np.float32)
                for k, v in jt.val_step().items()})


def _stage3_pallas(out: dict, root: str, tmp: str, smpl):
    from moco_flow_tpu.parallel.mesh import make_mesh
    from moco_flow_tpu.train import get_trainer
    from moco_flow_tpu.train.checkpoint import _flatten
    from moco_flow_tpu.utils.config import Config

    cfg = train_config(root, osp.join(tmp, "log3"))
    cfg["model"]["mlp_impl"] = "pallas"
    out["s3/config_json"] = np.asarray(json.dumps(s3_config()))
    m = cfg["model"]
    for run, step in S3_RUNS.items():
        jt = get_trainer(Config(copy.deepcopy(cfg), mode="train"),
                         smpl_data=smpl, mesh=make_mesh(1))
        jt.params = sharpen(jt.params)
        if run == "none":
            out.update({f"s3/params0/{k}": np.array(v)
                        for k, v in _flatten(jt.params).items()})
        jt.clock.step = step
        jt.nof_opt_deleted = True
        ds = jt.train_dataset
        nv = int(ds.correspondence_table.verts.shape[1])
        d = jax_draws(0, step, ds.table, m["N_rand"], m["N_samples"],
                      m["N_importance"])
        d.update(jax_corr_draws(0, step, m["N_sampled"], nv))
        out.update({f"s3/draws/{run}/{k}": v for k, v in d.items()})
        metrics = jt.train_step()
        out.update({f"s3/metrics/{run}/{k}": np.asarray(v, np.float32)
                    for k, v in metrics.items() if k != "state/nerf"})
        jt.clock.tick()
        out.update({f"s3/params_{run}/{k}": np.array(v)
                    for k, v in _flatten(jt.params).items()})
    out["s3/val/step"] = np.asarray(jt.clock.step)
    out.update({f"s3/val/{k}": np.asarray(v, np.float32)
                for k, v in jt.val_step().items()})


def golden_arrays(stage3: bool = True) -> dict:
    """Everything the fixture holds (without ``stage3`` only stage 2's
    arrays), computed with the JAX package."""
    from moco_flow_tpu.data.synthetic import make_synthetic_scene
    tmp = tempfile.mkdtemp()
    root = osp.join(tmp, "scene")
    smpl = make_synthetic_scene(root, **SCENE)
    out: dict = {}
    _stage2(out, root, tmp, smpl)
    if stage3:
        _stage3_pallas(out, root, tmp, smpl)
    return out


def load(path: str = FIXTURE) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


# -- replays through the port (no JAX) ----------------------------------------

def port_points(arrs: dict, pre: str):
    """The draws under ``pre`` as a port ``PointDraws``."""
    import torch
    from moco_flow_tpu_torch.data.draws import PointDraws
    d = unflatten_prefix(arrs, pre)
    return PointDraws(frame=int(d["frame"]),
                      cube=torch.from_numpy(d["cube"]),
                      pick=torch.from_numpy(d["pick"]).long(),
                      noise=torch.from_numpy(d["noise"]))


def port_stage2_trainer(arrs: dict, device):
    """The port's ``NoFTrainer`` on the fixture's correspondence table at
    step 0 with the initial parameters."""
    import torch
    from moco_flow_tpu_torch.data.correspondence import CorrespondenceTable
    from moco_flow_tpu_torch.train.checkpoint import (_unflatten,
                                                      params_from_jax)
    from moco_flow_tpu_torch.train.stage_nof import NoFTrainer
    cfg = json.loads(str(arrs["config_json"]))
    tr = NoFTrainer(cfg, device=device)
    tr.build_model(cfg["model"])
    tr.set_points(CorrespondenceTable(
        torch.from_numpy(arrs["corr/verts"]),
        torch.from_numpy(arrs["corr/src_to_cano"])),
        torch.from_numpy(arrs["table/norm_idx"]))
    tr.configure_optimizers(cfg["optimizer"], cfg.get("scheduler"))
    tr.params = params_from_jax(_unflatten(unflatten_prefix(arrs,
                                                            "params0")),
                                device)
    return tr


def port_stage2_replay(arrs: dict, device, steps: int = N_STEPS):
    """The fixture's first ``steps`` stage-2 steps through the port with
    JAX's draws, then (after all of them) the val step with JAX's val
    draws: ``([metrics per step], val metrics or None, trainer)``."""
    tr = port_stage2_trainer(arrs, device)
    metrics = []
    for i in range(steps):
        m = tr.train_step(draws=port_points(arrs, f"draws/{i}"))
        metrics.append({k: float(v) for k, v in m.items()})
        tr.clock.tick()
    val = tr.val_step(draws=port_points(arrs, "val/draws")) \
        if steps == N_STEPS else None
    return metrics, val, tr


def port_stage3_run(arrs: dict, phases: dict, run: str, device, scene=None):
    """The stage-3 ``pallas`` step ``run`` through the port on the phases
    fixture's data (``phases``), with JAX's draws: ``(metrics, trainer)``;
    with ``scene`` the trainer also has its val dataset."""
    from moco_flow_tpu_torch.train.checkpoint import (_unflatten,
                                                      params_from_jax)
    from scripts.make_torch_port_phases_golden import (port_draws,
                                                       port_trainer)
    s3 = unflatten_prefix(arrs, "s3")
    merged = dict(phases, config_json=s3["config_json"])
    tr = port_trainer(merged, device, S3_RUNS[run], True, scene)
    tr.params = params_from_jax(_unflatten(unflatten_prefix(s3, "params0")),
                                device)
    m = tr.train_step(draws=port_draws(s3, run))
    tr.clock.tick()
    return {k: float(v) for k, v in m.items()}, tr


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
