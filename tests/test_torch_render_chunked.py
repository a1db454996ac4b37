"""The port's ``BaseTrainer.render_rays_chunked`` against the JAX trainer's
at the training fixture's widths (scripts/make_torch_port_train_golden.py:
NeRF 4x32, NoF 4x32, 8 + 8 samples, chunk 1024), on the CPU.

JAX builds the 32x32 synthetic scene and a ``MoCoFlowTrainer`` on a
one-device mesh with ``mlp_impl: fused`` (its Pallas kernels interpreted),
sharpened sigma heads and its clock at step 6000 (PE annealing partly on);
the port takes the same parameters. Cases:
- no rays with the chains off (the test-time render) and on (a training
  render at perturb 0): JAX renders one dummy ray and returns every per-ray
  output with 0 rows and the consensus scalars as they are;
- 2500 rays with the chains on, in tiles of 1024: the tail tile of 452 rays
  is padded to 1024, and the per-tile consensus scalars are averaged
  weighted by each tile's real ray count.
Keys, shapes and values must agree, values within the render tolerance of
fp32 (1e-5 abs and rel, as tests/test_torch_slice.py).
"""

import copy
import os

import numpy as np
import pytest
import torch

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu.data.synthetic import make_synthetic_scene
from moco_flow_tpu.parallel.mesh import make_mesh
from moco_flow_tpu.train import get_trainer
from moco_flow_tpu.train.checkpoint import _flatten as j_flatten
from moco_flow_tpu.train.factory import render_config as j_render_config
from moco_flow_tpu.utils.config import Config
from moco_flow_tpu_torch.train.checkpoint import _unflatten, params_from_jax
from moco_flow_tpu_torch.train.factory import render_config
from moco_flow_tpu_torch.train.stage_mocoflow import MoCoFlowTrainer
from scripts.make_torch_port_train_golden import (SCENE, STEP, sharpen,
                                                  train_config)

TOL = 1e-5
CHUNK = 1024


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("chunked"))
    root = os.path.join(tmp, "scene")
    smpl = make_synthetic_scene(root, **SCENE)
    cfg = train_config(root, os.path.join(tmp, "log"))
    jt = get_trainer(Config(copy.deepcopy(cfg), mode="train"),
                     smpl_data=smpl, mesh=make_mesh(1))
    jt.params = sharpen(jt.params)
    jt.clock.step = STEP
    pt = MoCoFlowTrainer(copy.deepcopy(cfg), device="cpu")
    pt.build_model(cfg["model"])
    pt.params = params_from_jax(
        _unflatten({k: np.asarray(v)
                    for k, v in j_flatten(jt.params).items()}), "cpu")
    pt.clock.step = STEP
    ds = jt.val_dataset
    frames = [np.asarray(ds.frame_rays(i)[0]) for i in range(2)]
    return jt, pt, cfg["model"], frames


def _rays(frames, n: int, chained: bool) -> np.ndarray:
    """n rays from the two frames in turn; with ``chained`` a tenth
    column, the other frame's index (the chain_global target)."""
    rows = []
    for i, f in enumerate(frames):
        r = f
        if chained:
            other = frames[1 - i][:1, 8:9]
            r = np.concatenate([f, np.broadcast_to(other, (len(f), 1))], 1)
        rows.append(r)
    out = np.concatenate(rows)
    return np.ascontiguousarray(np.resize(out, (n, out.shape[1])),
                                np.float32)


CASES = {"0-rays-chain-off": (0, False), "0-rays-chain-on": (0, True),
         "2500-rays-chain-on": (2500, True)}


@pytest.mark.parametrize("case", list(CASES))
def test_render_rays_chunked_matches_jax(trainers, case):
    jt, pt, model_cfg, frames = trainers
    n, chains = CASES[case]
    kw = (dict(use_nof=True, chain_local=True, chain_global=True,
               perturb=0.0) if chains else
          dict(use_nof=True, test_time=True, perturb=0.0))
    rays = _rays(frames, n, chains)
    bg = np.random.default_rng(n).uniform(size=(n, 3)).astype(np.float32)
    want = jt.render_rays_chunked(rays, bg, j_render_config(model_cfg, **kw),
                                  anneal=jt.anneal(), chunk=CHUNK)
    got = pt.render_rays_chunked(torch.from_numpy(rays),
                                 torch.from_numpy(bg),
                                 render_config(model_cfg, **kw),
                                 anneal=pt.anneal(), chunk=CHUNK)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(want)
    scalars = [k for k, v in want.items() if v.ndim == 0]
    assert bool(scalars) == chains
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        if v.ndim:
            assert v.shape[0] == n, k
        assert np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], v, rtol=TOL, atol=TOL,
                                   err_msg=k)
