"""The whole ported slice against the JAX package at 32x32: a stage-3
checkpoint written by the JAX trainer is rendered and scored by the port's
``test()`` and by the JAX trainer, on the same synthetic frame.

JAX builds the scene (``make_synthetic_scene``) and a ``MoCoFlowTrainer``
from ``__graft_entry__._tiny_moco_config`` (full-width 8x256 NeRFs, 4x128
NoFs) on a one-device mesh, with ``mlp_impl: fused`` so its renders run the
test-time pass kernel (interpreted on the CPU), and saves a checkpoint at a
step inside the coarse-to-fine window, so the annealing weights restored
from the checkpoint are partly on. The port loads that checkpoint and runs
``test(config, args)`` with ``--eval_metrics`` on the CPU.

Tolerance 1e-5 on per-ray outputs (fp32, as in test_torch_nn.py): the port
also computes the frame's SMPL vertices, and so its near/far, in its own
fp32 summation order; measured max |diff| 1e-6 (depth), 2e-7 (rgb).
"""

import copy
import os

import numpy as np
import pytest

import jax.numpy as jnp

from __graft_entry__ import _tiny_moco_config
import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu.data.synthetic import make_synthetic_scene
from moco_flow_tpu.parallel.mesh import make_mesh
from moco_flow_tpu.train import get_trainer
from moco_flow_tpu.utils.config import Config
from moco_flow_tpu_torch.test import parse_args, test as run_port_test

STEP = 505000  # inside coarse2fine_start/end_iter of the tiny config


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("slice"))
    root = os.path.join(tmp, "scene")
    smpl = make_synthetic_scene(root, n_frames=2, size=32, focal=40.0)
    cfg = _tiny_moco_config(root, os.path.join(tmp, "log"))
    cfg["model"]["mlp_impl"] = "fused"
    port_cfg = copy.deepcopy(cfg)
    jt = get_trainer(Config(cfg, mode="train"), smpl_data=smpl,
                     mesh=make_mesh(1))
    jt.clock.step = STEP
    # sharpened sigma heads: a freshly drawn NeRF is empty or dense
    # everywhere; this one stops some rays and lets others through
    for net in ("coarse_NeRF", "fine_NeRF"):
        head = jt.params[net]["sigma"]
        jt.params[net]["sigma"] = {"w": head["w"] * 10.0,
                                   "b": jnp.zeros_like(head["b"])}
    jt.save_ckpt("final")
    ckpt = jt._ckpt_path("final") + ".npz"
    ds = jt.val_dataset
    rays, _ = ds.frame_rays(0)
    want = jt.render_rays_chunked(rays, ds.bkgd_img, jt.rcfg_test,
                                  anneal=jt.anneal())
    want = {k: np.asarray(v) for k, v in want.items()}
    want_metrics = jt.evaluate_sequence(max_frames=1)

    args = parse_args(["-c", "unused.yaml", "-r", ckpt, "--render_gt",
                       "--reso", "32", "--eval_metrics",
                       "--eval_max_frames", "1", "--device", "cpu"])
    pt = run_port_test(port_cfg, args, smpl_data=smpl)
    got = pt.render_rays_chunked(pt.val_dataset.frame_rays(0),
                                 pt.val_dataset.bkgd_img, pt.rcfg_test,
                                 anneal=pt.anneal())
    got = {k: v.numpy() for k, v in got.items()}
    return jt, pt, want, got, want_metrics


def test_slice_restores_checkpoint_state(slice_run):
    jt, pt, *_ = slice_run
    assert pt.step == STEP
    for k, v in jt.anneal().items():
        np.testing.assert_array_equal(pt.anneal()[k].numpy(), np.asarray(v))
    assert 0 < float(np.asarray(jt.anneal()["nerf_xyz"]).sum()) < 10


def test_slice_frame_is_not_trivial(slice_run):
    """Some rays are stopped and some pass, so the comparison below covers
    both passes' weights, the rgb head and the background blend."""
    _, _, want, _, _ = slice_run
    for key in ("opacity_coarse", "opacity_fine"):
        assert want[key].min() < 0.5 < want[key].max(), key
    assert want["rgb_fine"].std() > 0.05


@pytest.mark.parametrize("key", ["rgb_fine", "depth_fine", "opacity_fine",
                                 "opacity_coarse"])
def test_slice_per_ray_outputs(slice_run, key):
    _, _, want, got, _ = slice_run
    assert got[key].shape == want[key].shape == (32 * 32,) + \
        want[key].shape[1:]
    assert np.isfinite(got[key]).all()
    np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5)


def test_slice_metrics(slice_run):
    _, pt, _, _, want = slice_run
    assert pt.metrics["frames"] == want["frames"] == 1
    for k in ("psnr", "ssim", "dssim"):
        np.testing.assert_allclose(pt.metrics[k], want[k], rtol=1e-4,
                                   err_msg=k)
