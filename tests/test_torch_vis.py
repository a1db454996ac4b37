"""The port's visualisation (``moco_flow_tpu_torch/train/vis.py``) and novel
poses (``geometry/poses.py``) against the JAX package's.

A JAX ``MoCoFlowTrainer`` and the port's hold the same weights (the
training fixture's widths, sigma heads sharpened tenfold with biases of 1,
so that about half the rays stop; ``params_from_jax``) on the same 2-frame
scene at step 6000 (PE annealing partly open).

- poses: ``pose_spherical``, ``create_spheric_poses``,
  ``create_bullet_effect_poses`` and the val dataset's ``spherical_poses``
  within 1e-6;
- ``colorize_depth`` equal to JAX's (cv2's JET) on the same depths;
- ``sigma_grid`` at n_grid 16, canonical and warped into frame 1, within
  1e-5 of the grid's largest |sigma|;
- ``visualize_frame`` (the novel pose drawn from the shared
  ``val_rng((seed, step))``): rgb panels within 1e-5 of JAX's; depth
  panels equal except where the normalized depth lies within 1e-5 of a
  bin edge of the colour table; the same file;
- ``visualize_mesh`` on a sphere field: the same OBJ text at the same path.

JAX renders on its plain XLA route (``mlp_impl: xla``), the port its
fused route's plain versions.
"""

import copy
import os
import os.path as osp

import numpy as np
import pytest
import torch

import jax

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu.data.synthetic import make_synthetic_scene
from moco_flow_tpu.geometry import poses as jax_poses
from moco_flow_tpu.parallel.mesh import make_mesh
from moco_flow_tpu.train import get_trainer as jax_trainer
from moco_flow_tpu.train import vis as jax_vis
from moco_flow_tpu.utils.config import Config as JaxConfig
from moco_flow_tpu_torch.geometry import poses
from moco_flow_tpu_torch.train import vis
from moco_flow_tpu_torch.train.checkpoint import params_from_jax
from moco_flow_tpu_torch.train.stage_mocoflow import MoCoFlowTrainer
from scripts.make_torch_port_train_golden import SCENE, sharpen, train_config

STEP = 6000


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("vis"))
    root = osp.join(tmp, "scene")
    smpl = make_synthetic_scene(root, **SCENE)
    cfg = train_config(root, osp.join(tmp, "log"))
    cfg["model"]["mlp_impl"] = "xla"
    port_cfg = copy.deepcopy(cfg)
    jt = jax_trainer(JaxConfig(cfg, mode="train", seed=0), smpl_data=smpl,
                     mesh=make_mesh(1))
    params = sharpen(jt.params)
    for net in ("coarse_NeRF", "fine_NeRF"):
        head = params[net]["sigma"]
        params[net] = dict(params[net], sigma={
            "w": head["w"], "b": jax.numpy.ones_like(head["b"])})
    jt.params = params
    jt.clock.step = STEP
    pt = MoCoFlowTrainer(port_cfg, device="cpu", seed=0, smpl_data=smpl)
    pt.build_model(port_cfg["model"])
    pt.params = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       jt.params))
    pt.prepare_dataloader(port_cfg["dataloader"])
    pt.clock.step = STEP
    return jt, pt, tmp


@pytest.mark.parametrize("theta,phi,radius,up", [
    (0.0, 0.0, 2.0, None), (37.0, -15.0, 3.3, [0, -1, 0]),
    (250.0, -30.0, 4.1, [0.2, -1.0, 0.1])])
def test_pose_spherical_equals_jax(theta, phi, radius, up):
    np.testing.assert_allclose(
        poses.pose_spherical(theta, phi, radius, (0.1, 0, -0.2), up),
        jax_poses.pose_spherical(theta, phi, radius, (0.1, 0, -0.2), up),
        atol=1e-6, rtol=0)


def test_pose_tracks_equal_jax():
    a = poses.create_spheric_poses(radius=2.7, vec_up=[0, -1, 0])
    b = jax_poses.create_spheric_poses(radius=2.7, vec_up=[0, -1, 0])
    assert a.shape == (90, 4, 4)
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    a = poses.create_bullet_effect_poses(radius=3.0, move_dist=0.5,
                                         init_angle=10.0)
    b = jax_poses.create_bullet_effect_poses(radius=3.0, move_dist=0.5,
                                             init_angle=10.0)
    assert a.shape == (120, 4, 4)
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_dataset_spherical_poses_equal_jax(pair):
    jt, pt, _ = pair
    np.testing.assert_allclose(pt.val_dataset.spherical_poses,
                               jt.val_dataset.spherical_poses, atol=1e-6,
                               rtol=0)


def test_colorize_depth_equals_jax():
    rng = np.random.default_rng(0)
    depth = rng.uniform(2.0, 6.0, (31, 17)).astype(np.float32)
    depth[3, 4] = np.nan
    np.testing.assert_array_equal(vis.colorize_depth(depth),
                                  jax_vis.colorize_depth(depth))


@pytest.mark.parametrize("frame", [-1, 1])
def test_sigma_grid_equals_jax(pair, frame):
    jt, pt, _ = pair
    want = jax_vis.sigma_grid(jt, frame, n_grid=16, chunk=4096,
                              clip_negative=False)
    got = vis.sigma_grid(pt, frame, n_grid=16, chunk=4096,
                         clip_negative=False)
    assert got.shape == (16, 16, 16) and want.std() > 0.1
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    clipped = vis.sigma_grid(pt, frame, n_grid=16, chunk=4096)
    np.testing.assert_array_equal(clipped, np.maximum(got, 0))


def _port_norm_depth(pt, idx, c2w4, white, use_nof):
    """The port's depth of one view, min-max normalized as colorize_depth
    normalizes it."""
    ds = pt.val_dataset
    bg = torch.ones_like(ds.bkgd_img) if white else ds.bkgd_img
    job = (ds.frame_rays(idx, c2w4=c2w4), idx, bg,
           ds.frame_mask(idx, c2w4=c2w4))
    res = next(pt.render_views_pipelined([job], vis._test_rcfg(pt, use_nof),
                                         anneal=pt.anneal()))
    x = res["depth_fine"].reshape(ds.size).numpy()
    return (x - x.min()) / (x.max() - x.min() + 1e-8)


@pytest.mark.parametrize("frame", [-1, 1])
def test_visualize_frame_equals_jax(pair, frame):
    jt, pt, tmp = pair
    use_nof = frame != -1
    want = jax_vis.visualize_frame(jt, frame, use_nof=use_nof,
                                   save_path=osp.join(tmp, "jax"),
                                   save_tb=False)
    got = vis.visualize_frame(pt, frame, use_nof=use_nof,
                              save_path=osp.join(tmp, "port"))
    h, w = pt.val_dataset.size
    assert got.shape == want.shape == (h, 5 * w, 3)
    panels = lambda s: [s[:, i * w:(i + 1) * w] for i in range(5)]  # noqa
    g, j = panels(got), panels(np.asarray(want))
    for i in (0, 1, 3):                            # GT, pred, novel pred
        np.testing.assert_allclose(g[i], j[i], rtol=0, atol=1e-5)
    assert 0.05 < g[1].std()                      # not a flat image
    idx = frame if frame != -1 else 0
    pose = pt.val_dataset.spherical_poses[int(pt.val_rng().integers(90))]
    for i, (c2w4, white) in ((2, (None, False)), (4, (pose, True))):
        bad = np.any(g[i] != j[i], axis=-1)
        if bad.any():
            x = _port_norm_depth(pt, idx, c2w4, white, use_nof)[bad]
            edge = np.abs(x * 255 - np.round(x * 255)) / 255
            assert (edge < 1e-5).all(), (i, x[edge >= 1e-5])
        assert len(np.unique(g[i].reshape(-1, 3), axis=0)) > 2
    name = "canonical.png" if frame == -1 else f"frame_{frame}.png"
    sub = f"images_epoch_{pt.clock.epoch}_step_{STEP}"
    assert osp.exists(osp.join(tmp, "jax", sub, name))
    assert osp.exists(osp.join(tmp, "port", sub, name))


def test_visualize_mesh_equals_jax(pair, monkeypatch):
    jt, pt, tmp = pair
    lin = np.linspace(-1.5, 1.5, 24, dtype=np.float32)
    gx, gy, gz = np.meshgrid(lin, lin, lin, indexing="ij")
    sphere = np.maximum(20.0 * (1.0 - np.sqrt(gx ** 2 + gy ** 2 + gz ** 2)),
                        0).astype(np.float32)
    monkeypatch.setattr(jax_vis, "sigma_grid", lambda *a, **k: sphere)
    monkeypatch.setattr(vis, "sigma_grid", lambda *a, **k: sphere)
    want = jax_vis.visualize_mesh(jt, -1, n_grid=24, sigma_threshold=10,
                                  save_path=osp.join(tmp, "jax"))
    got = vis.visualize_mesh(pt, -1, n_grid=24, sigma_threshold=10,
                             save_path=osp.join(tmp, "port"))
    assert osp.relpath(got, osp.join(tmp, "port")) == \
        osp.relpath(want, osp.join(tmp, "jax"))
    with open(got) as f, open(want) as g:
        assert f.read() == g.read()
    monkeypatch.setattr(vis, "sigma_grid", lambda *a, **k: sphere * 0)
    assert vis.visualize_mesh(pt, -1, n_grid=24) is None
    assert os.listdir(osp.dirname(got)) == ["canonical.obj"]
