"""The port's occupancy-grid skipping (``moco_flow_tpu_torch/render/
occupancy.py``, ``train/vis.py``'s grid builders and the occupancy half of
``train/base.py``) against the JAX package's.

A JAX ``MoCoFlowTrainer`` (``mlp_impl: xla``) and the port's hold the same
weights (the training fixture's widths; sigma heads scaled by -1000 with
biases of -60, so that about 40% of a 24^2 frame's rays are provably empty
at ``occ_res`` 8; ``params_from_jax``) on a 3-frame 24^2 scene at step 6000.

- the host tightener equals JAX's ``tighten_ray_bounds`` bit for bit on the
  grid regimes of ``tests/test_occupancy.py`` (sparse, hard-inf cells, fog,
  negligible fog, empty, measured outer density, a finite shell, one cell,
  all occupied, tail mass); the device tightener matches it: the same
  ``coarse`` and ``n_probe``, the same empty mask, near / far within 2e-5;
- the ``device``, host and ``warp`` grids equal JAX's: sig within 1e-5 of
  the grid's largest |sigma|, occupancy equal away from the threshold, the
  outer bound; the ``warp`` grid also against a numpy oracle of its math;
- ``softplus`` raises, a training step clears the grid cache, a frame
  proven empty composites to the background, ``masked_render: fused``
  equals ``loop``, ``occ_tighten: 0`` keeps the exact render's bits,
  ``tighten_rays`` and ``evaluate_sequence`` equal JAX's, and a scaled
  frame runs through the view path.
"""

import contextlib
import copy
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu.data.synthetic import make_synthetic_scene
from moco_flow_tpu.parallel.mesh import make_mesh
from moco_flow_tpu.render import occupancy as jax_occ
from moco_flow_tpu.train import get_trainer as jax_trainer
from moco_flow_tpu.utils.config import Config as JaxConfig
from moco_flow_tpu_torch.render import occupancy as occ
from moco_flow_tpu_torch.render.volume import RenderConfig
from moco_flow_tpu_torch.train.checkpoint import params_from_jax
from moco_flow_tpu_torch.train.stage_mocoflow import MoCoFlowTrainer
from moco_flow_tpu_torch.train.stage_nof import nof_points
from scripts.make_torch_port_train_golden import train_config

STEP = 6000
SIZE = 24
SIGMA_W, SIGMA_B = -1000.0, -60.0
OCC = {"occ_res": 8, "occ_supersample": 1, "occ_threshold": 5.0}


def make_pair(tmp: str, n_frames: int = 3):
    """(JAX trainer, port trainer, scene's SMPL data) with one set of
    weights, occupancy on at ``OCC``."""
    root = osp.join(tmp, "scene")
    smpl = make_synthetic_scene(root, n_frames=n_frames, size=SIZE,
                                focal=30.0)
    cfg = train_config(root, osp.join(tmp, "log"))
    cfg["dataloader"].update(size=[SIZE, SIZE], val_size=[SIZE, SIZE])
    cfg["model"].update(mlp_impl="xla", **OCC)
    port_cfg = copy.deepcopy(cfg)
    jt = jax_trainer(JaxConfig(cfg, mode="train", seed=0), smpl_data=smpl,
                     mesh=make_mesh(1))
    params = dict(jt.params)
    for net in ("coarse_NeRF", "fine_NeRF"):
        head = params[net]["sigma"]
        params[net] = dict(params[net], sigma={
            "w": head["w"] * SIGMA_W, "b": jnp.full_like(head["b"],
                                                         SIGMA_B)})
    jt.params = params
    jt.clock.step = STEP
    pt = MoCoFlowTrainer(port_cfg, device="cpu", seed=0, smpl_data=smpl)
    pt.build_model(port_cfg["model"])
    pt.params = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    pt.prepare_dataloader(port_cfg["dataloader"])
    pt.clock.step = STEP
    return jt, pt, smpl


@contextlib.contextmanager
def model_keys(*trainers, **keys):
    """``model`` config keys set on every trainer (and their grid caches
    cleared) for the block."""
    cfgs = [t.config.raw["model"] if hasattr(t.config, "raw")
            else t.config["model"] for t in trainers]
    saved = [{k: m.get(k) for k in keys} for m in cfgs]
    for t, m in zip(trainers, cfgs):
        m.update(keys)
        t._occ_grids.clear()
    try:
        yield
    finally:
        for t, m, s in zip(trainers, cfgs, saved):
            for k, v in s.items():
                if v is None:
                    m.pop(k, None)
                else:
                    m[k] = v
            t._occ_grids.clear()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return make_pair(str(tmp_path_factory.mktemp("occ")))


# ---------------------------------------------------------------------------
# The tighteners on the grid regimes of tests/test_occupancy.py
# ---------------------------------------------------------------------------

def camera_rays(h, w, focal, origin_z=3.0, near=1.0, far=5.0):
    """A pinhole bundle looking down -z from (0, 0, origin_z)."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    dirs = np.stack([(xs - w / 2) / focal, (ys - h / 2) / focal,
                     -np.ones_like(xs)], axis=-1).reshape(-1, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    o = np.tile([0.0, 0.0, origin_z], (h * w, 1)).astype(np.float32)
    return np.concatenate(
        [o, dirs, np.full((h * w, 1), near, np.float32),
         np.full((h * w, 1), far, np.float32),
         np.zeros((h * w, 1), np.float32)], axis=-1)


def _regime(name: str):
    """(grid kwargs, rays, size) of one regime."""
    res, ext = 16, 1.5
    rays20 = (camera_rays(20, 20, 30.0), (20, 20))
    sparse = (np.random.default_rng(7).uniform(size=(res,) * 3) < 0.03
              ).astype(np.float32) * 60
    if name == "sparse":
        return dict(occ=sparse > 5, sig=sparse), *rays20
    if name == "hard_inf":
        hard = np.zeros((res,) * 3, np.float32)
        hard[7:9, 7:9, 7:9] = np.inf
        return dict(occ=hard > 5, sig=hard), *rays20
    if name in ("fog", "negligible_fog"):
        fog = np.full((res,) * 3, 4.0 if name == "fog" else 1e-6,
                      np.float32)
        return dict(occ=fog > 5, sig=fog), camera_rays(16, 16, 20.0), \
            (16, 16)
    if name == "empty":
        return dict(occ=np.zeros((res,) * 3, bool)), *rays20
    if name == "outer_density":
        return dict(occ=np.zeros((res,) * 3, bool), outer_sig=10.0), *rays20
    if name == "finite_shell":
        return dict(occ=sparse > 5, sig=sparse, outer_sig=0.0,
                    outer_extent=2.0), *rays20
    if name == "beyond_shell":
        return dict(occ=np.zeros((12,) * 3, bool), outer_sig=0.0,
                    outer_extent=2.0), camera_rays(8, 8, 20.0, far=8.0), \
            (8, 8)
    if name == "one_cell":
        one = np.zeros((res,) * 3, bool)
        one[8, 8, 8] = True
        return dict(occ=one), camera_rays(24, 24, 40.0), (24, 24)
    if name == "all_occupied":
        return dict(occ=np.ones((8,) * 3, bool), threshold=-1.0), \
            camera_rays(16, 16, 20.0), (16, 16)
    if name == "tail_mass":
        sig = (np.random.default_rng(3).uniform(size=(32,) * 3) < 0.02
               ).astype(np.float32) * 50
        return dict(occ=sig > 5, sig=sig), *rays20
    raise KeyError(name)


REGIMES = ("sparse", "hard_inf", "fog", "negligible_fog", "empty",
           "outer_density", "finite_shell", "beyond_shell", "one_cell",
           "all_occupied", "tail_mass")


def _grids(name: str):
    kw, rays, size = _regime(name)
    kw = dict({"extent": 1.5, "threshold": 5.0}, **kw)
    return occ.OccupancyGrid(**kw), jax_occ.OccupancyGrid(**kw), rays, size


@pytest.mark.parametrize("name", REGIMES)
def test_host_tightener_equals_jax(name):
    grid, jgrid, rays, size = _grids(name)
    out, stats = occ.tighten_ray_bounds(grid, rays, size)
    want, wstats = jax_occ.tighten_ray_bounds(jgrid, rays, size)
    np.testing.assert_array_equal(out, want)
    assert set(stats) == set(wstats)
    for k in stats:
        np.testing.assert_array_equal(stats[k], wstats[k], err_msg=k)


@pytest.mark.parametrize("name", REGIMES)
def test_device_tightener_matches_host(name):
    grid, _, rays, size = _grids(name)
    ref, rstats = occ.tighten_ray_bounds(grid, rays, size)
    out, stats = occ.tighten_ray_bounds_device(grid, torch.from_numpy(rays),
                                               size)
    out = out.numpy()
    assert (stats["coarse"], stats["n_probe"]) == (rstats["coarse"],
                                                   rstats["n_probe"])
    np.testing.assert_array_equal(stats["empty_mask"].numpy(),
                                  rstats["empty_mask"])
    assert int(stats["kept_count"]) == int((~rstats["empty_mask"]).sum())
    np.testing.assert_allclose(out[:, 6], ref[:, 6], rtol=0, atol=2e-5)
    np.testing.assert_allclose(out[:, 7], ref[:, 7], rtol=0, atol=2e-5)
    np.testing.assert_array_equal(out[:, :6], ref[:, :6])
    np.testing.assert_array_equal(out[:, 8:], ref[:, 8:])
    np.testing.assert_allclose(float(stats["empty_frac"]),
                               rstats["empty_frac"], atol=1e-6)
    np.testing.assert_allclose(float(stats["range_ratio"]),
                               rstats["range_ratio"], rtol=1e-5)


def test_probe_plan_reads_no_rays(monkeypatch):
    """What the device tightener reads back: the plan's head (two
    directions and far.max(), 7 values) and its span maximum, nothing
    ray-sized."""
    grid, _, rays, size = _grids("sparse")
    reads = []
    for name in ("cpu", "numpy", "item", "tolist", "__float__", "__int__",
                 "__array__"):
        method = getattr(torch.Tensor, name)

        def spy(t, *a, _m=method, **k):
            reads.append(t.numel())
            return _m(t, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, spy)
    occ.tighten_ray_bounds_device(grid, torch.from_numpy(rays), size)
    assert reads and max(reads) <= 7, reads


# ---------------------------------------------------------------------------
# The grid builders
# ---------------------------------------------------------------------------

def _check_grid(got, want, label: str):
    scale = np.abs(want.sig[np.isfinite(want.sig)]).max()
    both_inf = np.isinf(got.sig) & np.isinf(want.sig)
    np.testing.assert_allclose(np.where(both_inf, 0, got.sig),
                               np.where(both_inf, 0, want.sig), rtol=0,
                               atol=1e-5 * scale, err_msg=label)
    differ = got.occ != want.occ
    assert (np.abs(want.sig[differ] - want.threshold) < 1e-5 * scale).all()
    assert got.outer_extent == want.outer_extent
    np.testing.assert_allclose(got.outer_sig, want.outer_sig, rtol=0,
                               atol=1e-5 * scale, err_msg=label)


@pytest.mark.parametrize("frame", [-1, 0])
@pytest.mark.parametrize("device", [True, False])
def test_grid_equals_jax(pair, frame, device):
    jt, pt, _ = pair
    kw = dict(resolution=8, supersample=2, threshold=5.0, extent=1.5,
              device=device)
    got = occ.build_occupancy_grid(pt, frame, **kw)
    want = jax_occ.build_occupancy_grid(jt, frame, **kw)
    assert isinstance(got, occ.DeviceOccupancyGrid if device
                      else occ.OccupancyGrid)
    _check_grid(got, want, f"frame {frame} device {device}")
    assert got.occ.any() and not got.occ.all()
    if device:   # the lattice order: the device grid is the host grid
        _check_grid(got, occ.build_occupancy_grid(pt, frame, **dict(
            kw, device=False)), "device vs host")


def test_warp_grid_equals_jax_and_its_math(pair):
    jt, pt, _ = pair
    res, ss, ext = 8, 2, 1.5
    kw = dict(resolution=res, supersample=ss, threshold=5.0, extent=ext)
    cano = occ.build_occupancy_grid(pt, -1, **kw)
    warp = occ.build_occupancy_grid(pt, 0, builder="warp", cano_grid=cano,
                                    **kw)
    direct = occ.build_occupancy_grid(pt, 0, **kw)
    jcano = jax_occ.build_occupancy_grid(jt, -1, **kw)
    jwarp = jax_occ.build_occupancy_grid(jt, 0, builder="warp",
                                         cano_grid=jcano, **kw)
    _check_grid(warp, jwarp, "warp")
    # the pullback's math in numpy: supersample 1, two dilation steps
    n = res
    f = np.arange(n ** 3)
    ijk = np.stack([f // (n * n), (f // n) % n, f % n], axis=-1)
    pts = ijk.astype(np.float32) * np.float32(2.0 * ext / (n - 1)) - ext
    y = nof_points(pt.params["bw_NoF"], pt.statics, pt.anneal(),
                   torch.from_numpy(pts), torch.tensor(-1.0),   # frame 0
                   RenderConfig(use_nof=True)).numpy()
    c_sig = cano.sig
    ids = np.floor((y + ext) / (2.0 * ext / res)).astype(np.int64)
    inb = ((ids >= 0) & (ids < res)).all(-1)
    ids = np.clip(ids, 0, res - 1)
    vals = np.where(inb, c_sig[ids[:, 0], ids[:, 1], ids[:, 2]],
                    np.where((np.abs(y) <= cano.outer_extent).all(-1),
                             cano.outer_sig, np.inf))
    sig = vals.reshape(res, res, res)
    for _ in range(2):
        pad = np.pad(sig, 1, constant_values=-np.inf)
        sig = np.max(np.stack([pad[i:i + res, j:j + res, k:k + res]
                               for i in range(3) for j in range(3)
                               for k in range(3)]), axis=0)
    got = warp.sig
    both_inf = np.isinf(sig) & np.isinf(got)
    np.testing.assert_allclose(np.where(both_inf, 0.0, got),
                               np.where(both_inf, 0.0, sig), rtol=1e-4,
                               atol=1e-4)
    # conservative against the direct build: direct-occupied => warp's
    assert not (direct.occ & ~warp.occ).any()


# ---------------------------------------------------------------------------
# The trainer's occupancy half
# ---------------------------------------------------------------------------

def test_occupancy_requires_relu(pair):
    _, pt, smpl = pair
    cfg = copy.deepcopy(pt.config)
    cfg["model"]["nerf_activate_type"] = "softplus"
    tr = MoCoFlowTrainer(cfg, device="cpu", seed=0, smpl_data=smpl)
    tr.build_model(cfg["model"])
    tr.prepare_dataloader(cfg["dataloader"])
    with pytest.raises(ValueError, match="relu"):
        tr.occupancy_grid(0)


def test_a_training_step_clears_the_grid_cache(pair):
    _, pt, smpl = pair
    cfg = copy.deepcopy(pt.config)
    tr = MoCoFlowTrainer(cfg, device="cpu", seed=0, smpl_data=smpl)
    tr.build_model(cfg["model"])
    tr.prepare_dataloader(cfg["dataloader"])
    tr.prepare_train_data(cfg["dataloader"])
    tr.configure_optimizers(cfg["optimizer"], cfg.get("scheduler"))
    tr.clock.step = STEP
    tr.tighten_rays(tr.val_dataset.frame_rays(0), 0)
    assert 0 in tr._occ_grids
    tr.train_func()
    assert not tr._occ_grids


@pytest.mark.parametrize("impl", ["fused", "loop"])
def test_a_frame_proven_empty_is_background(pair, impl):
    jt, pt, _ = pair
    n = SIZE * SIZE
    rays = pt.val_dataset.frame_rays(0)
    bg = torch.full((n, 3), 0.5)
    with model_keys(pt, masked_render=impl):
        res = pt.render_masked_image(rays, torch.zeros(n, dtype=torch.bool),
                                     bg, pt.rcfg_test, anneal=pt.anneal(),
                                     count=0)
    want = jt.render_masked_image(jnp.asarray(rays.numpy()),
                                  np.zeros(n, bool), jnp.full((n, 3), 0.5),
                                  jt.rcfg_test, anneal=jt.anneal())
    assert set(res) == set(want)
    np.testing.assert_array_equal(res["rgb_fine"].numpy(), bg.numpy())
    np.testing.assert_array_equal(res["depth_fine"].numpy(),
                                  np.full(n, 10.0, np.float32))
    for k in res:
        np.testing.assert_array_equal(res[k].numpy(), np.asarray(want[k]))


def test_masked_render_fused_equals_loop(pair):
    jt, pt, _ = pair
    rays_t = pt.tighten_rays(pt.val_dataset.frame_rays(0), 0)
    keep = pt.occ_keep_mask()
    assert 0 < int(keep.sum()) < SIZE * SIZE
    bg = torch.full((SIZE * SIZE, 3), 0.3)
    rng = np.random.default_rng(7)
    for mask in (keep, torch.from_numpy(rng.random(SIZE * SIZE) < 0.3)):
        with model_keys(pt, masked_render="loop"):
            a = pt.render_masked_image(rays_t, mask.numpy(), bg,
                                       pt.rcfg_test, anneal=pt.anneal())
        b = pt.render_masked_image(rays_t, mask, bg, pt.rcfg_test,
                                   anneal=pt.anneal(),
                                   count=int(mask.sum()))
        want = jt.render_masked_image(
            jnp.asarray(rays_t.numpy()), mask.numpy(),
            jnp.asarray(bg.numpy()), jt.rcfg_test, anneal=jt.anneal(),
            count=int(mask.sum()))
        assert set(a) == set(b) == set(want)
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(),
                                          err_msg=k)
        np.testing.assert_allclose(b["rgb_fine"].numpy(),
                                   np.asarray(want["rgb_fine"]), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("impl", ["auto", "host"])
def test_tighten_rays_equals_jax(pair, impl):
    """The trainer's grid (the auto extent, the device builder) and
    tightening against JAX's: the empty mask equal, near / far within
    2e-5, the rest of the rays untouched; the host path bit for bit on the
    port's own grid."""
    jt, pt, _ = pair
    with model_keys(jt, pt, occ_impl=impl):
        for frame in (0, 2):
            rays = pt.val_dataset.frame_rays(frame)
            got = pt.tighten_rays(rays, frame).numpy()
            keep = pt.occ_keep_mask().numpy()
            jrays, _ = jt.val_dataset.frame_rays(frame)
            want = np.asarray(jt.tighten_rays(jrays, frame))
            np.testing.assert_array_equal(keep,
                                          np.asarray(jt.occ_keep_mask()))
            assert 0 < keep.sum() < keep.size
            np.testing.assert_allclose(got[:, 6:8], want[:, 6:8], rtol=0,
                                       atol=2e-5)
            np.testing.assert_array_equal(got[:, :6], rays.numpy()[:, :6])
            if impl == "host":
                grid = pt.occupancy_grid(frame)
                ref, _ = occ.tighten_ray_bounds(grid, rays.numpy(),
                                                (SIZE, SIZE))
                np.testing.assert_array_equal(got, ref)


def test_skip_without_tighten_keeps_exact_sampling(pair):
    _, pt, _ = pair
    rays = pt.val_dataset.frame_rays(0)
    bg = torch.full((SIZE * SIZE, 3), 0.4)
    with model_keys(pt, occ_tighten=0):
        rays_t = pt.tighten_rays(rays, 0)
        np.testing.assert_array_equal(rays_t.numpy(), rays.numpy())
        keep = pt.occ_keep_mask().numpy()
        out = pt.commit_view(pt.prepare_view(rays, 0), bg, pt.rcfg_test,
                             anneal=pt.anneal())
    pt.tighten_rays(rays, 0)
    np.testing.assert_array_equal(pt.occ_keep_mask().numpy(), keep)
    with torch.no_grad():
        exact = pt.render_rays_chunked(rays, bg, pt.rcfg_test,
                                       anneal=pt.anneal())
    np.testing.assert_array_equal(out["rgb_fine"].numpy()[keep],
                                  exact["rgb_fine"].numpy()[keep])
    fg = out["opacity_fine"].numpy() > 0
    np.testing.assert_array_equal(out["depth_fine"].numpy()[keep & fg],
                                  exact["depth_fine"].numpy()[keep & fg])
    np.testing.assert_array_equal(out["rgb_fine"].numpy()[~keep],
                                  bg.numpy()[~keep])


def test_evaluate_sequence_tightens_as_jax(pair):
    jt, pt, _ = pair
    got = pt.evaluate_sequence(max_frames=2)
    want = jt.evaluate_sequence(max_frames=2)
    assert got["frames"] == want["frames"] == 2
    for k in ("psnr", "ssim", "dssim"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_scaled_frame_through_the_view_path(pair):
    jt, pt, _ = pair
    ds = pt.val_dataset
    rays = ds.frame_rays_scaled(0, 2)
    jrays, jmask = jt.val_dataset.frame_rays_scaled(0, 2)
    assert rays.shape == (4 * SIZE * SIZE, 9)
    np.testing.assert_allclose(rays.numpy(), np.asarray(jrays), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(ds.frame_mask(0, scale=2),
                                  np.asarray(jmask))
    assert ds.frame_rays_scaled(1, 2).shape == rays.shape   # cached camera
    outs = list(pt.render_views_pipelined(
        [(rays, 0, torch.ones((rays.shape[0], 3)))], pt.rcfg_test,
        anneal=pt.anneal()))
    assert outs[0]["rgb_fine"].shape == (4 * SIZE * SIZE, 3)
    assert torch.isfinite(outs[0]["rgb_fine"]).all()
    assert pt._occ_stats["coarse"] >= 1
    with pytest.raises(ValueError, match="cannot infer"):
        pt._infer_view_size(SIZE * SIZE + 7)
