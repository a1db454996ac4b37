"""The port's training render and its cv2-free valid-pixel mask against the
JAX package.

``render_rays``' training branch (the transposed path with the warp chain)
runs in both packages on the same parameters, rays and random numbers: JAX
derives its depth jitter and importance uniforms from a key inside
``render_rays``; the test recomputes them from that key the same way and
hands them to the port in a ``Draws`` record. JAX runs ``mlp_impl: fused``
(its NeRF and warp-chain Pallas kernels interpreted on the CPU), the port
the plain versions of its kernels. Compared: every per-ray output, the four
consensus scalars, and the gradients of the image loss plus the weighted
consensus terms w.r.t. every parameter, with ``share_coarse_warps`` on
(warp only the new fine samples and depth-merge) and off (re-warp the
sorted union).

Widths: NeRF 4x32 (skip 2, 4 PE frequencies, 5-dim frame feature), NoF 4x32
(skip 2, 3 frequencies, 33-dim frame embedding, quaternion head), 13 rays
x (8 + 8) samples, PE annealing below one. Tolerance (fp32), relative to
each array's largest magnitude: 1e-5 (both sides sum in fp32 in other
orders).

The mask: ``geometry.camera.valid_rays_mask`` fills the convex hull of the
projected AABB corners without cv2 (a monotone-chain hull and a scanline
fill that reproduces ``cv2.fillConvexPoly``'s coverage). It must equal the
cv2 mask exactly, pixel for pixel, on the synthetic scene's cameras and on
random hulls that reach past the image.
"""

import numpy as np
import pytest
import torch

import cv2
import jax
import jax.numpy as jnp

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu.nn.nerf import NeRFConfig as JNeRFConfig, init_nerf
from moco_flow_tpu.nn.nof import NoFConfig as JNoFConfig, init_nof
from moco_flow_tpu.render import volume as jvol
from moco_flow_tpu.train.checkpoint import _flatten as j_flatten
from moco_flow_tpu_torch.data.draws import Draws
from moco_flow_tpu_torch.geometry.camera import (convex_hull, fill_convex,
                                                 valid_rays_mask)
from moco_flow_tpu_torch.nn.nerf import NeRFConfig
from moco_flow_tpu_torch.nn.nof import NoFConfig
from moco_flow_tpu_torch.render import volume as tvol
from moco_flow_tpu_torch.train.checkpoint import _flatten, params_from_jax

NERF = dict(depth=4, width=32, in_channels_xyz=27, skips=(2,),
            extra_feat_type="ind", extra_feat_dim=5)
NOF = dict(depth=4, width=32, in_channels_xyz=21, skips=(2,),
           extra_feat_dim=33, use_quat=True)
N_RAYS, N_SAMPLES, N_IMPORTANCE = 13, 8, 8
TOL = 1e-5
CONSENSUS = ("nof_local_disp_coarse", "nof_local_disp_fine",
             "nof_global_disp_coarse", "nof_global_disp_fine")
LOSS_W = 0.2


def _statics(mod, nerf_cls, nof_cls):
    e = mod.EmbeddingSpec
    return mod.ModelStatics(
        coarse=nerf_cls(**NERF), fine=nerf_cls(**NERF), nof=nof_cls(**NOF),
        nerf_xyz=e(4), nerf_ind=e(2, in_channels=1), nof_xyz=e(3),
        nof_ind=e(16, in_channels=1))


@pytest.fixture(scope="module")
def setup():
    k = jax.random.split(jax.random.key(5), 4)
    params = {"coarse_NeRF": init_nerf(k[0], JNeRFConfig(**NERF)),
              "fine_NeRF": init_nerf(k[1], JNeRFConfig(**NERF)),
              "bw_NoF": init_nof(k[2], JNoFConfig(**NOF)),
              "fw_NoF": init_nof(k[3], JNoFConfig(**NOF))}
    for net in ("coarse_NeRF", "fine_NeRF"):
        # sharpened sigma heads: some rays stop, others pass, so the
        # consensus masks (alpha >= 0.01) and the weights matter
        head = params[net]["sigma"]
        params[net]["sigma"] = {"w": head["w"] * 10.0,
                                "b": jnp.full_like(head["b"], 0.3)}
    rng = np.random.default_rng(4)
    n = N_RAYS
    o = np.array([0.0, 0.0, 4.0]) + 0.05 * rng.normal(size=(n, 3))
    d = rng.normal(size=(n, 3))
    d[:, 2] = -np.abs(d[:, 2]) - 3.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    near, far = np.full((n, 1), 2.5), np.full((n, 1), 5.5)
    ind = rng.uniform(-1, 1, (n, 1))
    chained = np.full((n, 1), rng.uniform(-1, 1))
    rays = np.concatenate([o, d, near, far, ind, chained], -1).astype(
        np.float32)
    bg = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    target = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    anneal = {"nerf_xyz": np.array([1.0, 1.0, 0.7, 0.2], np.float32),
              "nof_xyz": np.array([1.0, 0.6, 0.0], np.float32)}
    key = jax.random.key(11)
    k_perturb, _, k_pdf, _ = jax.random.split(key, 4)
    draws = Draws(
        frame=0, pixels=torch.zeros(n, dtype=torch.long),
        background=torch.zeros(1, 3), chained=0,
        perturb=torch.from_numpy(np.array(
            jax.random.uniform(k_perturb, (n, N_SAMPLES)))),
        pdf=torch.from_numpy(np.array(
            jax.random.uniform(k_pdf, (n, N_IMPORTANCE)))))
    return params, rays, bg, target, anneal, key, draws


def _loss(res, target, xp):
    img = sum(xp.mean((res[k] - target) ** 2)
              for k in ("rgb_coarse", "rgb_fine"))
    return img + LOSS_W * sum(res[k] for k in CONSENSUS)


def _jax(setup, share):
    params, rays, bg, target, anneal, key, _ = setup
    rcfg = jvol.RenderConfig(
        n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, perturb=1.0,
        use_nof=True, chain_local=True, chain_global=True, mlp_impl="fused",
        share_coarse_warps=share)
    statics = _statics(jvol, JNeRFConfig, JNoFConfig)
    ann = {k: jnp.asarray(v) for k, v in anneal.items()}

    def loss(p):
        res = jvol.render_rays(p, statics, ann, jnp.asarray(rays),
                               jnp.asarray(bg), key, rcfg)
        return _loss(res, jnp.asarray(target), jnp), res

    (_, res), grads = jax.value_and_grad(loss, has_aux=True)(params)
    out = {f"out/{k}": np.asarray(v) for k, v in res.items()}
    out.update({f"grad/{k}": np.asarray(v)
                for k, v in j_flatten(grads).items()})
    return out


def _port(setup, share):
    params, rays, bg, target, anneal, _, draws = setup
    rcfg = tvol.RenderConfig(
        n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, perturb=1.0,
        use_nof=True, chain_local=True, chain_global=True,
        share_coarse_warps=share)
    statics = _statics(tvol, NeRFConfig, NoFConfig)
    p = params_from_jax(params)
    leaves = _flatten(p, leaf=lambda t: t)
    for t in leaves.values():
        t.requires_grad_(True)
    res = tvol.render_rays(p, statics,
                           {k: torch.from_numpy(v) for k, v in anneal.items()},
                           torch.from_numpy(rays), torch.from_numpy(bg), rcfg,
                           draws=draws)
    _loss(res, torch.from_numpy(target), torch).backward()
    out = {f"out/{k}": v.detach().numpy() for k, v in res.items()}
    out.update({f"grad/{k}": (t.grad if t.grad is not None
                              else torch.zeros_like(t)).numpy()
                for k, t in leaves.items()})
    return out


@pytest.fixture(scope="module", params=[True, False],
                ids=["share-coarse-warps", "rewarp-union"])
def both(request, setup):
    return request.param, _jax(setup, request.param), _port(setup,
                                                            request.param)


def _close(got, want, what):
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: max|diff| {err:.3e} > {TOL * scale:.3e}"


def test_outputs_match_jax(both):
    """Per-ray rgb / depth / opacity of both passes, and the consensus
    scalars, which must not be trivial."""
    _, want, got = both
    outs = [k for k in want if k.startswith("out/")]
    assert set(outs) == {k for k in got if k.startswith("out/")}
    for k in outs:
        _close(got[k], want[k], k)
    for k in CONSENSUS:
        assert float(want[f"out/{k}"]) > 1e-4, k
    opacity = want["out/opacity_fine"]
    assert opacity.min() < 0.5 < opacity.max()


def test_gradients_match_jax(both):
    """Gradients of the image + consensus loss w.r.t. every parameter of
    both NeRFs and both NoFs."""
    _, want, got = both
    grads = [k for k in want if k.startswith("grad/")]
    assert set(grads) == {k for k in got if k.startswith("grad/")}
    for net in ("coarse_NeRF", "fine_NeRF", "bw_NoF", "fw_NoF"):
        assert any(np.abs(want[k]).max() > 0 for k in grads
                   if k.startswith(f"grad/{net}/")), net
    for k in grads:
        _close(got[k], want[k], k)


def test_share_coarse_warps_is_the_same_function(setup):
    """Warping only the new samples and merging gives the fine pass of the
    re-warped union (the same samples, the same networks)."""
    on, off = _port(setup, True), _port(setup, False)
    for k in ("out/rgb_fine", "out/depth_fine", "out/opacity_fine"):
        np.testing.assert_allclose(on[k], off[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def _cv2_mask(size, pix):
    mask = np.zeros(tuple(size), np.uint8)
    cv2.fillConvexPoly(mask, cv2.convexHull(pix.astype(np.int32)), 255)
    return mask > 0


@pytest.mark.parametrize("size,focal", [(32, 40.0), (256, 300.0)])
def test_valid_rays_mask_matches_cv2_on_scene_cameras(size, focal):
    """The synthetic scene's camera (``data/synthetic.py``: the fixed
    diag(1, -1, -1, 1) pose, recentred by the body's translation, at the
    fixture's and the benchmark's sizes) looking at AABBs of body size,
    some shifted or large enough to leave the image: the JAX package's cv2
    mask and the port's, pixel for pixel."""
    from moco_flow_tpu.geometry import camera as jcam
    rng = np.random.default_rng(size)
    k_mat = np.array([[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1]])
    c2w4 = np.diag([1.0, -1.0, -1.0, 1.0])
    c2w4[2, 3] -= 4.0
    for trial in range(20):
        half = rng.uniform(0.3, 1.6, 3)
        center = rng.normal(scale=0.3, size=3)
        corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                            for z in (-1, 1)]) * half + center
        want = jcam.valid_rays_mask((size, size), corners, c2w4, k_mat)
        got = valid_rays_mask((size, size), corners, c2w4, k_mat)
        assert want.any()
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")


@pytest.mark.parametrize("seed", range(6))
def test_fill_convex_matches_cv2_on_random_hulls(seed):
    """Random point sets, some reaching past the image edges, some
    degenerate (collinear, a single point)."""
    rng = np.random.default_rng(seed)
    size = (int(rng.integers(20, 60)), int(rng.integers(20, 60)))
    for trial in range(25):
        n = int(rng.integers(1, 9))
        pts = rng.integers(-15, max(size) + 15, (n, 2))
        if trial % 7 == 3:
            pts[:, 1] = pts[0, 1]                       # collinear
        want = _cv2_mask(size, pts)
        got = fill_convex(size, convex_hull(pts))
        np.testing.assert_array_equal(got, want,
                                      err_msg=f"{size} {pts.tolist()}")
