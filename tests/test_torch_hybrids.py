"""The hybrid routes (``mlp_impl: fused_nof`` / ``fused_nerf``) and sigma
noise of the port's ``render_rays`` against the JAX package.

- The training branch with the NoF under each hybrid (the kernels' plain
  versions here: ``fused_nof`` the NoF warps on #3 and the chains on #5/#6
  with the NeRF on #8; ``fused_nerf`` the NeRF on #1/#2 with the NoF on
  #9) against ``jax.value_and_grad`` of JAX's ``render_rays(...,
  mlp_impl="xla")`` with injected draws: the chains off without noise, and
  both chains on with sigma noise (JAX's normals of ``k_noise_c`` /
  ``k_noise_f`` handed to the port's ``Draws``); every output, and the
  gradients of a loss over the rgb, the depth and every consensus term.
  The ``fused`` route's transposed training branch takes the noise too.
- The test-time render under each hybrid against JAX's test-time render
  on the ``xla`` route (no #7 on either hybrid).

Tolerances (fp32): outputs 1e-5 of the larger of 1 and each array's
largest magnitude, gradients 1e-5 of each network's largest gradient, as
``tests/test_torch_pallas_train.py`` (the two sides sum the same fp32
products in other orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu.nn.nerf import NeRFConfig as JNeRFConfig, init_nerf
from moco_flow_tpu.nn.nof import NoFConfig as JNoFConfig, init_nof
from moco_flow_tpu.render import volume as jvol
from moco_flow_tpu.train.checkpoint import _flatten as j_flatten
from moco_flow_tpu_torch.data.draws import Draws
from moco_flow_tpu_torch.nn.nerf import NeRFConfig
from moco_flow_tpu_torch.nn.nof import NoFConfig
from moco_flow_tpu_torch.render import volume as tvol
from moco_flow_tpu_torch.train.checkpoint import _flatten, params_from_jax

TOL = 1e-5
N_RAYS, N_SAMPLES, N_IMPORTANCE = 11, 8, 8
NERF = dict(depth=4, width=32, in_channels_xyz=27, skips=(2,),
            extra_feat_type="ind", extra_feat_dim=5)
NOF = dict(depth=4, width=32, in_channels_xyz=21, skips=(2,),
           extra_feat_dim=33, use_quat=True)
ANNEAL = {"nerf_xyz": np.array([1.0, 1.0, 0.7, 0.2], np.float32),
          "nof_xyz": np.array([1.0, 0.6, 0.0], np.float32)}


def _statics(mod, nerf_cls, nof_cls):
    e = mod.EmbeddingSpec
    return mod.ModelStatics(
        coarse=nerf_cls(**NERF), fine=nerf_cls(**NERF), nof=nof_cls(**NOF),
        nerf_xyz=e(4), nerf_ind=e(2, in_channels=1), nof_xyz=e(3),
        nof_ind=e(16, in_channels=1))


@pytest.fixture(scope="module")
def params():
    """Sharpened sigma heads and NoF heads scaled up (the warps move points
    off the identity)."""
    k = jax.random.split(jax.random.key(23), 4)
    p = {"coarse_NeRF": init_nerf(k[0], JNeRFConfig(**NERF)),
         "fine_NeRF": init_nerf(k[1], JNeRFConfig(**NERF)),
         "bw_NoF": init_nof(k[2], JNoFConfig(**NOF)),
         "fw_NoF": init_nof(k[3], JNoFConfig(**NOF))}
    for net in ("coarse_NeRF", "fine_NeRF"):
        head = p[net]["sigma"]
        p[net]["sigma"] = {"w": head["w"] * 10.0,
                           "b": jnp.full_like(head["b"], 0.3)}
    for net in ("bw_NoF", "fw_NoF"):
        p[net]["head"]["w"] = p[net]["head"]["w"] * 2.0
    return p


def _rays(seed: int):
    rng = np.random.default_rng(seed)
    n = N_RAYS
    o = np.array([0.0, 0.0, 4.0]) + 0.05 * rng.normal(size=(n, 3))
    d = rng.normal(size=(n, 3))
    d[:, 2] = -np.abs(d[:, 2]) - 3.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    near, far = np.full((n, 1), 2.5), np.full((n, 1), 5.5)
    ind = rng.uniform(-1, 1, (n, 1))
    chained = np.full((n, 1), rng.uniform(-1, 1))
    rays = np.concatenate([o, d, near, far, ind, chained],
                          -1).astype(np.float32)
    bg = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    target = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return rays, bg, target


def _loss(res, target, sum_fn):
    out = sum_fn((res["rgb_fine"] - target) ** 2) \
        + sum_fn((res["rgb_coarse"] - target) ** 2) \
        + 0.1 * sum_fn(res["depth_fine"])
    for k, v in res.items():
        if k.startswith("nof_"):
            out = out + v
    return out


def _close(got, want, scale, what):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: max|diff| {err:.3e} > " \
                               f"{TOL * scale:.3e}"


def jax_draws(key, n: int, s: int, i: int, noise: bool) -> Draws:
    """The uniforms and normals JAX's ``render_rays`` derives from ``key``
    as a port ``Draws``."""
    k_perturb, k_noise_c, k_pdf, k_noise_f = jax.random.split(key, 4)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    extra = {}
    if noise:
        extra = {"sigma_noise_coarse": t(jax.random.normal(k_noise_c,
                                                           (n, s))),
                 "sigma_noise_fine": t(jax.random.normal(k_noise_f,
                                                         (n, s + i)))}
    return Draws(frame=0, pixels=torch.zeros(n, dtype=torch.long),
                 background=torch.zeros(1, 3), chained=None,
                 perturb=t(jax.random.uniform(k_perturb, (n, s))),
                 pdf=t(jax.random.uniform(k_pdf, (n, i))), **extra)


@pytest.mark.parametrize("impl,chains,noise", [
    ("fused_nof", False, 0.0), ("fused_nof", True, 1.0),
    ("fused_nerf", False, 0.0), ("fused_nerf", True, 1.0),
    ("fused", True, 1.0)],
    ids=["fused_nof-off", "fused_nof-chains-noise", "fused_nerf-off",
         "fused_nerf-chains-noise", "fused-chains-noise"])
def test_hybrid_training_render_matches_jax(params, impl, chains, noise):
    rays, bg, target = _rays(5)
    key = jax.random.key(19)
    kw = dict(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, perturb=1.0,
              use_nof=True, chain_local=chains, chain_global=chains,
              noise_std=noise)
    statics = _statics(jvol, JNeRFConfig, JNoFConfig)
    ja = {k: jnp.asarray(v) for k, v in ANNEAL.items()}

    @jax.jit
    def jfn(p):
        def loss(p):
            res = jvol.render_rays(p, statics, ja, jnp.asarray(rays),
                                   jnp.asarray(bg), key,
                                   jvol.RenderConfig(mlp_impl="xla", **kw))
            return _loss(res, target, jnp.mean), res
        return jax.value_and_grad(loss, has_aux=True)(p)

    (_, jres), jgrads = jfn(params)
    p = params_from_jax(params)
    leaves = _flatten(p, leaf=lambda t: t)
    for t in leaves.values():
        t.requires_grad_(True)
    res = tvol.render_rays(
        p, _statics(tvol, NeRFConfig, NoFConfig),
        {k: torch.from_numpy(v) for k, v in ANNEAL.items()},
        torch.from_numpy(rays), torch.from_numpy(bg),
        tvol.RenderConfig(mlp_impl=impl, **kw),
        draws=jax_draws(key, N_RAYS, N_SAMPLES, N_IMPORTANCE, noise > 0))
    _loss(res, torch.from_numpy(target), torch.mean).backward()
    assert set(res) == set(jres)
    for k, v in jres.items():
        want = np.asarray(v)
        _close(res[k], want, max(float(np.abs(want).max()), 1.0), k)
    want = {k: np.asarray(v) for k, v in j_flatten(jgrads).items()}
    assert set(want) == set(leaves)
    for net in ("coarse_NeRF", "fine_NeRF", "bw_NoF", "fw_NoF"):
        keys = [k for k in want if k.startswith(net)]
        scale = max(float(np.abs(want[k]).max()) for k in keys)
        if net == "fw_NoF" and not chains:
            assert scale == 0.0                 # no chain reaches fw
        for k in keys:
            got = leaves[k].grad
            if scale == 0.0:
                assert got is None or not got.abs().max(), k
                continue
            assert got is not None, k
            _close(got, want[k], scale, f"d{k}")


@pytest.mark.parametrize("impl", ["fused_nof", "fused_nerf"])
def test_hybrid_test_render_matches_jax(params, impl):
    """The test-time render (sigma-only coarse pass, deterministic
    importance depths, the bw warp of each sample set) under each hybrid
    against JAX's on the ``xla`` route."""
    rays, bg, _ = _rays(7)
    kw = dict(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, perturb=0.0,
              use_nof=True, test_time=True)
    jres = jvol.render_rays(params, _statics(jvol, JNeRFConfig, JNoFConfig),
                            {k: jnp.asarray(v) for k, v in ANNEAL.items()},
                            jnp.asarray(rays[:, :9]), jnp.asarray(bg),
                            jax.random.key(0),
                            jvol.RenderConfig(mlp_impl="xla", **kw))
    with torch.no_grad():
        res = tvol.render_rays(
            params_from_jax(params), _statics(tvol, NeRFConfig, NoFConfig),
            {k: torch.from_numpy(v) for k, v in ANNEAL.items()},
            torch.from_numpy(rays[:, :9]), torch.from_numpy(bg),
            tvol.RenderConfig(mlp_impl=impl, **kw))
    assert set(res) == set(jres)
    for k, v in jres.items():
        want = np.asarray(v)
        _close(res[k], want, max(float(np.abs(want).max()), 1.0), k)
