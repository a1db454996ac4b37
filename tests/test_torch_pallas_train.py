"""The stage-3 training step on the per-op route (``mlp_impl: pallas``)
against the JAX package.

- ``render_rays``'s row-major training branch with the NoF (kernels #8 /
  #9 as their plain versions here) against ``jax.value_and_grad`` of JAX's
  ``render_rays(..., mlp_impl="pallas")`` (its Pallas kernels interpreted
  on the CPU, jitted) with injected draws: the chains off, local, global
  and both, ``share_coarse_warps`` on and off; every output and the
  gradients of a loss over the rgb, the depth and every consensus term.
  Each NoF evaluation is one ``nof_fused`` call, whose backward (``_NofFusedVjp``)
  returns gradients for both its PE rows and its base point: in a chain
  fw's input is bw's output, so both paths carry gradient. JAX's fused
  route is no reference here: its backward rounds dz to bf16
  (``ops/megakernel.py:528``).
- A ``none`` and a ``msk`` step of JAX's ``MoCoFlowTrainer`` under
  ``pallas`` (``scripts/make_torch_port_stage2_golden.py``, ``s3/``) replayed
  with JAX's draws, and the val step after the ``msk`` step.

Tolerances (fp32): outputs 1e-5 of the larger of 1 and each array's
largest magnitude (rgb and opacity lie in [0, 1]; a depth sums weights
times depths of 2.5-5.5, and a ray that stops little has a small depth
made of large terms; the consensus terms are distances of order 1);
gradients 1e-5 of each network's largest gradient, as
``test_torch_stage1.py``; step losses,
``train_psnr`` and val metrics 1e-5 relative; parameters 1e-6 absolute
(updates ~1e-4 a step).
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
from moco_flow_tpu_torch.data.synthetic import make_synthetic_scene
from moco_flow_tpu_torch.nn.nerf import NeRFConfig
from moco_flow_tpu_torch.nn.nof import NoFConfig
from moco_flow_tpu_torch.render import volume as tvol
from moco_flow_tpu_torch.train.checkpoint import _flatten, params_from_jax
from scripts import make_torch_port_phases_golden as phases_golden
from scripts.make_torch_port_stage2_golden import (S3_RUNS, load,
                                                   port_stage3_run)
from scripts.make_torch_port_train_golden import SCENE

TOL = 1e-5
N_RAYS, N_SAMPLES, N_IMPORTANCE = 13, 8, 8
NERF = dict(depth=4, width=32, in_channels_xyz=27, skips=(2,),
            extra_feat_type="ind", extra_feat_dim=5)
NOF = dict(depth=4, width=32, in_channels_xyz=21, skips=(2,),
           extra_feat_dim=33, use_quat=True)
CASES = {"off": (False, False), "local": (True, False),
         "global": (False, True), "both": (True, True)}


def _statics(mod, nerf_cls, nof_cls):
    e = mod.EmbeddingSpec
    return mod.ModelStatics(
        coarse=nerf_cls(**NERF), fine=nerf_cls(**NERF), nof=nof_cls(**NOF),
        nerf_xyz=e(4), nerf_ind=e(2, in_channels=1), nof_xyz=e(3),
        nof_ind=e(16, in_channels=1))


@pytest.fixture(scope="module")
def params():
    """Sharpened sigma heads (rays stop at different depths) and NoF heads
    scaled up (the warps move points off the identity)."""
    k = jax.random.split(jax.random.key(21), 4)
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


@pytest.mark.parametrize("share", [True, False],
                         ids=["share-coarse-warps", "rewarp-union"])
@pytest.mark.parametrize("chains", list(CASES))
def test_pallas_training_render_matches_jax(params, chains, share):
    local, glob = CASES[chains]
    rays, bg, target = _rays(5)
    anneal = {"nerf_xyz": np.array([1.0, 1.0, 0.7, 0.2], np.float32),
              "nof_xyz": np.array([1.0, 0.6, 0.0], np.float32)}
    key = jax.random.key(17)
    k_perturb, _, k_pdf, _ = jax.random.split(key, 4)
    kw = dict(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, perturb=1.0,
              use_nof=True, chain_local=local, chain_global=glob,
              share_coarse_warps=share, mlp_impl="pallas")
    statics = _statics(jvol, JNeRFConfig, JNoFConfig)
    ja = {k: jnp.asarray(v) for k, v in anneal.items()}

    @jax.jit
    def jfn(p):
        def loss(p):
            res = jvol.render_rays(p, statics, ja, jnp.asarray(rays),
                                   jnp.asarray(bg), key,
                                   jvol.RenderConfig(**kw))
            return _loss(res, target, jnp.mean), res
        return jax.value_and_grad(loss, has_aux=True)(p)

    (_, jres), jgrads = jfn(params)
    draws = Draws(frame=0, pixels=torch.zeros(N_RAYS, dtype=torch.long),
                  background=torch.zeros(1, 3), chained=None,
                  perturb=torch.from_numpy(np.array(jax.random.uniform(
                      k_perturb, (N_RAYS, N_SAMPLES)))),
                  pdf=torch.from_numpy(np.array(jax.random.uniform(
                      k_pdf, (N_RAYS, N_IMPORTANCE)))))
    p = params_from_jax(params)
    leaves = _flatten(p, leaf=lambda t: t)
    for t in leaves.values():
        t.requires_grad_(True)
    res = tvol.render_rays(p, _statics(tvol, NeRFConfig, NoFConfig),
                           {k: torch.from_numpy(v) for k, v in
                            anneal.items()},
                           torch.from_numpy(rays), torch.from_numpy(bg),
                           tvol.RenderConfig(**kw), draws=draws)
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
        if net == "fw_NoF" and not (local or glob):
            assert scale == 0.0                 # no chain reaches fw
        for k in keys:
            got = leaves[k].grad
            if scale == 0.0:
                assert got is None or not got.abs().max(), k
                continue
            assert got is not None, k
            _close(got, want[k], scale, f"d{k}")


# ---------------------------------------------------------------------------
# JAX's pallas steps, replayed
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stored():
    return load()


@pytest.fixture(scope="module")
def phases():
    return phases_golden.load()


@pytest.fixture(scope="module")
def replay(stored, phases):
    scene = make_synthetic_scene(None, **SCENE)
    return {run: port_stage3_run(stored, phases, run, "cpu",
                                 scene if run == "msk" else None)
            for run in S3_RUNS}


@pytest.mark.parametrize("run", list(S3_RUNS))
def test_pallas_step_losses_match_jax(stored, replay, run):
    got = replay[run][0]
    want = {k[len(f"s3/metrics/{run}/"):]: float(v) for k, v in
            stored.items() if k.startswith(f"s3/metrics/{run}/")}
    assert set(got) == set(want)
    assert ("alphas_mask" in got) == (run == "msk")
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-5 * abs(v), k


@pytest.mark.parametrize("run", list(S3_RUNS))
def test_pallas_step_params_match_jax(stored, replay, run):
    params = _flatten(replay[run][1].params)
    moved = 0.0
    for k, v in params.items():
        want = stored[f"s3/params_{run}/{k}"]
        np.testing.assert_allclose(v, want, rtol=0, atol=1e-6, err_msg=k)
        moved = max(moved, float(np.abs(want
                                        - stored[f"s3/params0/{k}"]).max()))
    assert moved > 1e-5


@pytest.mark.parametrize("name", ["val_psnr", "ssim"])
def test_pallas_val_step_matches_jax(stored, replay, name):
    tr = replay["msk"][1]
    assert tr.clock.step == int(stored["s3/val/step"])
    got = tr.val_step()[name]
    want = float(stored[f"s3/val/{name}"])
    assert abs(got - want) <= 1e-5 * abs(want)
