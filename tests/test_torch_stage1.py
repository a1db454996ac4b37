"""Stage 1 (the canonical NeRF) and the per-op route (``mlp_impl: pallas``)
of the port against the JAX package.

- ``render_rays`` on the per-op route (the row-major branch, kernels #8/#9
  as their plain versions here) against JAX's ``render_rays(...,
  mlp_impl="pallas")`` (its Pallas kernels interpreted on the CPU): the
  stage-1 training render with injected draws (outputs and the gradients
  of the image loss), and the stage-3 test render with the bw warp
  (``share_coarse_warps`` on and off), which must also agree with the
  port's fused test render of the same weights.
- RAdam (``train/optim.py``) against ``make_optimizer({"type": "radam"})``
  over 12 steps on a random pytree, with and without weight decay, across
  a ``steplr`` milestone and the rectification threshold (step 6 is the
  first rectified update); its ``opt_named`` state both ways.
- ``scripts/make_torch_port_stage1_golden.py`` runs JAX's ``NeRFTrainer``
  (``mlp_impl: pallas``, fp32, radam, NeRF 4x32 on ``N_freqs: 0`` padded
  positions and a ``dir`` extra, 32 rays x (8 + 8) samples) for three steps
  and a val step; the port replays them with JAX's draws, resumes JAX's
  checkpoint, and JAX resumes the port's.
- The CLI's dispatch on ``model.type`` and ``render_config``'s routes.
- The stage-3 training render under ``pallas`` against the fused route's,
  and its refusals (the parity with JAX is
  ``tests/test_torch_pallas_train.py``).

Tolerances (fp32): renders and gradients 1e-5 of each array's largest
magnitude (both sides sum in fp32 in other orders); the optimizer 1e-6
absolute (updates ~1e-2 a step); loss, ``train_psnr`` and val metrics 1e-5
relative, parameters 1e-6 absolute (updates ~1e-4 a step; measured max
|diff| 2.3e-10), optimizer state 1e-6 absolute.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu.data.synthetic import make_synthetic_scene as j_scene
from moco_flow_tpu.nn.nerf import NeRFConfig as JNeRFConfig, init_nerf
from moco_flow_tpu.nn.nof import NoFConfig as JNoFConfig, init_nof
from moco_flow_tpu.render import volume as jvol
from moco_flow_tpu.train import optim as joptim
from moco_flow_tpu.train.checkpoint import _flatten as j_flatten
from moco_flow_tpu_torch.data.draws import Draws
from moco_flow_tpu_torch.data.synthetic import make_synthetic_scene
from moco_flow_tpu_torch.nn.nerf import NeRFConfig
from moco_flow_tpu_torch.nn.nof import NoFConfig
from moco_flow_tpu_torch.render import volume as tvol
from moco_flow_tpu_torch.train import get_trainer, optim
from moco_flow_tpu_torch.train.__main__ import parse_args, train
from moco_flow_tpu_torch.train.checkpoint import (
    _flatten, _unflatten, load_checkpoint, params_from_jax, save_checkpoint)
from moco_flow_tpu_torch.train.factory import render_config
from moco_flow_tpu_torch.train.stage_mocoflow import MoCoFlowTrainer
from moco_flow_tpu_torch.train.stage_nerf import NeRFTrainer
from moco_flow_tpu_torch.train.stage_nof import NoFTrainer
from scripts.make_torch_port_stage1_golden import (
    CKPT_AFTER, N_STEPS, SCENE, golden_arrays, jax_trainer, load,
    port_draws, port_replay, port_trainer, prefixed, stage1_config)

TOL = 1e-5
N_RAYS, N_SAMPLES, N_IMPORTANCE = 13, 8, 8
S1_NERF = dict(depth=4, width=32, in_channels_xyz=15, skips=(2,),
               extra_feat_type="dir", extra_feat_dim=27)
S3_NERF = dict(depth=4, width=32, in_channels_xyz=27, skips=(2,),
               extra_feat_type="ind", extra_feat_dim=5)
S3_NOF = dict(depth=4, width=32, in_channels_xyz=21, skips=(2,),
              extra_feat_dim=33, use_quat=True)
METRICS = ("img_loss", "train_psnr")


def _close(got, want, what):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: max|diff| {err:.3e} > {TOL * scale:.3e}"


def _rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


def _rays(seed: int):
    rng = np.random.default_rng(seed)
    n = N_RAYS
    o = np.array([0.0, 0.0, 4.0]) + 0.05 * rng.normal(size=(n, 3))
    d = rng.normal(size=(n, 3))
    d[:, 2] = -np.abs(d[:, 2]) - 3.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    near, far = np.full((n, 1), 2.5), np.full((n, 1), 5.5)
    ind = rng.uniform(-1, 1, (n, 1))
    rays = np.concatenate([o, d, near, far, ind], -1).astype(np.float32)
    bg = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    target = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return rays, bg, target


def _sharpen(params: dict) -> dict:
    """Sigma heads that stop some rays and pass others."""
    for net in ("coarse_NeRF", "fine_NeRF"):
        head = params[net]["sigma"]
        params[net]["sigma"] = {"w": head["w"] * 10.0,
                                "b": jnp.full_like(head["b"], 0.3)}
    return params


# ---------------------------------------------------------------------------
# The per-op route of render_rays
# ---------------------------------------------------------------------------

def _s1_statics(mod, cls):
    e = mod.EmbeddingSpec
    return mod.ModelStatics(coarse=cls(**S1_NERF), fine=cls(**S1_NERF),
                            nerf_xyz=e(0), nerf_dir=e(4))


@pytest.fixture(scope="module")
def stage1_render():
    """JAX's and the port's stage-1 training render (perturbed, softplus,
    injected draws) and the gradients of the image loss."""
    k = jax.random.split(jax.random.key(7), 2)
    params = _sharpen({"coarse_NeRF": init_nerf(k[0], JNeRFConfig(**S1_NERF)),
                       "fine_NeRF": init_nerf(k[1], JNeRFConfig(**S1_NERF))})
    rays, bg, target = _rays(8)
    key = jax.random.key(12)
    k_perturb, _, k_pdf, _ = jax.random.split(key, 4)
    draws = Draws(frame=0, pixels=torch.zeros(N_RAYS, dtype=torch.long),
                  background=torch.zeros(1, 3), chained=None,
                  perturb=torch.from_numpy(np.array(jax.random.uniform(
                      k_perturb, (N_RAYS, N_SAMPLES)))),
                  pdf=torch.from_numpy(np.array(jax.random.uniform(
                      k_pdf, (N_RAYS, N_IMPORTANCE)))))
    kw = dict(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, perturb=1.0,
              activation="softplus", mlp_impl="pallas")

    def jloss(p):
        res = jvol.render_rays(p, _s1_statics(jvol, JNeRFConfig), {},
                               jnp.asarray(rays), jnp.asarray(bg), key,
                               jvol.RenderConfig(**kw))
        return sum(jnp.mean((res[k] - target) ** 2)
                   for k in ("rgb_coarse", "rgb_fine")), res

    (_, jres), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    p = params_from_jax(params)
    leaves = _flatten(p, leaf=lambda t: t)
    for t in leaves.values():
        t.requires_grad_(True)
    res = tvol.render_rays(p, _s1_statics(tvol, NeRFConfig), {},
                           torch.from_numpy(rays), torch.from_numpy(bg),
                           tvol.RenderConfig(**kw), draws=draws)
    sum(torch.mean((res[k] - torch.from_numpy(target)) ** 2)
        for k in ("rgb_coarse", "rgb_fine")).backward()
    return jres, jgrads, res, leaves


def test_stage1_render_matches_jax(stage1_render):
    jres, _, res, _ = stage1_render
    assert set(res) == set(jres)
    for k, v in jres.items():
        _close(res[k], np.asarray(v), k)
    # softplus keeps every ray opaque (the last sample's delta is 1e10):
    # the sharpened field must still stop rays at different depths
    assert np.ptp(np.asarray(jres["depth_fine"])) > 0.05


def test_stage1_render_gradients_match_jax(stage1_render):
    """Each gradient within 1e-5 of its network's largest gradient: the
    density's gradients cancel to a small part of their terms (the coarse
    sigma head's to ~1e-4 of the network's scale), and fp32's rounding of
    another summation order is relative to the terms, not to the sum."""
    _, jgrads, _, leaves = stage1_render
    want = {k: np.asarray(v) for k, v in j_flatten(jgrads).items()}
    assert set(want) == set(leaves)
    for net in ("coarse_NeRF", "fine_NeRF"):
        keys = [k for k in want if k.startswith(net)]
        scale = max(float(np.abs(want[k]).max()) for k in keys)
        for k in keys:
            got = leaves[k].grad
            assert got is not None, k
            err = float(np.abs(got.numpy() - want[k]).max())
            assert err <= TOL * scale, f"{k}: max|diff| {err:.3e}"


def _s3_statics(mod, nerf_cls, nof_cls):
    e = mod.EmbeddingSpec
    return mod.ModelStatics(
        coarse=nerf_cls(**S3_NERF), fine=nerf_cls(**S3_NERF),
        nof=nof_cls(**S3_NOF), nerf_xyz=e(4), nerf_ind=e(2, in_channels=1),
        nof_xyz=e(3), nof_ind=e(16, in_channels=1))


@pytest.fixture(scope="module")
def stage3_params():
    k = jax.random.split(jax.random.key(9), 3)
    params = {"coarse_NeRF": init_nerf(k[0], JNeRFConfig(**S3_NERF)),
              "fine_NeRF": init_nerf(k[1], JNeRFConfig(**S3_NERF)),
              "bw_NoF": init_nof(k[2], JNoFConfig(**S3_NOF))}
    params = _sharpen(params)
    params["bw_NoF"]["head"]["w"] = params["bw_NoF"]["head"]["w"] * 4.0
    return params


@pytest.mark.parametrize("share", [True, False],
                         ids=["share-coarse-warps", "rewarp-union"])
def test_stage3_test_render_matches_jax(stage3_params, share):
    """The stage-3 test render under mlp_impl: pallas: the bw warp of each
    sample set (#9), the sigma-only coarse pass and the full fine pass
    (#8), against JAX; and against the port's fused test render (#7's
    plain version) of the same weights."""
    rays, bg, _ = _rays(10)
    anneal = {"nerf_xyz": np.array([1.0, 1.0, 0.7, 0.2], np.float32),
              "nof_xyz": np.array([1.0, 0.6, 0.0], np.float32)}
    kw = dict(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, use_nof=True,
              test_time=True, share_coarse_warps=share)
    jres = jvol.render_rays(
        stage3_params, _s3_statics(jvol, JNeRFConfig, JNoFConfig),
        {k: jnp.asarray(v) for k, v in anneal.items()}, jnp.asarray(rays),
        jnp.asarray(bg), jax.random.key(0),
        jvol.RenderConfig(mlp_impl="pallas", **kw))
    p = params_from_jax(stage3_params)
    args = (p, _s3_statics(tvol, NeRFConfig, NoFConfig),
            {k: torch.from_numpy(v) for k, v in anneal.items()},
            torch.from_numpy(rays), torch.from_numpy(bg))
    res = tvol.render_rays(*args, tvol.RenderConfig(mlp_impl="pallas", **kw))
    fused = tvol.render_rays(*args, tvol.RenderConfig(mlp_impl="fused", **kw))
    assert set(res) == set(jres) == set(fused)
    for k, v in jres.items():
        _close(res[k], np.asarray(v), k)
        _close(res[k], fused[k].numpy(), f"{k} vs the fused route")


def test_per_op_training_with_the_nof_raises(stage3_params):
    """The stage-3 training render under pallas runs (its parity with JAX
    is ``tests/test_torch_pallas_train.py``'s): with the bw warp only it
    matches the fused route's training render of the same weights and
    depths; with ``noise_std > 0`` it needs the Draws' sigma noise; and it
    refuses the test-time fine budget / coarse probe."""
    rays, bg, _ = _rays(11)
    p = params_from_jax(stage3_params)
    statics = _s3_statics(tvol, NeRFConfig, NoFConfig)
    kw = dict(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, use_nof=True)
    args = (p, statics, {}, torch.from_numpy(rays), torch.from_numpy(bg))
    res = tvol.render_rays(*args, tvol.RenderConfig(mlp_impl="pallas", **kw))
    fused = tvol.render_rays(*args, tvol.RenderConfig(mlp_impl="fused", **kw))
    assert set(res) == set(fused)
    for k, v in fused.items():
        _close(res[k], v.numpy(), f"{k} vs the fused route")
    draws = Draws(frame=0, pixels=torch.zeros(N_RAYS, dtype=torch.long),
                  background=torch.zeros(1, 3), chained=None,
                  perturb=torch.rand(N_RAYS, N_SAMPLES),
                  pdf=torch.rand(N_RAYS, N_IMPORTANCE))
    with pytest.raises(ValueError, match="sigma noise"):
        tvol.render_rays(*args, tvol.RenderConfig(mlp_impl="pallas",
                                                  noise_std=1.0, **kw),
                         draws=draws)
    with pytest.raises(ValueError, match="fused test-time route"):
        tvol.render_rays(*args, tvol.RenderConfig(mlp_impl="pallas",
                                                  fine_budget=8, **kw))


@pytest.mark.parametrize("impl,route", [("pallas", "pallas"),
                                        ("fused", "fused"), ("xla", "fused"),
                                        ("auto", "fused"), (None, "fused"),
                                        ("fused_nof", "fused_nof"),
                                        ("fused_nerf", "fused_nerf")])
def test_render_config_routes(impl, route):
    model = {} if impl is None else {"mlp_impl": impl}
    assert render_config(model).mlp_impl == route
    assert render_config(model, test_time=True).mlp_impl == route


def test_render_config_refuses_what_it_cannot_run():
    for impl in ("fused_nof", "fused_nerf"):
        with pytest.raises(ValueError, match="fused test-time route"):
            render_config({"mlp_impl": impl, "fine_budget": 24},
                          test_time=True)
    with pytest.raises(ValueError, match="unknown"):
        render_config({"mlp_impl": "triton"})
    model = {"mlp_impl": "pallas", "fine_budget": 24, "coarse_probe": 8}
    assert render_config(model).fine_budget == 0       # training: ignored
    with pytest.raises(ValueError, match="fused test-time route"):
        render_config(model, test_time=True)
    assert render_config(dict(model, mlp_impl="fused"),
                         test_time=True).fine_budget == 24


# ---------------------------------------------------------------------------
# RAdam
# ---------------------------------------------------------------------------

def _tree(rng):
    return {"a": {"w": rng.normal(size=(5, 4)).astype(np.float32),
                  "b": rng.normal(size=(4,)).astype(np.float32)},
            "c": [rng.normal(size=(3,)).astype(np.float32)]}


@pytest.mark.parametrize("wd", [0.0, 1e-2], ids=["no-decay", "decay"])
def test_radam_matches_optax(wd):
    """12 steps of the port's RAdam against the JAX package's chain on the
    same gradients (with a zero gradient at step 3 and a steplr milestone
    at update 8), parameters after every step; then the state in
    ``opt_named`` form, and a port optimizer restored from JAX's state
    mid-run continues as JAX does."""
    rng = np.random.default_rng(1)
    params0 = _tree(rng)
    grads = [_tree(rng) for _ in range(12)]
    grads[3] = jax.tree.map(np.zeros_like, grads[3])
    ocfg = {"type": "radam", "lr": 1e-2, "weight_decay": wd}
    scfg = {"type": "steplr", "decay_step": [8], "decay_gamma": 0.5}
    jopt = joptim.make_optimizer(ocfg, scfg)
    jp = jax.tree.map(jnp.asarray, params0)
    jstate = jopt.init(jp)
    names = list(_flatten(params0))
    tp = [torch.from_numpy(v.copy()) for v in _flatten(params0).values()]
    topt = optim.make_optimizer(tp, ocfg, scfg, names=names)
    assert isinstance(topt, optim.ScheduledRAdam)
    mid = None
    for i, g in enumerate(grads):
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        gd = _flatten(g)
        for name, t in zip(names, tp):
            t.grad = torch.from_numpy(gd[name])
        topt.step()
        got = dict(zip(names, tp))
        for k, want in j_flatten(jp).items():
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want),
                                       rtol=0, atol=1e-6,
                                       err_msg=f"step {i} {k}")
        if i == 5:
            mid = ({jax.tree_util.keystr(p): np.asarray(v) for p, v in
                    jax.tree_util.tree_flatten_with_path(jstate)[0]},
                   [t.clone() for t in tp])
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jstate)[0]}
    got = topt.state_named("")
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), v, rtol=0, atol=1e-6,
                                   err_msg=k)
    # JAX's state after 6 updates -> a fresh port optimizer -> 6 more
    state6, p6 = mid
    resumed = optim.make_optimizer(p6, ocfg, scfg, names=names)
    resumed.load_named(state6, "")
    assert resumed.count == 6
    for g in grads[6:]:
        gd = _flatten(g)
        for name, t in zip(names, p6):
            t.grad = torch.from_numpy(gd[name])
        resumed.step()
    for got_t, want_t in zip(p6, tp):
        np.testing.assert_allclose(got_t.numpy(), want_t.numpy(), rtol=0,
                                   atol=1e-6)


def test_radam_rectifies_from_step_6():
    """N_sma(5) = 4.98 < 5 <= N_sma(6) at b2 = 0.999 (float32 scalars)."""
    opt = optim.ScheduledRAdam([torch.zeros(1)], lambda c: 1e-3)
    flags = []
    for count in range(1, 9):
        opt.count = count
        flags.append(opt._scalars()[0])
    assert flags == [False] * 5 + [True] * 3


# ---------------------------------------------------------------------------
# The stage-1 fixture: JAX's NeRFTrainer replayed
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stored():
    return load()


@pytest.fixture(scope="module")
def fresh():
    return golden_arrays()


@pytest.fixture(scope="module")
def replay(stored):
    return port_replay(stored, "cpu", make_synthetic_scene(None, **SCENE))


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stage1_scene"))
    return root, j_scene(root, **SCENE)


def test_fixture_still_matches_jax(fresh, stored):
    assert set(fresh) == set(stored)
    for k in fresh:
        if k == "config_json":
            assert str(fresh[k]) == str(stored[k])
        else:
            np.testing.assert_allclose(stored[k], fresh[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)


def test_fixture_steps_are_not_trivial(stored):
    """The loss falls, both NeRFs moved, and the val frame is not blank."""
    losses = [float(stored[f"metrics/{i}/img_loss"]) for i in range(N_STEPS)]
    assert 0.01 < losses[-1] < losses[0] < 1.0
    for net in ("coarse_NeRF", "fine_NeRF"):
        moved = max(float(np.abs(v - stored[f"params{N_STEPS}/{k}"]).max())
                    for k, v in prefixed(stored, "params0").items()
                    if k.startswith(net))
        assert 1e-5 < moved < 1e-2, net
    assert 0 < float(stored["val/val_psnr"]) < 40


@pytest.mark.parametrize("step", range(N_STEPS))
@pytest.mark.parametrize("name", METRICS)
def test_step_metrics_match_jax(stored, replay, step, name):
    got = replay[0][step][name]
    assert _rel(got, float(stored[f"metrics/{step}/{name}"])) <= 1e-5, name


@pytest.mark.parametrize("net", ["coarse_NeRF", "fine_NeRF"])
def test_updated_params_match_jax(stored, replay, net):
    params = _flatten(replay[2].params)
    keys = [k for k in params if k.startswith(f"{net}/")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(params[k], stored[f"params{N_STEPS}/{k}"],
                                   rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["val_psnr", "ssim"])
def test_val_step_matches_jax(stored, replay, name):
    assert _rel(replay[1][name], float(stored[f"val/{name}"])) <= 1e-5


def test_optimizer_state_matches_jax(stored):
    """After two steps the port's checkpointed optimizer state has JAX's
    ``opt_named`` paths and values."""
    _, _, tr = port_replay(stored, "cpu", steps=CKPT_AFTER)
    got = tr._opt_state_named()
    want = prefixed(stored, f"opt{CKPT_AFTER}")
    assert set(got) == set(want)
    assert {"[0].count", "[1].count"} <= set(got)
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), v, rtol=0, atol=1e-6,
                                   err_msg=k)


def test_port_resumes_jax_checkpoint(stored, tmp_path):
    """JAX's parameters and optimizer state after two steps, as a
    checkpoint, resume in the port, whose third step matches JAX's."""
    from moco_flow_tpu.train.checkpoint import save_checkpoint as j_save
    path = str(tmp_path / "jax_ckpt")
    j_save(path, {"params": _unflatten(prefixed(stored,
                                                f"params{CKPT_AFTER}")),
                  "opt_named": prefixed(stored, f"opt{CKPT_AFTER}")},
           extra={"clock": {"epoch": 1, "minibatch": CKPT_AFTER,
                            "step": CKPT_AFTER}})
    tr = port_trainer(stored, "cpu")
    tr.load_ckpt(path + ".npz")
    assert tr.clock.step == CKPT_AFTER
    m = tr.train_step(draws=port_draws(stored, CKPT_AFTER))
    assert tr.opt.count == CKPT_AFTER + 1
    for k, v in m.items():
        assert _rel(float(v), float(stored[f"metrics/{CKPT_AFTER}/{k}"])) \
            <= 1e-5, k
    for k, v in _flatten(tr.params).items():
        np.testing.assert_allclose(v, stored[f"params{N_STEPS}/{k}"], rtol=0,
                                   atol=1e-6, err_msg=k)


def test_jax_resumes_port_checkpoint(stored, scene_dir, tmp_path):
    """The port's checkpoint after two steps resumes in JAX's
    ``NeRFTrainer``, whose third step matches the fixture's."""
    _, _, tr = port_replay(stored, "cpu", steps=CKPT_AFTER)
    tr.job_dir = str(tmp_path)
    path = tr.save_ckpt("port")
    root, smpl = scene_dir
    jt = jax_trainer(stage1_config(root, str(tmp_path / "jlog")), smpl)
    jt.load_ckpt(path + ".npz")
    assert jt.clock.step == CKPT_AFTER
    jt.train_step()
    for k, v in j_flatten(jt.params).items():
        np.testing.assert_allclose(np.asarray(v), stored[f"params{N_STEPS}/{k}"],
                                   rtol=0, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_train_cli_runs_stage1_and_resumes(stored, tmp_path):
    """``train(config, args, scene=...)`` with ``model.type: nerf`` builds a
    ``NeRFTrainer``, trains, checkpoints the clock and RAdam's state, and a
    second run resumes from it."""
    cfg = json.loads(str(stored["config_json"]))
    cfg["save_dir"] = str(tmp_path / "log")
    cfg["trainer"]["num_iters"] = 2
    scene = make_synthetic_scene(None, **SCENE)
    args = parse_args(["-c", "unused", "-n", "job", "--device", "cpu"])
    tr = train(copy.deepcopy(cfg), args, scene=scene)
    assert isinstance(tr, NeRFTrainer) and tr.clock.step == 2
    assert all(np.isfinite(float(v)) for v in tr.losses.values())
    tree, extra = load_checkpoint(os.path.join(tr.job_dir, "ckpts", "final"))
    assert extra["clock"]["step"] == 2
    assert int(tree["opt_named"]["[0].count"]) == 2
    assert int(tree["opt_named"]["[1].count"]) == 2
    cfg["trainer"]["num_iters"] = 3
    args = parse_args(["-c", "unused", "-n", "job2", "--device", "cpu"])
    tr2 = train(cfg, args, scene=scene)
    assert tr2.clock.step == 3 and tr2.opt.count == 3


def test_get_trainer_dispatches_on_model_type(stored):
    cfg = json.loads(str(stored["config_json"]))
    assert type(get_trainer(cfg, device="cpu")) is NeRFTrainer
    assert type(get_trainer(dict(cfg, model={"type": "moco_flow"}),
                            device="cpu")) is MoCoFlowTrainer
    assert type(get_trainer(dict(cfg, model={"type": "nof"}),
                            device="cpu")) is NoFTrainer
    with pytest.raises(ValueError, match="not found"):
        get_trainer(dict(cfg, model={"type": "gan"}))


def test_test_cli_renders_on_the_per_op_route(tmp_path):
    """``test(config, args)`` with a stage-3 config under ``mlp_impl:
    pallas`` renders through the per-op route and scores like the fused
    route on the same weights; ``--fine_budget`` / ``--coarse_probe`` with
    it raise, as in JAX."""
    from moco_flow_tpu_torch.test import parse_args as test_args
    from moco_flow_tpu_torch.test import test as run_test
    from scripts.make_torch_port_train_golden import train_config
    scene = make_synthetic_scene(None, **SCENE)
    metrics = {}
    for impl in ("pallas", "fused"):
        cfg = train_config(None, str(tmp_path / "log"))
        cfg["model"]["mlp_impl"] = impl
        args = test_args(["-c", "unused", "--render_gt", "--reso", "32",
                          "--eval_metrics", "--eval_max_frames", "1",
                          "--device", "cpu"])
        tr = run_test(cfg, args, scene=scene)
        assert tr.rcfg_test.mlp_impl == impl
        metrics[impl] = tr.metrics
    assert metrics["pallas"]["frames"] == 1
    for k in ("psnr", "ssim", "dssim"):
        assert _rel(metrics["pallas"][k], metrics["fused"][k]) <= 1e-5, k
    cfg = train_config(None, str(tmp_path / "log"))
    cfg["model"]["mlp_impl"] = "pallas"
    for flag in ("--fine_budget", "--coarse_probe"):
        args = test_args(["-c", "unused", "--render_gt", "--reso", "32",
                          flag, "8", "--device", "cpu"])
        with pytest.raises(ValueError, match="fused test-time route"):
            run_test(copy.deepcopy(cfg), args, scene=scene)
