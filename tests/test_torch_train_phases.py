"""The port's stage-3 step in its ``full`` / ``none`` + freeze / ``msk``
variants, the val step and the pieces they add, against the JAX package.

``scripts/make_torch_port_phases_golden.py`` runs the JAX
``MoCoFlowTrainer`` (``mlp_impl: fused``, its Pallas kernels interpreted on
the CPU; NeRF 4x32, NoF 4x32, 32 rays x (8 + 8) samples, 64 + 64
correspondence points, c2f start 5000) through steps 4998-5000 (``full``
twice with the density frozen and both optimizers, then ``none`` with the
density still frozen, where the ``nof`` optimizer is deleted) and 10000-10001
(``msk``), then one val step; the port replays them on the CPU with JAX's
draws.

Tolerances (fp32): loss terms, ``train_psnr`` and the val metrics 1e-5
relative; parameters 1e-6 absolute (the updates are ~1e-4 a step; measured
max |diff| 4.5e-8). Correspondences: ``inside`` and the nearest vertex
exactly (one flip would move a point between the L1 and the mask loss),
distances 1e-5 (see the KNN test), canonical points 1e-5 (a 4x4 product
of chains ~1). The
optimizer-state round trip is held to the step tolerances.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu.data.synthetic import make_synthetic_scene as j_scene
from moco_flow_tpu.geometry.smpl import (
    smpl_vertex_transforms as j_vertex_transforms,
    synthetic_smpl_data as j_smpl_data)
from moco_flow_tpu.nn import losses as jl
from moco_flow_tpu.ops.knn import nearest_neighbor as j_nearest_neighbor
from moco_flow_tpu.train import optim as joptim
from moco_flow_tpu_torch.data.correspondence import (
    CorrespondenceTable, sample_correspondences)
from moco_flow_tpu_torch.data.dataset import get_dataset
from moco_flow_tpu_torch.data.synthetic import make_synthetic_scene
from moco_flow_tpu_torch.geometry.smpl import (smpl_vertex_transforms,
                                               synthetic_smpl_data)
from moco_flow_tpu_torch.nn import losses
from moco_flow_tpu_torch.ops.knn import nearest_neighbor
from moco_flow_tpu_torch.train import optim
from moco_flow_tpu_torch.train.__main__ import parse_args, train
from moco_flow_tpu_torch.train.checkpoint import (
    _flatten, _unflatten, load_checkpoint, params_from_jax, save_checkpoint)
from scripts.make_torch_port_phases_golden import (
    CKPT_AFTER, RUNS, SCENE, golden_arrays, load, port_draws, port_run,
    port_trainer, unflatten_prefix)
from scripts.make_torch_port_train_golden import train_config

STEPS = [(run, i) for run, (_, n, _) in RUNS.items() for i in range(n)]
NETS = ("coarse_NeRF", "fine_NeRF", "bw_NoF", "fw_NoF")


@pytest.fixture(scope="module")
def stored():
    return load()


@pytest.fixture(scope="module")
def fresh():
    return golden_arrays()


@pytest.fixture(scope="module")
def scene():
    return make_synthetic_scene(None, **SCENE)


@pytest.fixture(scope="module")
def replay(stored, scene):
    return {run: port_run(stored, run, "cpu", scene if run == "msk" else None)
            for run in RUNS}


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("phases_scene"))
    return root, j_scene(root, **SCENE)


def _rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


# ---------------------------------------------------------------------------
# The fixture and the replay of JAX's steps
# ---------------------------------------------------------------------------

def test_fixture_still_matches_jax(fresh, stored):
    assert set(fresh) == set(stored)
    for k in fresh:
        if k == "config_json":
            assert str(fresh[k]) == str(stored[k])
        else:
            np.testing.assert_allclose(stored[k], fresh[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)


def test_fixture_phases_are_not_trivial(stored):
    """Points lie on both sides of the surface threshold, the frozen density
    does not move through step 5000 and moves in ``msk``, the rgb branch
    and the NoFs move in ``full``, and each variant has its loss terms."""
    for run, i in STEPS:
        inside = stored[f"corr/{run}/{i}/inside"]
        assert 0.1 < inside.mean() < 0.9
    for net in ("coarse_NeRF", "fine_NeRF"):
        for part in ("trunk/0/w", "sigma/w"):
            k = f"{net}/{part}"
            np.testing.assert_array_equal(stored[f"params_full/{k}"],
                                          stored[f"params0/{k}"])
            assert np.abs(stored[f"params_msk/{k}"]
                          - stored[f"params0/{k}"]).max() > 1e-6
        assert np.abs(stored[f"params_full/{net}/final/w"]
                      - stored[f"params0/{net}/final/w"]).max() > 1e-6
    for net in ("bw_NoF", "fw_NoF"):
        assert np.abs(stored[f"params_ckpt/{net}/layers/0/w"]
                      - stored[f"params0/{net}/layers/0/w"]).max() > 1e-6
    keys = lambda run, i: {k.split("/")[-1] for k in stored  # noqa: E731
                           if k.startswith(f"metrics/{run}/{i}/")}
    assert {"nof_bw", "nof_fw", "alphas_mask"} <= keys("full", 0)
    assert not {"nof_bw", "nof_fw", "alphas_mask"} & keys("full", 2)
    assert "alphas_mask" in keys("msk", 0) and "nof_bw" not in keys("msk", 0)
    assert [bool(stored[f"deleted/{r}/{i}"]) for r, i in STEPS] == [
        False, False, True, True, True]


@pytest.mark.parametrize("run,i", STEPS)
def test_phase_step_matches_jax(stored, replay, run, i):
    """Every loss term and ``train_psnr`` of each replayed step, and whether
    the ``nof`` optimizer is deleted after it."""
    metrics, deleted, _ = replay[run]
    want = {k.split("/")[-1]: float(v) for k, v in stored.items()
            if k.startswith(f"metrics/{run}/{i}/")}
    assert set(metrics[i]) == set(want)
    for k, v in want.items():
        assert _rel(metrics[i][k], v) <= 1e-5, (k, metrics[i][k], v)
    assert deleted[i] == bool(stored[f"deleted/{run}/{i}"])


@pytest.mark.parametrize("run", list(RUNS))
def test_phase_params_match_jax(stored, replay, run):
    params = _flatten(replay[run][2].params)
    for net in NETS:
        assert any(k.startswith(f"{net}/") for k in params)
    for k, v in params.items():
        want = stored[f"params_{run}/{k}"]
        assert v.shape == want.shape, k
        np.testing.assert_allclose(v, want, rtol=0, atol=1e-6, err_msg=k)


def test_val_step_matches_jax(stored, replay):
    """The val step after the ``msk`` run: same clock, same frame, PSNR and
    DSSIM (under ``ssim``, the JAX key) of the chain-off render."""
    tr = replay["msk"][2]
    assert tr.clock.step == int(stored["val/step"])
    got = tr.val_func()
    assert set(got) == {"val_psnr", "ssim"}
    for k, v in got.items():
        assert _rel(v, float(stored[f"val/{k}"])) <= 1e-5, (k, v)


# ---------------------------------------------------------------------------
# Correspondences
# ---------------------------------------------------------------------------

def test_correspondence_table_matches_jax(stored, scene):
    """The port's train dataset of the same scene builds the table itself:
    posed vertices and src -> canonical chains (``torch.linalg.inv``)."""
    cfg = json.loads(str(stored["config_json"]))
    ds = get_dataset(cfg["dataloader"], "train", scene=scene)
    table = ds.correspondence_table
    np.testing.assert_allclose(table.verts.numpy(), stored["corr/verts"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(table.src_to_cano.numpy(),
                               stored["corr/src_to_cano"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("run,i", STEPS)
def test_sample_correspondences_matches_jax(stored, run, i):
    table = CorrespondenceTable(torch.from_numpy(stored["corr/verts"]),
                                torch.from_numpy(stored["corr/src_to_cano"]))
    d = port_draws(stored, f"{run}/{i}")
    got = sample_correspondences(table, d.frame, d.cube, d.pick, d.noise)
    want = unflatten_prefix(stored, f"corr/{run}/{i}")
    np.testing.assert_array_equal(got["inside"].numpy(), want["inside"])
    np.testing.assert_allclose(got["query"].numpy(), want["query"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got["cano"].numpy(), want["cano"], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("n_refs,n_queries,chunk", [(256, 128, 8192),
                                                    (6890, 2000, 512)])
def test_nearest_neighbor_matches_jax(n_refs, n_queries, chunk):
    """Index and ``inside`` (distance < 0.2) exactly, on random vertices
    and queries half near the surface (so many sit near the threshold), in
    one chunk and in several. Distances 1e-5: both sides take the root of
    (|v|^2 - 2 q.v) + |q|^2, which cancels |q|^2 ~ 7 down to d^2 ~ 0.04, so
    the last-bit difference of the two BLAS dot products (fused or not)
    grows ~100-fold (measured max 7.2e-6)."""
    rng = np.random.default_rng(n_refs)
    refs = rng.normal(scale=0.5, size=(n_refs, 3)).astype(np.float32)
    near = refs[rng.integers(0, n_refs, n_queries // 2)] + rng.normal(
        scale=0.2, size=(n_queries // 2, 3)).astype(np.float32)
    cube = rng.uniform(-1.5, 1.5, (n_queries - len(near), 3))
    q = np.concatenate([cube, near]).astype(np.float32)
    jd, ji = j_nearest_neighbor(jnp.asarray(refs), jnp.asarray(q),
                                chunk=chunk)
    td, ti = nearest_neighbor(torch.from_numpy(refs), torch.from_numpy(q),
                              chunk=chunk)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy() < 0.2, np.asarray(jd) < 0.2)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-5)


def test_smpl_vertex_transforms_matches_jax():
    data_j, data_t = j_smpl_data(300, seed=2), synthetic_smpl_data(300, seed=2)
    rng = np.random.default_rng(2)
    pose = rng.normal(scale=0.3, size=(3, 72)).astype(np.float32)
    betas = rng.normal(scale=0.5, size=(3, 10)).astype(np.float32)
    want = np.asarray(j_vertex_transforms(data_j, jnp.asarray(pose),
                                          jnp.asarray(betas)))
    got = smpl_vertex_transforms(data_t, torch.from_numpy(pose),
                                 torch.from_numpy(betas)).numpy()
    assert got.shape == (3, 300, 4, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# Losses and the density freeze
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask_kind", ["mixed", "empty", "full"])
@pytest.mark.parametrize("fn", ["masked_loss_L1", "masked_loss_MSE",
                                "masked_bce"])
def test_masked_losses_match_jax(fn, mask_kind):
    """An empty mask falls back to the plain mean, on both sides."""
    rng = np.random.default_rng(3)
    pred = rng.uniform(0.0, 1.0, (50, 3)).astype(np.float32)
    pred[0, 0], pred[1, 1] = 0.0, 1.0            # the BCE clamps
    target = rng.normal(size=(50, 3)).astype(np.float32)
    mask = {"mixed": rng.uniform(size=50) < 0.4, "empty": np.zeros(50, bool),
            "full": np.ones(50, bool)}[mask_kind]
    if fn == "masked_bce":
        want = jl.masked_bce(jnp.asarray(pred[:, 0]), jnp.asarray(mask), 0.0)
        got = losses.masked_bce(torch.from_numpy(pred[:, 0]),
                                torch.from_numpy(mask), 0.0)
    else:
        kind = fn.split("_")[-1]
        want = jl.masked_loss(jnp.asarray(pred), jnp.asarray(target),
                              jnp.asarray(mask), kind)
        got = losses.masked_loss(torch.from_numpy(pred),
                                 torch.from_numpy(target),
                                 torch.from_numpy(mask), kind)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    t = target[:, 0] > 0
    np.testing.assert_allclose(
        float(losses.bce(torch.from_numpy(pred[:, 0]),
                         torch.from_numpy(t.astype(np.float32)))),
        float(jl.bce(jnp.asarray(pred[:, 0]), jnp.asarray(t, jnp.float32))),
        rtol=1e-6)
    np.testing.assert_allclose(
        float(losses.l1(torch.from_numpy(pred), torch.from_numpy(target))),
        float(jl.l1(jnp.asarray(pred), jnp.asarray(target))), rtol=1e-6)


def test_zero_grads_where_matches_optax_across_freeze():
    """Adam with the density frozen for two steps and free for two more:
    the port's zero gradients (not None) keep every parameter's step equal
    to optax's global count, so the bias correction after the freeze lifts
    is optax's. Two optimizers (``moco`` and ``nof``) step on the same
    gradients, as the ``full`` phase's double update."""
    rng = np.random.default_rng(4)
    tree = {"coarse_NeRF": {"trunk": [{"w": rng.normal(size=(3, 4)),
                                       "b": rng.normal(size=4)}],
                            "sigma": {"w": rng.normal(size=(4, 1)),
                                      "b": rng.normal(size=1)},
                            "rgb": {"w": rng.normal(size=(4, 3)),
                                    "b": rng.normal(size=3)}},
            "bw_NoF": {"layers": [{"w": rng.normal(size=(3, 3)),
                                   "b": rng.normal(size=3)}]}}
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
    grads = [jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
        for _ in range(4)]
    ocfg = {"type": "adam", "lr": 1e-2}
    sched = {"type": "steplr", "decay_step": [3], "decay_gamma": 0.5}
    freeze = lambda k: k.split("/")[0].endswith("NeRF") and \
        k.split("/")[1] in ("trunk", "sigma")             # noqa: E731

    jm, jn = joptim.make_optimizer(ocfg, sched), joptim.make_optimizer(
        ocfg, sched)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    sm, sn = jm.init(jp), jn.init({"bw_NoF": jp["bw_NoF"]})
    tp = params_from_jax(tree)
    named = _flatten(tp, leaf=lambda t: t)
    for t in named.values():
        t.requires_grad_(True)
    nof = {k: t for k, t in named.items() if k.startswith("bw_NoF/")}
    om = optim.make_optimizer(list(named.values()), ocfg, sched,
                              names=list(named))
    on = optim.make_optimizer(list(nof.values()), ocfg, sched,
                              names=list(nof))
    for step, g in enumerate(grads):
        frozen = step < 2
        jg = jax.tree_util.tree_map(jnp.asarray, g)
        if frozen:
            jg = joptim.zero_grads_where(jg, freeze)
        u, sm = jm.update(jg, sm, jp)
        jp = jax.tree_util.tree_map(lambda a, b: a + b, jp, u)
        u, sn = jn.update({"bw_NoF": jg["bw_NoF"]}, sn,
                          {"bw_NoF": jp["bw_NoF"]})
        jp = {**jp, "bw_NoF": jax.tree_util.tree_map(
            lambda a, b: a + b, jp["bw_NoF"], u["bw_NoF"])}
        om.zero_grad()
        flat_g = _flatten(g)
        for k, t in named.items():
            t.grad = torch.from_numpy(flat_g[k])
        if frozen:
            optim.zero_grads_where(named, freeze)
        om.step()
        on.step()
        want = {k: np.asarray(v) for k, v in
                _flatten(jax.tree_util.tree_map(np.asarray, jp)).items()}
        for k, t in named.items():
            np.testing.assert_allclose(t.detach().numpy(), want[k], rtol=0,
                                       atol=1e-6, err_msg=f"{k} step {step}")
            if freeze(k) and frozen:
                np.testing.assert_array_equal(t.detach().numpy(),
                                              _flatten(tree)[k])
    assert om.count == on.count == 4


# ---------------------------------------------------------------------------
# Optimizer state in checkpoints (both directions) and the CLI
# ---------------------------------------------------------------------------

def _jax_params(stored, prefix):
    return _unflatten(unflatten_prefix(stored, prefix))


def test_port_resumes_jax_checkpoint(stored, tmp_path):
    """JAX's checkpoint after its 2nd ``full`` step (parameters and
    ``opt_named`` of both optimizers, written by the JAX package) resumes
    in the port, whose 3rd step (5000) matches JAX's own."""
    from moco_flow_tpu.train.checkpoint import save_checkpoint as j_save
    start = RUNS["full"][0]
    path = str(tmp_path / "jax_ckpt")
    j_save(path, {"params": _jax_params(stored, "params_ckpt"),
                  "opt_named": unflatten_prefix(stored, "ckpt_opt")},
           extra={"clock": {"epoch": 1, "minibatch": 0,
                            "step": start + CKPT_AFTER},
                  "nof_opt_deleted": False})
    tr = port_trainer(stored, "cpu", 0, False)
    tr.load_ckpt(path + ".npz")
    assert tr.clock.step == start + CKPT_AFTER
    m = tr.train_step(draws=port_draws(stored, f"full/{CKPT_AFTER}"))
    assert tr.opt.count == int(stored["ckpt_opt/['moco'][1].count"]) + 1
    for k, v in m.items():
        want = float(stored[f"metrics/full/{CKPT_AFTER}/{k}"])
        assert _rel(float(v), want) <= 1e-5, k
    for k, v in _flatten(tr.params).items():
        np.testing.assert_allclose(v, stored[f"params_full/{k}"], rtol=0,
                                   atol=1e-6, err_msg=k)


def test_jax_resumes_port_checkpoint(stored, scene_dir, tmp_path):
    """The port's checkpoint after its 2nd ``full`` step resumes in the JAX
    trainer, whose 3rd step matches the fixture's; the port writes the
    same ``opt_named`` paths as JAX."""
    import copy
    from moco_flow_tpu.parallel.mesh import make_mesh
    from moco_flow_tpu.train import get_trainer
    from moco_flow_tpu.train.checkpoint import _flatten as j_flatten
    from moco_flow_tpu.utils.config import Config
    start = RUNS["full"][0]
    tr = port_trainer(stored, "cpu", start, False)
    for i in range(CKPT_AFTER):
        tr.train_step(draws=port_draws(stored, f"full/{i}"))
        tr.clock.tick()
    tr.job_dir = str(tmp_path)
    path = tr.save_ckpt("port")
    tree, extra = load_checkpoint(path)
    assert set(tree["opt_named"]) == set(unflatten_prefix(stored,
                                                          "ckpt_opt"))
    assert extra["nof_opt_deleted"] is False
    root, smpl = scene_dir
    cfg = train_config(root, str(tmp_path / "jlog"))
    jt = get_trainer(Config(copy.deepcopy(cfg), mode="train"),
                     smpl_data=smpl, mesh=make_mesh(1))
    jt.load_ckpt(path + ".npz")
    assert jt.clock.step == start + CKPT_AFTER
    jt.train_step()
    for k, v in j_flatten(jt.params).items():
        np.testing.assert_allclose(np.asarray(v), stored[f"params_full/{k}"],
                                   rtol=0, atol=1e-6, err_msg=k)


def test_deleted_nof_optimizer_is_not_written(replay, tmp_path):
    """After step 5000 the ``nof`` optimizer is gone: the checkpoint holds
    the ``moco`` state only, and a load keeps it deleted."""
    tr = replay["full"][2]
    assert tr.nof_opt_deleted and tr.opt_nof is None
    tr.job_dir = str(tmp_path)
    path = tr.save_ckpt("after")
    tree, extra = load_checkpoint(path)
    names = set(tree["opt_named"])
    assert names and all(k.startswith("['moco']") for k in names)
    assert int(tree["opt_named"]["['moco'][0].count"]) == RUNS["full"][1]
    assert extra["nof_opt_deleted"] is True


def test_train_cli_crosses_phases(stored, scene_dir, tmp_path):
    """``train(config, args)`` from a checkpoint at step 4999 through
    ``full``, ``none`` + freeze and ``none``: finite losses, the NeRF
    trunk frozen until step 5000 and moving after, the ``nof`` optimizer
    deleted; then the val step."""
    root, smpl = scene_dir
    cfg = train_config(root, str(tmp_path / "log"))
    cfg["trainer"]["num_iters"] = 5002
    params = params_from_jax(_jax_params(stored, "params0"))
    seed = str(tmp_path / "seed")
    save_checkpoint(seed, {"params": params}, extra={
        "clock": {"epoch": 1, "minibatch": 0, "step": 4999}})
    args = parse_args(["-c", "unused", "-r", seed + ".npz", "-n", "job",
                       "--device", "cpu"])
    tr = train(cfg, args, smpl_data=smpl)
    assert tr.clock.step == 5002 and tr.nof_opt_deleted
    assert all(np.isfinite(float(v)) for v in tr.losses.values())
    tree, extra = load_checkpoint(os.path.join(tr.job_dir, "ckpts", "final"))
    assert extra["nof_opt_deleted"] is True
    assert int(tree["opt_named"]["['moco'][0].count"]) == 3
    trunk = tree["params"]["coarse_NeRF"]["trunk"][0]["w"]
    moved = np.abs(trunk - stored["params0/coarse_NeRF/trunk/0/w"]).max()
    assert 1e-6 < moved < 1e-3            # one free step (5001)
    val = tr.val_func()
    assert set(val) == {"val_psnr", "ssim"}
    assert all(np.isfinite(v) for v in val.values())
