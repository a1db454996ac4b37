"""Stage 2 (the NoF pretraining) of the port against the JAX package.

- ``NoFDataset`` against JAX's on the same synthetic scene: the frame
  table at 8x8 and the correspondence table.
- ``scripts/make_torch_port_stage2_golden.py`` runs JAX's ``NoFTrainer``
  (``init_nof.yaml``'s model narrowed to NoF 4x32: xyz PE of 0 bands
  padded to 33 inputs, frame PE of 16 bands, quaternion head; 64 + 64
  points a step at thickness 0.1; adam + steplr) for three steps and a val
  step on a fresh 10,000-point set; the port replays them with JAX's draws
  (its NoF evaluations through the single-warp kernels #3/#4's plain
  versions), resumes JAX's checkpoint, and JAX resumes the port's.
- The port's own draws (the frame policy, the val step's seeded set), the
  render config (fp32, no jitter, whatever ``compute_dtype`` says), the
  CLI with ``val_every_n_step > 0`` and a resume.
- The KNN's chunks: any chunk size gives the same ``idx`` and bitwise the
  same ``dist``, every launch of a call has one shape, and ``allow_tf32``
  changes neither.

Tolerances (fp32): losses and val losses 1e-5 relative; parameters and
optimizer state 1e-6 absolute (updates ~1e-3 a step; measured max |diff|
2.5e-7); correspondences: ``inside`` exactly, canonical points 1e-5; the
dataset's tables 1e-6 relative (both packages run the same fp32 SMPL
forward kinematics).
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu.data.dataset import get_dataset as j_get_dataset
from moco_flow_tpu.data.synthetic import make_synthetic_scene as j_scene
from moco_flow_tpu.train.checkpoint import _flatten as j_flatten
from moco_flow_tpu_torch.data.correspondence import sample_correspondences
from moco_flow_tpu_torch.data.dataset import NoFDataset, get_dataset
from moco_flow_tpu_torch.data.draws import draw_val_points
from moco_flow_tpu_torch.data.synthetic import make_synthetic_scene
from moco_flow_tpu_torch.ops import knn
from moco_flow_tpu_torch.train.__main__ import parse_args, train
from moco_flow_tpu_torch.train.checkpoint import (_flatten, _unflatten,
                                                  load_checkpoint)
from moco_flow_tpu_torch.train.stage_nof import NoFTrainer
from scripts.make_torch_port_phases_golden import unflatten_prefix
from scripts.make_torch_port_stage2_golden import (
    CKPT_AFTER, N_STEPS, THICKNESS, VAL_POINTS, golden_arrays, load,
    port_points, port_stage2_replay, port_stage2_trainer, stage2_config)
from scripts.make_torch_port_train_golden import SCENE


def _rel(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


@pytest.fixture(scope="module")
def stored():
    return load()


@pytest.fixture(scope="module")
def replay(stored):
    return port_stage2_replay(stored, "cpu")


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stage2_scene"))
    return root, j_scene(root, **SCENE)


def _jax_trainer(root, smpl, save_dir):
    from moco_flow_tpu.parallel.mesh import make_mesh
    from moco_flow_tpu.train import get_trainer
    from moco_flow_tpu.utils.config import Config
    return get_trainer(Config(stage2_config(root, save_dir), mode="train"),
                       smpl_data=smpl, mesh=make_mesh(1))


# ---------------------------------------------------------------------------
# The dataset
# ---------------------------------------------------------------------------

def test_nof_dataset_matches_jax(scene_dir):
    root, smpl = scene_dir
    cfg = {"type": "nof", "root_dir": root, "interval": 1}
    jds = j_get_dataset(cfg, "train", smpl_data=smpl)
    ds = get_dataset(cfg, "train",
                     scene=make_synthetic_scene(None, **SCENE))
    assert isinstance(ds, NoFDataset)
    assert ds.size == jds.size == (8, 8)
    assert ds.num_frames == jds.num_frames
    assert ds.images is None
    for name in ("c2w", "near", "far", "norm_idx"):
        np.testing.assert_allclose(getattr(ds.table, name).numpy(),
                                   np.asarray(getattr(jds.table, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    for name in ("valid_idx", "valid_count"):
        np.testing.assert_array_equal(getattr(ds.table, name).numpy(),
                                      np.asarray(getattr(jds.table, name)))
    got, want = ds.correspondence_table, jds.correspondence_table
    for name in ("verts", "src_to_cano"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# JAX's stage-2 trajectory, replayed
# ---------------------------------------------------------------------------

def test_fixture_still_matches_jax(stored):
    """The stage-2 arrays of the fixture, regenerated by the JAX package
    (its stage-3 ``pallas`` arrays are held against JAX live by
    ``tests/test_torch_pallas_train.py``)."""
    fresh = golden_arrays(stage3=False)
    assert set(fresh) == {k for k in stored if not k.startswith("s3/")}
    for k in fresh:
        if k == "config_json":
            assert str(fresh[k]) == str(stored[k])
        else:
            np.testing.assert_allclose(stored[k], fresh[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)


def test_fixture_steps_are_not_trivial(stored):
    """Both NoFs moved, both losses are non-zero and the points straddle
    the body (some inside, most outside)."""
    for net in ("bw_NoF", "fw_NoF"):
        moved = max(float(np.abs(v - stored[f"params{N_STEPS}/{k}"]).max())
                    for k, v in unflatten_prefix(stored, "params0").items()
                    if k.startswith(net))
        assert 1e-4 < moved < 1e-1, net
    for i in range(N_STEPS):
        assert 0.01 < float(stored[f"metrics/{i}/nof_bw"]) < 10
        inside = stored[f"corr/{i}/inside"]
        assert 0 < inside.sum() < inside.size // 2


@pytest.mark.parametrize("step", range(N_STEPS))
def test_correspondences_match_jax(stored, step):
    """The port's correspondences on JAX's draws: the NoF's supervision."""
    tr = port_stage2_trainer(stored, "cpu")
    d = port_points(stored, f"draws/{step}")
    corr = sample_correspondences(tr._corr, d.frame, d.cube, d.pick,
                                  d.noise, thickness=THICKNESS)
    want = unflatten_prefix(stored, f"corr/{step}")
    np.testing.assert_array_equal(corr["inside"].numpy(), want["inside"])
    for k in ("query", "cano"):
        np.testing.assert_allclose(corr[k].numpy(), want[k], rtol=0,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("step", range(N_STEPS))
@pytest.mark.parametrize("name", ["nof_bw", "nof_fw"])
def test_step_losses_match_jax(stored, replay, step, name):
    got = replay[0][step][name]
    assert _rel(got, float(stored[f"metrics/{step}/{name}"])) <= 1e-5


@pytest.mark.parametrize("net", ["bw_NoF", "fw_NoF"])
def test_updated_params_match_jax(stored, replay, net):
    params = _flatten(replay[2].params)
    keys = [k for k in params if k.startswith(f"{net}/")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(params[k], stored[f"params{N_STEPS}/{k}"],
                                   rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["val_nof_bw", "val_nof_fw"])
def test_val_step_matches_jax(stored, replay, name):
    assert replay[2].clock.step == int(stored["val/step"])
    assert _rel(replay[1][name], float(stored[f"val/{name}"])) <= 1e-5


def test_optimizer_state_matches_jax(stored):
    _, _, tr = port_stage2_replay(stored, "cpu", steps=CKPT_AFTER)
    got = tr._opt_state_named()
    want = unflatten_prefix(stored, f"opt{CKPT_AFTER}")
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), v, rtol=0, atol=1e-6,
                                   err_msg=k)


def test_port_resumes_jax_checkpoint(stored, tmp_path):
    """JAX's parameters and adam state after two steps resume in the port,
    whose third step matches JAX's."""
    from moco_flow_tpu.train.checkpoint import save_checkpoint as j_save
    path = str(tmp_path / "jax_ckpt")
    j_save(path, {"params": _unflatten(unflatten_prefix(
        stored, f"params{CKPT_AFTER}")),
        "opt_named": unflatten_prefix(stored, f"opt{CKPT_AFTER}")},
        extra={"clock": {"epoch": 1, "minibatch": CKPT_AFTER,
                         "step": CKPT_AFTER}})
    tr = port_stage2_trainer(stored, "cpu")
    tr.load_ckpt(path + ".npz")
    assert tr.clock.step == CKPT_AFTER
    m = tr.train_step(draws=port_points(stored, f"draws/{CKPT_AFTER}"))
    assert tr.opt.count == CKPT_AFTER + 1
    for k, v in m.items():
        assert _rel(float(v), float(stored[f"metrics/{CKPT_AFTER}/{k}"])) \
            <= 1e-5, k
    for k, v in _flatten(tr.params).items():
        np.testing.assert_allclose(v, stored[f"params{N_STEPS}/{k}"], rtol=0,
                                   atol=1e-6, err_msg=k)


def test_jax_resumes_port_checkpoint(stored, scene_dir, tmp_path):
    """The port's checkpoint after two steps resumes in JAX's
    ``NoFTrainer``, whose third step matches the fixture's."""
    _, _, tr = port_stage2_replay(stored, "cpu", steps=CKPT_AFTER)
    tr.job_dir = str(tmp_path)
    path = tr.save_ckpt("port")
    root, smpl = scene_dir
    jt = _jax_trainer(root, smpl, str(tmp_path / "jlog"))
    jt.load_ckpt(path + ".npz")
    assert jt.clock.step == CKPT_AFTER
    jt.train_step()
    for k, v in j_flatten(jt.params).items():
        np.testing.assert_allclose(np.asarray(v),
                                   stored[f"params{N_STEPS}/{k}"], rtol=0,
                                   atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# The port's own draws, render config and CLI
# ---------------------------------------------------------------------------

def test_stage2_renders_fp32_unperturbed_on_the_single_warp(stored):
    """JAX's stage 2 ignores ``compute_dtype`` and ``mlp_impl``:
    ``RenderConfig(use_nof=True)``, which the port runs on #3/#4."""
    cfg = json.loads(str(stored["config_json"]))
    cfg["model"].update(compute_dtype="bfloat16", perturb=1.0,
                        mlp_impl="pallas")
    tr = NoFTrainer(cfg, device="cpu")
    tr.build_model(cfg["model"])
    assert tr.rcfg.compute_dtype == "float32" and tr.rcfg.dtype is None
    assert tr.rcfg.perturb == 0.0 and tr.rcfg.mlp_impl == "fused"
    assert set(tr.params) == {"bw_NoF", "fw_NoF"}


def test_draws_follow_the_frame_policy_and_the_val_seed(stored):
    tr = port_stage2_trainer(stored, "cpu")
    tr.config["model"]["frame_sampling"] = "sequential"
    n = tr.config["model"]["N_sampled"]
    for step in range(4):
        d = tr.draw(step)
        assert d.frame == step % tr.num_frames
        assert d.cube.shape == (n, 3) and d.pick.shape == (n,)
        assert float(d.cube.abs().max()) <= 1.5
    a, b = tr.draw(7), tr.draw(7)
    assert torch.equal(a.cube, b.cube) and torch.equal(a.noise, b.noise)
    nv = int(tr._corr.verts.shape[1])
    v1, v2 = draw_val_points(5, 2, nv), draw_val_points(5, 2, nv)
    assert v1.cube.shape == (VAL_POINTS, 3)
    assert torch.equal(v1.cube, v2.cube) and v1.frame == v2.frame
    assert not torch.equal(draw_val_points(6, 2, nv).cube, v1.cube)
    assert int(v1.pick.max()) < nv
    tr.config["model"]["frame_sampling"] = "random"
    with pytest.raises(ValueError, match="frame_sampling"):
        tr.draw(0)


def test_train_cli_runs_stage2_with_val_and_resumes(stored, tmp_path,
                                                    capsys):
    """``train(config, args, scene=...)`` with ``model.type: nof`` and
    ``val_every_n_step: 2`` (``init_nof.yaml`` sets 5000): the val step
    runs at steps 0 and 2, checkpoints hold the clock and adam's state,
    and a second run resumes from them."""
    cfg = json.loads(str(stored["config_json"]))
    cfg["save_dir"] = str(tmp_path / "log")
    cfg["trainer"].update(num_iters=3, val_every_n_step=2,
                          save_every_n_step=2)
    scene = make_synthetic_scene(None, **SCENE)
    args = parse_args(["-c", "unused", "-n", "job", "--device", "cpu"])
    tr = train(copy.deepcopy(cfg), args, scene=scene)
    assert isinstance(tr, NoFTrainer) and tr.clock.step == 3
    out = capsys.readouterr().out
    assert "[val step 0]" in out and "[val step 2]" in out
    assert all(np.isfinite(v) for v in tr.val_metrics.values())
    tree, extra = load_checkpoint(os.path.join(tr.job_dir, "ckpts", "final"))
    assert extra["clock"]["step"] == 3
    assert int(tree["opt_named"]["[0].count"]) == 3
    cfg["trainer"]["num_iters"] = 5
    args = parse_args(["-c", "unused", "-n", "job2", "--device", "cpu"])
    tr2 = train(cfg, args, scene=scene)
    assert tr2.clock.step == 5 and tr2.opt.count == 5
    assert "[val step 4]" in capsys.readouterr().out


def test_pretrained_nof_and_path_load_in_order(stored, tmp_path):
    """``pretrained_nof`` and then ``pretrained_path`` overlay the fresh
    NoFs, as JAX's ``build_model`` merges them."""
    a = port_stage2_replay(stored, "cpu", steps=1)[2]
    a.job_dir = str(tmp_path)
    first = a.save_ckpt("first")
    a.train_step(draws=port_points(stored, "draws/1"))
    second = a.save_ckpt("second")
    cfg = json.loads(str(stored["config_json"]))
    for paths, want in (((first, None), first), ((first, second), second)):
        cfg["model"]["pretrained_nof"] = paths[0] + ".npz"
        cfg["model"]["pretrained_path"] = paths[1] and paths[1] + ".npz"
        tr = NoFTrainer(cfg, device="cpu")
        tr.build_model(cfg["model"])
        ref = load_checkpoint(want)[0]["params"]
        for k, v in _flatten(tr.params).items():
            np.testing.assert_array_equal(v, _flatten(ref)[k], err_msg=k)


# ---------------------------------------------------------------------------
# The KNN's chunks
# ---------------------------------------------------------------------------

def test_knn_chunks_give_the_same_bits():
    """Stage 2 asks for 200,000 x 6,890 a step; the chunk comes from a
    memory budget. Every chunk size gives the same nearest vertex and
    bitwise the same distance, ties included (duplicated vertices: the
    first of them wins)."""
    rng = np.random.default_rng(3)
    refs = torch.from_numpy(rng.normal(size=(689, 3)).astype(np.float32))
    refs = torch.cat([refs, refs[:50]])           # exact ties
    queries = torch.from_numpy(
        rng.uniform(-2, 2, size=(3001, 3)).astype(np.float32))
    queries[:40] = refs[:40]
    d0, i0 = knn.nearest_neighbor(refs, queries, chunk=queries.shape[0])
    assert int(i0[:40].max()) < 40
    for chunk in (1, 7, 128, 1000, None):
        d, i = knn.nearest_neighbor(refs, queries, chunk=chunk)
        assert torch.equal(i, i0), chunk
        assert torch.equal(d.view(torch.int32), d0.view(torch.int32)), chunk


def test_knn_chunk_rows_fit_the_budget(monkeypatch):
    """The chunk fits the budget (stage 2's 200,000 queries in a few
    launches), every launch of a call has one shape of at least
    ``MIN_ROWS`` rows (the last chunk padded), a lowered budget gives
    smaller chunks and the same bits, and ``allow_tf32`` is off around the
    product whatever the caller set."""
    rows = knn.chunk_rows(6890)
    assert 4 * 6890 * rows <= knn.BUDGET_BYTES
    assert -(-200_000 // rows) <= 4
    assert knn.chunk_rows(10**12) == knn.MIN_ROWS
    rng = np.random.default_rng(4)
    refs = torch.from_numpy(rng.normal(size=(50, 3)).astype(np.float32))
    queries = torch.from_numpy(rng.normal(size=(250, 3)).astype(np.float32))
    want = knn.nearest_neighbor(refs, queries)
    monkeypatch.setattr(knn, "BUDGET_BYTES", 4 * 50 * 100)
    assert knn.chunk_rows(50) == 100
    shapes, addmm = [], torch.addmm

    def spy(inp, a, b, **kw):
        shapes.append((tuple(a.shape), torch.backends.cuda.matmul.allow_tf32))
        return addmm(inp, a, b, **kw)

    monkeypatch.setattr(torch, "addmm", spy)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = knn.nearest_neighbor(refs, queries)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert shapes == [((84, 3), False)] * 3       # 250 rows as 3 x 84
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
