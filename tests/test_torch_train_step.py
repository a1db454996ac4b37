"""The port's stage-3 training step against the JAX package's, and the train
fixture that carries JAX's numbers to machines without JAX.

``scripts/make_torch_port_train_golden.py`` runs two steps of the JAX
``MoCoFlowTrainer`` (one-device mesh, ``mlp_impl: fused``, so its NeRF and
warp-chain Pallas kernels run interpreted on the CPU) on
``__graft_entry__._tiny_moco_config`` narrowed to NeRF 4x32 / NoF 4x32,
32 rays x (8 + 8) samples, on the 32x32 synthetic scene, with the clock at
step 6000 (the ``none`` phase). JAX's draws are recomputed from its step
keys and handed to the port's ``train_step``, which runs the plain versions
of the kernels here.

Tolerances (fp32): loss terms and ``train_psnr`` 1e-5 relative; parameters
after the two Adam steps 1e-6 absolute (the updates are ~2e-4, the lr of
two steps; measured max |diff| 7e-8). The frame table that the port builds
itself (its cv2-free valid-pixel mask included) must equal JAX's exactly:
one pixel more or less would shift every ray the draws pick.
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu.data.synthetic import make_synthetic_scene
from moco_flow_tpu_torch.data.dataset import get_dataset
from moco_flow_tpu_torch.data.draws import Draws
from moco_flow_tpu_torch.data.synthetic import \
    make_synthetic_scene as port_scene
from moco_flow_tpu_torch.train.__main__ import parse_args, train
from moco_flow_tpu_torch.train.checkpoint import (
    _unflatten, load_checkpoint, params_from_jax, save_checkpoint)
from moco_flow_tpu_torch.train.stage_mocoflow import MoCoFlowTrainer
from scripts.make_torch_port_train_golden import (
    FIXTURE, N_STEPS, SCENE, STEP, golden_arrays, port_replay, train_config)

METRICS = ("img_loss", "nof_local", "nof_global", "train_psnr")
NETS = ("coarse_NeRF", "fine_NeRF", "bw_NoF", "fw_NoF")


@pytest.fixture(scope="module")
def stored():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def fresh():
    return golden_arrays()


@pytest.fixture(scope="module")
def replay(stored):
    return port_replay(stored, "cpu")


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("train_scene"))
    smpl = make_synthetic_scene(root, **SCENE)
    return root, smpl


def test_fixture_still_matches_jax(fresh, stored):
    assert set(fresh) == set(stored)
    for k in fresh:
        if k == "config_json":
            assert str(fresh[k]) == str(stored[k])
        else:
            np.testing.assert_allclose(stored[k], fresh[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)


def test_fixture_steps_are_not_trivial(stored):
    """Both NeRFs stop some rays and pass others, so the consensus masks
    and the compositing weights matter, and every network moved."""
    for i in range(N_STEPS):
        assert 0.01 < float(stored[f"metrics/{i}/img_loss"]) < 1.0
        assert float(stored[f"metrics/{i}/nof_local"]) > 0
    for net in NETS:
        keys = [k for k in stored if k.startswith(f"params0/{net}/")]
        moved = max(float(np.abs(stored[k] - stored[
            k.replace("params0/", f"params{N_STEPS}/")]).max()) for k in keys)
        assert 1e-5 < moved < 1e-3, net


@pytest.mark.parametrize("step", range(N_STEPS))
@pytest.mark.parametrize("name", METRICS)
def test_step_metrics_match_jax(stored, replay, step, name):
    got = replay[0][step][name]
    want = float(stored[f"metrics/{step}/{name}"])
    np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("net", NETS)
def test_updated_params_match_jax(stored, replay, net):
    params = replay[1]
    keys = [k for k in params if k.startswith(f"{net}/")]
    assert keys
    for k in keys:
        want = stored[f"params{N_STEPS}/{k}"]
        assert params[k].shape == want.shape, k
        np.testing.assert_allclose(params[k], want, rtol=0, atol=1e-6,
                                   err_msg=k)


def test_port_frame_table_matches_jax(stored, scene_dir):
    """The port's own train dataset (SMPL AABBs, cameras, near/far and the
    cv2-free valid-pixel table) against the table the JAX dataset built."""
    root, smpl = scene_dir
    cfg = train_config(root, "unused")
    ds = get_dataset(cfg["dataloader"], "train", smpl_data=smpl)
    for name in ("valid_idx", "valid_count"):
        np.testing.assert_array_equal(
            getattr(ds.table, name).numpy(), stored[f"table/{name}"],
            err_msg=name)
    for name in ("c2w", "near", "far", "norm_idx"):
        np.testing.assert_allclose(getattr(ds.table, name).numpy(),
                                   stored[f"table/{name}"], rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(ds.images.numpy(), stored["images"])
    np.testing.assert_allclose(ds.directions_flat.numpy(),
                               stored["directions"], rtol=1e-6, atol=1e-7)


def _trainer(stored, step: int) -> MoCoFlowTrainer:
    tr = MoCoFlowTrainer(json.loads(str(stored["config_json"])),
                         device="cpu")
    tr.build_model(tr.config["model"])
    tr.configure_optimizers(tr.config["optimizer"],
                            tr.config.get("scheduler"))
    tr.clock.step = step
    return tr


@pytest.mark.parametrize("step,phase", [(5000, "none"), (10000, "msk"),
                                        (100, "full"), (1_100_000, "msk")])
def test_every_phase_trains(stored, scene_dir, step, phase):
    """Every phase trains (tests/test_torch_train_phases.py holds them
    against JAX), with sigma noise too: under ``noise_std > 0`` the step's
    Draws carry the noise of both passes, and the step's losses are finite
    and its parameters move (the noise against JAX is
    tests/test_torch_hybrids.py's)."""
    root, smpl = scene_dir
    cfg = json.loads(str(stored["config_json"]))
    cfg["model"]["noise_std"] = 0.5
    tr = MoCoFlowTrainer(cfg, device="cpu")
    tr.build_model(cfg["model"])
    tr.configure_optimizers(cfg["optimizer"], cfg.get("scheduler"))
    ds = get_dataset(train_config(root, "unused")["dataloader"], "train",
                     smpl_data=smpl)
    tr.set_train_data(*_table_args(stored), corr=ds.correspondence_table)
    tr.clock.step = step
    assert tr.phase(step)[0] == phase
    assert tr.phase(STEP) == ("none", False)
    draws = tr.draw(step)
    assert draws.sigma_noise_coarse.shape == draws.perturb.shape
    before = {k: t.detach().clone() for k, t in tr._named().items()}
    metrics = tr.train_step(draws=draws)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert any(not torch.equal(t, before[k])
               for k, t in tr._named().items())


def test_val_step_and_vis_run(stored, tmp_path):
    """Under ``val_every_n_step > 0`` stage 3 runs the val step and then
    ``visualize_batch`` (train/vis.py: the canonical frame strip after
    every val, the orbit and the mesh after the first), once more after
    the last step; stage 2 visualises nothing, so its loop runs the val
    step alone."""
    cfg = json.loads(str(stored["config_json"]))
    cfg["save_dir"] = str(tmp_path / "log3")
    cfg["trainer"].update(num_iters=2, val_every_n_step=1)
    tr = train(cfg, parse_args(["-c", "unused", "-n", "job", "--device",
                                "cpu"]), scene=port_scene(None, **SCENE))
    assert tr.clock.step == 2
    assert set(tr.val_metrics) == {"val_psnr", "ssim"}
    log_dir = os.path.join(tr.job_dir, "log")
    # two frames an epoch: the closing strip is epoch 2's
    for epoch, step in ((1, 0), (1, 1), (2, 2)):
        assert os.path.exists(os.path.join(
            log_dir, f"images_epoch_{epoch}_step_{step}", "canonical.png"))
    orbit = os.path.join(log_dir, "spherical_videos_epoch_1_step_0",
                         "canonical_images")
    assert len(os.listdir(orbit)) == 90
    from scripts.make_torch_port_stage2_golden import stage2_config
    cfg2 = stage2_config(None, str(tmp_path / "log"))
    cfg2["trainer"].update(num_iters=3, val_every_n_step=2)
    tr = train(cfg2, parse_args(["-c", "unused", "-n", "job", "--device",
                                 "cpu"]),
               scene=port_scene(None, n_frames=2, size=16))
    assert tr.clock.step == 3
    assert set(tr.val_metrics) == {"val_nof_bw", "val_nof_fw"}


def test_train_cli_resumes_and_saves(stored, scene_dir, tmp_path):
    """``train(config, args)`` from a checkpoint at step 6000 for two steps
    on the scene's files: the clock resumes, every loss is finite, the
    parameters move, and the final checkpoint holds the new clock."""
    root, smpl = scene_dir
    cfg = train_config(root, str(tmp_path / "log"))
    params = params_from_jax(_unflatten(
        {k[len("params0/"):]: v for k, v in stored.items()
         if k.startswith("params0/")}))
    seed = str(tmp_path / "seed")
    save_checkpoint(seed, {"params": params}, extra={
        "clock": {"epoch": 1, "minibatch": 0, "step": STEP}})
    args = parse_args(["-c", "unused", "-r", seed + ".npz", "-n", "job",
                       "--device", "cpu"])
    tr = train(cfg, args, smpl_data=smpl)
    assert tr.clock.step == STEP + N_STEPS
    assert tr.nof_opt_deleted
    assert all(np.isfinite(float(v)) for v in tr.losses.values())
    tree, extra = load_checkpoint(os.path.join(tr.job_dir, "ckpts", "final"))
    assert extra["clock"]["step"] == STEP + N_STEPS
    assert extra["nof_opt_deleted"] is True
    moved = np.abs(tree["params"]["coarse_NeRF"]["trunk"][0]["w"]
                   - stored["params0/coarse_NeRF/trunk/0/w"]).max()
    assert 1e-5 < moved < 1e-3


def test_draws_are_a_function_of_seed_and_step(stored):
    """A resumed run draws what the uninterrupted run would have drawn."""
    tr = _trainer(stored, STEP)
    tr.set_train_data(*_table_args(stored))
    a, b = tr.draw(STEP + 3), tr.draw(STEP + 3)
    c = tr.draw(STEP + 4)
    assert isinstance(a, Draws)
    for name in ("pixels", "background", "perturb", "pdf"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    assert not torch.equal(a.perturb, c.perturb)
    m = tr.config["model"]
    assert a.pixels.shape == (m["N_rand"],)
    assert int(a.pixels.max()) < int(stored["table/valid_count"][a.frame])
    assert a.perturb.shape == (m["N_rand"], m["N_samples"])
    assert a.pdf.shape == (m["N_rand"], m["N_importance"])
    assert 0 <= a.chained < len(stored["table/valid_count"])


def _table_args(stored):
    from moco_flow_tpu_torch.data.dataset import FrameTable
    table = FrameTable(
        **{k: torch.from_numpy(stored[f"table/{k}"])
           for k in ("c2w", "near", "far", "norm_idx")},
        valid_idx=torch.from_numpy(stored["table/valid_idx"]).long(),
        valid_count=torch.from_numpy(stored["table/valid_count"]).long())
    return (table, torch.from_numpy(stored["directions"]),
            torch.from_numpy(stored["images"]),
            torch.from_numpy(stored["bkgd_img"]), bool(stored["rand_bkgd"]))
