"""Data parallelism in the port on two gloo ranks on the CPU, against JAX's
two-device mesh (as tests/test_multihost.py runs JAX's over two processes).

``tests/fixtures/torch_port_dp_golden.npz``
(scripts/make_torch_port_dp_golden.py) holds JAX's steps on ``make_mesh(2)`` at the fixtures' small widths: two
stage-3 ``full`` steps (the density frozen, the ``nof`` optimizer's second
update), one stage-1 step and two stage-2 steps, with each chip's draws.
Two ranks spawned by ``parallel/multihost.py::launch`` replay them with
``train_step(draws=...)``: loss terms and ``train_psnr`` (the mean over the
ranks) within 1e-5 relative and the parameters within 1e-6 absolute of
JAX's, as tests/test_torch_train_step.py, and the two ranks' parameters
equal to the bit. Also:

- the fixture's draws are JAX's: recomputed here from
  ``fold_in(fold_in(key(seed), step), rank)``;
- ``render_rays_chunked`` on two ranks equals this process's world-1
  render to the bit (2500 rays in 1024-ray tiles with the chains on, 0
  rays, one tile: fewer tiles than ranks), on both ranks;
- the ranks draw different rays, and world 1 draws what it drew before
  data parallelism; rank 0's parameters reach every rank;
- ``make_optimizer(world_size=2)`` and the ranks' trainers divide the
  milestones by the world;
- ``maybe_init_distributed`` / ``is_main`` / the backend rule, and
  ``require=True`` raising with nothing configured;
- ``python -m moco_flow_tpu_torch.train --device cpu --num_devices 2``: one
  ``log.txt`` and one ``metrics.jsonl`` record a log step, one checkpoint
  a save, the clock at ``num_iters``, and a resume; then
  ``moco_flow_tpu_torch.test --render_frame 0`` on two ranks writes the
  bytes that world 1 writes.
"""

import json
import os
import os.path as osp

import numpy as np
import pytest
import torch

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu_torch.parallel import multihost
from moco_flow_tpu_torch.parallel.mesh import epoch_perm_frame, fold_rank_if
from moco_flow_tpu_torch.train.factory import render_config
from moco_flow_tpu_torch.train.optim import make_optimizer
from scripts import make_torch_port_dp_golden as gd

METRICS_RTOL, PARAMS_ATOL = 1e-5, 1e-6
CHUNK = 1024
WORLD = gd.WORLD
# case -> (rays, chains on)
RENDERS = {"2500-rays-chain-on": (2500, True), "0-rays-chain-off": (0, False),
           "0-rays-chain-on": (0, True), "one-tile": (700, False)}
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def _rays(table: dict, n: int, chains: bool, seed: int = 0) -> np.ndarray:
    """``n`` rays from a sphere of radius 2.5 towards the origin, near 1.5,
    far 3.5, each with a frame's normalized index and, with ``chains``,
    the chained frame's."""
    rng = np.random.default_rng(seed + n)
    o = rng.normal(size=(n, 3))
    o = 2.5 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o + rng.uniform(-0.3, 0.3, size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    idx = rng.choice(np.asarray(table["norm_idx"]), size=(n, 1))
    cols = [o, d, np.full((n, 1), 1.5), np.full((n, 1), 3.5), idx]
    if chains:
        cols.append(rng.choice(np.asarray(table["norm_idx"]), size=(n, 1)))
    return np.ascontiguousarray(np.concatenate(cols, 1), np.float32)


def _render_all(tr, table: dict) -> dict:
    """Every case of ``RENDERS`` through ``tr.render_rays_chunked``."""
    out = {}
    for case, (n, chains) in RENDERS.items():
        kw = (dict(use_nof=True, chain_local=True, chain_global=True,
                   perturb=0.0) if chains else
              dict(use_nof=True, test_time=True, perturb=0.0))
        bg = np.random.default_rng(n).uniform(size=(n, 3)).astype(np.float32)
        with torch.no_grad():
            res = tr.render_rays_chunked(
                torch.from_numpy(_rays(table, n, chains)),
                torch.from_numpy(bg), render_config(tr.config["model"], **kw),
                anneal=tr.anneal(), chunk=CHUNK)
        out[case] = {k: v.numpy() for k, v in res.items()}
    return out


def _table(arrs: dict) -> dict:
    return gd.unflatten_prefix(arrs, "s3/table")


def _rank_checks(rank: int, world: int, device, threads: int) -> dict:
    """One rank's share of the tests: the fixture replays, the renders,
    the draws, the broadcast, the optimizers' schedules."""
    torch.set_num_threads(threads)
    arrs = gd.load()
    out = {"rank": rank, "world": world, "is_main": multihost.is_main(),
           "count": multihost.process_count(), "runs": {}}
    for stage in gd.RUNS:
        out["runs"][stage] = gd.port_run(arrs, stage, rank, device)
    tr = gd.port_trainer(arrs, "s3", device)
    out["attrs"] = (tr.world_size, tr.rank, tr.is_main)
    out["renders"] = _render_all(tr, _table(arrs))
    d = tr.draw(4996)
    out["draw"] = (d.frame, d.pixels.numpy(), d.perturb.numpy())
    out["epoch_perm"] = [epoch_perm_frame(3, s, 5, rank) for s in range(10)]
    with torch.no_grad():
        for t in tr._named().values():
            t.add_(float(rank))
    tr.broadcast_params()
    out["broadcast"] = {k: v.detach().numpy().copy()
                        for k, v in tr._named().items()}
    tr2 = gd.port_trainer(arrs, "s2", device)
    opt = tr2._optimizers()
    out["lr"] = [opt.schedule(c) for c in (149_999, 150_000)]
    return out


@pytest.fixture(scope="module")
def arrs():
    return gd.load()


# the ranks' threads, and this process's for the world-1 render that they
# must equal (a CPU reduction's order may follow the thread count)
THREADS = max(1, torch.get_num_threads() // WORLD)


@pytest.fixture(scope="module")
def ranks():
    return multihost.launch(_rank_checks, ["cpu"] * WORLD, THREADS)


@pytest.mark.parametrize("stage", list(gd.RUNS))
def test_ranks_replay_jax_mesh_steps(ranks, arrs, stage):
    _, n_steps = gd.RUNS[stage]
    for r in ranks:
        metrics, params = r["runs"][stage]
        assert len(metrics) == n_steps
        for i, m in enumerate(metrics):
            want = gd.unflatten_prefix(arrs, f"{stage}/metrics/{i}")
            assert set(m) == set(want), (stage, i)
            for k, v in m.items():
                w = float(want[k])
                assert abs(v - w) <= METRICS_RTOL * max(abs(w), 1e-30), \
                    (stage, i, k, v, w)
        want = gd.unflatten_prefix(arrs, f"{stage}/params{n_steps}")
        assert set(params) == set(want)
        for k, v in params.items():
            np.testing.assert_allclose(v, want[k], rtol=0, atol=PARAMS_ATOL,
                                       err_msg=f"{stage} {k}")
    p0, p1 = (r["runs"][stage][1] for r in ranks)
    for k in p0:
        assert p0[k].tobytes() == p1[k].tobytes(), (stage, k)
    m0, m1 = (r["runs"][stage][0] for r in ranks)
    assert m0 == m1


def test_fixture_draws_are_jax_rank_keys(arrs):
    """The fixture's draws come from the rank-folded step keys (JAX)."""
    table = type("T", (), {"valid_count": _table(arrs)["valid_count"]})
    cfg = json.loads(str(arrs["s3/config_json"]))
    nv = int(arrs["s3/corr/verts"].shape[1])
    for r in range(WORLD):
        want = gd.s3_draws(0, 4996, r, table, cfg["model"], nv)
        got = gd.unflatten_prefix(arrs, f"s3/draws/{r}/0")
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    a, b = (gd.unflatten_prefix(arrs, f"s3/draws/{r}/0")["pixels"]
            for r in range(WORLD))
    assert not np.array_equal(a, b)


@pytest.fixture(scope="module")
def world1_renders(arrs):
    tr = gd.port_trainer(arrs, "s3", "cpu")
    assert tr.world_size == 1
    saved = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        return _render_all(tr, _table(arrs))
    finally:
        torch.set_num_threads(saved)


@pytest.mark.parametrize("case", list(RENDERS))
def test_sharded_render_equals_world_1(ranks, world1_renders, case):
    want = world1_renders[case]
    n = RENDERS[case][0]
    for r in ranks:
        got = r["renders"][case]
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            if v.ndim:
                assert v.shape[0] == n, k
            assert got[k].tobytes() == v.tobytes(), (case, k)


def test_ranks_draw_apart_and_world_1_unchanged(ranks, arrs):
    (f0, p0, u0), (f1, p1, u1) = (r["draw"] for r in ranks)
    assert not np.array_equal(p0, p1) and not np.array_equal(u0, u1)
    tr = gd.port_trainer(arrs, "s3", "cpu")
    d = tr.draw(4996)
    gen = torch.Generator().manual_seed(0 * 1_000_003 + 4996)
    assert tr._step_generator(4996).initial_seed() == gen.initial_seed()
    assert not np.array_equal(d.pixels.numpy(), p0)
    assert fold_rank_if(12345, None) == 12345
    old = [int(torch.randperm(5, generator=torch.Generator().manual_seed(
        (3 * 1_000_003 + 0x5EED) * 1_000_003 + s // 5))[s % 5])
        for s in range(10)]
    assert [epoch_perm_frame(3, s, 5) for s in range(10)] == old
    e0, e1 = (r["epoch_perm"] for r in ranks)
    assert sorted(e0[:5]) == sorted(e1[:5]) == list(range(5))
    assert e0 != e1


def test_rank_attributes_and_broadcast(ranks):
    for r in ranks:
        assert r["world"] == r["count"] == WORLD
        assert r["is_main"] == (r["rank"] == 0)
        assert r["attrs"] == (WORLD, r["rank"], r["rank"] == 0)
    b0, b1 = (r["broadcast"] for r in ranks)
    for k in b0:
        assert b0[k].tobytes() == b1[k].tobytes(), k


def test_milestones_divided_by_world(ranks):
    t = torch.zeros(1, requires_grad=True)
    sched = {"type": "steplr", "decay_step": [4, 8], "decay_gamma": 0.5}
    for world, lrs in ((1, [1.0] * 4 + [0.5] * 4 + [0.25]),
                       (2, [1.0] * 2 + [0.5] * 2 + [0.25] * 5)):
        opt = make_optimizer([t], {"type": "adam", "lr": 1.0}, sched,
                             world_size=world)
        assert [opt.schedule(c) for c in range(9)] == lrs, world
    # stage 2's adam at decay_step 300000: the ranks' milestone is 150000
    for r in ranks:
        assert r["lr"] == [1e-3, 5e-4]


def test_process_group_absent_and_required(monkeypatch):
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    assert not multihost.maybe_init_distributed()
    assert multihost.process_index() == 0 and multihost.process_count() == 1
    assert multihost.is_main()
    with pytest.raises(RuntimeError, match="no process group"):
        multihost.maybe_init_distributed(require=True)
    with pytest.raises(RuntimeError, match="rank"):
        multihost.maybe_init_distributed("localhost:1", 2, None)


def test_backend_rule():
    assert multihost.backend_for(["cpu", "cpu"]) == "gloo"
    assert multihost.backend_for(["cuda:0", "cuda:0"]) == "gloo"
    assert multihost.backend_for(["cuda:0", "cuda:1"]) == "nccl"
    with pytest.raises(ValueError):
        multihost.backend_for(["cpu", "cuda:0"])


# -- the CLI on two gloo ranks -----------------------------------------------

def _cli_config(root: str, save_dir: str, steps: int) -> dict:
    """c2f.yaml at CPU size (NeRF 2 x 32, NoF W 32, 8 + 8 samples, 32
    rays, 32^2 frames), without the hand-over, a checkpoint every 2
    steps."""
    from moco_flow_tpu_torch.utils.config import load_yaml
    cfg = load_yaml(osp.join(osp.dirname(osp.dirname(osp.abspath(
        __file__))), "configs", "people_snapshot", "male-3-casual",
        "c2f.yaml"))
    m = cfg["model"]
    for k in ("coarse_NeRF", "fine_NeRF"):
        m[k] = dict(m[k], D=2, W=32, skips=[1])
    for k in ("fw_NoF", "bw_NoF"):
        m[k] = dict(m[k], W=32)
    m.update(N_samples=8, N_importance=8, N_rand=32, chunk=1024,
             N_sampled=64, pretrained_nerf=None, pretrained_nof=None)
    cfg["dataloader"].update(root_dir=root, size=[32, 32], val_size=[24, 24])
    cfg["save_dir"] = save_dir
    cfg["trainer"].update(num_iters=steps, val_every_n_step=0,
                          save_every_n_step=2, log_freq=1)
    return cfg


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def test_cli_two_ranks_one_record_and_resume(tmp_path, monkeypatch):
    from moco_flow_tpu_torch.data.synthetic import make_synthetic_scene
    from moco_flow_tpu_torch.geometry.smpl import (save_smpl_data,
                                                   synthetic_smpl_data)
    from moco_flow_tpu_torch.test import main as test_main
    from moco_flow_tpu_torch.train.__main__ import main as train_main
    from moco_flow_tpu_torch.train.checkpoint import load_checkpoint
    from moco_flow_tpu_torch.utils.config import dump_config
    for k in TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    tmp = str(tmp_path)
    root = osp.join(tmp, "scene")
    smpl = synthetic_smpl_data(300)
    make_synthetic_scene(root, n_frames=3, size=32, focal=40.0, smpl=smpl)
    monkeypatch.setenv("SMPL_MODEL_DIR", osp.dirname(
        save_smpl_data(smpl, osp.join(tmp, "smpl"))))
    log = osp.join(tmp, "log")
    for job, steps in (("job1", 4), ("job2", 6)):
        path = osp.join(tmp, f"{job}.yaml")
        dump_config(_cli_config(root, log, steps), path)
        assert train_main(["-c", path, "-n", job, "-s", "0", "--device",
                           "cpu", "--num_devices", str(WORLD)]) is None
    exp = osp.join(log, _cli_config(root, log, 4)["exp_name"])
    assert sorted(os.listdir(exp)) == ["job1", "job2"]
    ck1 = sorted(os.listdir(osp.join(exp, "job1", "ckpts")))
    assert [c for c in ck1 if c.endswith(".npz")] == [
        "epoch2_iter2.npz", "final.npz"]
    ck2 = sorted(c for c in os.listdir(osp.join(exp, "job2", "ckpts"))
                 if c.endswith(".npz"))
    assert len(ck2) == 2 and ck2[0].endswith("_iter4.npz") and \
        ck2[1] == "final.npz", ck2
    for job, steps in (("job1", [0, 2]), ("job2", [4])):
        # rank 0's records only (and its TensorBoard events where
        # tensorboardX is importable)
        assert sorted(set(os.listdir(osp.join(exp, job, "log")))
                      - {"train.events"}) == ["log.txt", "metrics.jsonl"]
        with open(osp.join(exp, job, "log", "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        assert [r["step"] for r in recs
                if any(k.startswith("train/") for k in r)] == steps, job
        assert os.path.exists(osp.join(exp, job, "config.yaml"))
        assert os.path.isdir(osp.join(exp, job, "code"))
    with open(osp.join(exp, "job2", "log", "log.txt")) as f:
        text = f.read()
    assert text.count("loaded checkpoint") == 1 and "job1" in text
    for job, step in (("job1", 4), ("job2", 6)):
        _, extra = load_checkpoint(osp.join(exp, job, "ckpts", "final.npz"))
        assert extra["clock"]["step"] == step, job
    # test.py's frame strip on two ranks: rank 0 writes the world-1 bytes
    trees = {}
    for n in (1, WORLD):
        out = osp.join(tmp, f"test{n}")
        argv = ["-c", path, "-r", osp.join(exp, "job2", "ckpts", "final.npz"),
                "--render_gt", "--reso", "24", "--render_frame", "0",
                "--device", "cpu", "--num_devices", str(n), "--out_dir", out]
        saved = torch.get_num_threads()
        torch.set_num_threads(max(1, saved // WORLD))   # as the ranks'
        try:
            test_main(argv)
        finally:
            torch.set_num_threads(saved)
        trees[n] = {osp.relpath(osp.join(d, f), out): _read(osp.join(d, f))
                    for d, _, fs in os.walk(out) for f in fs}
    assert list(trees[1]) == ["images_epoch_4_step_6/frame_0.png"]
    assert trees[WORLD] == trees[1]
