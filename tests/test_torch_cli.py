"""The port's CLIs on the published YAMLs, with the host packages that the
GPU machine lacks blocked.

``yaml``, ``PIL``, ``cv2`` and ``imageio`` are set to ``None`` in
``sys.modules`` while the port runs, so any import of them on its paths
fails. The three files under ``configs/`` are read with the port's loader
and narrowed to CPU size (NeRF 2 x 32, NoF 4 x 32, 8 + 8 samples, 32 rays,
32^2 frames and 24^2 val frames), two steps with ``val_every_n_step: 2``
and ``log_freq: 1``; everything else stays as written. Then:

- ``python -m moco_flow_tpu_torch.train -c <yaml>`` reaches ``final`` for
  stages 1, 2 and 3 (stage 3 from stage 1's and 2's finals), with the
  layout, ``config.yaml``, the code snapshot, ``log.txt``,
  ``metrics.jsonl`` and stages 1 and 3's frame strips and orbits; a second
  call resumes;
- every ``moco_flow_tpu_torch.test`` mode writes the same file tree
  (names) as the JAX package's ``test.py`` on the same checkpoint and
  scene (JAX writes an mp4 only where imageio has ffmpeg, absent here);
  ``--test_json`` reads its file's directory; ``--profile`` writes a
  ``torch.profiler`` trace that shows each step's ``train.*`` spans;
- ``--occ_res`` writes the same files as without it, ``--device cuda``
  without a card fails;
- no module of the port imports jax, moco_flow_tpu or the host packages.
"""

import argparse
import ast
import contextlib
import copy
import json
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu_torch.data.synthetic import make_synthetic_scene
from moco_flow_tpu_torch.geometry.smpl import (save_smpl_data,
                                               synthetic_smpl_data)
from moco_flow_tpu_torch.test import main as port_test_main
from moco_flow_tpu_torch.train import vis
from moco_flow_tpu_torch.train.__main__ import main as train_main
from moco_flow_tpu_torch.utils.config import dump_config, load_yaml

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIGS = osp.join(ROOT, "configs", "people_snapshot", "male-3-casual")
STAGES = ("init_nerf", "init_nof", "c2f")
BLOCKED = ("yaml", "PIL", "cv2", "imageio")


@contextlib.contextmanager
def blocked_host_packages():
    saved = {m: sys.modules.get(m) for m in BLOCKED}
    sys.modules.update({m: None for m in BLOCKED})
    try:
        yield
    finally:
        for m, v in saved.items():
            if v is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = v


def narrow(cfg: dict) -> dict:
    """A published config at CPU size; every other key as written."""
    m = cfg["model"]
    for k in ("coarse_NeRF", "fine_NeRF"):
        if m.get(k):
            m[k] = dict(m[k], D=2, W=32, skips=[1])
    for k in ("fw_NoF", "bw_NoF"):
        if m.get(k):
            m[k] = dict(m[k], W=32)
    if "N_samples" in m:
        m.update(N_samples=8, N_importance=8, N_rand=32, chunk=1024)
    if "N_sampled" in m:
        m["N_sampled"] = 64 if m["type"] == "moco_flow" else 500
    if "size" in cfg["dataloader"]:
        cfg["dataloader"].update(size=[32, 32], val_size=[24, 24])
    return cfg


def stage_config(stage: str, root: str, save_dir: str, finals: dict,
                 steps: int = 2) -> dict:
    cfg = narrow(load_yaml(osp.join(CONFIGS, f"{stage}.yaml")))
    cfg["dataloader"]["root_dir"] = root
    cfg["save_dir"] = save_dir
    tcfg = cfg["trainer"]
    tcfg.update(num_iters=steps, val_every_n_step=2, log_freq=1)
    if stage == "c2f":
        cfg["model"].update(pretrained_nerf=finals["init_nerf"],
                            pretrained_nof=finals["init_nof"])
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("cli"))
    root = osp.join(tmp, "scene")
    smpl = synthetic_smpl_data(300)
    make_synthetic_scene(root, n_frames=3, size=32, focal=40.0, smpl=smpl)
    old = os.environ.get("SMPL_MODEL_DIR")
    os.environ["SMPL_MODEL_DIR"] = osp.dirname(
        save_smpl_data(smpl, osp.join(tmp, "smpl")))
    out = {"tmp": tmp, "root": root, "smpl": smpl, "finals": {},
           "trainers": {}, "cfgs": {}, "paths": {}}
    try:
        with blocked_host_packages():
            for stage in STAGES:
                cfg = stage_config(stage, root, osp.join(tmp, "log"),
                                   out["finals"])
                path = osp.join(tmp, f"{stage}.yaml")
                dump_config(cfg, path)
                tr = train_main(["-c", path, "-n", "job", "-s", "0",
                                 "--device", "cpu"])
                out["trainers"][stage], out["cfgs"][stage] = tr, cfg
                out["paths"][stage] = path
                out["finals"][stage] = osp.join(tr.job_dir, "ckpts",
                                                "final.npz")
        yield out
    finally:
        if old is None:
            os.environ.pop("SMPL_MODEL_DIR", None)
        else:
            os.environ["SMPL_MODEL_DIR"] = old


def _records(job: str) -> list:
    import json
    with open(osp.join(job, "log", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("stage", STAGES)
def test_train_cli_runs_the_published_yaml(runs, stage):
    tr, cfg = runs["trainers"][stage], runs["cfgs"][stage]
    job = tr.job_dir
    assert tr.clock.step == 2 and osp.exists(runs["finals"][stage])
    assert load_yaml(osp.join(job, "config.yaml")) == cfg
    assert osp.exists(osp.join(job, "code", "moco_flow_tpu_torch", "ops",
                               "native", "mcubes.cpp"))
    with open(osp.join(job, "log", "log.txt")) as f:
        text = f.read()
    assert "[Epoch/Step : 1/2]: saved checkpoint" in text
    recs = _records(job)
    train = {r["step"] for r in recs if any(k.startswith("train/")
                                            for k in r)}
    valid = {r["step"] for r in recs if any(k.startswith("valid/")
                                            for k in r)}
    assert train == {0, 1} and valid == {0}
    vals = [v for r in recs for k, v in r.items()
            if k.startswith(("train/", "valid/"))]
    assert vals and np.isfinite(vals).all()
    log_dir = osp.join(job, "log")
    made = sorted(d for d in os.listdir(log_dir)
                  if osp.isdir(osp.join(log_dir, d)))
    if stage == "init_nof":
        assert not [d for d in made if "epoch" in d]
        return
    assert [d for d in made if d.startswith("images_epoch")] == [
        "images_epoch_1_step_0", "images_epoch_1_step_2"]
    # vis_mesh_video_every_n_val as written (5): the orbit and the mesh
    # after the first val only
    assert [d for d in made if d.startswith("spherical")] == [
        "spherical_videos_epoch_1_step_0"]
    orbit = osp.join(log_dir, "spherical_videos_epoch_1_step_0",
                     "canonical_images")
    assert len(os.listdir(orbit)) == 90
    meshes = [d for d in made if d.startswith("mesh_epoch")]
    assert meshes or "visualize_mesh: empty sigma field" in text
    assert text.count("save_video: no mp4 encoder") == 1


def test_train_cli_resumes(runs):
    cfg = copy.deepcopy(runs["cfgs"]["init_nof"])
    cfg["trainer"]["num_iters"] = 3
    path = osp.join(runs["tmp"], "init_nof_more.yaml")
    dump_config(cfg, path)
    with blocked_host_packages():
        tr = train_main(["-c", path, "-n", "job2", "-s", "0", "--device",
                         "cpu"])
    assert tr.clock.step == 3
    with open(osp.join(tr.job_dir, "log", "log.txt")) as f:
        text = f.read()
    first = runs["finals"]["init_nof"][:-len(".npz")]
    assert f"loaded checkpoint {first}" in text


def _modes(out_dir: str, thr: float, mesh_frame: int, frame: int) -> list:
    return ["--render_gt", "--reso", "24", "--out_dir", out_dir,
            "--render_training_poses", "--render_spherical_poses",
            "--render_bullet_time", "--extract_mesh", "--mesh_frame",
            str(mesh_frame), "--N_grid", "20", "--sigma_threshold", str(thr),
            "--render_frame", str(frame), "--eval_metrics",
            "--eval_max_frames", "1"]


def _tree(d: str) -> set:
    return {osp.relpath(osp.join(r, f), d) for r, _, fs in os.walk(d)
            for f in fs if not f.endswith(".mp4")}


@pytest.mark.parametrize("mesh_frame,frame", [(-1, 0), (0, -1)])
def test_test_modes_write_the_jax_tree(runs, monkeypatch, mesh_frame, frame):
    """JAX's side draws blank panels of the frame's size in place of its
    renders, its sigma grid is the port's and its metrics a stub: what is
    compared is the tree of names (the values are test_torch_vis.py's)."""
    from moco_flow_tpu.train import vis as jax_vis
    from moco_flow_tpu.train.base import BaseTrainer as JaxBase
    from moco_flow_tpu.utils.config import Config as JaxConfig
    from test import test as jax_test
    tr = runs["trainers"]["c2f"]
    grid = vis.sigma_grid(tr, mesh_frame, n_grid=20)
    thr = float(np.quantile(grid, 0.75))
    assert grid.min() < thr < grid.max()
    tmp, path = runs["tmp"], runs["paths"]["c2f"]
    port_out = osp.join(tmp, f"port_{mesh_frame}")
    with blocked_host_packages():
        pt = port_test_main(["-c", path, "-r", runs["finals"]["c2f"],
                             "-s", "0", "--device", "cpu"]
                            + _modes(port_out, thr, mesh_frame, frame))
    assert np.isfinite(pt.metrics["psnr"]) and pt.metrics["frames"] == 1
    assert pt.mesh_path is not None
    jax_out = osp.join(tmp, f"jax_{mesh_frame}")

    def blank(trainer, ds, *a, **k):
        return np.zeros((*ds.size, 3), np.float32), \
            np.zeros((*ds.size, 3), np.float32)
    monkeypatch.setattr(jax_vis, "_render_view", blank)
    monkeypatch.setattr(jax_vis, "_render_views", lambda trainer, ds, views,
                        **k: (blank(trainer, ds) for _ in views))
    monkeypatch.setattr(jax_vis, "sigma_grid", lambda *a, **k: grid)
    monkeypatch.setattr(JaxBase, "evaluate_sequence",
                        lambda self, **k: {"psnr": 0.0})
    p = argparse.ArgumentParser()
    for flag in ("--render_gt", "--render_training_poses",
                 "--render_spherical_poses", "--render_bullet_time",
                 "--extract_mesh", "--eval_metrics"):
        p.add_argument(flag, action="store_true")
    for flag, typ in (("--reso", int), ("--out_dir", str),
                      ("--mesh_frame", int), ("--N_grid", int),
                      ("--sigma_threshold", float), ("--render_frame", int),
                      ("--eval_max_frames", int)):
        p.add_argument(flag, type=typ)
    args = p.parse_args(_modes(jax_out, thr, mesh_frame, frame))
    args = argparse.Namespace(
        **vars(args), mode="test", config=path, resume=runs["finals"]["c2f"],
        job_name=None, seed="0", test_json=None, spherical_poses_frame=-1,
        bullet_time_frame=0, fine_budget=None, coarse_probe=None,
        occ_res=None)
    jt = jax_test(JaxConfig.from_args(args, mode="test"), args,
                  smpl_data=runs["smpl"])
    assert jt.clock.step == pt.clock.step == 2
    want = _tree(jax_out)
    assert _tree(port_out) == want
    assert len([f for f in want if "spherical_videos" in f]) == 90
    assert len([f for f in want if f.startswith("bullet")]) == 120
    assert len([f for f in want if f.startswith("videos")]) == 3


def test_test_json_reads_its_directory(runs):
    """``--test_json`` (without ``--render_gt``) reads the sequence from the
    file's directory, as JAX's test.py does."""
    cfg = copy.deepcopy(runs["cfgs"]["c2f"])
    cfg["dataloader"]["root_dir"] = osp.join(runs["tmp"], "nowhere")
    path = osp.join(runs["tmp"], "c2f_elsewhere.yaml")
    dump_config(cfg, path)
    out = osp.join(runs["tmp"], "test_json")
    with blocked_host_packages():
        pt = port_test_main(["-c", path, "-r", runs["finals"]["c2f"],
                             "--test_json", osp.join(runs["root"],
                                                     "val.json"),
                             "--reso", "16", "--render_frame", "1",
                             "--out_dir", out, "--device", "cpu"])
    assert pt.val_dataset.root_dir == runs["root"]
    assert _tree(out) == {"images_epoch_1_step_2/frame_1.png"}


def test_profile_writes_a_trace(runs):
    cfg = copy.deepcopy(runs["cfgs"]["init_nof"])
    cfg["trainer"].update(num_iters=1, val_every_n_step=0)
    cfg["save_dir"] = osp.join(runs["tmp"], "profiled")
    path = osp.join(runs["tmp"], "init_nof_profiled.yaml")
    dump_config(cfg, path)
    with blocked_host_packages():
        tr = train_main(["-c", path, "-n", "job", "--device", "cpu",
                         "--profile"])
    prof = osp.join(tr.job_dir, "log", "plugins", "profile")
    assert sorted(os.listdir(prof)) == ["ops.txt", "trace.json"]
    assert os.path.getsize(osp.join(prof, "trace.json")) > 0


def test_profile_trace_shows_the_step_spans(runs):
    """``--profile``'s trace holds each training step's spans
    (``utils/logging.py::span``): one ``train.step`` a step and its five
    parts."""
    cfg = copy.deepcopy(runs["cfgs"]["init_nof"])
    cfg["trainer"].update(num_iters=2, val_every_n_step=0)
    cfg["save_dir"] = osp.join(runs["tmp"], "profiled_spans")
    path = osp.join(runs["tmp"], "init_nof_spans.yaml")
    dump_config(cfg, path)
    with blocked_host_packages():
        tr = train_main(["-c", path, "-n", "job", "--device", "cpu",
                         "--profile"])
    with open(osp.join(tr.job_dir, "log", "plugins", "profile",
                       "trace.json")) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("train.")]
    parts = ("train.step", "train.inputs", "train.forward", "train.backward",
             "train.reduce", "train.optimizer")
    assert {n: names.count(n) for n in parts} == dict.fromkeys(parts, 2)


def test_occupancy_and_a_missing_card_raise(runs):
    """``--occ_res 8`` runs (the views and the metrics through the frame's
    occupancy grid) and writes the same files as the same modes without
    it; ``--device cuda`` without a card raises."""
    path = runs["paths"]["c2f"]
    trees = {}
    for occ in ([], ["--occ_res", "8"]):
        out = osp.join(runs["tmp"], f"occ_{len(occ)}")
        with blocked_host_packages():
            pt = port_test_main(
                ["-c", path, "-r", runs["finals"]["c2f"], "--render_gt",
                 "--reso", "24", "--out_dir", out, "--render_frame", "0",
                 "--render_spherical_poses", "--eval_metrics",
                 "--eval_max_frames", "1", "--device", "cpu"] + occ)
        trees[len(occ)] = _tree(out)
        assert np.isfinite(pt.metrics["psnr"])
    assert pt.occ_cfg["resolution"] == 8 and pt._occ_stats["n_probe"] >= 8
    assert len(trees[0]) == 91 and trees[2] == trees[0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_test_main(["-c", path, "--render_gt"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_main(["-c", path, "-n", "never"])
    with pytest.raises(ValueError, match="--test_json or --render_gt"):
        port_test_main(["-c", path, "--device", "cpu"])


def test_the_port_imports_no_jax_and_no_host_package():
    """Statically, no import of the forbidden modules anywhere in the
    package or chip_smoke.py (tensorboardX is optional, behind its
    ImportError guard) but cv2 inside ``scripts/data_utils.py::clip_video``
    (the video decode, which needs it as JAX's script does), and no
    module-level import of h5py or joblib (the offline toolchain's GT reader
    and VIBE pkl reader import them where they are used); and every module
    imports with the forbidden modules blocked."""
    bad = ("jax", "moco_flow_tpu", "yaml", "PIL", "cv2", "imageio")
    lazy = ("h5py", "joblib", "scripts")
    gated = {(osp.join("moco_flow_tpu_torch", "scripts", "data_utils.py"),
              "clip_video", "cv2")}
    files = [osp.join(ROOT, "chip_smoke.py")] + [
        osp.join(d, f) for d, _, fs in
        os.walk(osp.join(ROOT, "moco_flow_tpu_torch")) for f in fs
        if f.endswith(".py")]
    found = []
    for path in files:
        tree = ast.parse(open(path).read())
        where = {id(n): f.name for f in ast.walk(tree)
                 if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
                 for n in ast.walk(f)}
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            func = where.get(id(node))
            found += [(path, n) for n in names
                      if (n.split(".")[0] in bad and (osp.relpath(
                          path, ROOT), func, n) not in gated)
                      or (n.split(".")[0] in lazy and func is None)]
    assert not found
    mods = sorted(
        "moco_flow_tpu_torch." + osp.relpath(osp.join(d, f), osp.join(
            ROOT, "moco_flow_tpu_torch"))[:-3].replace(os.sep, ".")
        for d, _, fs in os.walk(osp.join(ROOT, "moco_flow_tpu_torch"))
        for f in fs if f.endswith(".py") and f != "__init__.py")
    code = ("import sys, importlib\n"
            f"sys.modules.update({{m: None for m in {bad!r}}})\n"
            f"for m in {mods!r}:\n    importlib.import_module(m)\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)
