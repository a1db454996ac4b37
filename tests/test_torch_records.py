"""The port's run records against the JAX trainer's.

The three published YAMLs at ``test_torch_cli.py``'s CPU size, three steps
with ``log_freq: 1`` and ``val_every_n_step: 2``, through JAX's
``train.py::train`` and the port's ``train``: every ``metrics.jsonl``
holds the same records in the same order, each with the same keys on the
same step (``train/...`` each step, ``valid/...`` after each val step, and
stage 3's ``hist/weights/...`` annealing vectors; ``train/state/nerf``
among stage 3's keys). The values differ, as each package draws its own
rays; the step-parity tests hold them. ``log.txt`` has JAX's line format.
Both sides' ``visualize_batch`` is a no-op here (``test_torch_cli.py`` and
``test_torch_vis.py`` cover it).
"""

import json
import os.path as osp

import pytest

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu.data.synthetic import make_synthetic_scene
from moco_flow_tpu.parallel.mesh import make_mesh
from moco_flow_tpu.train import stage_mocoflow as jax_s3
from moco_flow_tpu.train import stage_nerf as jax_s1
from moco_flow_tpu.utils.config import Config as JaxConfig
from moco_flow_tpu_torch.train import stage_mocoflow, stage_nerf
from moco_flow_tpu_torch.train.__main__ import parse_args, train
from tests.test_torch_cli import STAGES, stage_config

STEPS = 3


def _records(job: str) -> list:
    with open(osp.join(job, "log", "metrics.jsonl")) as f:
        return [(r["step"], sorted(k for k in r if k not in ("step", "time")))
                for r in map(json.loads, f)]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    from train import train as jax_train
    tmp = str(tmp_path_factory.mktemp("records"))
    root = osp.join(tmp, "scene")
    smpl = make_synthetic_scene(root, n_frames=3, size=32, focal=40.0)
    mp = pytest.MonkeyPatch()
    for cls in (jax_s1.NeRFTrainer, jax_s3.MoCoFlowTrainer,
                stage_nerf.NeRFTrainer, stage_mocoflow.MoCoFlowTrainer):
        mp.setattr(cls, "visualize_batch", lambda self, save_path=None: None)
    out = {"jax": {}, "port": {}}
    finals = {"jax": {}, "port": {}}
    try:
        for stage in STAGES:
            for side in ("jax", "port"):
                cfg = stage_config(stage, root, osp.join(tmp, side),
                                   finals[side], steps=STEPS)
                if side == "jax":
                    tr = jax_train(JaxConfig(cfg, mode="train",
                                             job_name="job", seed=0),
                                   smpl_data=smpl, mesh=make_mesh(1))
                    job = tr.config.exp_dir
                    finals[side][stage] = tr._ckpt_path("final") + ".npz"
                else:
                    tr = train(cfg, parse_args(["-c", "unused", "-n", "job",
                                                "-s", "0", "--device",
                                                "cpu"]), smpl_data=smpl)
                    job = tr.job_dir
                    finals[side][stage] = osp.join(job, "ckpts",
                                                   "final.npz")
                out[side][stage] = job
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("stage", STAGES)
def test_metrics_records_match_jax(both, stage):
    want = _records(both["jax"][stage])
    got = _records(both["port"][stage])
    assert got == want
    steps = lambda prefix: [s for s, ks in got  # noqa: E731
                            if any(k.startswith(prefix) for k in ks)]
    assert steps("train/") == list(range(STEPS))
    assert steps("valid/") == [0, 2]
    if stage == "c2f":
        assert steps("hist/") == [0, 0, 1, 1, 2, 2]
        assert all("train/state/nerf" in ks for _, ks in got
                   if any(k.startswith("train/") for k in ks))


@pytest.mark.parametrize("stage", STAGES)
def test_log_lines_have_jax_form(both, stage):
    lines = {}
    for side in ("jax", "port"):
        with open(osp.join(both[side][stage], "log", "log.txt")) as f:
            lines[side] = [ln.split(" - ", 1)[1].split("]: ")[0]
                           for ln in f.read().splitlines()
                           if "saved checkpoint" in ln]
    # 3 frames a epoch: the clock's epoch has ticked to 2 after 3 steps
    assert lines["port"] == lines["jax"] == [f"[Epoch/Step : 2/{STEPS}"]
