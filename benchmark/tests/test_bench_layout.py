"""A configuration, a traffic mix, a kind of work and a per-layer metric are
each added as new files that the harness finds by name, with no file of
the benchmark edited: a copy of the benchmark gains them, their cell and
its limits, and runs it."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

# a kind whose step is not a training step: a product of two seeded
# matrices, compared with the same product in float64
MATMUL_KIND = '''
import torch

FAULTS = ()


class Job:
    def __init__(self, cell, seed, device):
        n = int(cell.traffic["n"])
        g = torch.Generator(device=device).manual_seed(seed)
        self.a = torch.rand((n, n), generator=g, device=device)
        self.b = torch.rand((n, n), generator=g, device=device)
        self.work = {"model_flops": 2.0 * n ** 3}
        self.diagnose = {}

    def step(self, i):
        self.y = self.a @ self.b
        return self.y.sum()

    def finish(self):
        pass

    def compare(self):
        want = self.a.double() @ self.b.double()
        return {"product_gap": float((self.y.double() - want).abs().max())}


def setup(cell, seed, device, fault=None, lap=lambda what: None):
    return Job(cell, seed, device)


def control(cell, seed, device):
    return {"product_gap": 1.0}
'''


def _run_in_copy(tmp_path, add, cell, trace):
    """A copy of the benchmark, ``add(copy, manifest)`` putting new files
    into it and entries into the manifest, then one CPU run of ``cell``;
    returns its result line and checks that no file of the copy changed."""
    copy = tmp_path / "benchmark"
    shutil.copytree(BENCH, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    add(copy, manifest)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    code = ("import json\nfrom benchmark import cells, run\n"
            "from benchmark.tests.small import SMALL, SEED\n"
            f"r = run.run_cell(cells.load_manifest(), {cell!r}, SEED, 0.0, "
            f"{trace}, device='cpu', override=SMALL)\n"
            "r.pop('_steps_s'); r.pop('_setup_parts')\n"
            "print(json.dumps(r))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    for p, data in before.items():
        assert p.read_bytes() == data, p
    return json.loads(out.stdout.strip().splitlines()[-1])


def _metric(manifest, name, cell):
    manifest["per_layer"].append(
        {"name": name, "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "device",
         "moves": "train_steps_per_s", "workloads": [cell]})


def test_new_config_mix_and_metric_found_by_name(tmp_path):
    cell = "c2f_four.train_msk_later"

    def add(copy, manifest):
        (copy / "metrics" / "throwaway.train.py").write_text(
            "def read(w):\n    return 42.0 if w.traced else None\n")
        cfg = json.loads((BENCH / "configs" / "c2f.json").read_text())
        cfg["num_frames"] = 4
        (copy / "configs" / "c2f_four.json").write_text(json.dumps(cfg))
        traffic = json.loads((BENCH / "traffic" / "train_msk.json")
                             .read_text())
        traffic["clock_step"] = 1200000
        (copy / "traffic" / "train_msk_later.json").write_text(
            json.dumps(traffic))
        shutil.copy(BENCH / "limits" / "c2f.train_msk.json",
                    copy / "limits" / f"{cell}.json")
        manifest["configs"].append(dict(manifest["configs"][0],
                                        name="c2f_four",
                                        file="benchmark/configs/"
                                             "c2f_four.json"))
        manifest["workloads"].append(dict(manifest["workloads"][0],
                                          name=cell, config="c2f_four",
                                          traffic="train_msk_later"))
        _metric(manifest, "throwaway.train", cell)

    r = _run_in_copy(tmp_path, add, cell, True)
    assert r["correct"], r["checks"]
    assert r["metrics"] == {"throwaway.train": {"value": 42.0, "unit": "%"}}


def test_new_kind_of_work_found_by_name(tmp_path):
    """A mix whose step is no training step: its kind, traffic, limits and
    metric are new files."""
    cell = "c2f.matmul"

    def add(copy, manifest):
        (copy / "kinds" / "matmul.py").write_text(MATMUL_KIND)
        (copy / "traffic" / "matmul.json").write_text(
            json.dumps({"kind": "matmul", "n": 16}))
        (copy / "limits" / f"{cell}.json").write_text(
            json.dumps({"product_gap": 1e-4}))
        (copy / "metrics" / "flops.matmul.py").write_text(
            "def read(w):\n    return w.work['model_flops'] * w.steps\n")
        manifest["workloads"].append(
            {"name": cell, "config": "c2f", "traffic": "matmul", "chips": 1,
             "why": "a throwaway product"})
        _metric(manifest, "flops.matmul", cell)

    plain = _run_in_copy(tmp_path / "plain", add, cell, False)
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {"train_steps_per_s", "setup_s"}
    traced = _run_in_copy(tmp_path / "traced", add, cell, True)
    assert traced["correct"] and traced["attempted"] >= 1
    assert traced["metrics"]["flops.matmul"]["value"] == \
        2.0 * 16 ** 3 * traced["attempted"]
    assert list(traced["checks"]) == ["product_gap"]
