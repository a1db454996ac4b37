"""The program's spans (``moco_flow_tpu_torch/utils/logging.py::span``) in
a ``torch.profiler`` trace of one training step of each stage, on the
fixtures' small widths on the CPU: stage 1, stage 2 and stage 3 in its
``full``, ``none`` (density frozen) and ``msk`` phases.

Each step has one ``train.step`` and in it, once each, in order and never
overlapping, ``train.inputs``, ``train.forward``, ``train.backward``,
``train.reduce`` and ``train.optimizer``; a render's ``render.sample_pdf``
lies in ``train.forward``; where the step draws correspondences (stage 2,
stage 3's ``msk``), ``data.correspondences`` lies in ``train.inputs`` and
``data.knn`` in it, and the benchmark's ``knn_*.points`` readers read
them. With no profiler running, ``span`` makes no ``record_function``."""

import json

import pytest
import torch

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu_torch.utils.logging import span
from scripts import make_torch_port_phases_golden as gp
from scripts import make_torch_port_stage1_golden as g1
from scripts import make_torch_port_stage2_golden as g2

PARTS = ("train.inputs", "train.forward", "train.backward", "train.reduce",
         "train.optimizer")
# case -> (stage, stage-3 clock step, nof optimizer deleted, draws)
CASES = {"s1": ("s1", None, None, 0), "s2": ("s2", None, None, "draws/0"),
         "s3-full": ("s3", 4998, False, "full/0"),
         "s3-none": ("s3", 5000, False, "full/2"),
         "s3-msk": ("s3", 10000, True, "msk/0")}


@pytest.fixture(scope="module")
def fixtures():
    return {"s1": g1.load(), "s2": g2.load(), "s3": gp.load()}


def trainer_and_draws(fixtures, case):
    stage, step, deleted, which = CASES[case]
    arrs = fixtures[stage]
    if stage == "s1":
        return g1.port_trainer(arrs, "cpu"), g1.port_draws(arrs, which)
    if stage == "s2":
        return (g2.port_stage2_trainer(arrs, "cpu"),
                g2.port_points(arrs, which))
    return (gp.port_trainer(arrs, "cpu", step, deleted),
            gp.port_draws(arrs, which))


def program_spans(prof, tmp_path) -> list:
    """The ``train.*`` and ``render.*`` ranges of the trace as exported:
    ``(name, start_us, end_us)`` by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    if isinstance(events, dict):
        events = events["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and e["name"].startswith(("train.", "render."))),
                  key=lambda x: x[1])


@pytest.mark.parametrize("case", list(CASES))
def test_step_spans_nest_and_do_not_overlap(fixtures, case, tmp_path):
    tr, draws = trainer_and_draws(fixtures, case)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        metrics = tr.train_step(draws=draws)
    assert all(torch.isfinite(v) for v in metrics.values())
    spans = program_spans(prof, tmp_path)
    steps = [s for s in spans if s[0] == "train.step"]
    assert len(steps) == 1, spans
    _, t0, t1 = steps[0]
    parts = [s for s in spans if s[0] in PARTS]
    assert [p[0] for p in parts] == list(PARTS)
    for name, s, e in parts:
        assert t0 <= s <= e <= t1, name
    for (_, _, end), (name, start, _) in zip(parts, parts[1:]):
        assert end <= start, name
    fwd = next(p for p in parts if p[0] == "train.forward")
    pdf = [s for s in spans if s[0] == "render.sample_pdf"]
    assert len(pdf) == (0 if case == "s2" else 1)
    for _, s, e in pdf:
        assert fwd[1] <= s <= e <= fwd[2]
    assert {s[0] for s in spans} <= {"train.step", *PARTS,
                                     "render.sample_pdf"}


@pytest.mark.parametrize("case", ["s2", "s3-msk"])
def test_data_spans_lie_in_inputs_and_are_read(fixtures, case):
    from benchmark import cells
    from benchmark.trace import Window, read_chrome_trace
    tr, draws = trainer_and_draws(fixtures, case)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("bench.window"):
            tr.train_step(draws=draws)
    w = Window(work={}, on_card=False, steps=1)
    read_chrome_trace(prof, w)

    def named(name):
        return [(s, e) for n, s, e in w.host if n == name]

    (i0, i1), = named("train.inputs")
    (c0, c1), = named("data.correspondences")
    (k0, k1), = named("data.knn")
    assert i0 <= c0 <= k0 <= k1 <= c1 <= i1
    assert cells.metric_reader("knn_host_ms.points")(w) == \
        pytest.approx((k1 - k0) / 1e3)
    assert cells.metric_reader("knn_idle_ms.points")(w) is None   # no card


def test_span_makes_no_record_function_without_a_profiler(fixtures,
                                                           monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    with span("train.step"):
        pass
    tr, draws = trainer_and_draws(fixtures, "s3-msk")
    tr.train_step(draws=draws)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="no profiler"):
            span("train.step")
