"""The readers of the program's training-step spans (``spans.py``, the
``*_host_ms.train`` and ``*_idle_ms.train`` metrics) on a hand-made window
whose host spans and device intervals are known, and on a traced CPU run
of each cell."""

import math

import pytest

from benchmark import cells, run, spans
from benchmark.tests.small import CELLS, SEED, SMALL
from benchmark.trace import Window

PARTS = spans.PARTS
METRICS = [f"{p}_{k}_ms.train" for p in PARTS for k in ("host", "idle")]


def window(on_card=True) -> Window:
    """Two steps over [0, 1000] us. Step 1: inputs [10, 60), forward
    [60, 300) with render.sample_pdf [100, 150), backward [300, 400),
    reduce [400, 405), optimizer [405, 450). Step 2: inputs [500, 540),
    forward [540, 700), backward [700, 800), reduce [800, 801), optimizer
    [801, 900). The device is busy on [0, 20), [30, 110), [120, 310),
    [320, 330), [340, 420), [505, 520), [560, 710), [820, 950)."""
    host = [("bench.step", 0, 480), ("bench.step", 490, 980),
            ("train.step", 5, 470), ("train.step", 495, 960),
            ("train.inputs", 10, 60), ("train.forward", 60, 300),
            ("render.sample_pdf", 100, 150), ("aten::cat", 105, 115),
            ("train.backward", 300, 400), ("train.reduce", 400, 405),
            ("train.optimizer", 405, 450),
            ("train.inputs", 500, 540), ("train.forward", 540, 700),
            ("train.backward", 700, 800), ("train.reduce", 800, 801),
            ("train.optimizer", 801, 900)]
    busy = [(0, 20), (30, 110), (120, 310), (320, 330), (340, 420),
            (505, 520), (560, 710), (820, 950)]
    device = [("k", s, e) for s, e in busy]
    return Window(work={}, on_card=on_card, steps=2, traced=True,
                  t0_us=0.0, t1_us=1000.0, device=device, host=host)


def read(name, w):
    return cells.metric_reader(name)(w)


def test_host_ms_read_exactly():
    w = window()
    want = {"inputs": 50 + 40, "forward": 240 + 160, "backward": 100 + 100,
            "optimizer": 45 + 99}
    for p, us in want.items():
        assert read(f"{p}_host_ms.train", w) == pytest.approx(us / 1e3 / 2)


def test_idle_ms_read_exactly():
    """Gaps: [20, 30) inputs; [110, 120) forward, inside render.sample_pdf;
    [310, 320) and [330, 340) backward; [420, 505) begins in optimizer and
    ends in the next step's inputs: optimizer alone; [520, 560) inputs, up
    to forward; [710, 820) backward, into optimizer; [950, 1000) outside
    every part."""
    w = window()
    want = {"inputs": 10 + 40, "forward": 10, "backward": 10 + 10 + 110,
            "optimizer": 85}
    for p, us in want.items():
        assert read(f"{p}_idle_ms.train", w) == pytest.approx(us / 1e3 / 2)
    assert spans.idle_us_by_part(w)[None] == pytest.approx(50)


def test_gap_across_parts_counts_for_where_it_began():
    w = window()
    w.device = [("k", 0, 390), ("k", 420, 1000)]   # one gap [390, 420)
    got = spans.idle_us_by_part(w)
    assert got["backward"] == 30
    assert got["optimizer"] == 0 and got[None] == 0


def test_render_idle_counts_for_forward():
    w = window()
    w.device = [("k", 0, 120), ("k", 140, 1000)]   # in render.sample_pdf
    assert spans.idle_us_by_part(w) == {"inputs": 0, "forward": 20,
                                        "backward": 0, "optimizer": 0,
                                        None: 0}
    assert read("forward_idle_ms.train", w) == pytest.approx(0.01)


def test_idle_parts_add_up_to_the_window_idle():
    w = window()
    total = sum(spans.idle_us_by_part(w).values()) / 1e3 / w.steps
    whole = (1 - w.busy_s() / w.window_s) * w.window_s * 1e3 / w.steps
    assert total == pytest.approx(whole)
    outside = spans.idle_us_by_part(w)[None] / 1e3 / w.steps
    assert sum(read(f"{p}_idle_ms.train", w) for p in PARTS) + outside \
        == pytest.approx(whole)
    idle_share = read("idle_share.train", w)
    assert total == pytest.approx(idle_share / 100 * w.window_s * 1e3
                                  / w.steps)


def test_idle_readers_need_the_card():
    w = window(on_card=False)
    for p in PARTS:
        assert read(f"{p}_idle_ms.train", w) is None
        assert read(f"{p}_host_ms.train", w) is not None


@pytest.mark.parametrize("name", METRICS)
def test_readers_give_none_without_spans(name):
    """A parent commit without the program's spans, or an untraced run."""
    w = window()
    w.host = [h for h in w.host if not h[0].startswith("train.")]
    assert read(name, w) is None
    w = window()
    w.traced = False
    assert read(name, w) is None


@pytest.mark.parametrize("name", CELLS)
def test_traced_cpu_run_reports_host_ms(name):
    r = run.run_cell(cells.load_manifest(), name, SEED, 0.0, True,
                     device="cpu", override=SMALL)
    assert r["correct"], r["checks"]
    for p in PARTS:
        v = r["metrics"][f"{p}_host_ms.train"]
        assert v["unit"] == "ms" and math.isfinite(v["value"])
        assert v["value"] > 0
        assert f"{p}_idle_ms.train" not in r["metrics"]    # off the card
