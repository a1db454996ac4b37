"""The measured window as the metric readers see it, and the reading of a
``torch.profiler`` trace of it.

A traced run wraps the window in ``torch.profiler.profile`` (CPU and CUDA
activities) with the benchmark's own spans around each call into the
program (``bench.window``, ``bench.step``, ``bench.sync``, and a kind's
own, such as ``bench.draws``), exports the Chrome trace into a temporary directory and
reads back the device's kernels, copies and sets, and the host's spans and
operators, on one clock.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


@dataclasses.dataclass
class Window:
    """What one run measured. ``work`` is what one step counts, as the
    cell's kind gives it (``model_flops``; ``launches``, the
    ``counts.Launch`` of each kernel launch; ``roofline_kernel``, whether
    a device kernel's name is one of those launches'). Host timings are in
    seconds; trace times (``device``, ``host``: ``(name, start_us,
    end_us)``) in microseconds, clipped to the traced window
    ``[t0_us, t1_us]``."""
    work: dict
    on_card: bool
    steps: int = 0
    wall_s: float = 0.0
    step_s: list = dataclasses.field(default_factory=list)
    setup_s: float = 0.0
    traced: bool = False
    t0_us: float = 0.0
    t1_us: float = 0.0
    device: list = dataclasses.field(default_factory=list)
    host: list = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.t1_us - self.t0_us) / 1e6

    def busy_intervals(self, keep=lambda name: True) -> list:
        """The union of the device intervals whose name ``keep`` accepts,
        as sorted disjoint ``(start_us, end_us)``."""
        spans = sorted((s, e) for n, s, e in self.device if keep(n))
        out = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(x) for x in out]

    def busy_s(self, keep=lambda name: True) -> float:
        return sum(e - s for s, e in self.busy_intervals(keep)) / 1e6


def short_name(name: str) -> str:
    """A kernel's name without ``void``, template arguments and
    parameters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    for sep in ("<", "("):
        name = name.split(sep)[0]
    return name.strip() or "?"


def read_chrome_trace(prof, window: Window) -> None:
    """Fill ``window``'s trace fields from the profiler ``prof``, whose
    ``bench.window`` span bounds the window."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in spans if e.get("cat") == "user_annotation"
           and e.get("name") == "bench.window"]
    if not win:
        raise RuntimeError("the trace holds no bench.window span")
    t0 = float(win[0]["ts"])
    t1 = t0 + float(win[0]["dur"])
    window.t0_us, window.t1_us = t0, t1
    for e in spans:
        s = float(e["ts"])
        end = s + float(e["dur"])
        if end < t0 or s > t1:
            continue
        item = (e.get("name", "?"), max(s, t0), min(end, t1))
        if e.get("cat") in DEVICE_CATS:
            window.device.append(item)
        elif e.get("cat") in HOST_CATS:
            window.host.append(item)
    window.traced = True


def breakdown(window: Window, top: int = 10) -> dict:
    """The device operations that took most time (seconds, summed by
    name), and the device's idle time summed by what the host was doing
    when each gap began: the innermost benchmark span and host operator
    open then."""
    ops: dict = {}
    for name, s, e in window.device:
        k = short_name(name)
        ops[k] = ops.get(k, 0.0) + (e - s) / 1e6
    busy = window.busy_intervals()
    gaps, prev = [], window.t0_us
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if window.t1_us > prev:
        gaps.append((prev, window.t1_us))
    host = sorted(window.host, key=lambda h: h[1])
    by_what: dict = {}
    active, i = [], 0
    for g0, g1 in gaps:                  # a sweep: the host events open at g0
        while i < len(host) and host[i][1] <= g0:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[2] >= g0]
        span = min((h for h in active if h[0].startswith("bench.")),
                   key=lambda h: h[2] - h[1], default=None)
        op = min((h for h in active if not h[0].startswith("bench.")),
                 key=lambda h: h[2] - h[1], default=None)
        label = " > ".join(x[0] for x in (span, op) if x) or "no host span"
        by_what[label] = by_what.get(label, 0.0) + (g1 - g0) / 1e6
    order = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(by_what.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in order],
            "idle_gaps": [[k, v] for k, v in idle]}
