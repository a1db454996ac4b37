"""The program's spans in a traced window: the parts of a training step
that ``moco_flow_tpu_torch`` names with ``utils/logging.py::span``.

Inside each ``train.step`` the trainer opens, one after another and never
overlapping, ``train.inputs`` (draws to the device, rays, the chained-frame
column, correspondences and their KNN), ``train.forward`` (the render and
the losses, with the renderer's ``render.*`` spans inside), ``train.backward``
(autograd and the density freeze), ``train.reduce`` (the gradients' mean
over the ranks) and ``train.optimizer`` (the updates). Such a span is a
``record_function`` range, exported as a ``user_annotation`` and kept in
``Window.host`` on the device trace's clock.

The readers give, a step, the host's time in a part's spans and the
device's idle time that began inside them. A parent commit without the
spans reads None.
"""

from __future__ import annotations

import bisect

PARTS = ("inputs", "forward", "backward", "optimizer")


def _part_spans(w, part: str) -> list:
    name = f"train.{part}"
    return [(s, e) for n, s, e in w.host if n == name]


def host_ms(w, part: str) -> float | None:
    """Host milliseconds a step in the ``train.<part>`` spans: their summed
    duration over the window's steps. None without a trace or a span."""
    if not (w.traced and w.steps):
        return None
    spans = _part_spans(w, part)
    if not spans:
        return None
    return sum(e - s for s, e in spans) / 1e3 / w.steps


def gaps(w) -> list:
    """The device's idle intervals, ``(start_us, end_us)``: the complement
    of its busy intervals within ``[t0_us, t1_us]`` (as ``trace.breakdown``
    builds them)."""
    out, prev = [], w.t0_us
    for s, e in w.busy_intervals():
        if s > prev:
            out.append((prev, s))
        prev = max(prev, e)
    if w.t1_us > prev:
        out.append((prev, w.t1_us))
    return out


def idle_us_by_part(w) -> dict:
    """The window's device idle in microseconds by the part whose span was
    open when each gap began; a gap counts whole for that part, a gap in a
    nested ``render.*`` span for ``forward``. The idle that began outside
    the four parts (the benchmark's draws and synchronise, a step's glue,
    ``train.reduce``) is under None."""
    spans = sorted((s, e, p) for p in PARTS for s, e in _part_spans(w, p))
    starts = [s for s, _, _ in spans]
    out = dict.fromkeys((*PARTS, None), 0.0)
    for g0, g1 in gaps(w):
        i = bisect.bisect_right(starts, g0) - 1
        part = spans[i][2] if i >= 0 and g0 < spans[i][1] else None
        out[part] += g1 - g0
    return out


def idle_ms(w, part: str) -> float | None:
    """Device idle milliseconds a step that began inside a
    ``train.<part>`` span: how long the device waited on that part of the
    host. None off the card, without a trace or without the span."""
    if not (w.on_card and w.traced and w.steps and _part_spans(w, part)):
        return None
    return idle_us_by_part(w)[part] / 1e3 / w.steps
