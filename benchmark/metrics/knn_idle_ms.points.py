"""``knn_idle_ms.points``: device idle milliseconds a step in gaps that
began inside the program's ``data.knn`` spans (the device's gaps of
``spans.gaps``, each counted whole where it began): how long the device
waited on the host's KNN. None off the card, without a trace or without
the span (a program that does not open it)."""

import bisect

from benchmark.spans import gaps

SPAN = "data.knn"


def read(w):
    spans = sorted((s, e) for n, s, e in w.host if n == SPAN)
    if not (w.on_card and w.traced and w.steps and spans):
        return None
    starts = [s for s, _ in spans]
    idle = 0.0
    for g0, g1 in gaps(w):
        i = bisect.bisect_right(starts, g0) - 1
        if i >= 0 and g0 < spans[i][1]:
            idle += g1 - g0
    return idle / 1e3 / w.steps
