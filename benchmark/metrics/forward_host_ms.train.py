"""``forward_host_ms.train``: host milliseconds a step in the program's
``train.forward`` spans (the render, with its ``render.*`` spans, and
the losses up to their sum): how long the host takes to enqueue that
part of a step (``spans.host_ms``)."""

from benchmark.spans import host_ms


def read(w):
    return host_ms(w, "forward")
