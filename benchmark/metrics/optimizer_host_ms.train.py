"""``optimizer_host_ms.train``: host milliseconds a step in the program's
``train.optimizer`` spans (the optimizers' updates): how long the host
takes to enqueue that part of a step (``spans.host_ms``)."""

from benchmark.spans import host_ms


def read(w):
    return host_ms(w, "optimizer")
