"""``inputs_host_ms.train``: host milliseconds a step in the program's
``train.inputs`` spans (draws to the device, rays, the chained-frame
column, correspondences and their KNN): how long the host takes to
enqueue that part of a step (``spans.host_ms``)."""

from benchmark.spans import host_ms


def read(w):
    return host_ms(w, "inputs")
