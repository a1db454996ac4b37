"""``knn_host_ms.points``: host milliseconds a step in the program's
``data.knn`` spans (``ops/knn.py::nearest_neighbor`` inside
``sample_correspondences``, within ``train.inputs``): how long the host
takes to enqueue the KNN. None without a trace or without the span (a
program that does not open it)."""

SPAN = "data.knn"


def read(w):
    if not (w.traced and w.steps):
        return None
    spans = [(s, e) for n, s, e in w.host if n == SPAN]
    if not spans:
        return None
    return sum(e - s for s, e in spans) / 1e3 / w.steps
