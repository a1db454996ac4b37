"""``backward_idle_ms.train``: device idle milliseconds a step in gaps that
began inside the program's ``train.backward`` spans: how long the device
waited on that part of the host (``spans.idle_ms``)."""

from benchmark.spans import idle_ms


def read(w):
    return idle_ms(w, "backward")
