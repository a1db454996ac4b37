"""``torch_ops_ms.train``: device milliseconds a step in kernels that are
not the program's own (sorts, ``sample_pdf``, compositing, the losses, the
optimizer's elementwise work, cuBLAS products), the union of their
intervals in the traced window over its steps."""

from benchmark.kernels import is_port_kernel


def read(w):
    if not (w.on_card and w.traced and w.steps and w.device):
        return None
    return 1e3 * w.busy_s(lambda n: not is_port_kernel(n)) / w.steps
