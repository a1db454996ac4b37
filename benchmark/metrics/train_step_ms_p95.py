"""``train_step_ms_p95``: the 95th percentile (linear between order
statistics) of every window step's time, each from its start to the
``torch.cuda.synchronize()`` that ends it; host clock."""

import numpy as np


def read(w):
    if not w.step_s:
        return None
    return float(np.percentile(np.asarray(w.step_s) * 1e3, 95))
