"""Observability: the text log and the scalar records of a run.

Port of ``moco_flow_tpu/utils/logging.py``: a ``log.txt`` work log and an
appendable ``metrics.jsonl`` of scalar (``train/...``, ``valid/...``) and
histogram (``hist/...``) records, so a headless run keeps its losses;
TensorBoard events too where tensorboardX is importable. ``profile_trace``
is the ``torch.profiler`` counterpart of JAX's ``jax.profiler`` hook, and
``span`` names the program's ranges in its trace. In a data-parallel run
the records and the trace are rank 0's (the trainer makes its
``WorkLogger`` there only).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time

import numpy as np
import torch

_NO_SPAN = contextlib.nullcontext()


class WorkLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._logger = logging.getLogger(f"mocoflow_torch.{log_dir}")
        self._logger.setLevel(logging.INFO)
        self._logger.propagate = False
        if not self._logger.handlers:
            h = logging.FileHandler(os.path.join(log_dir, "log.txt"))
            h.setFormatter(logging.Formatter("%(asctime)s - %(message)s"))
            self._logger.addHandler(h)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter
            self._tb = SummaryWriter(os.path.join(log_dir, "train.events"))
        except ImportError:
            pass

    def put_line(self, line: str):
        self._logger.info(line)
        for h in self._logger.handlers:
            h.flush()

    def scalars(self, tag_prefix: str, values: dict, step: int):
        rec = {"step": step, "time": time.time()}
        for k, v in values.items():
            v = float(v)
            rec[f"{tag_prefix}/{k}"] = v
            if self._tb is not None:
                self._tb.add_scalar(f"{tag_prefix}/{k}", v, step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def histogram(self, tag: str, values, step: int):
        """The PE-annealing weights on log steps: a jsonl record of the raw
        vector (and a TensorBoard histogram where it is importable)."""
        values = np.asarray(values)
        if self._tb is not None:
            self._tb.add_histogram(tag, values, step)
        self._jsonl.write(json.dumps(
            {"step": step, "time": time.time(),
             f"hist/{tag}": [float(v) for v in values.ravel()]}) + "\n")
        self._jsonl.flush()

    def image(self, tag: str, img, step: int):
        """img: (H, W, 3) float in [0, 1]; TensorBoard only (tensorboardX
        encodes images with Pillow, so without it there is no image)."""
        if self._tb is not None:
            try:
                self._tb.add_image(tag, img, step, dataformats="HWC")
            except ImportError:
                pass

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        for h in list(self._logger.handlers):
            h.close()
            self._logger.removeHandler(h)


def span(name: str):
    """A named range of the program in a ``torch.profiler`` trace: a
    ``record_function`` while a profiler runs, else a shared null context,
    so that a span costs one flag check when nothing traces. The spans are
    ``train.step`` around a trainer's ``train_step`` and, inside it and
    never overlapping, ``train.inputs``, ``train.forward``,
    ``train.backward``, ``train.reduce`` and ``train.optimizer``;
    ``render.*`` inside a render (``render.sample_pdf``); and
    ``data.correspondences`` around ``sample_correspondences`` with
    ``data.knn`` around its ``nearest_neighbor`` call, both inside
    ``train.inputs`` of the stage-2 step and of the stage-3 ``msk`` /
    ``full`` steps. The benchmark's traced runs read them
    (``benchmark/spans.py``, ``benchmark/metrics/knn_*.points.py``), and
    ``--profile``'s trace (:func:`profile_trace`) shows them."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


def profile_trace(log_dir: str):
    """A ``torch.profiler`` context over the host and, where there is one,
    the card; on exit the trace goes to ``log_dir/plugins/profile/trace.json``
    (Perfetto / chrome://tracing) and a table of the ops by device time
    beside it. On a rank other than 0 it traces nothing."""
    from torch.profiler import ProfilerActivity, profile

    from ..parallel.multihost import is_main
    if not is_main():
        return contextlib.nullcontext()

    out = os.path.join(log_dir, "plugins", "profile")
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)

    @contextlib.contextmanager
    def trace():
        os.makedirs(out, exist_ok=True)
        with profile(activities=acts) as prof:
            yield prof
        prof.export_chrome_trace(os.path.join(out, "trace.json"))
        sort = ("self_cuda_time_total" if len(acts) > 1
                else "self_cpu_time_total")
        with open(os.path.join(out, "ops.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by=sort, row_limit=60))

    return trace()
