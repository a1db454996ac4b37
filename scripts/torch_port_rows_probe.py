#!/usr/bin/env python
"""Check that the fused test render gives a ray the same bits in any tile,
which the packed stream of views (``render/packed.py``) and ``occ_tighten:
0`` rest on, with the render pass's per-ray partials as GEMMs of one shape
(``ops/folds.py::_rows_matmul``) and, for comparison, as one GEMM over the
call's rays (a BLAS picks its kernel, and the order of its sum, from the
shape).

    python scripts/torch_port_rows_probe.py [--device cuda]

c2f.yaml's stage-3 model at its widths (phase 5's: a seeded init, sigma
biases +1) on frame 0 of the 256x256 synthetic scene: ``render_rays`` of
rays [a, b) against the same rays inside one 16384-ray call, for a few
(a, b), in fp32 and bf16. Prints, for each, the number of differing
elements and the largest difference of every output, then the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SPANS = ((0, 4096), (8192, 12288), (0, 2048), (100, 2148))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import chip_smoke as cs
    from moco_flow_tpu_torch.ops import folds
    from moco_flow_tpu_torch.render.volume import render_rays
    from moco_flow_tpu_torch.train.stage_mocoflow import MoCoFlowTrainer
    cfg = cs.occupancy_config()
    scene = cs.make_synthetic_scene(None, n_frames=8, size=256, focal=300.0)
    tr = MoCoFlowTrainer(cfg, device=args.device, seed=0, scene=scene)
    tr.build_model(cfg["model"])
    tr.prepare_dataloader(cfg["dataloader"])
    for net in ("coarse_NeRF", "fine_NeRF"):
        tr.params[net]["sigma"]["b"] += 1.0
    rays = tr.val_dataset.frame_rays(0).to(args.device)
    bg = torch.ones((rays.shape[0], 3), device=args.device)
    anneal = tr.anneal()

    def compare(tag: str, dtype: str):
        rcfg = dataclasses.replace(tr.rcfg_test, compute_dtype=dtype)
        with torch.no_grad():
            big = render_rays(tr.params, tr.statics, anneal, rays[:16384],
                              bg[:16384], rcfg)
            for a, b in SPANS:
                small = render_rays(tr.params, tr.statics, anneal,
                                    rays[a:b], bg[a:b], rcfg)
                diffs = {k: (int((small[k] != big[k][a:b]).sum()),
                             float((small[k] - big[k][a:b]).abs().max()))
                         for k in small}
                print(f"{tag}, {dtype}, rays {a}:{b} against the same rays "
                      f"in a 16384-ray call: {diffs}", flush=True)

    for dtype in ("float32", "bfloat16"):
        compare("partials in GEMMs of one shape", dtype)
    rows = folds._rows_matmul
    folds._rows_matmul = lambda x, w: x.float() @ w.float()
    try:
        compare("partials as one GEMM", "float32")
    finally:
        folds._rows_matmul = rows
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())


if __name__ == "__main__":
    main()
