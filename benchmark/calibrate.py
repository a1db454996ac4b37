"""The readings that the limits in ``limits/<cell>.json`` are set from, on
the card at the cell's own size.

    python3 -m benchmark.calibrate --workload c2f.train_msk --seeds 12 \\
        --control 3 --faults 3 --out calib.jsonl

- sound runs: the program through the harness's set-up and steps and the
  reference after it (``run.run_cell`` with a window of one step), one a
  seed: the lower readings;
- the control: the kind's ``control``, the reference put in the program's
  place and computed one precision below the configuration's: the upper
  readings;
- each of the kind's ``FAULTS`` planted in the program;
- with ``--witness``, the kind's ``witness`` (for training: the float32
  reference against the float64 one).

Each reading is one JSON line, also printed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import cells, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first-seed", type=int, default=3_000_000_011)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--witness", type=int, default=0,
                    help="seeds of the kind's witness")
    ap.add_argument("--seed-list", type=int, nargs="*",
                    help="these seeds instead of --first-seed / --seeds")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    manifest = cells.load_manifest()
    cell = cells.load_cell(manifest, args.workload)
    card = torch.cuda.get_device_name(0)
    seeds = args.seed_list or [args.first_seed + 7919 * i
                               for i in range(args.seeds)]

    def emit(kind, seed, values, **extra):
        line = json.dumps({"cell": args.workload, "kind": kind, "seed": seed,
                           "card": card, **values, **extra})
        print(line, flush=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")

    def checked(r):
        return {k: c["value"] for k, c in r["checks"].items()}

    for seed in seeds:
        t = time.time()
        diag: dict = {}
        r = run.run_cell(manifest, args.workload, seed, 0.0, False,
                         diagnose=diag)
        emit("sound", seed, checked(r), seconds=time.time() - t,
             memory_peak_bytes=r["device"]["memory_peak_bytes"], **diag)
    for seed in seeds[:args.control]:
        emit("control", seed, cell.kind.control(cell, seed, "cuda"))
    for seed in seeds[:args.witness]:
        emit("witness", seed, cell.kind.witness(cell, seed, "cuda"))
    for fault in cell.kind.FAULTS:
        for seed in seeds[:args.faults]:
            r = run.run_cell(manifest, args.workload, seed, 0.0, False,
                             fault=fault)
            emit(f"fault_{fault}", seed, checked(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
