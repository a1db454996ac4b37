"""Run one cell of the benchmark of ``moco_flow_tpu_torch`` on the card.

    python3 -m benchmark.run --workload c2f.train_msk --seed 7 --seconds 45 \\
        --trace 0

A run finds the cell's configuration, traffic mix and the mix's kind of
work by name (``cells.py``, ``kinds/``); the kind makes the inputs and
weights on the card from ``--seed``, builds the program's object under
test and warms every shape of its step (set-up ends there). The run times
``--seconds`` of the kind's steps, each ending in a synchronise; then, with
the program's state freed, the kind compares with the plain reference. It
prints each compared number beside its limit as its last lines on standard
error, and one JSON line last on standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones, each read by
``metrics/<name>.py``), ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last.

It exits non-zero without a result when there is no card (or fewer than
the cell asks for), when the program cannot be imported, and when JAX or
the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "moco_flow_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def judge(values: dict, limits: dict) -> tuple[dict, bool]:
    """Each number beside its limit, and whether every number is finite and
    within its limit. A number without a limit fails."""
    checks = {k: {"value": v, "limit": limits.get(k, math.nan)}
              for k, v in values.items()}
    ok = bool(values) and all(math.isfinite(v) and v <= limits.get(k, -1.0)
                              for k, v in values.items())
    return checks, ok


def run_cell(manifest: dict, name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float | None = None,
             override: dict | None = None, fault: str | None = None,
             diagnose: dict | None = None) -> dict:
    """One run of the cell ``name``; returns the result line as a dict.
    ``override`` (merged into the configuration) and ``fault`` (one of the
    kind's ``FAULTS``) are for the tests; ``diagnose``, a dict, gets both
    sides' readings."""
    import torch
    from benchmark import cells, trace as tr_mod

    t_start = time.time() if t_start is None else t_start
    parts = {"start": time.time() - t_start}
    dev = torch.device(device)

    def lap(what):
        _sync(dev)
        parts[what] = time.time() - t_start - sum(parts.values())

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = cells.load_cell(manifest, name, override=override)
    on_card = dev.type == "cuda"
    job = cell.kind.setup(cell, seed, dev, fault=fault, lap=lap)
    window = tr_mod.Window(work=job.work, on_card=on_card,
                           setup_s=time.time() - t_start)

    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    span = torch.profiler.record_function
    outs = []
    t0 = time.perf_counter()
    with span("bench.window"):
        while True:
            s0 = time.perf_counter()
            with span("bench.step"):
                out = job.step(len(outs))
            with span("bench.sync"):
                _sync(dev)
            t1 = time.perf_counter()
            window.step_s.append(t1 - s0)
            outs.append(out)
            if t1 - t0 >= seconds:
                break
    window.wall_s = t1 - t0
    window.steps = len(window.step_s)
    if prof is not None:
        prof.__exit__(None, None, None)
    failed = int((~torch.isfinite(torch.stack(outs).float())).sum())
    mem_peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
    if prof is not None:
        tr_mod.read_chrome_trace(prof, window)
        del prof

    metrics = {}
    for m in cells.cell_metrics(manifest, name, trace):
        value = cells.metric_reader(m["name"])(window)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    del outs, out
    job.finish()
    values = job.compare()
    if diagnose is not None:
        diagnose.update(job.diagnose)
    checks, ok = judge(values, cells.load_limits(name))
    result = {"correct": bool(ok and failed == 0),
              "attempted": window.steps, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": (torch.cuda.get_device_name(dev)
                                  if on_card else "cpu"),
                         "count": 1, "memory_peak_bytes": mem_peak}}
    if trace and window.traced:
        result["device"]["busy_s"] = window.busy_s()
        result["device"]["window_s"] = window.window_s
        result["breakdown"] = tr_mod.breakdown(window)
    result["_steps_s"] = list(window.step_s)
    result["_setup_parts"] = parts
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # Python's bytecode of every module the run imports, torch's too, kept
    # at a fixed path inside the checkout, also where the environment says
    # not to write it: only the checkout's first run compiles it
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False
    from benchmark.cells import load_manifest
    manifest = load_manifest()
    wl = next((w for w in manifest["workloads"]
               if w["name"] == args.workload), None)
    if wl is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(wl["chips"]):
        print(f"{args.workload} needs {wl['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(manifest, args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=T_START)
    steps = sorted(1e3 * t for t in result.pop("_steps_s"))
    print(f"step ms: n {len(steps)}, min {steps[0]:.2f}, median "
          f"{steps[len(steps) // 2]:.2f}, max {steps[-1]:.2f}",
          file=sys.stderr)
    print("setup_s parts: " + ", ".join(
        f"{k} {v:.3f}" for k, v in result.pop("_setup_parts").items()),
        file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result, allow_nan=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
