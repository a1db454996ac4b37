#!/usr/bin/env python
"""Time the port's stage-3 ``none`` training step, its render-pass kernel or
all its kernels, in two trees of this repository on one card, interleaved
A, B, B, A.

    python scripts/torch_port_step_ab.py A_DIR B_DIR [--steps 10]
        [--what step|render|kernels|nof|mlp|frame|phases] [--pairs 3]

Each directory is a checkout holding ``chip_smoke.py`` and
``moco_flow_tpu_torch/`` (for example a parent commit unpacked with ``git
archive`` under the git-ignored ``build/``). Both trees build their kernels
first, in parallel, each into its own ``build/torch_kernels/``. Then each
run is a process of its own in its tree: the training slice of
chip_smoke.py's phase 8 (``train(config, args)`` at c2f.yaml widths, 1024
rays x (128 + 128) samples, both chains, from a seeded checkpoint at step
6000), 3 warm steps and ``--steps`` steps timed with CUDA events, in bf16
and fp32. With ``--what render`` a run is chip_smoke.py's phase 3 instead:
the render-pass kernel (#1/#7) at N=4096 rays, coarse S=128 sigma-only and
fine S=256, with and without the NoF, bf16 and fp32, each the mean of 5
launches after a warm one. With ``--what kernels`` a run times the
training kernels #1, #2, #5 and #6 at one stage-3 step's shapes (two
launches each, N=1024, bf16 and fp32, mean of 3 after a warm pair; the
forwards' plain versions too), the
render pass #7 as above (with a 256x256 frame's own 8 launches) and #8 /
#9 at chip_smoke.py phase 12's shapes, each with its plain version (fp32
where the tree's chip_smoke.py times it), and the single NoF warp #3 / #4
as ``--what nof`` does. ``--what nof`` times only #3 / #4, bf16 and fp32,
with their plain versions: the step's correspondence ray (1 x 2000,
forward and backward), the val tile (16384 x 128, forward) and stage 2's
200,000-point set in the shape the tree's ``nof_fused_rays`` launches the
kernels with (forward and backward), and splits one stage-2 call of #4
into device time by kernel name (torch.profiler) beside its wall time on
the host clock. ``--what mlp`` times the per-op NoF #9 alone at the
``pallas`` render tile (16384 x 128 rows, bf16 and fp32, mean of 5 after
a warm launch) with its plain version and a digest of its output (equal
digests, the same bits); ``--what frame`` runs chip_smoke.py's phase 15
(one 256x256 frame under ``pallas`` and under ``fused``, bf16 and fp32,
through ``test(config, args)``). ``--what phases`` runs chip_smoke.py's
phase 11 (the ``msk`` / ``full`` steps and the val step at 108x108, bf16
and fp32) and reports its three times per dtype. The runs go A B B A, ``--pairs``
times over (at least 3); beside every run the card's SM clock, memory
clock and temperature as nvidia-smi reads them just before and just after
it.
Prints one JSON line per run and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import json, os, sys
import torch
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from moco_flow_tpu_torch.ops import _build
if sys.argv[1] == "build":
    _build.build()
    _build.load_library()
    sys.exit(0)
if sys.argv[1] == "render":
    times = cs.phase_kernel_vs_plain(torch.device("cuda"))["times"]
    print("MS " + json.dumps({k: v[0] for k, v in times.items()}),
          flush=True)
    sys.exit(0)
NOF_ROWS = 200000     # stage 2: both NoFs' point set of init_nof.yaml


def nof_times(dev):
    # #3 / #4 at the step ray (1 x 2000, forward and backward), the val
    # tile (16384 x 128, forward) and stage 2's 200k-point set (forward and
    # backward) in the shape the tree's nof_fused_rays hands the kernels,
    # each with its plain version, bf16 and fp32; and the device time of
    # one stage-2 call of #4 by kernel name beside its host-clock wall time
    import re
    import time
    from moco_flow_tpu_torch.nn.embedding import anneal_weights
    from moco_flow_tpu_torch.ops import nof_rays as nr
    gen = torch.Generator().manual_seed(2)
    fcfg = cs.NoFConfig()
    P = cs.init_nof(gen, fcfg, dev)
    an_f = anneal_weights(505000, 5, 5000, 1005000).to(dev)
    cases = {"ray": cs._nof_case(P, fcfg, an_f, 1, 2000, gen, dev),
             "val": cs._nof_case(P, fcfg, an_f, 16384, 128, gen, dev)}
    seen = {}
    apply = nr._NofOp.apply

    def grab(spec, dt, n_parts, xyz_t, *arrs):
        seen["args"] = (spec, xyz_t, list(arrs[:n_parts]),
                        list(arrs[n_parts:]))
        return apply(spec, dt, n_parts, xyz_t, *arrs)

    nr._NofOp.apply = grab
    try:
        nr.nof_fused_rays(P, fcfg, 5, True, an_f,
                          (0.6 * torch.randn(1, NOF_ROWS, 3,
                                             generator=gen)).to(dev),
                          torch.randn(1, 33, generator=gen).to(dev))
    finally:
        nr._NofOp.apply = apply
    spec, xyz, parts, ws = seen["args"]
    g = (torch.randn(tuple(xyz.shape), generator=gen)
         / NOF_ROWS ** 0.5).to(dev)
    cases["stage2"] = (spec, xyz, parts, ws, g)
    out = {"stage2 kernel shape": list(xyz.shape[1:])}
    for dname, dt in (("bf16", torch.bfloat16), ("fp32", None)):
        for shape, bwd in (("ray", True), ("val", False), ("stage2", True)):
            spec, xyz, parts, ws, g = cases[shape]
            calls = {"nof_fwd": lambda: nr.nof_fwd(spec, dt, xyz, parts, ws),
                     "nof_fwd plain": lambda: nr._nof_fwd_ref(spec, dt, xyz,
                                                              parts, ws)}
            if bwd:
                calls["nof_bwd"] = lambda: nr.nof_bwd(spec, dt, xyz, parts,
                                                      ws, g)
                calls["nof_bwd plain"] = lambda: nr._nof_bwd_ref(
                    spec, dt, xyz, parts, ws, g)
            for name, fn in calls.items():
                out[f"{name} {shape} {dname}"] = cs.cuda_ms(fn, reps=5)
        spec, xyz, parts, ws, g = cases["stage2"]
        fn = lambda: nr.nof_bwd(spec, dt, xyz, parts, ws, g)  # noqa: E731
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        split = {"wall": wall}
        for ev in prof.key_averages():
            ms = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0)) / 1e3
            if ms > 0:
                name = re.sub(r"^void |\(anonymous namespace\)::", "",
                              ev.key)
                m = re.match(r"[\w:]+", name)
                k = m.group(0) if m else ev.key[:40]
                split[k] = split.get(k, 0.0) + ms
        out[f"split nof_bwd stage2 {dname}"] = split
    return out


if sys.argv[1] == "nof":
    print("MS " + json.dumps(nof_times(torch.device("cuda"))), flush=True)
    sys.exit(0)
if sys.argv[1] == "mlp":
    # #9 at the pallas render tile (16384 x 128 rows of c2f.yaml's NoF),
    # bf16 and fp32, with its plain version and a digest of its output
    # (equal digests: the same bits)
    import hashlib
    from moco_flow_tpu_torch.ops import fused_mlp as fm
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(3)
    fcfg = cs.NoFConfig()
    ws = fm._nof_weights_flat(cs.init_nof(gen, fcfg, dev))
    rows = 16384 * 128
    inp = (torch.rand(rows, fcfg.in_dim, generator=gen) * 2 - 1).to(dev)
    xyz = (0.6 * torch.randn(rows, 3, generator=gen)).to(dev)
    out = {}
    for dname, dt in (("bf16", torch.bfloat16), ("fp32", None)):
        o = fm.nof_pallas(fcfg, dt, inp, xyz, ws).cpu().numpy()
        out[f"nof_pallas {dname} digest"] = hashlib.sha256(
            o.tobytes()).hexdigest()[:16]
        out[f"nof_pallas {dname}"] = cs.cuda_ms(
            lambda: fm.nof_pallas(fcfg, dt, inp, xyz, ws), reps=5)
        out[f"nof_pallas plain {dname}"] = cs.cuda_ms(
            lambda: fm._nof_pallas_ref(fcfg, dt, inp, xyz, ws), reps=3)
    print("MS " + json.dumps(out), flush=True)
    sys.exit(0)
if sys.argv[1] == "frame":
    ms = cs.phase_pallas_frame("")["ms"]
    print("MS " + json.dumps({f"{route} {dtype}": v
                              for (route, dtype), v in ms.items()}),
          flush=True)
    sys.exit(0)
if sys.argv[1] == "phases":
    r = cs.phase_phases_slice("")
    print("MS " + json.dumps({f"{k} {d}": v for d in ("bfloat16", "float32")
                              for k, v in zip(("msk", "full", "val"), r[d])}),
          flush=True)
    sys.exit(0)
if sys.argv[1] == "kernels":
    from moco_flow_tpu_torch.nn.embedding import anneal_weights
    from moco_flow_tpu_torch.ops import nerf_rays as nr
    from moco_flow_tpu_torch.ops import nof_chain as nc
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(1)
    ncfg = cs.NeRFConfig(extra_feat_type="ind", extra_feat_dim=5)
    fcfg = cs.NoFConfig()
    P = {"nerf": cs.init_nerf(gen, ncfg, dev),
         "bw_NoF": cs.init_nof(gen, fcfg, dev),
         "fw_NoF": cs.init_nof(gen, fcfg, dev)}
    an_n = anneal_weights(505000, 10, 5000, 1005000).to(dev)
    an_f = anneal_weights(505000, 5, 5000, 1005000).to(dev)
    nerf = [cs._nerf_case(P["nerf"], ncfg, an_n, 1024, s, False, gen, dev)
            for s in (128, 256)]
    c = cs._chain_case(P, fcfg, an_f, 1024, 128, True, True, gen, dev)
    out = {}
    for dname, dt in (("bf16", torch.bfloat16), ("fp32", None)):
        calls = {
            "nerf_fwd": lambda: [nr.nerf_fwd(x[0], dt, *x[1:4]) for x in nerf],
            "nerf_bwd": lambda: [nr.nerf_bwd(x[0], dt, *x[1:5]) for x in nerf],
            "chain_fwd": lambda: [nc.chain_fwd(c[0], dt, 2, *c[1:5])
                                  for _ in range(2)],
            "chain_bwd": lambda: [nc.chain_bwd(c[0], dt, 2, *c[1:])
                                  for _ in range(2)]}
        calls["nerf_fwd plain"] = lambda: [nr._nerf_fwd_ref(x[0], dt,
                                                            *x[1:4])
                                           for x in nerf]
        calls["chain_fwd plain"] = lambda: [nc._chain_fwd_ref(c[0], dt, 2,
                                                              *c[1:5])
                                            for _ in range(2)]
        for name, fn in calls.items():
            out[f"{name} {dname}"] = cs.cuda_ms(fn, reps=3)
    for k, v in cs.phase_kernel_vs_plain(dev)["times"].items():
        out["render_pass " + k] = v[0]
        out["render_pass plain " + k] = v[1]
    for k, v in cs.phase_mlp_kernels(dev, "")["times"].items():
        name = k if " " in k else k + " bf16"
        out[name] = v[0]
        out[name.replace("_pallas", "_pallas plain")] = v[1]
    out.update(nof_times(dev))
    print("MS " + json.dumps(out), flush=True)
    sys.exit(0)
from moco_flow_tpu_torch.train.__main__ import parse_args, train
from moco_flow_tpu_torch.train.checkpoint import save_checkpoint
from moco_flow_tpu_torch.train.factory import build_statics, init_params
torch.backends.cuda.matmul.allow_tf32 = False
steps = int(sys.argv[2])
scene = cs.make_synthetic_scene(None, n_frames=8, size=256, focal=300.0)
out = {}
for dtype in ("bfloat16", "float32"):
    cfg = cs.train_config(dtype)
    cfg["save_dir"] = os.path.join(os.getcwd(), "build", "step_ab", dtype)
    cfg["trainer"]["num_iters"] = cs.TRAIN_START + 1
    params = init_params(torch.Generator().manual_seed(0),
                         build_statics(cfg["model"]), with_nof=True,
                         with_fw_nof=True)
    for net in ("coarse_NeRF", "fine_NeRF"):
        params[net]["sigma"]["b"] += 1.0
    seed = os.path.join(cfg["save_dir"], "seeded")
    save_checkpoint(seed, {"params": params}, extra={
        "clock": {"epoch": 1, "minibatch": 0, "step": cs.TRAIN_START}})
    args = parse_args(["-c", "(dict)", "-r", seed + ".npz", "-n", "ab",
                       "--device", "cuda"])
    tr = train(cfg, args, scene=scene)
    for _ in range(3):
        tr.train_step()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(steps):
        tr.train_step()
    e1.record()
    torch.cuda.synchronize()
    out[dtype] = e0.elapsed_time(e1) / steps
print("MS " + json.dumps(out), flush=True)
"""


def _clocks() -> str:
    """The card's SM clock, memory clock and temperature, now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--what", choices=("step", "render", "kernels", "nof",
                                      "mlp", "frame", "phases"),
                   default="step")
    p.add_argument("--pairs", type=int, default=3,
                   help="A B B A rounds, at least 3")
    args = p.parse_args(argv)
    if args.pairs < 3:
        raise SystemExit("--pairs: at least 3 A B B A rounds")
    trees = {"A": os.path.abspath(args.a), "B": os.path.abspath(args.b)}
    builds = {k: subprocess.Popen([sys.executable, "-c", CHILD, "build"],
                                  cwd=d) for k, d in trees.items()}
    for k, proc in builds.items():
        if proc.wait() != 0:
            raise SystemExit(f"build of {k} ({trees[k]}) failed")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for i, k in enumerate(("A", "B", "B", "A") * args.pairs):
        before = _clocks()
        run = subprocess.run([sys.executable, "-c", CHILD, args.what,
                              str(args.steps)], cwd=trees[k],
                             capture_output=True, text=True)
        after = _clocks()
        line = next((ln for ln in run.stdout.splitlines()
                     if ln.startswith("MS ")), None)
        if run.returncode != 0 or line is None:
            sys.stderr.write(run.stdout[-4000:] + run.stderr[-4000:])
            raise SystemExit(f"run {k} failed ({run.returncode})")
        ms = json.loads(line[len("MS "):])
        print(json.dumps({"run": i, "tree": k, "dir": trees[k],
                          "what": args.what, "steps": args.steps,
                          "clocks_before": before, "clocks_after": after,
                          "ms": ms}), flush=True)
    print(card)


if __name__ == "__main__":
    main()
