#!/usr/bin/env python
"""Time the port's stage-3 ``none`` training step, its render-pass kernel or
all its kernels, in two trees of this repository on one card, interleaved
A, B, B, A.

    python scripts/torch_port_step_ab.py A_DIR B_DIR [--steps 10]
        [--what step|render|kernels] [--pairs 3]

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
where the tree's chip_smoke.py times it). The runs go A B B A, ``--pairs`` times over (at least 3);
beside every run the card's SM clock, memory clock
and temperature as nvidia-smi reads them just before and just after it.
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
    p.add_argument("--what", choices=("step", "render", "kernels"),
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
