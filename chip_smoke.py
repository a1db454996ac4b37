#!/usr/bin/env python
"""Smoke test of the PyTorch + CUDA port on one GPU: builds the port's CUDA
kernels from this checkout, checks each against its plain PyTorch version
and against the JAX package's numbers (fixtures), then renders and scores
a frame and trains a few steps through the port's own entry points.

    python3 chip_smoke.py

Phases (each ends in torch.cuda.synchronize(), so a fault shows where it
happened; any failure raises and the script exits non-zero):
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. build the kernels (nvcc, sm_90a) into build/torch_kernels/; the
     forward MLP kernels' and the fp32 training passes' registers, stack
     and spills from -Xptxas -v (a spill fails the phase);
  3. kernel against plain version: first one product of the wgmma tile
     (wg_tile.cuh, through wg_probe.cu) against the plain product, then
     render_pass vs render_pass_ref on the same
     CUDA inputs at the published widths (NeRF 8x256, bw-NoF 4x128), all four
     variants (coarse S=128 sigma-only / fine S=256 full, with and without
     the NoF warp), N = 1000 (ragged) and 4096 rays, fp32 and bf16, with
     times at N = 4096 and a 256x256 frame's own 8 launches (TFLOP/s, share
     of the bf16 and split-TF32 bounds, weight bytes streamed from L2);
  4. the port against JAX's numbers: tests/fixtures/torch_port_golden.npz
     (written by scripts/make_torch_port_golden.py) rendered through the
     port's render_rays on the card;
  5. the slice end to end: the in-memory 256x256 synthetic scene (8 frames),
     the c2f.yaml stage-3 model at its published widths from a seeded-init
     checkpoint, ``test(config, args)`` with --eval_metrics on one frame, in
     bf16 and fp32; the kernel must have launched twice per 16384-ray tile,
     the outputs must be finite and non-trivial, and the frame is timed with
     CUDA events after a warm frame;
  6. the training step's kernels against their plain versions at full width
     (NeRF 8x256, NoF 4x128): the NeRF forward and backward (nerf_rays.cu),
     full and sigma-only, and the warp chain forward and backward
     (chain_bwd.cu) with local + global, local only and global only chains,
     N x S = 1000 x 128, 256 x 256 and 1000 x 127 (rows not a multiple of
     the 128-row tile), fp32 and bf16: outputs, dxyz, every d(partial) and
     dW, under TRAIN_TOL, bf16 also within the plain version's own
     bf16-vs-fp32 gap; the fp32 forwards' and backwards' error (the split
     TF32 product of their passes);
     every kernel bitwise equal across two launches, the backward kernels
     also in chunks (a lowered scratch cap) as in one launch; then each
     kernel, its plain version and its bounds at one step's shapes, and
     the backward kernels' split (forward pass, walk pass, dW products, dW
     sums), scratch size and TFLOP/s;
  7. the training step against JAX's numbers: the two steps of
     tests/fixtures/torch_port_train_golden.npz (written by
     scripts/make_torch_port_train_golden.py) replayed on the card with
     JAX's draws: loss terms, train_psnr and the updated parameters;
  8. the training slice end to end: ``train(config, args)`` of
     moco_flow_tpu_torch.train on the in-memory 256x256 scene at c2f.yaml
     widths with both chains, from a seeded checkpoint at step 6000 (the
     ``none`` phase), 6 steps in bf16 and in fp32; each training kernel
     must have launched twice per step, the losses must be finite and the
     parameters must move; the step is timed with CUDA events after 3 warm
     steps with its peak memory, and one bf16 step is profiled (device time
     by kernel group, idle share;
     build/chip_smoke_train/train_step_profile.txt);
  9. the single-warp NoF kernels (the one-stage entry points of
     chain_bwd.cu) against their plain versions at the full NoF width
     (4x128, skip 2, 5 + 16 frequencies, quaternion head), fp32 and bf16:
     one ray of 2000 samples (the step's correspondence set) and of 10000
     (one ray over many tiles), stage 2's 200,000-point set as
     nof_fused_rays launches it (re-chunked into 49 rays of 4096 samples),
     forward and backward, and the val tile 16384 x 128, forward; the
     backward's scratch (reckoned and the kernel's) and chunks at stage 2's
     shape; then each kernel, its plain version and its bound at the step
     ray, the val tile and stage 2's shape;
  10. the msk / full phases against JAX's numbers: the steps of
     tests/fixtures/torch_port_phases_golden.npz (written by
     scripts/make_torch_port_phases_golden.py) replayed on the card in fp32
     (full + freeze with both optimizers, none + freeze where the nof
     optimizer goes, msk), and the val step;
  11. the phases end to end: ``train(config, args)`` at c2f.yaml widths
     with its loss weights and both Adams, on a 256x256 scene whose body has
     SMPL's 6890 vertices, from step 4996 across full -> none + freeze ->
     none and from 9998 across none -> msk, bf16 and fp32, with the launch
     counts of each phase; a msk and a full step timed (3 warm + 5 timed),
     the val step at val_size 108x108 timed, one bf16 msk step profiled
     (build/chip_smoke_train/msk_step_profile.txt);
  12. the per-op MLP kernels (fused_mlp.cu, #8/#9) against their plain
     versions at full width, then timed (#8 also TFLOP/s, share of its
     bounds and weight bytes streamed from L2 a stage-1 step);
  13. JAX's stage-1 fixture replayed on the card (fp32);
  14. stage 1 through ``train(config, args)`` at init_nerf.yaml's model
     under mlp_impl: pallas from a seeded init whose sigma heads are
     biased up by 1 (launches, step, peak memory, val, profile),
     then a step as the YAML is written ('xla': #1/#2), with its peak
     memory and the backward's chunks;
  15. the pallas 256x256 frame against the fused render;
  16. JAX's stage-2 fixture (tests/fixtures/torch_port_stage2_golden.npz,
     written by scripts/make_torch_port_stage2_golden.py) replayed on the
     card in fp32: three stage-2 steps and the val step, and the stage-3
     none / msk steps and val step under mlp_impl: pallas;
  17. stage 2 through ``train(config, args)`` at init_nof.yaml's model and
     N_sampled 100,000 on a body of 6890 vertices: #3/#4 launches, the val
     step every 2 steps, step time, the KNN's time beside the plain BLAS
     formula's (and its bits in other chunks, with TF32 allowed and as the
     BLAS formula), peak memory, a profile with the idle
     share (build/chip_smoke_stage2/stage2_step_profile.txt);
  18. the stage-3 step under mlp_impl: pallas at c2f.yaml's widths through
     ``train(config, args)`` (full -> none, none -> msk; bf16 and fp32) with
     #8/#9 launches a step, #8/#9 against their plain versions on the
     arguments of the steps' own launches (each shape: c2f's NeRF with its
     5-wide 'ind' extra at 1024 x 128 and 1024 x 256 rows, the mask
     term's sigma-only rows, the NoF's sample sets and N_sampled points;
     fp32 and bf16), each phase's step time beside the fused route's, and
     the pallas val step;
  19. the hand-over: stage 3 built from phase 14's and phase 17's finals
     (pretrained_nerf / pretrained_nof), the moved tensors checked equal,
     then a few fused full steps through ``train(config, args)`` in which
     the NoFs and the rgb branch move, with each step's share of samples
     with alpha >= 0.01.
  20. the published runs through the CLIs: a synthetic 8-frame scene written
     as 1080x1080 RGBA PNGs (drawn at 135x135 and upsampled with the port's
     bilinear resize, the meta's intrinsics scaled to match) and a
     6890-vertex SMPL pickle under $SMPL_MODEL_DIR; the real
     configs/people_snapshot/male-3-casual/{init_nerf,init_nof,c2f}.yaml
     read with the port's loader, changed only in root_dir, save_dir,
     num_iters, val_every_n_step (2), vis_mesh_video_every_n_val (1) and
     c2f's pretrained_nerf / pretrained_nof (stage 1's and stage 2's
     finals), written back and run through
     ``moco_flow_tpu_torch.train.main`` twice each (the second call one
     step more: its log.txt must hold the resume line); stage 1 starts from
     a seeded checkpoint (-r) whose sigma biases put the canonical density
     around visualize_mesh's threshold of 10, so its mesh is not empty.
     That field is a fresh NeRF's, nearly flat: the meshes and the
     marching-cubes time are of its level sets, not of a body.
     Each run's layout, config.yaml, code snapshot, finite train/ and
     valid/ records, and for stages 1 and 3 the frame strips, the 90-view
     orbits and the meshes are checked. Then one spherical view and the
     256^3 sigma grids (canonical, and frame 0 through #3) are timed, the
     grids' 0.75 quantiles set the test meshes' thresholds, marching cubes
     is timed, and ``moco_flow_tpu_torch.test.main`` runs every mode on the
     stage-3 final at --reso 128 (training poses, spherical, bullet time,
     the mesh canonical and of frame 0 at --N_grid 256, --render_frame 0
     and -1, --eval_metrics), on the fused route ('xla') and under
     mlp_impl: pallas. #3/#7/#8/#9 are held against their plain versions on
     the first launch of each shape on these paths (fp32 and bf16), before
     it runs.
     Depth cuts: 1-2 training steps a call, so stages 1 and 3 visualise
     three times each (step 0's val, the closing visualize_batch of each
     call); the test modes at --reso 128.
  21. occupancy skipping and the packed stream: phase 5's c2f model on a
     256x256 scene with a 6890-vertex body, fp32 on the fused route as
     c2f.yaml runs it, its fine NeRF fitted (400 Adam steps, scaffolding)
     to sigma 150 within 0.15 of the body's vertices and -20 elsewhere and
     copied into the coarse one; the grids at 192^3 x supersample 2
     (canonical, frame 0 direct and warp) timed with CUDA events, a view's
     tighten (empty_frac, range_ratio), a 256x256 frame exact and with
     occupancy (both times, the PSNR between them), with occ_tighten 0 the
     kept rays equal to the exact render's bits, a 16-view orbit packed
     against a view at a time (equal bits, ms a view each), a 1024x1024
     frame_rays_scaled view, and 4 orbit views packed against a view at a
     time under mlp_impl: pallas (equal bits); #3/#7/#8/#9 held on each
     first shape in fp32, #7/#8/#9 beside their fp64 plain versions where
     the fitted field's gain lifts fp32's own rounding above TOL
     (_hold_exact, which must also reject two wrong kernels). Then
     test.main --occ_res 64 on phase 20's stage-3 final (--render_frame 0,
     --eval_metrics) on both routes, #3/#7/#8/#9 held as in phase 20.
  22. the training options and the render-time models:
     (a) phase 21's fitted field distilled into a 4x128 student
     (render/distill.py's distill_with_restarts: bench.py's 3000 steps of
     16384 points, up to 3 seeds), ms a distill step, the 256^2 frame exact
     in fp32 and bf16 for the teacher and the student (#7 at 4x128 skip
     2; PSNR against the teacher's fp32 frame), the occupancy grid rebuilt
     on the student and its frame with occupancy, train_step refused after
     the swap; #7 / #8 at the student's widths held on a seeded init in
     fp32 and bf16, and on the fitted field's launches in fp32
     (_hold_exact); (b) stage 1 with scripts/bench_hashgrid.py's hash NeRF
     (L 8, F 2, T 2^16, res 16-256, 2x64, dir 27, lr 1e-2) through train()
     on a 128^2 scene, 1024 rays x (64 + 64), 3 steps and a val step in
     fp32 and bf16 beside the 8x256 PE NeRF in the same cell, and one
     stage-3 full step with a hash NeRF under auto (-> fused_nof); (c)
     phase 18's cell on one trainer a dtype: msk / full / none steps under
     fused_nof, fused_nerf, fused and pallas (2 warm, 3 timed), and a 256^2
     test frame under each hybrid; (d) a stage-3 full step per optimizer
     (sgd with momentum, adam with weight decay, adamw with warmup,
     ranger, radam with weight decay) x schedule (explr, cosine, poly), and
     one with noise_std 1.0: finite losses, moving parameters, the
     opt_named round trip. #3 / #8 / #9 held on the first launch of each
     shape of (b) and (c).
  23. data parallelism: two ranks on cuda:0 over gloo, spawned by
     parallel/multihost.py::launch (the kernels built here first): (a)
     tests/fixtures/torch_port_dp_golden.npz (JAX's make_mesh(2) steps of
     the three stages, scripts/make_torch_port_dp_golden.py) replayed on
     each rank within STEP_TOL, the ranks' parameters equal to the bit;
     (b) train() at c2f.yaml's widths from a seeded checkpoint at step
     4990, 3 full steps (the clock ticking by 2) in fp32 and in bf16,
     equal to the bit to one process that runs both ranks' draws on the
     same parameters, averages their gradients and metrics and applies the
     same two Adam updates; each rank's step, the gradient all-reduce and
     peak memory; (c) one stage-1 step (init_nerf.yaml, 'xla') and one
     stage-2 step (init_nof.yaml) through train() on the two ranks; (d)
     test() --eval_metrics on one 256x256 fp32 frame, fused and pallas,
     each rank's frame equal to world 1's to the bit, both timed; (e) the
     fixture over NCCL on two cards, where there are two (else the line
     says it was not run). The two ranks share one card's SMs: its times
     are no scaling figure.
  24. the offline toolchain (moco_flow_tpu_torch/scripts/): (a) a seeded
     30-frame VIBE pkl over the 6890-vertex body's SMPL pickle ->
     train.json / val.json (equal to the bit to a second run) and
     create_init_nerf_data's 120 views at 1080^2 on the card; two views
     drawn again on the card and by the CPU plain version (alpha may
     differ on 0.01% of pixels, rgb where both cover within 1e-5; the
     written PNGs are the card's renders), ms a view on each; (b)
     median_background of 30 and 31 of those frames on the card, equal to
     the CPU plain version and to np.median; (c) two init_nerf.yaml steps
     through the training CLI on the 120 views; (d) phase 5's model at
     c2f.yaml's widths -> reverse_checkpoint -> a reference .pth ->
     convert_ref_ckpt's CLI with --config c2f.yaml: its 256^2 fp32 frame
     equal to the bit to the original's; (e) drive_pipeline_e2e's CLI
     (TOOL_PIPE_STEPS a stage, no occupancy eval), in a process of its
     own beside (c) and (d): PSNR and SSIM.
Phase 9 also holds #3/#4 at init_nof.yaml's NoF (0 xyz bands) at stage 2's
shape. The last three lines are the card, the kernel JSON (launch counts
from the main paths of phases 5, 8, 11, 14, 15, 17, 18, 19, 20, 21, 22,
23 and 24) and the result JSON. Needs one CUDA card; imports neither JAX nor moco_flow_tpu.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
DEVICE = "cuda"     # the training entry point's --device (phases 8, 11)

from moco_flow_tpu_torch.data.synthetic import make_synthetic_scene  # noqa: E402
from moco_flow_tpu_torch.nn.embedding import anneal_weights  # noqa: E402
from moco_flow_tpu_torch.nn.nerf import NeRFConfig, init_nerf  # noqa: E402
from moco_flow_tpu_torch.nn.nof import NoFConfig, init_nof  # noqa: E402
from moco_flow_tpu_torch.ops import _build  # noqa: E402
from moco_flow_tpu_torch.ops.render_pass import (  # noqa: E402
    render_pass, render_pass_ref)
from moco_flow_tpu_torch.render.volume import (  # noqa: E402
    EmbeddingSpec, RenderConfig, embed_padded, render_rays)
from moco_flow_tpu_torch.test import parse_args, test  # noqa: E402
from moco_flow_tpu_torch.train.checkpoint import (  # noqa: E402
    _unflatten, params_from_jax, save_checkpoint)
from moco_flow_tpu_torch.train.factory import (  # noqa: E402
    build_statics, init_params)

# kernel vs plain version, (atol, rtol) on |kernel - plain| <= atol + rtol|plain|.
# fp32: both sum in fp32, in other orders (measured max 1.2e-7 on an H100).
# bf16: both round the same values to bf16, but another summation order can
# flip a rounding (2^-8 relative) that later layers carry (measured max
# 1.4e-4, sigmas up to 0.035); the bound is the bf16-vs-fp32 gap that
# tests/test_torch_nn.py measures for the JAX package (7.8e-4), rounded up.
TOL = {"fp32": (1e-4, 1e-4), "bf16": (1e-3, 1e-2)}
# the port on the card against JAX's fixture numbers, on the same grounds
GOLDEN_TOL = {"float32": TOL["fp32"], "bfloat16": TOL["bf16"]}
FIXTURE = os.path.join(HERE, "tests", "fixtures", "torch_port_golden.npz")
REPLACES = "moco_flow_tpu/ops/megakernel.py:1466"  # _pass_call
SOURCE = "moco_flow_tpu_torch/ops/csrc/render_pass.cu"
# (name, source, TPU kernel it replaces) of the training step's kernels
TRAIN_KERNELS = (
    ("nerf_fwd", "moco_flow_tpu_torch/ops/csrc/nerf_rays.cu",
     "moco_flow_tpu/ops/megakernel.py:389"),
    ("nerf_bwd", "moco_flow_tpu_torch/ops/csrc/nerf_rays.cu",
     "moco_flow_tpu/ops/megakernel.py:558"),
    ("chain_fwd", "moco_flow_tpu_torch/ops/csrc/chain_bwd.cu",
     "moco_flow_tpu/ops/megakernel.py:1154"),
    ("chain_bwd", "moco_flow_tpu_torch/ops/csrc/chain_bwd.cu",
     "moco_flow_tpu/ops/megakernel.py:1214"))
# the single warp of the msk / full phases and the val step
NOF_KERNELS = (
    ("nof_fwd", "moco_flow_tpu_torch/ops/csrc/chain_bwd.cu",
     "moco_flow_tpu/ops/megakernel.py:876"),
    ("nof_bwd", "moco_flow_tpu_torch/ops/csrc/chain_bwd.cu",
     "moco_flow_tpu/ops/megakernel.py:1012"))


def log(msg: str):
    print(msg, flush=True)


def check_close(name, got, want, atol, rtol) -> float:
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    if bad.any():
        raise AssertionError(f"{name}: max |diff| {err.max().item():.3e} "
                             f"exceeds {atol:g} + {rtol:g}|ref| at "
                             f"{int(bad.sum())} elements")
    return err.max().item()


def cuda_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def phase_card() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke test needs one GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[1 card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    # fp32 matmuls of the plain versions stay fp32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# the kernels of #7 / #8 / #9 (wgmma tile in bf16, split TF32 in fp32) and
# the wgmma layer probe, by the name ptxas gives them
FWD_KERNELS = ("render_pass_wg_kernel", "render_pass_tf32_kernel",
               "nerf_wg_kernel", "nerf_tf32_kernel", "nof_wg_kernel",
               "nof_tf32_kernel", "wg_probe_kernel")
# their dynamic shared memory a block at the main paths' widths (ptxas
# reports only static shared memory), from the kernels' layouts: wgmma
# tile 1 KB alignment + 4 x 32 KB weight ring + H (4 x 16 KB) + E (16 KB) +
# 128 B of mbarriers, #7 also positions and NoF head outputs (9,728 B);
# split TF32 two 16 x 264 fp32 weight slices + E (128 x 68) + H (128 x 260)
# fp32, #7 also positions and head outputs (19 x 128 fp32). #9 at c2f's NoF
# (66 inputs, 128 wide): a 7 x 16 KB ring, H (2 x 16 KB), two E buffers (2
# x 2 x 16 KB), two position buffers and the head outputs (22 x 128 fp32)
# and their 4 mbarriers; split TF32 two hi + lo pairs of 16 x 264 slices,
# E (128 x 84), H (128 x 132) and the head outputs (128 x 16)
FWD_SMEM = {"render_pass_wg_kernel": 1024 + 4 * 32768 + 5 * 16384 + 9728
            + 128,
            "nerf_wg_kernel": 1024 + 4 * 32768 + 5 * 16384 + 128,
            "nof_wg_kernel": 1024 + 7 * 16384 + 6 * 16384 + 22 * 128 * 4
            + 32 + 128,
            "render_pass_tf32_kernel": 4 * (19 * 128 + 2 * 16 * 264
                                            + 128 * (68 + 260)),
            "nerf_tf32_kernel": 4 * (2 * 16 * 264 + 128 * (68 + 260)),
            "nof_tf32_kernel": 4 * (4 * 16 * 264 + 128 * (16 + 84 + 132))}
# the fp32 builds of #2 / #4 / #6's row-tile passes (split TF32), by the
# stem of their mangled names
PASS_KERNELS = {f"{k}<float>": f"{k}IfE" for k in (
    "nerf_fwd_pass", "nerf_walk_pass", "chain_fwd_pass", "chain_walk_pass",
    "nof_fwd_pass", "nof_walk_pass")}
# and of the long-K weight-gradient product (wgrad.cu, split TF32 on wgmma)
DW_KERNELS = {"matrix_mma_kernel<float>": "matrix_mma_kernelIfE"}
PTXAS = {}   # kernel -> its ptxas lines (registers, stack, spills)


def phase_build():
    t0 = time.perf_counter()
    path, out = _build.build()
    _build.load_library()
    dt = time.perf_counter() - t0
    log(f"[2 build] {path} in {dt:.1f} s")
    checked = {**{k: k for k in FWD_KERNELS}, **PASS_KERNELS, **DW_KERNELS}
    name = None
    for line in out.splitlines():
        if "Function properties for" in line:
            name = next((k for k, stem in checked.items() if stem in line),
                        None)
        if "registers" in line or "spill" in line:
            log(f"[2 build] {line.strip()}")
            if name:
                PTXAS.setdefault(name, []).append(line.strip())
    if PTXAS:   # a cached build prints nothing
        spills = []
        for k in checked:
            info = " | ".join(PTXAS.get(k, ["not in the compiler's output"]))
            log(f"[2 build] {k}: {info}")
            if " 0 bytes spill stores" not in info:
                spills.append(k)
        if spills:
            raise AssertionError(f"{', '.join(spills)} spill registers")


def fwd_weight_bytes(mats, dname: str) -> int:
    """Bytes of weights one 128-row tile of #7 / #8 / #9 streams from L2: bf16
    the wgmma tile's slice images (ceil(K / 64) x wg_width(N) x 128), fp32
    the split-TF32 product's staged rows (K x pad16(N) x 4)."""
    from moco_flow_tpu_torch.ops._args import wg_width
    if dname == "bf16":
        return sum(-(-k // 64) * wg_width(n) * 128 for k, n in mats)
    return sum(k * -(-n // 16) * 16 * 4 for k, n in mats)


def fwd_shares(flops: float, k_ms: float, dname: str) -> str:
    """TFLOP/s and the share of the bound: bf16 against 989 TFLOP/s, fp32
    against the split TF32 product's (3 TF32 products a term at 495) and
    the FFMA one (67)."""
    tf = flops / k_ms / 1e9
    if dname == "bf16":
        return (f"{tf:.1f} TFLOP/s, {bound_ms(flops, 0, 'bf16')[0] / k_ms:.1%}"
                " of the bf16 bound")
    return (f"{tf:.1f} TFLOP/s, {3 * flops / PEAK['tf32'] * 1e3 / k_ms:.1%} "
            f"of the split-TF32 bound ({3 * flops / PEAK['tf32'] * 1e3:.3f} "
            f"ms), {bound_ms(flops, 0, 'fp32')[0] / k_ms:.1%} of the FFMA "
            "bound")


def phase_wg_probe(dev) -> float:
    """One product of the wgmma tile (csrc/wg_tile.cuh, through the
    card-only entry point csrc/wg_probe.cu) against the plain product on
    the same bf16 operands, before the kernels built on it: 128 x 256 x
    256, N = 8, 16, 128, ragged K = 63 and 90 and rows not a multiple of
    the tile; fp32 sums in another order, so TOL["fp32"]."""
    from moco_flow_tpu_torch.ops.wg_probe import wg_layer, wg_layer_ref
    gen = torch.Generator().manual_seed(11)
    worst = 0.0
    for rows, k, n in ((128, 256, 256), (128, 256, 128), (128, 256, 16),
                       (128, 256, 8), (128, 63, 256), (128, 90, 128),
                       (1000, 33, 9)):
        a = torch.randn(rows, k, generator=gen).to(dev)
        w = (torch.randn(k, n, generator=gen) / k ** 0.5).to(dev)
        b = torch.randn(n, generator=gen).to(dev)
        got, want = wg_layer(a, w, b), wg_layer_ref(a, w, b)
        torch.cuda.synchronize()
        e = check_close(f"wg probe {rows}x{k}x{n}", got, want, *TOL["fp32"])
        worst = max(worst, e)
        log(f"[3 kernel vs plain] wgmma layer probe {rows} x {k} x {n}: "
            f"max|d| {e:.3e} (tol {TOL['fp32'][0]:g} + {TOL['fp32'][1]:g}"
            "|ref|)")
    return worst


def _full_width_inputs(n: int, s: int, dev, seed: int):
    gen = torch.Generator().manual_seed(seed)
    o = torch.tensor([0.0, 0.0, 4.0]) + 0.05 * torch.randn(n, 3, generator=gen)
    d = torch.randn(n, 3, generator=gen)
    d[:, 2] = -d[:, 2].abs() - 1
    d = d / d.norm(dim=-1, keepdim=True)
    z = torch.sort(2.5 + 3 * torch.rand(n, s, generator=gen), -1).values
    ind = torch.rand(n, 1, generator=gen) * 2 - 1
    return [t.to(dev) for t in (o, d, z, ind)]


def phase_kernel_vs_plain(dev) -> dict:
    gen = torch.Generator().manual_seed(0)
    ncfg = NeRFConfig(extra_feat_type="ind", extra_feat_dim=5)
    fcfg = NoFConfig()
    params = {"coarse_NeRF": init_nerf(gen, ncfg, dev),
              "bw_NoF": init_nof(gen, fcfg, dev)}
    an_n = anneal_weights(505000, 10, 5000, 1005000).to(dev)
    an_f = anneal_weights(505000, 5, 5000, 1005000).to(dev)
    max_err, times = 0.0, {}
    for n in (1000, 4096):
        for s, sigma_only in ((128, True), (256, False)):
            o, d, z, ind = _full_width_inputs(n, s, dev, seed=n + s)
            extra = embed_padded(ind, EmbeddingSpec(2, in_channels=1), 5)
            ind_emb = embed_padded(ind, EmbeddingSpec(16, in_channels=1), 33)
            for use_nof in (True, False):
                plain = {}
                for dname, dt in (("fp32", None), ("bf16", torch.bfloat16)):
                    args = (params, "coarse_NeRF", ncfg, fcfg, 10, 5, True,
                            True, an_n, an_f, o, d, z,
                            None if sigma_only else extra, ind_emb, use_nof,
                            sigma_only, dt)
                    ks, kr = render_pass(*args)
                    rs, rr = render_pass_ref(*args)
                    torch.cuda.synchronize()
                    plain[dname] = rs
                    tag = (f"{'coarse' if sigma_only else 'fine'} S={s} "
                           f"N={n} {'nof' if use_nof else 'cano'} {dname}")
                    atol, rtol = TOL[dname]
                    es = check_close(f"{tag} sigma", ks, rs, atol, rtol)
                    er = 0.0 if sigma_only else check_close(
                        f"{tag} rgb", kr, rr, atol, rtol)
                    max_err = max(max_err, es, er)
                    line = (f"[3 kernel vs plain] {tag}: max|d sigma| "
                            f"{es:.3e} max|d rgb| {er:.3e} "
                            f"(tol {atol:g} + {rtol:g}|ref|)")
                    if n == 4096:
                        k_ms = cuda_ms(lambda: render_pass(*args))
                        p_ms = cuda_ms(lambda: render_pass_ref(*args))
                        times[tag] = (k_ms, p_ms)
                        rows = n * s
                        line += (f" | kernel {k_ms:.3f} ms "
                                 f"({rows / k_ms / 1e3:.2f} M samples/s), "
                                 f"plain {p_ms:.3f} ms")
                    log(line)
                gap = (plain["bf16"] - plain["fp32"]).abs().max().item()
                log(f"[3 kernel vs plain] bf16-vs-fp32 gap of the plain "
                    f"version, {tag[:-5]}: {gap:.3e}")
    # a 256x256 frame's own launches: 4 chunks of 16384 rays, each a coarse
    # (S=128, sigma only) and a fine (S=256) pass with the bw-NoF warp
    n = 16384
    frame = {"fp32": [0.0, 0.0], "bf16": [0.0, 0.0]}
    for s, sigma_only in ((128, True), (256, False)):
        o, d, z, ind = _full_width_inputs(n, s, dev, seed=n + s)
        extra = embed_padded(ind, EmbeddingSpec(2, in_channels=1), 5)
        ind_emb = embed_padded(ind, EmbeddingSpec(16, in_channels=1), 33)
        for dname, dt in (("fp32", None), ("bf16", torch.bfloat16)):
            args = (params, "coarse_NeRF", ncfg, fcfg, 10, 5, True, True,
                    an_n, an_f, o, d, z, None if sigma_only else extra,
                    ind_emb, True, sigma_only, dt)
            k_ms = cuda_ms(lambda: render_pass(*args), reps=3)
            p_ms = cuda_ms(lambda: render_pass_ref(*args), reps=1)
            frame[dname][0] += 4 * k_ms
            frame[dname][1] += 4 * p_ms
            kind = "coarse" if sigma_only else "fine"
            log(f"[3 kernel vs plain] frame launch {kind} S={s} N={n} nof "
                f"{dname}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
    work = (2 * 4 * n * (128 * (NERF_SIGMA_MACS + NOF_MACS)
                         + 256 * (NERF_MACS + NOF_MACS)),
            4 * n * (128 * 8 + 256 * 20 + 2 * 6 * 4))
    # the weight matrices one tile streams: NoF 4x128 (skip 2, 33 PE rows)
    # and head, NeRF 8x256 (skip 4, 63 PE rows), then final, extra, rgb
    nof_m = [(33, 128), (128, 128), (33, 128), (128, 128), (128, 128),
             (128, 9)]
    nerf_m = ([(63, 256)] + [(256, 256)] * 3 + [(63, 256), (256, 256)]
              + [(256, 256)] * 3)
    heads_m = [(256, 256), (256, 128), (128, 3)]
    tiles = 4 * n // 128           # a launch of S samples has S * n / 128
    for dname, (k_ms, p_ms) in frame.items():
        b_ms, b_by = bound_ms(*work, dname)
        times[f"frame {dname}"] = (k_ms, p_ms, b_ms, b_by)
        l2 = tiles * (128 * fwd_weight_bytes(nof_m + nerf_m, dname)
                      + 256 * fwd_weight_bytes(nof_m + nerf_m + heads_m,
                                               dname))
        log(f"[3 kernel vs plain] a 256x256 frame's 8 launches (4 x coarse "
            f"+ fine, N=16384) {dname}: kernel {k_ms:.3f} ms, plain "
            f"{p_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}: "
            f"{work[0] / 1e12:.3f} TFLOP); {fwd_shares(work[0], k_ms, dname)}"
            f"; weights streamed from L2 {l2 / 1e9:.1f} GB "
            f"({l2 / k_ms / 1e9:.2f} TB/s)")
    for k in ("render_pass_wg_kernel", "render_pass_tf32_kernel"):
        log(f"[3 kernel vs plain] {k}: "
            f"{' | '.join(PTXAS.get(k, ['(cached build)']))}; dynamic "
            f"shared memory {FWD_SMEM[k]} bytes a block")
    torch.cuda.synchronize()
    return {"max_abs_err": max_err, "times": times}


def phase_golden(dev) -> None:
    with np.load(FIXTURE) as f:
        arrs = {k: f[k] for k in f.files}
    cfg = json.loads(str(arrs["config_json"]))
    model, cases = cfg["model"], cfg["cases"]
    params = params_from_jax(_unflatten(
        {k[len("params/"):]: v for k, v in arrs.items()
         if k.startswith("params/")}), dev)
    anneal = {k[len("anneal/"):]: torch.from_numpy(v).to(dev)
              for k, v in arrs.items() if k.startswith("anneal/")}
    rays = torch.from_numpy(arrs["rays"]).to(dev)
    bg = torch.from_numpy(arrs["background"]).to(dev)
    statics = build_statics(model)
    for name, case in cases.items():
        rcfg = RenderConfig(n_samples=model["N_samples"],
                            n_importance=model["N_importance"],
                            test_time=True, **case)
        out = render_rays(params, statics, anneal, rays, bg, rcfg)
        torch.cuda.synchronize()
        atol, rtol = GOLDEN_TOL[case["compute_dtype"]]
        errs = []
        for k, v in out.items():
            want = torch.from_numpy(arrs[f"out/{name}/{k}"]).to(dev)
            if v.shape != want.shape:
                raise AssertionError(f"golden {name}/{k}: shape "
                                     f"{tuple(v.shape)} != {tuple(want.shape)}")
            errs.append(f"{k} {check_close(f'golden {name}/{k}', v, want, atol, rtol):.2e}")
        log(f"[4 port vs JAX fixture] {name} {case}: max|diff| "
            f"{', '.join(errs)} (tol {atol:g} + {rtol:g}|ref|)")


def slice_config() -> dict:
    """configs/people_snapshot/male-3-casual/c2f.yaml's model at its
    published widths, on the 256x256 synthetic scene (bench.py's)."""
    nof = {"type": "NoF", "D": 4, "W": 128, "in_channels_xyz": 33,
           "skips": [2], "extra_feat_type": "ind", "extra_feat_dim": 33,
           "use_quat": True}
    nerf = {"type": "NeRF", "D": 8, "W": 256, "in_channels_xyz": 63,
            "skips": [4], "extra_feat_type": "ind", "extra_feat_dim": 5}
    return {
        "save_dir": os.path.join(HERE, "build", "chip_smoke_log"),
        "exp_name": "c2f_synthetic",
        "dataloader": {"type": "moco_flow", "root_dir": None,
                       "imgs_dir": "images", "size": [256, 256],
                       "val_size": [256, 256],
                       "aabb": [[1.2, 1.2, 1.4], [0, 0, 0]], "bkgd": "rand",
                       "interval": 1},
        "model": {
            "type": "moco_flow", "pretrained_path": None,
            "pretrained_nerf": None, "pretrained_nof": None,
            "coarse_to_fine": True, "chunk": 16384, "N_samples": 128,
            "N_importance": 128, "use_disp": False, "perturb": 1.0,
            "nerf_activate_type": "relu", "compute_dtype": "bfloat16",
            "nof_embedding_xyz": {"in_channels": 3, "N_freqs": 5},
            "nof_embedding_ind": {"in_channels": 1, "N_freqs": 16},
            "fw_NoF": nof, "bw_NoF": dict(nof),
            "nerf_embedding_xyz": {"in_channels": 3, "N_freqs": 10},
            "nerf_embedding_dir": None,
            "nerf_embedding_ind": {"in_channels": 1, "N_freqs": 2},
            "coarse_NeRF": nerf, "fine_NeRF": dict(nerf)},
        "loss": {"chain_local": True, "chain_global": True},
        "trainer": {"num_iters": 2200000, "coarse2fine_start_iter": 5000,
                    "coarse2fine_end_iter": 1005000},
    }


def seeded_checkpoint(cfg: dict, path: str) -> str:
    """The port's seeded init of ``cfg``'s model as a checkpoint at the last
    training step (every PE band on). Both sigma heads are biased up by 1:
    a freshly drawn NeRF is often empty (sigma <= 0 everywhere), and a dense
    field makes every layer of both passes shape the rendered pixels."""
    params = init_params(torch.Generator().manual_seed(0),
                         build_statics(cfg["model"]), with_nof=True,
                         with_fw_nof=True)
    for net in ("coarse_NeRF", "fine_NeRF"):
        params[net]["sigma"]["b"] += 1.0
    step = cfg["trainer"]["num_iters"]
    save_checkpoint(path, {"params": params}, extra={
        "clock": {"epoch": 1, "minibatch": 0, "step": step}})
    return path + ".npz"


def phase_slice(card: str) -> int:
    scene = make_synthetic_scene(None, n_frames=8, size=256, focal=300.0)
    log(f"[5 slice] synthetic scene: {scene.images.shape} uint8 frames")
    cfg0 = slice_config()
    ckpt = seeded_checkpoint(cfg0, os.path.join(cfg0["save_dir"], "seeded"))
    args = parse_args(["-c", "(dict)", "-r", ckpt, "--render_gt", "--reso",
                       "256", "--eval_metrics", "--eval_max_frames", "1",
                       "--device", "cuda"])
    n_rays = 256 * 256
    tiles = -(-n_rays // 16384)
    trainers = {}
    render_pass.launches = 0
    for dtype in ("bfloat16", "float32"):
        cfg = slice_config()
        cfg["model"]["compute_dtype"] = dtype
        trainers[dtype] = test(cfg, args, scene=scene)
        torch.cuda.synchronize()
    launches = render_pass.launches
    want = 2 * tiles * len(trainers)
    log(f"[5 slice] render_pass launches in the two test() runs: {launches} "
        f"(expected 2 passes x {tiles} tiles x {len(trainers)} runs = {want})")
    if launches != want:
        raise AssertionError(f"render_pass launched {launches} times, "
                             f"expected {want}")
    frames = {}
    for dtype, tr in trainers.items():
        m = tr.metrics
        if m["frames"] != 1 or not all(np.isfinite(m[k])
                                       for k in ("psnr", "ssim", "dssim")):
            raise AssertionError(f"slice {dtype} metrics: {m}")
        ds = tr.val_dataset
        rays = ds.frame_rays(0)
        render = lambda: tr.render_rays_chunked(  # noqa: E731
            rays, ds.bkgd_img, tr.rcfg_test, anneal=tr.anneal())
        res = render()  # warm frame
        ms = cuda_ms(render, reps=1)
        for k, v in res.items():
            if v.shape[0] != n_rays or not torch.isfinite(v).all():
                raise AssertionError(f"slice {dtype} {k}: {tuple(v.shape)}, "
                                     "or non-finite values")
        frames[dtype] = res
        log(f"[5 slice] {dtype}: metrics {json.dumps(m)}; one 256x256 frame "
            f"(65536 rays, 128+128 samples) {ms:.1f} ms = "
            f"{n_rays / ms * 1e3:.0f} rays/s on {card}")
    fp32 = frames["float32"]
    opacity = fp32["opacity_fine"].mean().item()
    vs_bkgd = (fp32["rgb_fine"] - 1.0).abs().mean().item()  # white bkgd
    gap = (frames["bfloat16"]["rgb_fine"] - fp32["rgb_fine"]).abs().max()
    log(f"[5 slice] fp32 frame: mean fine opacity {opacity:.3f}, mean "
        f"|rgb - background| {vs_bkgd:.3f}; bf16-vs-fp32 max |d rgb| "
        f"{gap.item():.3e}")
    if opacity < 0.05 or vs_bkgd < 0.01 or not 0 < gap.item() < 0.1:
        raise AssertionError("the slice frame is empty, or bf16 and fp32 "
                             "disagree beyond bf16's own rounding")
    torch.cuda.synchronize()
    return launches


# ---------------------------------------------------------------------------
# The training step's kernels (phases 6-8)
# ---------------------------------------------------------------------------

def _rel(err: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max |err| / max |ref|, mean |err| / mean |ref|)."""
    return (err.abs().max().item() / max(ref.abs().max().item(), 1e-30),
            err.abs().mean().item() / max(ref.abs().mean().item(), 1e-30))


def check_train(name: str, got, want, dname: str, plain32=None,
                grad: bool = False) -> float:
    """One output of a training kernel against its plain version, under
    TRAIN_TOL; returns max |got - want|."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - want).abs()
    if grad:
        rmax, rmean = _rel(err, want)
        lim = TRAIN_TOL["fp32_grad"]
        ok = rmax <= lim[0] and rmean <= lim[1]
        why = (f"{lim[0]:g} of max|ref| and {lim[1]:g} of mean|ref| (at "
               f"{rmax:.2e}, {rmean:.2e})")
    else:
        atol, rtol = TOL["fp32"]
        ok = bool((err <= atol + rtol * want.abs()).all())
        why = f"{atol:g} + {rtol:g}|ref| elementwise"
    if dname == "bf16" and not ok:
        gap = (want - plain32.float()).abs()
        lim_max, lim_mean = gap.max().item(), gap.mean().item()
        ok = err.max().item() <= lim_max and err.mean().item() <= lim_mean
        why += (f", and the plain bf16-vs-fp32 gap (max {lim_max:.3e}, "
                f"mean {lim_mean:.3e})")
    if not ok:
        raise AssertionError(f"{name}: max|diff| {err.max().item():.3e} mean "
                             f"{err.mean().item():.3e} exceeds {why}")
    return err.max().item(), _rel(err, want)[0]


# kernel vs plain version for the training kernels. Forward outputs in fp32:
# TOL["fp32"] elementwise. Gradients in fp32: both sides sum in fp32 in other
# orders, and a pre-activation within rounding of zero takes the other side
# of the ReLU in one of them: that sample's whole cotangent below the layer
# changes. Over 10^5 samples and 10^3 activations each, tens of such flips
# happen, each moving one sample's dx or one ray's d(partial) by a sizeable
# fraction and every dW or db entry by ~1/sqrt(rows) of its scale; and a dW
# entry sums 10^5 signed terms that cancel to a small part of their absolute
# sum, so fp32's relative rounding of that sum is large. The bound is on the
# largest difference (0.1 of the tensor's largest magnitude) and on the mean
# difference (0.01 of the mean magnitude).
# bf16, forward and backward: the fp32 bounds, or else the kernel may differ
# from the plain bf16 version by no more than the plain bf16 version differs
# from the plain fp32 one on the same inputs (max and mean), the gap of
# bf16's own rounding.
TRAIN_TOL = {"fp32_grad": (0.1, 1e-2)}
NERF_MACS = 589_952        # per sample, full NeRF 8x256 (sigma-only 491,264)
NERF_SIGMA_MACS = 491_264
NOF_MACS = 58_752          # per NoF evaluation, 4x128 with the quaternion head
# dense FLOP/s, H100 SXM data sheet: bf16 and TF32 on the tensor cores,
# fp32 outside them
PEAK = {"bf16": 989e12, "fp32": 67e12, "tf32": 495e12}
HBM = 3.35e12                            # bytes/s


def bound_ms(flops: float, nbytes: float, dname: str) -> tuple:
    """(least time in ms, 'operations' | 'bytes') for the work."""
    t_ops, t_bytes = flops / PEAK[dname], nbytes / HBM
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _nerf_case(P, ncfg, an_n, n, s, sigma_only, gen, dev):
    from moco_flow_tpu_torch.ops.folds import _NerfSpec, _nerf_fold
    o, d, z, _ = _full_width_inputs(n, s, dev, seed=7 * n + s)
    xyz = (o.T[:, :, None] + d.T[:, :, None] * z[None]).contiguous()
    emb = torch.randn(n, 5, generator=gen).to(dev)
    ws, p_e = _nerf_fold(P, ncfg, 10, an_n, None if sigma_only else emb,
                         sigma_only)
    spec = _NerfSpec(8, 256, 30, (4,), sigma_only, not sigma_only, True)
    g = (torch.randn(1 if sigma_only else 4, n, s, generator=gen)
         / (n * s) ** 0.5).to(dev)
    return spec, xyz, p_e, ws, g


def _chain_case(P, fcfg, an_f, n, s, local, glob, gen, dev):
    from moco_flow_tpu_torch.ops.folds import _NofSpec, _nof_fold
    from moco_flow_tpu_torch.ops.nof_chain import _ChainSpec
    o, d, z, _ = _full_width_inputs(n, s, dev, seed=11 * n + s)
    xyz = (o.T[:, :, None] + d.T[:, :, None] * z[None]).contiguous()
    emb = torch.randn(n, 33, generator=gen).to(dev)
    emb_c = torch.randn(n, 33, generator=gen).to(dev)
    wsb, pb = _nof_fold(P["bw_NoF"], fcfg, 5, an_f, emb)
    wsf, pf = _nof_fold(P["fw_NoF"], fcfg, 5, an_f, emb)
    sets = [pb, pf]
    if glob:
        sets += [_nof_fold(P["fw_NoF"], fcfg, 5, an_f, emb_c)[1],
                 _nof_fold(P["bw_NoF"], fcfg, 5, an_f, emb_c)[1]]
    parts = [p for st in sets for p in st]
    spec = _ChainSpec(_NofSpec(4, 128, 15, (2,), True, True), local, glob)
    n_out = 1 + int(local) + int(glob)
    gs = [(torch.randn(3, n, s, generator=gen) / (n * s) ** 0.5).to(dev)
          for _ in range(n_out)]
    return spec, xyz, parts, wsb, wsf, gs


def _flat_grads(r) -> list:
    """(dx, d(partial) | [d(partial)] | None, [dW]) -> one list."""
    dp = r[1]
    dps = [] if dp is None else (list(dp) if isinstance(dp, list) else [dp])
    return [r[0]] + dps + list(r[2])


def _bwd_repeat_checks(P, ncfg, fcfg, an_n, an_f, size, gen, dev):
    """#2 and #6 give the same bits in two launches, and in chunks of whole
    rays (a lowered scratch cap) as in one launch."""
    from moco_flow_tpu_torch.ops import _args
    from moco_flow_tpu_torch.ops import nerf_rays as nr
    from moco_flow_tpu_torch.ops import nof_chain as nc
    n, s = size
    c = _nerf_case(P["nerf"], ncfg, an_n, n, s, False, gen, dev)
    cc = _chain_case(P, fcfg, an_f, n, s, True, True, gen, dev)
    calls = {"nerf_bwd": lambda dt: nr.nerf_bwd(c[0], dt, *c[1:5]),
             "chain_bwd": lambda dt: nc.chain_bwd(cc[0], dt, 2, *cc[1:])}
    for name, call in calls.items():
        for dname, dt in (("fp32", None), ("bf16", torch.bfloat16)):
            one = _flat_grads(call(dt))
            full = _args.run_chunks.last["scratch_bytes"]
            again = _flat_grads(call(dt))
            cap = _args.SCRATCH_CAP
            _args.SCRATCH_CAP = full // 3
            try:
                chunked = _flat_grads(call(dt))
                chunks = _args.run_chunks.last["chunks"]
            finally:
                _args.SCRATCH_CAP = cap
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(one, again))
            same_c = all(torch.equal(a, b) for a, b in zip(one, chunked))
            log(f"[6 train kernels] {name} {dname} N={n} S={s}: two launches "
                f"bitwise equal {same}; {chunks} chunks under a cap of "
                f"{full // 3} bytes bitwise equal to one launch {same_c} "
                f"({len(one)} tensors)")
            if not (same and same_c and chunks > 1):
                raise AssertionError(f"{name} {dname}: not deterministic "
                                     f"(repeat {same}, chunks {same_c} in "
                                     f"{chunks})")


def _device_split(fn, groups: dict) -> dict:
    """Device ms of one call of fn by kernel-name group (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {g: 0.0 for g in (*groups, "other")}
    for ev in prof.key_averages():
        ms = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0)) / 1e3
        if ms <= 0:
            continue
        g = next((g for g, pats in groups.items()
                  if any(p in ev.key.lower() for p in pats)), "other")
        out[g] += ms
    return out


def _dw_line(phase: str, what: str, ms: float, flops: float,
             card: str) -> None:
    """Logs the dW products' device ms against their split-TF32 bound
    (three TF32 products a term at the TF32 peak)."""
    bound = bound_ms(3 * flops, 0, "tf32")[0]
    if ms <= 0:
        log(f"[{phase}] dW products at {what}: no device time on {card}")
        return
    log(f"[{phase}] dW products (fp32, matrix_mma_kernel) at {what}: "
        f"{ms:.3f} ms, {flops / ms / 1e9:.1f} TFLOP/s, split-TF32 bound "
        f"{bound:.3f} ms ({100 * bound / ms:.1f}% of it; {flops / 1e9:.1f} "
        f"GFLOP) on {card}")


def _dw_init_nerf(gen, dev, card: str, n: int = 5120) -> None:
    """#2's fp32 dW products at init_nerf.yaml's model (raw xyz, the 27-wide
    ``dir`` extra) and a stage-1 step's shapes: n rays x 128 (coarse) and x
    256 (fine) samples."""
    from moco_flow_tpu_torch.ops import nerf_rays as nr
    from moco_flow_tpu_torch.ops.folds import _NerfSpec, _nerf_fold
    ncfg = NeRFConfig(extra_feat_type="dir", extra_feat_dim=27)
    params = init_nerf(gen, ncfg, dev)
    emb = torch.randn(n, 27, generator=gen).to(dev)
    ws, p_e = _nerf_fold(params, ncfg, 0, None, emb, False)
    spec = _NerfSpec(8, 256, 3, (4,), False, True, True)
    calls = []
    for s in (128, 256):
        xyz = (0.8 * torch.randn(3, n, s, generator=gen)).to(dev)
        g = (torch.randn(4, n, s, generator=gen) / (n * s) ** 0.5).to(dev)
        calls.append(lambda xyz=xyz, g=g: nr.nerf_bwd(spec, None, xyz, p_e, ws,
                                                      g))
    split = _device_split(lambda: [f() for f in calls], BWD_GROUPS)
    _dw_line("6 train kernels", f"init_nerf #2, {n} x (128 + 256) samples",
             split["dW products"], 2 * _nof_macs(ws) * n * (128 + 256), card)


def _fwd_repeat_checks(P, ncfg, fcfg, an_n, an_f, size, gen, dev):
    """#1 and #5 give the same bits in two launches."""
    from moco_flow_tpu_torch.ops import nerf_rays as nr
    from moco_flow_tpu_torch.ops import nof_chain as nc
    n, s = size
    full = _nerf_case(P["nerf"], ncfg, an_n, n, s, False, gen, dev)
    coarse = _nerf_case(P["nerf"], ncfg, an_n, n, s, True, gen, dev)
    cc = _chain_case(P, fcfg, an_f, n, s, True, True, gen, dev)
    calls = {"nerf_fwd full": lambda dt: [nr.nerf_fwd(full[0], dt,
                                                      *full[1:4])],
             "nerf_fwd sigma-only": lambda dt: [nr.nerf_fwd(coarse[0], dt,
                                                            *coarse[1:4])],
             "chain_fwd": lambda dt: list(nc.chain_fwd(cc[0], dt, 2,
                                                       *cc[1:5]))}
    for name, call in calls.items():
        for dname, dt in (("fp32", None), ("bf16", torch.bfloat16)):
            one, again = call(dt), call(dt)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(one, again))
            log(f"[6 train kernels] {name} {dname} N={n} S={s}: two launches "
                f"bitwise equal {same} ({len(one)} outputs)")
            if not same:
                raise AssertionError(f"{name} {dname}: not deterministic")


def phase_train_kernels(dev, card: str,
                        sizes=((1000, 128), (256, 256), (1000, 127)),
                        n: int = 1024) -> dict:
    """Kernels #1/#2 (NeRF forward / backward) and #5/#6 (warp chain) against
    their plain versions at full width on ``sizes`` (rays, samples), then
    timed at the step's shapes (``n`` rays)."""
    from moco_flow_tpu_torch.ops import _args
    from moco_flow_tpu_torch.ops import nerf_rays as nr
    from moco_flow_tpu_torch.ops import nof_chain as nc
    gen = torch.Generator().manual_seed(1)
    ncfg = NeRFConfig(extra_feat_type="ind", extra_feat_dim=5)
    fcfg = NoFConfig()
    P = {"nerf": init_nerf(gen, ncfg, dev), "bw_NoF": init_nof(gen, fcfg, dev),
         "fw_NoF": init_nof(gen, fcfg, dev)}
    an_n = anneal_weights(505000, 10, 5000, 1005000).to(dev)
    an_f = anneal_weights(505000, 5, 5000, 1005000).to(dev)
    err = {k: 0.0 for k in ("nerf_fwd", "nerf_bwd", "chain_fwd", "chain_bwd")}
    # bf16 backward: largest |kernel - plain| over the plain version's own
    # bf16-vs-fp32 gap, per tensor (must stay <= 1). A tensor that does not
    # depend on the compute type (the plain bf16 and fp32 versions agree
    # bit for bit, as d(sigma bias) = sum d(sigma)) has no gap; TRAIN_TOL's
    # fp32 bound holds it.
    gap_ratio = {"nerf_bwd": 0.0, "chain_bwd": 0.0}
    no_gap = {"nerf_bwd": 0, "chain_bwd": 0}
    # the fp32 passes multiply on the split TF32 product: their largest
    # |kernel - plain| and its share of the largest |plain| output (of a
    # tensor's, for the backwards)
    split_err = {k: [0.0, 0.0] for k in ("nerf_fwd", "chain_fwd",
                                         "nerf_bwd", "chain_bwd")}

    def track_split(name, e, e_rel):
        split_err[name] = [max(split_err[name][0], e),
                           max(split_err[name][1], e_rel)]

    def track_gap(name, got, want, want32):
        e = (got.float() - want.float()).abs().max().item()
        gap = (want.float() - want32.float()).abs().max().item()
        if gap == 0.0:
            no_gap[name] += 1
            return
        gap_ratio[name] = max(gap_ratio[name], e / gap)

    dts = (("fp32", None), ("bf16", torch.bfloat16))
    for n_r, s in sizes:
        for sigma_only in (False, True):
            spec, xyz, p_e, ws, g = _nerf_case(P["nerf"], ncfg, an_n, n_r,
                                               s, sigma_only, gen, dev)
            plain32 = None
            for dname, dt in dts:
                tag = (f"nerf {'sigma-only' if sigma_only else 'full'} "
                       f"N={n_r} S={s} {dname}")
                ko = nr.nerf_fwd(spec, dt, xyz, p_e, ws)
                ro = nr._nerf_fwd_ref(spec, dt, xyz, p_e, ws)
                kb = nr.nerf_bwd(spec, dt, xyz, p_e, ws, g)
                rb = nr._nerf_bwd_ref(spec, dt, xyz, p_e, ws, g)
                torch.cuda.synchronize()
                pb = plain32 or (None, None)
                e, e_rel = check_train(f"{tag} out", ko, ro, dname, pb[0])
                err["nerf_fwd"] = max(err["nerf_fwd"], e)
                if dname == "fp32":
                    track_split("nerf_fwd", e, e_rel)
                names = ["dxyz"] + ([] if sigma_only else ["d(extra partial)"])
                grads = [(kb[0], rb[0])] + ([] if sigma_only else
                                             [(kb[1], rb[1])])
                names += [f"dW[{i}]" for i in range(len(ws))]
                grads += list(zip(kb[2], rb[2]))
                refs32 = (None if pb[1] is None else
                          [pb[1][0]] + ([] if sigma_only else [pb[1][1]])
                          + list(pb[1][2]))
                worst, w_rel = 0.0, 0.0
                for i, (nm, (a, b)) in enumerate(zip(names, grads)):
                    w = check_train(f"{tag} {nm}", a, b, dname,
                                    None if refs32 is None else refs32[i],
                                    grad=True)
                    worst, w_rel = max(worst, w[0]), max(w_rel, w[1])
                    if refs32 is not None:
                        track_gap("nerf_bwd", a, b, refs32[i])
                err["nerf_bwd"] = max(err["nerf_bwd"], worst)
                if dname == "fp32":
                    track_split("nerf_bwd", worst, w_rel)
                log(f"[6 train kernels] {tag}: forward max|d| {e:.3e} "
                    f"({e_rel:.1e} of max|ref|), backward max|d| {worst:.3e} "
                    f"(at most {w_rel:.1e} of a tensor's max|ref|) over dxyz"
                    f"{'' if sigma_only else ', d(partial)'} and "
                    f"{len(ws)} dW (tolerance: TRAIN_TOL)")
                if dname == "fp32":
                    plain32 = (ro, rb)
    for n_r, s in sizes:
        for local, glob in ((True, True), (True, False), (False, True)):
            spec, xyz, parts, wsb, wsf, gs = _chain_case(
                P, fcfg, an_f, n_r, s, local, glob, gen, dev)
            plain32 = None
            for dname, dt in dts:
                tag = (f"chain local={int(local)} global={int(glob)} "
                       f"N={n_r} S={s} {dname}")
                ko = nc.chain_fwd(spec, dt, 2, xyz, parts, wsb, wsf)
                ro = nc._chain_fwd_ref(spec, dt, 2, xyz, parts, wsb, wsf)
                kb = nc.chain_bwd(spec, dt, 2, xyz, parts, wsb, wsf, gs)
                rb = nc._chain_bwd_ref(spec, dt, 2, xyz, parts, wsb, wsf, gs)
                torch.cuda.synchronize()
                pb = plain32 or (None, None)
                fw = [check_train(f"{tag} out{i}", a, b, dname,
                                  None if pb[0] is None else pb[0][i])
                      for i, (a, b) in enumerate(zip(ko, ro))]
                e, e_rel = max(x[0] for x in fw), max(x[1] for x in fw)
                err["chain_fwd"] = max(err["chain_fwd"], e)
                if dname == "fp32":
                    track_split("chain_fwd", e, e_rel)
                pairs = ([("dxyz", kb[0], rb[0])]
                         + [(f"dpartial[{i}]", a, b)
                            for i, (a, b) in enumerate(zip(kb[1], rb[1]))]
                         + [(f"dW[{i}]", a, b)
                            for i, (a, b) in enumerate(zip(kb[2], rb[2]))])
                refs32 = (None if pb[1] is None else
                          [pb[1][0]] + list(pb[1][1]) + list(pb[1][2]))
                worst, w_rel = 0.0, 0.0
                for i, (nm, a, b) in enumerate(pairs):
                    w = check_train(f"{tag} {nm}", a, b, dname,
                                    None if refs32 is None else refs32[i],
                                    grad=True)
                    worst, w_rel = max(worst, w[0]), max(w_rel, w[1])
                    if refs32 is not None:
                        track_gap("chain_bwd", a, b, refs32[i])
                err["chain_bwd"] = max(err["chain_bwd"], worst)
                if dname == "fp32":
                    track_split("chain_bwd", worst, w_rel)
                log(f"[6 train kernels] {tag}: forward max|d| {e:.3e} "
                    f"({e_rel:.1e} of max|ref|) over {len(ko)} outputs, "
                    f"backward max|d| {worst:.3e} (at most {w_rel:.1e} of a "
                    f"tensor's max|ref|) over "
                    f"dxyz, {len(kb[1])} d(partial) and {len(kb[2])} dW "
                    "(tolerance: TRAIN_TOL)")
                if dname == "fp32":
                    plain32 = (ro, rb)
    for name, r in gap_ratio.items():
        log(f"[6 train kernels] {name} bf16: largest |kernel - plain| is "
            f"{r:.3f} of the plain version's own bf16-vs-fp32 gap (max over "
            f"every output tensor; must stay <= 1; {no_gap[name]} tensors "
            "that do not depend on the compute type are held to TRAIN_TOL "
            "alone)")
        if sizes and not r <= 1.0:
            raise AssertionError(f"{name} bf16 differs from its plain "
                                 f"version by {r:.3f} x its bf16-vs-fp32 gap")
    for name, (e, e_rel) in split_err.items():
        tol = (f"{TOL['fp32'][0]:g} + {TOL['fp32'][1]:g}|ref|"
               if name.endswith("fwd") else "TRAIN_TOL")
        log(f"[6 train kernels] {name} fp32 on the split TF32 product: "
            f"largest |kernel - plain| {e:.3e} ({e_rel:.2e} of the largest "
            f"|plain| {'output' if name.endswith('fwd') else 'tensor'}; "
            f"tolerance {tol})")
    if sizes:
        _fwd_repeat_checks(P, ncfg, fcfg, an_n, an_f, sizes[-1], gen, dev)
        _bwd_repeat_checks(P, ncfg, fcfg, an_n, an_f, sizes[0], gen, dev)
        _dw_init_nerf(gen, dev, card)
    # times at the step's shapes, bf16 (the slice's compute type; its times
    # go into the kernels line) and fp32: one step launches each NeRF kernel
    # on N=1024 x S=128 (coarse) and S=256 (fine), each chain kernel twice on
    # N=1024 x S=128 (coarse, new samples)
    nerf = [_nerf_case(P["nerf"], ncfg, an_n, n, s, False, gen, dev)
            for s in (128, 256)]
    spec_c, xyz_c, parts, wsb, wsf, gs = _chain_case(P, fcfg, an_f, n, 128,
                                                     True, True, gen, dev)

    def work(dt):
        """name -> (kernel calls, plain calls) of one step, compute type dt"""
        return {
            "nerf_fwd": [[lambda c=c, f=f: f(c[0], dt, *c[1:4]) for c in nerf]
                         for f in (nr.nerf_fwd, nr._nerf_fwd_ref)],
            "nerf_bwd": [[lambda c=c, f=f: f(c[0], dt, *c[1:5]) for c in nerf]
                         for f in (nr.nerf_bwd, nr._nerf_bwd_ref)],
            "chain_fwd": [[lambda f=f: f(spec_c, dt, 2, xyz_c, parts, wsb,
                                         wsf)] * 2
                          for f in (nc.chain_fwd, nc._chain_fwd_ref)],
            "chain_bwd": [[lambda f=f: f(spec_c, dt, 2, xyz_c, parts, wsb,
                                         wsf, gs)] * 2
                          for f in (nc.chain_bwd, nc._chain_bwd_ref)]}

    samples = n * (128 + 256)
    n_w = {"nerf": sum(w.numel() for w in nerf[1][3]),
           "nof": sum(w.numel() for w in wsb) * 2}
    flops = {"nerf_fwd": 2 * NERF_MACS * samples,
             "nerf_bwd": 3 * 2 * NERF_MACS * samples,
             "chain_fwd": 2 * 5 * NOF_MACS * 2 * n * 128,
             "chain_bwd": 3 * 2 * 5 * NOF_MACS * 2 * n * 128}
    times, times32 = {}, {}
    for dname, dt in (("bf16", torch.bfloat16), ("fp32", None)):
        # each input read once, each output written once: positions (12 B),
        # outputs and cotangents fp32, per-ray partials fp32, weights in
        # the compute type (and dW fp32 out for the backward)
        wb = 2 if dt is not None else 4
        nbytes = {"nerf_fwd": samples * (12 + 16) + 2 * wb * n_w["nerf"]
                  + 2 * n * 128 * 4,
                  "nerf_bwd": samples * (12 + 16 + 12)
                  + 2 * (wb + 4) * n_w["nerf"] + 2 * 2 * n * 128 * 4,
                  "chain_fwd": 2 * n * 128 * (12 + 36) + 2 * wb * n_w["nof"]
                  + 2 * 8 * n * 128 * 4,
                  "chain_bwd": 2 * n * 128 * (12 + 36 + 12)
                  + 2 * (wb + 4) * n_w["nof"] + 2 * 2 * 8 * n * 128 * 4}
        for name, (kern, plain) in work(dt).items():
            k_ms = cuda_ms(lambda: [f() for f in kern], reps=3)
            p_ms = cuda_ms(lambda: [f() for f in plain], reps=3)
            b_ms, b_by = bound_ms(flops[name], nbytes[name], dname)
            # the fp32 passes' own product: three TF32 products a term
            tc = (f", split TF32 bound "
                  f"{bound_ms(3 * flops[name], nbytes[name], 'tf32')[0]:.4f}"
                  " ms (held to this one)"
                  if dname == "fp32" and name in split_err else "")
            (times if dname == "bf16" else times32)[name] = (k_ms, p_ms, b_ms,
                                                             b_by)
            log(f"[6 train kernels] {name} {dname}, one step's two launches: "
                f"kernel {k_ms:.3f} ms ({flops[name] / k_ms / 1e9:.1f} "
                f"TFLOP/s), plain {p_ms:.3f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}: {flops[name] / 1e12:.3f} TFLOP, "
                f"{nbytes[name] / 1e6:.1f} MB){tc} on {card}")
            if name in ("nerf_bwd", "chain_bwd"):
                split = _device_split(lambda: [f() for f in kern], BWD_GROUPS)
                sc = _args.run_chunks.last
                log(f"[6 train kernels] {name} {dname} split of the two "
                    "launches (device ms): " + ", ".join(
                        f"{k} {v:.3f}" for k, v in split.items())
                    + f"; scratch {sc['scratch_bytes'] / 2 ** 30:.3f} GiB "
                    f"in {sc['chunks']} chunk(s) for the last launch (cap "
                    f"{_args.SCRATCH_CAP / 2 ** 30:g} GiB)")
                if dname == "fp32":
                    # the dW products do one of the backward's three
                    # products
                    _dw_line("6 train kernels", f"c2f {name}, one step's two "
                             "launches", split["dW products"],
                             flops[name] / 3, card)
    torch.cuda.synchronize()
    return {"err": err, "times": times, "times32": times32,
            "split_err": split_err}


TRAIN_FIXTURE = os.path.join(HERE, "tests", "fixtures",
                             "torch_port_train_golden.npz")
# the port's two steps on the card against JAX's (fp32, fixture widths:
# rows are few, so the kernels' other summation order is the only source)
STEP_TOL = {"metrics_rtol": 1e-5, "params_atol": 1e-6}


def phase_train_golden(dev):
    from scripts.make_torch_port_train_golden import N_STEPS, port_replay
    with np.load(TRAIN_FIXTURE) as f:
        arrs = {k: f[k] for k in f.files}
    metrics, params = port_replay(arrs, dev)
    torch.cuda.synchronize()
    worst = 0.0
    for i, m in enumerate(metrics):
        for k, v in m.items():
            want = float(arrs[f"metrics/{i}/{k}"])
            rel = abs(v - want) / max(abs(want), 1e-30)
            worst = max(worst, rel)
            if rel > STEP_TOL["metrics_rtol"]:
                raise AssertionError(f"train fixture step {i} {k}: port {v} "
                                     f"JAX {want} (rel {rel:.2e})")
    perr = 0.0
    for k, v in params.items():
        d = float(np.abs(v - arrs[f"params{N_STEPS}/{k}"]).max())
        perr = max(perr, d)
        if d > STEP_TOL["params_atol"]:
            raise AssertionError(f"train fixture params {k}: max|diff| {d:.3e}")
    log(f"[7 train step vs JAX fixture] {N_STEPS} steps: loss terms and "
        f"train_psnr max rel diff {worst:.2e} (tol {STEP_TOL['metrics_rtol']:g}"
        f"), params after the steps max|diff| {perr:.2e} (tol "
        f"{STEP_TOL['params_atol']:g})")


TRAIN_START, TRAIN_STEPS = 6000, 6


def train_config(dtype: str) -> dict:
    """slice_config() as a stage-3 training run in the 'none' phase: 1024
    rays x (128 + 128) samples (bench.py's step shape), both chains, the
    reference's loss weights and Adam."""
    cfg = slice_config()
    cfg["save_dir"] = os.path.join(HERE, "build", "chip_smoke_train", dtype)
    cfg["model"].update({"N_rand": 1024, "compute_dtype": dtype,
                         "noise_std": 0.0})
    cfg["loss"].update({"nof_local_weight": 0.2, "nof_global_weight": 0.2,
                        "img_loss": {"type": "MSE", "weight": 1}})
    cfg["optimizer"] = {"moco": {"type": "adam", "lr": 1e-4,
                                 "weight_decay": 0}}
    cfg["scheduler"] = {"type": "steplr", "decay_step": [1050000],
                        "decay_gamma": 0.5}
    cfg["trainer"].update({"num_iters": TRAIN_START + TRAIN_STEPS,
                           "val_every_n_step": 0, "save_every_n_step": 0,
                           "log_freq": 5})
    return cfg


# kernel name patterns (lower case) of each group; #2, #4 and #6 share the
# long-K dW kernels of wgrad.cu
STEP_GROUPS = {"nerf_bwd passes": ("nerf_fwd_pass", "nerf_walk_pass"),
               "chain_bwd passes": ("chain_fwd_pass", "chain_walk_pass"),
               "nof_bwd passes": ("nof_fwd_pass", "nof_walk_pass"),
               "dW (#2/#4/#6)": ("matrix_mma", "colsum_kernel",
                                 "segsum_kernel", "reduce_kernel"),
               "chain_fwd": ("chain_fwd_kernel",),
               "nerf_fwd": ("nerf_fwd_kernel",),
               "nof_fwd": ("nof_fwd_kernel",), "sort": ("sort",)}
# the parts of #2 / #4 / #6 (phases 6 and 9's split)
BWD_GROUPS = {"forward pass": ("nerf_fwd_pass", "chain_fwd_pass",
                               "nof_fwd_pass"),
              "walk pass": ("nerf_walk_pass", "chain_walk_pass",
                            "nof_walk_pass"),
              "dW products": ("matrix_mma",),
              "dW sums": ("colsum_kernel", "segsum_kernel", "reduce_kernel")}


def _profile_step(tr, card: str, tag: str = "[8 train slice] profiled bf16",
                  fname: str = "train_step_profile.txt",
                  out_dir: str = "chip_smoke_train",
                  kernels: dict = STEP_GROUPS) -> None:
    """One profiled step: device time by kernel group and the idle share,
    written to build/<out_dir>/<fname>."""
    ranges = {"sample_pdf": "render.sample_pdf",
              "optimizer": "train.optimizer"}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        tr.train_step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    split = {k: 0.0 for k in (*kernels, *ranges, "other kernels")}
    busy = 0.0

    def dev_ms(ev, total=False):
        pre = "" if total else "self_"
        return getattr(ev, f"{pre}device_time_total",
                       getattr(ev, f"{pre}cuda_time_total", 0.0)) / 1e3

    for ev in prof.key_averages():
        on_card = str(getattr(ev, "device_type", "")).endswith("CUDA")
        # a range's span on the card (the program's, torch.optim's) is no
        # kernel
        if on_card and ev.key.startswith(("train.", "render.", "Optimizer.")):
            continue
        if on_card:
            ms = dev_ms(ev)                     # a kernel (or a copy)
            busy += ms
            k = next((g for g, pats in kernels.items()
                      if any(p in ev.key.lower() for p in pats)),
                     "other kernels")
            split[k] += ms
        else:
            for g, pat in ranges.items():       # a range of host code
                if ev.key.startswith(pat):
                    split[g] += dev_ms(ev, total=True)
    split["other kernels"] -= sum(split[g] for g in ranges)
    line = ", ".join(f"{k} {v:.2f}" for k, v in split.items())
    idle = (f"{1.0 - busy / wall:.3f}" if busy > 0 else
            "not measured (the profiler saw no device time)")
    log(f"{tag} step: wall {wall:.1f} ms, device "
        f"busy {busy:.1f} ms, idle share {idle}; device ms by group: "
        f"{line} on {card}")
    out = os.path.join(HERE, "build", out_dir)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, fname), "w") as f:
        f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=40))


def _check_scratch(tag: str) -> None:
    """The backward kernels' scratch never passed its cap."""
    from moco_flow_tpu_torch.ops import _args
    top = _args.run_chunks.max_scratch
    log(f"{tag} largest #2/#6 scratch so far {top / 2 ** 30:.3f} GiB (cap "
        f"{_args.SCRATCH_CAP / 2 ** 30:g} GiB)")
    if top > _args.SCRATCH_CAP:
        raise AssertionError(f"scratch {top} bytes above the cap")


def phase_train_slice(card: str) -> dict:
    """The training slice through its entry point: train(config, args) from
    a seeded checkpoint at step 6000, TRAIN_STEPS steps, bf16 then fp32."""
    from moco_flow_tpu_torch.ops import nerf_rays as nr
    from moco_flow_tpu_torch.ops import nof_chain as nc
    from moco_flow_tpu_torch.train.__main__ import parse_args as train_args
    from moco_flow_tpu_torch.train.__main__ import train
    counters = (nr.nerf_fwd, nr.nerf_bwd, nc.chain_fwd, nc.chain_bwd)
    scene = make_synthetic_scene(None, n_frames=8, size=256, focal=300.0)
    counts = {f.__name__: 0 for f in counters}
    result = {}
    for dtype in ("bfloat16", "float32"):
        cfg = train_config(dtype)
        params = init_params(torch.Generator().manual_seed(0),
                             build_statics(cfg["model"]), with_nof=True,
                             with_fw_nof=True)
        for net in ("coarse_NeRF", "fine_NeRF"):
            params[net]["sigma"]["b"] += 1.0
        seed = os.path.join(cfg["save_dir"], "seeded")
        save_checkpoint(seed, {"params": params}, extra={
            "clock": {"epoch": 1, "minibatch": 0, "step": TRAIN_START}})
        args = train_args(["-c", "(dict)", "-r", seed + ".npz", "-n", "smoke",
                           "--device", DEVICE])
        for f in counters:
            f.launches = 0
        tr = train(cfg, args, scene=scene)
        torch.cuda.synchronize()
        for f in counters:
            if f.launches != 2 * TRAIN_STEPS:
                raise AssertionError(
                    f"{f.__name__} launched {f.launches} times in "
                    f"{TRAIN_STEPS} steps, expected {2 * TRAIN_STEPS}")
            counts[f.__name__] += f.launches
        losses = {k: float(v) for k, v in tr.losses.items()}
        if tr.clock.step != TRAIN_START + TRAIN_STEPS or not all(
                np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"train {dtype}: step {tr.clock.step}, "
                                 f"losses {losses}")
        moved = max((tr.params[net]["trunk"][0]["w"].detach().cpu()
                     - params[net]["trunk"][0]["w"].cpu()).abs().max().item()
                    for net in ("coarse_NeRF", "fine_NeRF"))
        moved_nof = (tr.params["bw_NoF"]["layers"][0]["w"].detach().cpu()
                     - params["bw_NoF"]["layers"][0]["w"].cpu()).abs().max()
        if not 0 < moved < 1 or not 0 < moved_nof.item() < 1:
            raise AssertionError(f"train {dtype}: params moved {moved}, "
                                 f"{moved_nof.item()}")
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):                                   # warm steps
            tr.train_step()
        steps = 5
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(steps):
            tr.train_step()
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1) / steps
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        result[dtype] = ms
        log(f"[8 train slice] {dtype}: {TRAIN_STEPS} steps from step "
            f"{TRAIN_START}, last losses {json.dumps(losses)}; params moved "
            f"(NeRF {moved:.2e}, bw NoF {moved_nof.item():.2e}); launches "
            f"nerf fwd/bwd, chain fwd/bwd = {2 * TRAIN_STEPS} each; step "
            f"{ms:.1f} ms = {1024 / ms * 1e3:.0f} rays/s (1024 rays x "
            f"(128 + 128) samples), peak memory {peak:.2f} GiB on {card}")
        _check_scratch("[8 train slice]")
        if dtype == "bfloat16":
            _profile_step(tr, card)
        torch.cuda.synchronize()
    result["launches"] = counts
    return result


# ---------------------------------------------------------------------------
# The msk / full phases and the val step (phases 9-11)
# ---------------------------------------------------------------------------

STAGE2_POINTS = 200_000   # init_nof.yaml's N_sampled 100,000: 2 x 100,000 a NoF


def _nof_case(P, fcfg, an_f, n, s, gen, dev, rechunk: bool = False,
              n_freqs: int = 5):
    """#3/#4's inputs for n rays of s samples at ``n_freqs`` xyz PE bands
    (c2f's 5, or init_nof.yaml's 0, padded to the same 33 inputs); with
    ``rechunk`` one ray of s samples as nof_fused_rays launches the kernels
    with it (rays of 4096 samples, zero-padded, the frame embedding
    broadcast; the cotangent of the padding 0, as the slice of the output
    makes it)."""
    from moco_flow_tpu_torch.ops import nof_rays as nr
    from moco_flow_tpu_torch.ops.folds import _NofSpec, _nof_fold
    xyz = (0.6 * torch.randn(3, n, s, generator=gen)).to(dev)
    emb = torch.randn(n, 33, generator=gen).to(dev)
    g = (torch.randn(3, n, s, generator=gen) / (n * s) ** 0.5).to(dev)
    if rechunk:
        xyz_c, emb = nr._rechunk(xyz.permute(1, 2, 0), emb)
        xyz = xyz_c.permute(2, 0, 1).contiguous()
        g = nr._rechunk(g.permute(1, 2, 0), emb)[0].permute(2, 0, 1)
        g = g.contiguous()
    ws, parts = _nof_fold(P, fcfg, n_freqs, an_f if n_freqs else None, emb)
    spec = _NofSpec(4, 128, 3 * max(n_freqs, 1), (2,), True, True)
    return spec, xyz, parts, ws, g


def _nof_macs(ws) -> int:
    """Multiply-adds a row of the NoF's products (matrices of the folded
    operands; biases and per-ray partials excluded)."""
    return sum(w.shape[0] * w.shape[1] for w in ws
               if w.dim() == 2 and w.shape[0] > 1)


def phase_nof_kernels(dev, card: str,
                      sizes=((1, 2000, True), (1, 10000, True),
                             (1, STAGE2_POINTS, True),
                             (1, STAGE2_POINTS, True, 0),
                             (16384, 128, False))) -> dict:
    """Kernels #3/#4 (the single NoF warp) against their plain versions at
    full width on ``sizes`` (rays, samples, with the backward, and the xyz
    PE bands if not c2f's 5: init_nof.yaml's NoF has 0; one ray of
    STAGE2_POINTS samples goes in re-chunked, as stage 2 launches it), then
    each timed with its plain version and bound on the first (the step's
    correspondence ray), the stage-2 sets and the last forward (the val
    tile)."""
    from moco_flow_tpu_torch.ops import _args
    from moco_flow_tpu_torch.ops import nof_chain as nc
    from moco_flow_tpu_torch.ops import nof_rays as nr
    gen = torch.Generator().manual_seed(2)
    fcfg = NoFConfig()
    P = init_nof(gen, fcfg, dev)
    an_f = anneal_weights(505000, 5, 5000, 1005000).to(dev)
    err = {"nof_fwd": 0.0, "nof_bwd": 0.0}
    cases = {}
    keys = []
    for n_r, s, with_bwd, *bands in sizes:
        nf = bands[0] if bands else 5
        keys.append((n_r, s, nf))
        case = _nof_case(P, fcfg, an_f, n_r, s, gen, dev,
                         rechunk=s == STAGE2_POINTS, n_freqs=nf)
        spec, xyz, parts, ws, g = cases[keys[-1]] = case
        shape = f"N={xyz.shape[1]} S={xyz.shape[2]}" + (
            f" xyz bands {nf}" if nf != 5 else "")
        plain32 = None
        for dname, dt in (("fp32", None), ("bf16", torch.bfloat16)):
            tag = f"nof {shape} {dname}"
            ko = nr.nof_fwd(spec, dt, xyz, parts, ws)
            ro = nr._nof_fwd_ref(spec, dt, xyz, parts, ws)
            torch.cuda.synchronize()
            pb = plain32 or (None, None)
            e, e_rel = check_train(f"{tag} out", ko, ro, dname, pb[0])
            err["nof_fwd"] = max(err["nof_fwd"], e)
            line = (f"[9 nof kernels] {tag}: forward max|d| {e:.3e} "
                    f"({e_rel:.1e} of max|ref|)")
            rb = None
            if with_bwd:
                kb = nr.nof_bwd(spec, dt, xyz, parts, ws, g)
                rb = nr._nof_bwd_ref(spec, dt, xyz, parts, ws, g)
                torch.cuda.synchronize()
                got = [kb[0], *kb[1], *kb[2]]
                want = [rb[0], *rb[1], *rb[2]]
                refs32 = (None if pb[1] is None else
                          [pb[1][0], *pb[1][1], *pb[1][2]])
                worst, w_rel = 0.0, 0.0
                for i, (a, b) in enumerate(zip(got, want)):
                    w = check_train(f"{tag} grad[{i}]", a, b, dname,
                                    None if refs32 is None else refs32[i],
                                    grad=True)
                    worst, w_rel = max(worst, w[0]), max(w_rel, w[1])
                err["nof_bwd"] = max(err["nof_bwd"], worst)
                line += (f", backward max|d| {worst:.3e} (at most "
                         f"{w_rel:.1e} of a tensor's max|ref|) over dxyz, "
                         f"{len(kb[1])} d(partial) and {len(kb[2])} dW "
                         "(tolerance: TRAIN_TOL)")
                rows = xyz.shape[1] * xyz.shape[2]
                want_b = nc.scratch_bytes(nc._ChainSpec(spec, False, False),
                                          dt, rows)
                got_b = _args.run_chunks.last["scratch_bytes"]
                line += (f"; scratch {got_b} bytes ({got_b / rows:.0f} a "
                         f"row, reckoned {want_b}) in "
                         f"{_args.run_chunks.last['chunks']} chunk(s)")
                if got_b != want_b:
                    raise AssertionError(f"{tag}: scratch {got_b} bytes, "
                                         f"reckoned {want_b}")
            log(line)
            if dname == "fp32":
                plain32 = (ro, rb)
    # bound: each input read once (xyz 12 B a row, the cotangent 12 B, the
    # per-ray partials, the weights in the compute type), each output
    # written once (warped or dxyz 12 B a row, dW fp32)
    step_shape, val_shape = keys[0], keys[-1]
    stage2 = next(k for k in keys if k[1] == STAGE2_POINTS and k[2] == 5)
    stage2_0 = [k for k in keys if k[1] == STAGE2_POINTS and k[2] == 0]
    times, times_stage2 = {}, {}
    shapes = [("nof_fwd", step_shape), ("nof_bwd", step_shape),
              ("nof_fwd", stage2), ("nof_bwd", stage2),
              *[(nm, k) for k in stage2_0 for nm in ("nof_fwd", "nof_bwd")],
              ("nof_fwd", val_shape)]
    for dname, dt in (("bf16", torch.bfloat16), ("fp32", None)):
        wb = 2 if dt is not None else 4
        for name, key in shapes:
            spec, xyz, parts, ws, g = cases[key]
            n_w, n_p = sum(w.numel() for w in ws), len(parts)
            macs = NOF_MACS if key[2] == 5 else _nof_macs(ws)
            n_r, s = xyz.shape[1], xyz.shape[2]
            rows, part_b = n_r * s, n_r * 128 * 4 * n_p
            if name == "nof_fwd":
                kern = lambda: nr.nof_fwd(spec, dt, xyz, parts, ws)  # noqa: E731
                plain = lambda: nr._nof_fwd_ref(spec, dt, xyz, parts, ws)  # noqa: E731
                flops = 2 * macs * rows
                nbytes = rows * 24 + wb * n_w + part_b
            else:
                kern = lambda: nr.nof_bwd(spec, dt, xyz, parts, ws, g)  # noqa: E731
                plain = lambda: nr._nof_bwd_ref(spec, dt, xyz, parts, ws, g)  # noqa: E731
                flops = 3 * 2 * macs * rows
                nbytes = rows * 36 + (wb + 4) * n_w + 2 * part_b
            k_ms = cuda_ms(kern, reps=5)
            p_ms = cuda_ms(plain, reps=5)
            b_ms, b_by = bound_ms(flops, nbytes, dname)
            if dname == "bf16" and key == step_shape:
                times[name] = (k_ms, p_ms, b_ms, b_by)
            if key in stage2_0:
                times_stage2[(name, dname)] = (k_ms, p_ms, b_ms, b_by)
            # #3's fp32 build multiplies in split TF32 (#4's passes and
            # dW products too)
            shares = (f"; {fwd_shares(flops, k_ms, dname)}"
                      if name == "nof_fwd" else "")
            bands = "" if key[2] == 5 else f" xyz bands {key[2]}"
            log(f"[9 nof kernels] {name} {dname} N={n_r} S={s}{bands}, one "
                "launch: "
                f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
                f"{b_ms:.5f} ms ({b_by}: {flops / 1e9:.3f} GFLOP, "
                f"{nbytes / 1e6:.2f} MB){shares} on {card}")
        spec, xyz, parts, ws, g = cases[stage2]
        split = _device_split(lambda: nr.nof_bwd(spec, dt, xyz, parts, ws, g),
                              BWD_GROUPS)
        log(f"[9 nof kernels] nof_bwd {dname} at stage 2's shape, device ms "
            "by part: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
            + f" on {card}")
        for key in stage2_0:   # init_nof.yaml's NoF: its dW products
            if dname != "fp32":
                continue
            spec, xyz, parts, ws, g = cases[key]
            split = _device_split(
                lambda: nr.nof_bwd(spec, dt, xyz, parts, ws, g), BWD_GROUPS)
            _dw_line("9 nof kernels", f"init_nof #4, N={xyz.shape[1]} "
                     f"S={xyz.shape[2]}, xyz bands 0", split["dW products"],
                     2 * _nof_macs(ws) * xyz.shape[1] * xyz.shape[2], card)
    torch.cuda.synchronize()
    return {"err": err, "times": times, "stage2": times_stage2}


def phase_phases_golden(dev):
    """The fixture's full / none + freeze / msk steps and its val step
    replayed on the card (fp32), under STEP_TOL."""
    from scripts.make_torch_port_phases_golden import (
        FIXTURE as PHASES_FIXTURE, RUNS, SCENE, load, port_run)
    if not os.path.exists(PHASES_FIXTURE):
        raise FileNotFoundError(PHASES_FIXTURE)
    arrs = load()
    worst = perr = 0.0
    for run in RUNS:
        scene = (make_synthetic_scene(None, **SCENE) if run == "msk"
                 else None)
        metrics, deleted, tr = port_run(arrs, run, dev, scene)
        torch.cuda.synchronize()
        for i, m in enumerate(metrics):
            want = {k.split("/")[-1]: float(v) for k, v in arrs.items()
                    if k.startswith(f"metrics/{run}/{i}/")}
            if set(m) != set(want):
                raise AssertionError(f"{run} step {i}: loss terms {set(m)} "
                                     f"!= JAX's {set(want)}")
            if deleted[i] != bool(arrs[f"deleted/{run}/{i}"]):
                raise AssertionError(f"{run} step {i}: nof_opt_deleted "
                                     f"{deleted[i]}")
            for k, v in m.items():
                rel = abs(v - want[k]) / max(abs(want[k]), 1e-30)
                worst = max(worst, rel)
                if rel > STEP_TOL["metrics_rtol"]:
                    raise AssertionError(f"phases fixture {run} step {i} "
                                         f"{k}: port {v} JAX {want[k]}")
        from moco_flow_tpu_torch.train.checkpoint import _flatten
        for k, v in _flatten(tr.params).items():
            d = float(np.abs(v - arrs[f"params_{run}/{k}"]).max())
            perr = max(perr, d)
            if d > STEP_TOL["params_atol"]:
                raise AssertionError(f"phases fixture {run} params {k}: "
                                     f"max|diff| {d:.3e}")
        if run == "msk":
            val = tr.val_step()
            torch.cuda.synchronize()
            for k, v in val.items():
                want = float(arrs[f"val/{k}"])
                rel = abs(v - want) / max(abs(want), 1e-30)
                worst = max(worst, rel)
                if rel > STEP_TOL["metrics_rtol"]:
                    raise AssertionError(f"phases fixture val {k}: port {v} "
                                         f"JAX {want}")
    log(f"[10 phases vs JAX fixture] full x3 (4998-5000) and msk x2 "
        f"(10000-10001) steps and the val step: loss terms, train_psnr and "
        f"val metrics max rel diff {worst:.2e} (tol "
        f"{STEP_TOL['metrics_rtol']:g}), params max|diff| {perr:.2e} (tol "
        f"{STEP_TOL['params_atol']:g})")


# per-step launches of each phase: the single warp twice (bw and fw NoF
# supervision, the mask loss reuses bw) in full, once (the mask loss) in
# msk, never in none; the chain and the NeRF kernels twice every step
PHASE_LAUNCHES = {"full": {"nof_fwd": 2, "nof_bwd": 2},
                  "msk": {"nof_fwd": 1, "nof_bwd": 1},
                  "none": {"nof_fwd": 0, "nof_bwd": 0}}
PHASE_RUNS = ((4996, 6), (9998, 4))   # (resume step, steps)
VAL_SIZE = 108


_SCENES = {}


def body_scene(size: int = 256, focal: float = 300.0):
    """The synthetic 8-frame scene of the 6890-vertex body at ``size``,
    made once a size and shared by every phase on the body (the host
    renders it in ~40-60 s; the same seed gives the same scene)."""
    from moco_flow_tpu_torch.geometry.smpl import synthetic_smpl_data
    if "body" not in _SCENES:
        _SCENES["body"] = synthetic_smpl_data(6890)
    if (size, focal) not in _SCENES:
        _SCENES[(size, focal)] = make_synthetic_scene(
            None, n_frames=8, size=size, focal=focal, smpl=_SCENES["body"])
    return _SCENES[(size, focal)]


def phases_config(dtype: str) -> dict:
    """train_config() with c2f.yaml's NoF supervision: N_sampled 1000, nof
    10 x L1, msk 10 x BCE, the nof Adam."""
    cfg = train_config(dtype)
    cfg["save_dir"] = os.path.join(HERE, "build", "chip_smoke_phases", dtype)
    cfg["model"]["N_sampled"] = 1000
    cfg["loss"].update({"nof_loss": {"type": "L1", "weight": 10},
                        "msk_loss": {"type": "BCE", "weight": 10}})
    cfg["optimizer"]["nof"] = {"type": "adam", "lr": 1e-4, "weight_decay": 0}
    return cfg


def _timed_steps(tr, warm: int = 3, steps: int = 5) -> float:
    for _ in range(warm):
        tr.train_step()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(steps):
        tr.train_step()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / steps


def phase_phases_slice(card: str) -> dict:
    """The msk / full phases through train(config, args) at full width,
    then step and val times."""
    from moco_flow_tpu_torch.data.dataset import get_dataset
    from moco_flow_tpu_torch.ops import nerf_rays as nr
    from moco_flow_tpu_torch.ops import nof_chain as nc
    from moco_flow_tpu_torch.ops import nof_rays as nf
    from moco_flow_tpu_torch.train.__main__ import parse_args as train_args
    from moco_flow_tpu_torch.train.__main__ import train
    from moco_flow_tpu_torch.train.stage_mocoflow import MoCoFlowTrainer
    counters = (nf.nof_fwd, nf.nof_bwd, nr.nerf_fwd, nr.nerf_bwd,
                nc.chain_fwd, nc.chain_bwd)
    scene = body_scene()
    val_scene = body_scene(VAL_SIZE, 300.0 * VAL_SIZE / 256)
    smpl = scene.smpl
    log(f"[11 phases slice] scene 256x256 x 8 frames, val {VAL_SIZE}x"
        f"{VAL_SIZE}, body of {smpl.num_vertices} vertices")
    counts = {"nof_fwd": 0, "nof_bwd": 0}
    result = {}
    orig = MoCoFlowTrainer.train_func
    record = []

    def counted(self):
        before = {f.__name__: f.launches for f in counters}
        w0 = self.params["coarse_NeRF"]["trunk"][0]["w"].detach().clone()
        out = orig(self)
        w1 = self.params["coarse_NeRF"]["trunk"][0]["w"].detach()
        record.append((self.clock.step, self.phase(self.clock.step),
                       {f.__name__: f.launches - before[f.__name__]
                        for f in counters},
                       bool((w1 != w0).any()), self.nof_opt_deleted,
                       self.opt_nof is None))
        return out

    MoCoFlowTrainer.train_func = counted
    try:
        for dtype in ("bfloat16", "float32"):
            cfg = phases_config(dtype)
            params = init_params(torch.Generator().manual_seed(0),
                                 build_statics(cfg["model"]), with_nof=True,
                                 with_fw_nof=True)
            for net in ("coarse_NeRF", "fine_NeRF"):
                params[net]["sigma"]["b"] += 1.0
            for start, n_steps in PHASE_RUNS:
                cfg["trainer"]["num_iters"] = start + n_steps
                seed = os.path.join(cfg["save_dir"], f"seeded{start}")
                save_checkpoint(seed, {"params": params}, extra={
                    "clock": {"epoch": 1, "minibatch": 0, "step": start}})
                args = train_args(["-c", "(dict)", "-r", seed + ".npz", "-n",
                                   f"smoke{start}", "--device", DEVICE])
                record.clear()
                for f in counters:
                    f.launches = 0
                tr = train(cfg, args, scene=scene)
                torch.cuda.synchronize()
                for step, (mode, freeze), got, moved, deleted, gone in record:
                    want = dict(PHASE_LAUNCHES[mode], nerf_fwd=2, nerf_bwd=2,
                                chain_fwd=2, chain_bwd=2)
                    if got != want:
                        raise AssertionError(f"step {step} ({mode}): "
                                             f"launches {got}, want {want}")
                    if moved == freeze:
                        raise AssertionError(
                            f"step {step}: the NeRF trunk "
                            f"{'moved' if moved else 'stood'} with the "
                            f"density {'frozen' if freeze else 'free'}")
                    if mode == "none" and not (deleted and gone):
                        raise AssertionError(f"step {step}: the nof "
                                             "optimizer is not deleted")
                    if mode == "full" and (deleted or gone):
                        raise AssertionError(f"step {step}: the nof "
                                             "optimizer is gone in full")
                counts["nof_fwd"] += nf.nof_fwd.launches
                counts["nof_bwd"] += nf.nof_bwd.launches
                losses = {k: float(v) for k, v in tr.losses.items()}
                if not all(np.isfinite(v) for v in losses.values()):
                    raise AssertionError(f"{dtype} from {start}: {losses}")
                log(f"[11 phases slice] {dtype} from {start}: "
                    + ", ".join(f"{st} {m}{'+freeze' if fr else ''} "
                                f"nof {g['nof_fwd']}/{g['nof_bwd']}"
                                for st, (m, fr), g, *_ in record)
                    + f"; last losses {json.dumps(losses)}")
            # step times (tr: the msk run's trainer, at 10001): msk, then
            # full with both optimizers rebuilt (fresh state)
            tr.clock.step = 10000
            ms_msk = _timed_steps(tr)
            tr.clock.step = 4000
            tr.nof_opt_deleted, tr.opt = False, None
            ms_full = _timed_steps(tr)
            tr.clock.step = 10000
            tr.val_dataset = get_dataset(dict(cfg["dataloader"],
                                              val_size=[VAL_SIZE, VAL_SIZE]),
                                         "val", scene=val_scene)
            nf.nof_fwd.launches = nf.nof_bwd.launches = 0
            val = tr.val_func()                              # warm
            n_val = nf.nof_fwd.launches
            if n_val != 2 or nf.nof_bwd.launches != 0 or not all(
                    np.isfinite(v) for v in val.values()):
                raise AssertionError(f"val: {val}, nof_fwd {n_val}, nof_bwd "
                                     f"{nf.nof_bwd.launches} launches")
            counts["nof_fwd"] += n_val
            ms_val = cuda_ms(tr.val_step, reps=2)
            result[dtype] = (ms_msk, ms_full, ms_val)
            log(f"[11 phases slice] {dtype}: msk step {ms_msk:.1f} ms, full "
                f"step {ms_full:.1f} ms (1024 rays x (128 + 128) samples + "
                f"2000 correspondence points), val step {ms_val:.1f} ms "
                f"({VAL_SIZE}x{VAL_SIZE} rays in one 16384-ray tile, "
                f"{n_val} nof_fwd launches; {json.dumps(val)}) on {card}")
            if dtype == "bfloat16":
                tr.clock.step = 10000
                tr.nof_opt_deleted, tr.opt = True, None
                tr.train_step()                 # warm: the optimizer's state
                _profile_step(tr, card, "[11 phases slice] profiled bf16 msk",
                              "msk_step_profile.txt")
            torch.cuda.synchronize()
    finally:
        MoCoFlowTrainer.train_func = orig
    result["launches"] = counts
    return result


# ---------------------------------------------------------------------------
# The per-op route, mlp_impl: pallas (phases 12-15)
# ---------------------------------------------------------------------------

MLP_SOURCE = "moco_flow_tpu_torch/ops/csrc/fused_mlp.cu"
MLP_KERNELS = (("nerf_pallas", "moco_flow_tpu/ops/fused_mlp.py:94"),
               ("nof_pallas", "moco_flow_tpu/ops/fused_mlp.py:233"))
# init_nerf.yaml:38-45 (coarse_NeRF = fine_NeRF): 8x256, skip 4, 63 inputs
# (N_freqs 0 padded), a 'dir' extra of 27 (4 frequencies)
STAGE1_NERF = NeRFConfig(depth=8, width=256, in_channels_xyz=63, skips=(4,),
                         extra_feat_type="dir", extra_feat_dim=27)
STAGE1_RAYS = 5120                   # init_nerf.yaml:25 N_rand


def _mlp_macs(ws: list) -> int:
    """Multiply-adds a row: one per weight element (the even entries)."""
    return sum(w.numel() for w in ws[0::2])


def phase_mlp_kernels(dev, card: str, scale: int = 1) -> dict:
    """Kernels #8 (NeRF) and #9 (NoF) against their plain versions at full
    width: #8 at one stage-1 step's shapes (5120 rays x 128 and x 256 rows,
    'dir' extra) and the render tile's sigma-only 16384 x 128, #9 at the
    render tile 16384 x 128 of c2f's NoF, and both at a ragged 100003 rows;
    fp32 and bf16. Then each is timed with its plain version and bound at
    the main path's shapes. ``scale`` divides the row counts (a CPU
    rehearsal)."""
    from moco_flow_tpu_torch.ops import fused_mlp as fm
    gen = torch.Generator().manual_seed(3)
    nerf_p = init_nerf(gen, STAGE1_NERF, dev)
    fcfg = NoFConfig()
    nof_p = init_nof(gen, fcfg, dev)

    def nerf_case(rows, sigma_only):
        x = (torch.rand(rows, 63, generator=gen) * 2 - 1).to(dev)
        e = (torch.rand(rows, 27, generator=gen) * 2 - 1).to(dev)
        return (STAGE1_NERF, x, None if sigma_only else e, sigma_only,
                fm._nerf_weights_flat(nerf_p, sigma_only))

    def nof_case(rows):
        inp = (torch.rand(rows, fcfg.in_dim, generator=gen) * 2 - 1).to(dev)
        xyz = (0.6 * torch.randn(rows, 3, generator=gen)).to(dev)
        return fcfg, inp, xyz, fm._nof_weights_flat(nof_p)

    step = [nerf_case(STAGE1_RAYS * s // scale, False) for s in (128, 256)]
    cases = {
        "nerf": step + [nerf_case(16384 * 128 // scale, True),
                        nerf_case(100003 // scale, False)],
        "nof": [nof_case(16384 * 128 // scale), nof_case(100003 // scale)]}
    run = {"nerf": (fm.nerf_pallas, fm._nerf_pallas_ref),
           "nof": (fm.nof_pallas, fm._nof_pallas_ref)}
    err = {"nerf_pallas": 0.0, "nof_pallas": 0.0}
    dts = (("fp32", None), ("bf16", torch.bfloat16))
    for net, cs in cases.items():
        kern, plain = run[net]
        for c in cs:
            rows = c[1].shape[0]
            gap_ref = {}
            for dname, dt in dts:
                if net == "nerf":
                    cfg, x, e, so, ws = c
                    ko, ro = kern(cfg, dt, x, e, so, ws), plain(cfg, dt, x, e,
                                                                so, ws)
                    tag = (f"nerf {'sigma-only' if so else 'full'} rows="
                           f"{rows} {dname}")
                else:
                    cfg, inp, xyz, ws = c
                    ko, ro = kern(cfg, dt, inp, xyz, ws), plain(cfg, dt, inp,
                                                                xyz, ws)
                    tag = f"nof rows={rows} {dname}"
                torch.cuda.synchronize()
                atol, rtol = TOL[dname]
                e_max = check_close(tag, ko, ro, atol, rtol)
                err[f"{net}_pallas"] = max(err[f"{net}_pallas"], e_max)
                gap_ref[dname] = (ro, e_max)
                log(f"[12 mlp kernels] {tag}: max|d| {e_max:.3e} (tol "
                    f"{atol:g} + {rtol:g}|ref|)")
            gap = (gap_ref["bf16"][0] - gap_ref["fp32"][0]).abs().max().item()
            log(f"[12 mlp kernels] bf16-vs-fp32 gap of the plain version, "
                f"{tag[:-5]}: {gap:.3e}")
            # TOL['bf16'] is loose next to this gap: the kernel's bf16 body
            # must also stay within the gap, so that a mis-wired bf16 layer
            # cannot pass at these shapes
            if not gap_ref["bf16"][1] <= gap:
                raise AssertionError(
                    f"{tag[:-5]}: bf16 kernel vs plain {gap_ref['bf16'][1]:.3e}"
                    f" exceeds the plain version's bf16-vs-fp32 gap {gap:.3e}")
    # times at the main path's shapes: #8 one stage-1 step's two launches,
    # #9 one launch of the pallas render's tile (16384 rays x 128 samples)
    times = {}
    for dname, dt in (("bf16", torch.bfloat16), ("fp32", None)):
        wb = 2 if dt is not None else 4
        work = {}
        for name, cs, f in (("nerf_pallas", step, _mlp_nerf_call),
                            ("nof_pallas", cases["nof"][:1], _mlp_nof_call)):
            rows = [c[1].shape[0] for c in cs]
            macs = [_mlp_macs(c[-1]) for c in cs]
            flops = sum(2 * m * r for m, r in zip(macs, rows))
            if name == "nerf_pallas":   # x, extra in; 4 fp32 out a row
                nbytes = sum(r * 4 * (63 + 27 + 4) for r in rows)
            else:                       # inputs, xyz in; 3 fp32 out a row
                nbytes = sum(r * 4 * (fcfg.in_dim + 3 + 3) for r in rows)
            nbytes += len(cs) * wb * sum(w.numel() for w in cs[0][-1])
            work[name] = ([lambda c=c, f=f: f(fm, True, c, dt) for c in cs],
                          [lambda c=c, f=f: f(fm, False, c, dt) for c in cs],
                          flops, nbytes)
        for name, (kern, plain, flops, nbytes) in work.items():
            k_ms = cuda_ms(lambda: [f() for f in kern], reps=3)
            p_ms = cuda_ms(lambda: [f() for f in plain], reps=3)
            b_ms, b_by = bound_ms(flops, nbytes, dname)
            times[name if dname == "bf16" else f"{name} fp32"] = (
                k_ms, p_ms, b_ms, b_by)
            what = ("one stage-1 step's two launches (5120 x 128 + 5120 x "
                    "256 rows)" if name == "nerf_pallas" else
                    "one launch (16384 x 128 rows)")
            if name == "nerf_pallas":   # 63 inputs, 8x256 skip 4, dir 27
                mats = ([(63, 256)] + [(256, 256)] * 3
                        + [(63, 256), (256, 256)] + [(256, 256)] * 4
                        + [(256, 128), (27, 128), (128, 3)])
                tiles = sum(-(-c[1].shape[0] // 128) for c in step)
                parts = 1
            else:   # c2f's NoF: 66 inputs, 4x128 skip 2, the 9-wide head
                k_in = fcfg.in_dim
                mats = ([(k_in, 128), (128, 128), (k_in, 128), (128, 128),
                         (128, 128), (128, 9)])
                tiles = -(-cases["nof"][0][1].shape[0] // 128)
                parts = 1 if dt is not None else 2   # fp32: hi and lo parts
            l2 = tiles * parts * fwd_weight_bytes(mats, dname)
            extra = (f"; {fwd_shares(flops, k_ms, dname)}; weights streamed "
                     f"from L2 {l2 / 1e9:.2f} GB ({l2 / k_ms / 1e9:.2f} "
                     "TB/s)")
            log(f"[12 mlp kernels] {name} {dname}, {what}: kernel "
                f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b_ms:.4f} ms "
                f"({b_by}: {flops / 1e12:.3f} TFLOP, {nbytes / 1e6:.1f} MB)"
                f"{extra} on {card}")
    for k in ("nerf_wg_kernel", "nerf_tf32_kernel", "nof_wg_kernel",
              "nof_tf32_kernel"):
        log(f"[12 mlp kernels] {k}: "
            f"{' | '.join(PTXAS.get(k, ['(cached build)']))}; dynamic "
            f"shared memory {FWD_SMEM[k]} bytes a block")
    torch.cuda.synchronize()
    return {"err": err, "times": times}


def _mlp_nerf_call(fm, kernel: bool, c, dt):
    cfg, x, e, so, ws = c
    f = fm.nerf_pallas if kernel else fm._nerf_pallas_ref
    return f(cfg, dt, x, e, so, ws)


def _mlp_nof_call(fm, kernel: bool, c, dt):
    cfg, inp, xyz, ws = c
    f = fm.nof_pallas if kernel else fm._nof_pallas_ref
    return f(cfg, dt, inp, xyz, ws)


def phase_stage1_golden(dev):
    """The stage-1 fixture's three steps and its val step replayed on the
    card (fp32), under STEP_TOL."""
    from scripts.make_torch_port_stage1_golden import (
        N_STEPS, SCENE, load, port_replay)
    from moco_flow_tpu_torch.train.checkpoint import _flatten
    arrs = load()
    metrics, val, tr = port_replay(arrs, dev,
                                   make_synthetic_scene(None, **SCENE))
    torch.cuda.synchronize()
    worst = 0.0
    got = [(f"metrics/{i}/{k}", v) for i, m in enumerate(metrics)
           for k, v in m.items()] + [(f"val/{k}", v) for k, v in val.items()]
    for key, v in got:
        want = float(arrs[key])
        rel = abs(v - want) / max(abs(want), 1e-30)
        worst = max(worst, rel)
        if rel > STEP_TOL["metrics_rtol"]:
            raise AssertionError(f"stage-1 fixture {key}: port {v} JAX "
                                 f"{want} (rel {rel:.2e})")
    perr = 0.0
    for k, v in _flatten(tr.params).items():
        d = float(np.abs(v - arrs[f"params{N_STEPS}/{k}"]).max())
        perr = max(perr, d)
        if d > STEP_TOL["params_atol"]:
            raise AssertionError(f"stage-1 fixture params {k}: max|diff| "
                                 f"{d:.3e}")
    log(f"[13 stage 1 vs JAX fixture] {N_STEPS} radam steps on the per-op "
        f"route and the val step: img_loss, train_psnr and val metrics max "
        f"rel diff {worst:.2e} (tol {STEP_TOL['metrics_rtol']:g}), params "
        f"max|diff| {perr:.2e} (tol {STEP_TOL['params_atol']:g})")


STAGE1_START, STAGE1_STEPS, STAGE1_VAL = 0, 3, 216


def stage1_config(dtype: str, impl: str = "pallas") -> dict:
    """configs/people_snapshot/male-3-casual/init_nerf.yaml:9-67 as a dict
    (the GPU machine has no yaml), on the 256x256 synthetic scene in place
    of the 1080x1080 init_nerf renders, with ``mlp_impl`` ``impl`` and the
    compute type ``dtype``; a few steps, no periodic val or checkpoints."""
    nerf = {"type": "NeRF", "D": 8, "W": 256, "in_channels_xyz": 63,
            "skips": [4], "extra_feat_type": "dir", "extra_feat_dim": 27}
    return {
        "save_dir": os.path.join(HERE, "build", "chip_smoke_stage1", dtype),
        "exp_name": "init_nerf",
        "dataloader": {"type": "moco_flow", "root_dir": None,
                       "imgs_dir": "images", "size": [256, 256],
                       "val_size": [256, 256],
                       "aabb": [[1.2, 1.2, 1.2], [0, 0, 0]], "bkgd": 1.0,
                       "interval": 1},
        "model": {
            "type": "nerf", "pretrained_path": None, "N_rand": STAGE1_RAYS,
            "chunk": 16384, "N_samples": 128, "N_importance": 128,
            "use_disp": False, "perturb": 1.0, "noise_std": 0.0,
            "nerf_activate_type": "softplus", "compute_dtype": dtype,
            "mlp_impl": impl,
            "nerf_embedding_xyz": {"type": "Embedding", "in_channels": 3,
                                   "N_freqs": 0, "logscale": True},
            "nerf_embedding_dir": {"type": "Embedding", "in_channels": 3,
                                   "N_freqs": 4, "logscale": True},
            "nerf_embedding_ind": None,
            "coarse_NeRF": nerf, "fine_NeRF": dict(nerf)},
        "loss": {"type": "MSE"},
        "optimizer": {"type": "radam", "lr": 0.001, "weight_decay": 0},
        "scheduler": {"type": "steplr", "decay_step": [100000],
                      "decay_gamma": 0.5},
        "trainer": {"num_iters": STAGE1_START + STAGE1_STEPS,
                    "val_every_n_step": 0, "save_every_n_step": 0,
                    "log_freq": 1},
    }


STAGE1_GROUPS = {"nerf_pallas": ("nerf_wg_kernel",),
                 "gemm (the recompute backward)": ("gemm",)}


def phase_stage1_slice(card: str, size: int = 256,
                       val_size: int = STAGE1_VAL) -> dict:
    """Stage 1 through train(config, args, scene=...) at init_nerf.yaml's
    model on the per-op route from the seeded init with both sigma heads
    biased up by 1 (``pretrained_path``), fp32 then bf16: launches, step
    time, peak memory, the val step, a profile; then the YAML's own route
    (mlp_impl 'xla', which the port runs on the fused kernels #1/#2) for
    comparison."""
    from moco_flow_tpu_torch.data.dataset import get_dataset
    from moco_flow_tpu_torch.ops import _args
    from moco_flow_tpu_torch.ops import fused_mlp as fm
    from moco_flow_tpu_torch.ops import nerf_rays as nr
    from moco_flow_tpu_torch.train.__main__ import parse_args as train_args
    from moco_flow_tpu_torch.train.__main__ import train
    from moco_flow_tpu_torch.train.checkpoint import _flatten
    scene = make_synthetic_scene(None, n_frames=8, size=size,
                                 focal=300.0 * size / 256)
    val_scene = make_synthetic_scene(None, n_frames=8, size=val_size,
                                     focal=300.0 * val_size / 256)
    log(f"[14 stage-1 slice] scene {size}x{size} x 8 frames, val "
        f"{val_size}x{val_size}; N_rand {STAGE1_RAYS}, radam")
    result, launches = {}, 0
    for dtype in ("float32", "bfloat16"):
        cfg = stage1_config(dtype)
        cfg["dataloader"].update(size=[size, size], val_size=[size, size])
        shutil.rmtree(cfg["save_dir"], ignore_errors=True)   # from step 0
        args = train_args(["-c", "(dict)", "-n", "smoke", "--device",
                           DEVICE])
        # the seeded init with both sigma heads biased up by 1, as phase 18
        # (a freshly drawn NeRF is often empty under stage 3's ReLU, and
        # phase 19 hands this final over to stage 3)
        init = init_params(torch.Generator().manual_seed(0),
                           build_statics(cfg["model"]))
        for net in ("coarse_NeRF", "fine_NeRF"):
            init[net]["sigma"]["b"] += 1.0
        seed = os.path.join(cfg["save_dir"], "seeded")
        save_checkpoint(seed, {"params": init})
        cfg["model"]["pretrained_path"] = seed + ".npz"
        fm.nerf_pallas.launches = 0
        tr = train(cfg, args, scene=scene)
        torch.cuda.synchronize()
        got = fm.nerf_pallas.launches
        if got != 2 * STAGE1_STEPS:
            raise AssertionError(f"stage 1 {dtype}: nerf_pallas launched "
                                 f"{got} times in {STAGE1_STEPS} steps, "
                                 f"expected {2 * STAGE1_STEPS}")
        launches += got
        losses = {k: float(v) for k, v in tr.losses.items()}
        now = _flatten(tr.params)
        moved = max(float(np.abs(now[k] - v).max())
                    for k, v in _flatten(init).items())
        if not all(np.isfinite(v) for v in losses.values()) or \
                not 0 < moved < 1:
            raise AssertionError(f"stage 1 {dtype}: losses {losses}, "
                                 f"params moved {moved}")
        torch.cuda.reset_peak_memory_stats()
        ms = _timed_steps(tr)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        tr.val_dataset = get_dataset(
            dict(cfg["dataloader"], val_size=[val_size, val_size]),
            "val", scene=val_scene)
        fm.nerf_pallas.launches = 0
        val = tr.val_func()
        n_val = fm.nerf_pallas.launches
        launches += n_val
        tiles = -(-val_size ** 2 // 16384)
        if n_val != 2 * tiles or not all(np.isfinite(v)
                                         for v in val.values()):
            raise AssertionError(f"stage-1 val {dtype}: {val}, "
                                 f"{n_val} nerf_pallas launches")
        ms_val = cuda_ms(tr.val_step, reps=1)
        result[dtype] = {"step_ms": ms, "peak_gib": peak, "val_ms": ms_val}
        tr.save_ckpt("final")              # with the val step's clock
        result[dtype]["final"] = os.path.join(tr.job_dir, "ckpts",
                                              "final.npz")
        log(f"[14 stage-1 slice] {dtype}: {STAGE1_STEPS} steps, "
            f"nerf_pallas {got} launches, last losses {json.dumps(losses)}, "
            f"params moved {moved:.2e}; step {ms:.1f} ms = "
            f"{STAGE1_RAYS / ms * 1e3:.0f} rays/s, peak memory {peak:.2f} "
            f"GiB; val step {ms_val:.1f} ms ({n_val} nerf_pallas launches, "
            f"{json.dumps(val)}) on {card}")
        if dtype == "bfloat16":
            _profile_step(tr, card, "[14 stage-1 slice] profiled bf16",
                          "stage1_step_profile.txt", "chip_smoke_stage1",
                          STAGE1_GROUPS)
        del tr
        torch.cuda.empty_cache()
    # the YAML as written: mlp_impl 'xla' is the fused route in the port
    for dtype in ("float32", "bfloat16"):
        cfg = stage1_config(dtype, impl="xla")
        cfg["dataloader"].update(size=[size, size], val_size=[size, size])
        cfg["save_dir"] += "_xla"
        shutil.rmtree(cfg["save_dir"], ignore_errors=True)
        cfg["trainer"]["num_iters"] = STAGE1_START + 1
        nr.nerf_fwd.launches = nr.nerf_bwd.launches = 0
        tr = train(cfg, train_args(["-c", "(dict)", "-n", "smoke_xla",
                                    "--device", DEVICE]), scene=scene)
        torch.cuda.synchronize()
        if (nr.nerf_fwd.launches, nr.nerf_bwd.launches) != (2, 2) or \
                not all(np.isfinite(float(v)) for v in tr.losses.values()):
            raise AssertionError(f"stage 1 as written {dtype}: launches "
                                 f"{nr.nerf_fwd.launches}/"
                                 f"{nr.nerf_bwd.launches}, {tr.losses}")
        torch.cuda.reset_peak_memory_stats()
        ms = _timed_steps(tr, warm=1, steps=3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        result[dtype]["fused_step_ms"] = ms
        log(f"[14 stage-1 slice] {dtype}, init_nerf.yaml's mlp_impl 'xla' "
            f"(the fused kernels #1/#2, 2 launches each a step): step "
            f"{ms:.1f} ms = {STAGE1_RAYS / ms * 1e3:.0f} rays/s, peak memory "
            f"{peak:.2f} GiB, #2's fine launch in "
            f"{_args.run_chunks.last['chunks']} chunk(s) on {card}")
        _check_scratch("[14 stage-1 slice]")
        del tr
        torch.cuda.empty_cache()
    result["launches"] = launches
    return result


def phase_pallas_frame(card: str, size: int = 256) -> dict:
    """The phase-5 model's 256x256 frame through test(config, args) under
    mlp_impl: pallas (the bw warp #9, the sigma-only coarse #8 and the fine
    #8), bf16 and fp32: launches, frame time, and the difference from the
    fused render (#7) of the same weights."""
    import dataclasses
    from moco_flow_tpu_torch.ops import fused_mlp as fm
    scene = make_synthetic_scene(None, n_frames=8, size=size,
                                 focal=300.0 * size / 256)
    cfg0 = slice_config()
    ckpt = seeded_checkpoint(cfg0, os.path.join(cfg0["save_dir"], "seeded"))
    args = parse_args(["-c", "(dict)", "-r", ckpt, "--render_gt", "--reso",
                       str(size), "--eval_metrics", "--eval_max_frames", "1",
                       "--device", DEVICE])
    n_rays = size * size
    tiles = -(-n_rays // 16384)
    frames, result = {}, {}
    fm.nerf_pallas.launches = fm.nof_pallas.launches = 0
    trainers = {}
    for dtype in ("bfloat16", "float32"):
        cfg = slice_config()
        cfg["model"].update({"compute_dtype": dtype, "mlp_impl": "pallas"})
        trainers[dtype] = test(cfg, args, scene=scene)
        torch.cuda.synchronize()
    counts = {"nerf_pallas": fm.nerf_pallas.launches,
              "nof_pallas": fm.nof_pallas.launches}
    want = 2 * tiles * len(trainers)
    log(f"[15 pallas frame] launches in the two test() runs: {counts} "
        f"(expected 2 passes x {tiles} tiles x {len(trainers)} runs = {want} "
        "each)")
    if counts != {"nerf_pallas": want, "nof_pallas": want}:
        raise AssertionError(f"pallas frame launches {counts}, want {want}")
    for dtype, tr in trainers.items():
        m = tr.metrics
        if m["frames"] != 1 or not all(np.isfinite(m[k])
                                       for k in ("psnr", "ssim", "dssim")):
            raise AssertionError(f"pallas frame {dtype} metrics: {m}")
        ds = tr.val_dataset
        rays = ds.frame_rays(0)
        fused_rcfg = dataclasses.replace(tr.rcfg_test, mlp_impl="fused")
        for route, rcfg in (("pallas", tr.rcfg_test), ("fused", fused_rcfg)):
            render = lambda: tr.render_rays_chunked(  # noqa: E731
                rays, ds.bkgd_img, rcfg, anneal=tr.anneal())
            res = render()
            ms = cuda_ms(render, reps=1)
            for k, v in res.items():
                if v.shape[0] != n_rays or not torch.isfinite(v).all():
                    raise AssertionError(f"{route} frame {dtype} {k}")
            frames[(route, dtype)] = res
            result[(route, dtype)] = ms
        log(f"[15 pallas frame] {dtype}: metrics {json.dumps(m)}; one "
            f"{size}x{size} frame ({n_rays} rays): pallas "
            f"{result[('pallas', dtype)]:.1f} ms, fused "
            f"{result[('fused', dtype)]:.1f} ms on {card}")
    keys = frames[("fused", "float32")].keys()
    for k in keys:
        p32, f32 = frames[("pallas", "float32")][k], frames[("fused",
                                                             "float32")][k]
        e32 = check_close(f"pallas vs fused fp32 {k}", p32, f32, *TOL["fp32"])
        # bf16: the two routes round at other points, so the bound is the
        # fused render's own bf16-vs-fp32 gap (or the fp32 tolerance, where
        # bf16 leaves an output all but exact, as a saturated opacity)
        gap = (frames[("fused", "bfloat16")][k] - f32).abs().max().item()
        e16 = (frames[("pallas", "bfloat16")][k]
               - frames[("fused", "bfloat16")][k]).abs().max().item()
        bound = max(gap, TOL["fp32"][0])
        if not e16 <= bound:
            raise AssertionError(f"pallas vs fused bf16 {k}: max|d| "
                                 f"{e16:.3e} above {bound:.3e}, the larger "
                                 f"of the fused render's bf16-vs-fp32 gap "
                                 f"{gap:.3e} and {TOL['fp32'][0]:g}")
        log(f"[15 pallas frame] {k}: pallas vs fused fp32 max|d| {e32:.3e} "
            f"(tol {TOL['fp32'][0]:g} + {TOL['fp32'][1]:g}|ref|), bf16 "
            f"{e16:.3e} (bound {bound:.3e}: the larger of the fused "
            f"bf16-vs-fp32 gap {gap:.3e} and {TOL['fp32'][0]:g})")
    torch.cuda.synchronize()
    return {"launches": counts, "ms": result}


# ---------------------------------------------------------------------------
# Stage 2, the stage-3 step under pallas, the hand-over (phases 16-19)
# ---------------------------------------------------------------------------

def phase_stage2_golden(dev):
    """JAX's stage-2 steps and val step, and its stage-3 ``none`` / ``msk``
    steps and val step under mlp_impl: pallas, replayed on the card (fp32)
    under STEP_TOL (tests/fixtures/torch_port_stage2_golden.npz)."""
    from moco_flow_tpu_torch.train.checkpoint import _flatten
    from scripts.make_torch_port_phases_golden import load as load_phases
    from scripts.make_torch_port_stage2_golden import (
        N_STEPS, S3_RUNS, load, port_stage2_replay, port_stage3_run)
    from scripts.make_torch_port_train_golden import SCENE
    arrs = load()
    metrics, val, tr = port_stage2_replay(arrs, dev)
    torch.cuda.synchronize()
    got = [(f"metrics/{i}/{k}", v) for i, m in enumerate(metrics)
           for k, v in m.items()] + [(f"val/{k}", v) for k, v in val.items()]
    params = [(f"params{N_STEPS}/{k}", v)
              for k, v in _flatten(tr.params).items()]
    phases = load_phases()
    scene = make_synthetic_scene(None, **SCENE)
    for run in S3_RUNS:
        m, tr3 = port_stage3_run(arrs, phases, run, dev,
                                 scene if run == "msk" else None)
        got += [(f"s3/metrics/{run}/{k}", v) for k, v in m.items()]
        params += [(f"s3/params_{run}/{k}", v)
                   for k, v in _flatten(tr3.params).items()]
    got += [(f"s3/val/{k}", v) for k, v in tr3.val_step().items()]
    torch.cuda.synchronize()
    worst = perr = 0.0
    for key, v in got:
        want = float(arrs[key])
        rel = abs(v - want) / max(abs(want), 1e-30)
        worst = max(worst, rel)
        if not rel <= STEP_TOL["metrics_rtol"]:
            raise AssertionError(f"stage-2 fixture {key}: port {v} JAX "
                                 f"{want} (rel {rel:.2e})")
    for key, v in params:
        d = float(np.abs(v - arrs[key]).max())
        perr = max(perr, d)
        if not d <= STEP_TOL["params_atol"]:
            raise AssertionError(f"stage-2 fixture {key}: max|diff| {d:.3e}")
    log(f"[16 stage 2 vs JAX fixture] {N_STEPS} adam steps and the val step "
        f"of stage 2 (#3/#4), the pallas stage-3 none / msk steps and val "
        f"step (#8/#9): {len(got)} losses and metrics max rel diff "
        f"{worst:.2e} (tol {STEP_TOL['metrics_rtol']:g}), params max|diff| "
        f"{perr:.2e} (tol {STEP_TOL['params_atol']:g})")


STAGE2_STEPS, STAGE2_VAL_EVERY = 4, 2


def stage2_config() -> dict:
    """configs/people_snapshot/male-3-casual/init_nof.yaml:4-49 as a dict
    (the GPU machine has no yaml): N_sampled 100,000, the NoF 4x128 with 0
    xyz bands padded to 33 inputs, adam 5e-4, steplr; a few steps with the
    val step every STAGE2_VAL_EVERY of them (the YAML: 5000), no periodic
    checkpoints."""
    nof = {"type": "NoF", "D": 4, "W": 128, "in_channels_xyz": 33,
           "skips": [2], "extra_feat_type": "ind", "extra_feat_dim": 33,
           "use_quat": True}
    return {
        "save_dir": os.path.join(HERE, "build", "chip_smoke_stage2"),
        "exp_name": "init_nof",
        "dataloader": {"type": "nof", "root_dir": None, "interval": 1},
        "model": {
            "type": "nof", "pretrained_path": None, "pretrained_nof": None,
            "N_sampled": STAGE2_POINTS // 2,
            "nof_embedding_xyz": {"type": "Embedding", "in_channels": 3,
                                  "N_freqs": 0, "logscale": True},
            "nof_embedding_ind": {"type": "Embedding", "in_channels": 1,
                                  "N_freqs": 16, "logscale": True},
            "fw_NoF": nof, "bw_NoF": dict(nof)},
        "loss": {"type": "L1"},
        "optimizer": {"type": "adam", "lr": 0.0005, "weight_decay": 0},
        "scheduler": {"type": "steplr", "decay_step": [300000],
                      "decay_gamma": 0.5},
        "trainer": {"num_iters": STAGE2_STEPS,
                    "val_every_n_step": STAGE2_VAL_EVERY,
                    "save_every_n_step": 0, "log_freq": 1},
    }


STAGE2_GROUPS = {"nof_fwd (#3)": ("nof_fwd_kernel",),
                 "nof_bwd passes (#4)": ("nof_fwd_pass", "nof_walk_pass"),
                 "dW (#4)": ("matrix_mma", "colsum_kernel", "segsum_kernel",
                             "reduce_kernel")}


def phase_stage2_slice(card: str) -> dict:
    """Stage 2 through train(config, args, scene=...) at init_nof.yaml's
    model on a body of SMPL's 6890 vertices, fp32 (JAX's stage 2 ignores
    compute_dtype): #3/#4 launches, the val step through val_every_n_step,
    step time, the KNN's time, peak memory, a profile (idle share)."""
    from moco_flow_tpu_torch.geometry.smpl import synthetic_smpl_data
    from moco_flow_tpu_torch.ops import knn
    from moco_flow_tpu_torch.ops import nof_rays as nf
    from moco_flow_tpu_torch.train.__main__ import parse_args as train_args
    from moco_flow_tpu_torch.train.__main__ import train
    from moco_flow_tpu_torch.train.checkpoint import _flatten
    from moco_flow_tpu_torch.train.stage_nof import VAL_POINTS
    from scripts import torch_port_knn_ab as knn_ab
    smpl = synthetic_smpl_data(6890)
    scene = make_synthetic_scene(None, n_frames=8, size=64, smpl=smpl)
    cfg = stage2_config()
    shutil.rmtree(cfg["save_dir"], ignore_errors=True)      # from step 0
    init = init_params(torch.Generator().manual_seed(0),
                       build_statics(cfg["model"]), with_nerf=False,
                       with_nof=True, with_fw_nof=True)
    nf.nof_fwd.launches = nf.nof_bwd.launches = 0
    tr = train(cfg, train_args(["-c", "(dict)", "-n", "smoke", "--device",
                                DEVICE]), scene=scene)
    torch.cuda.synchronize()
    n_val = -(-STAGE2_STEPS // STAGE2_VAL_EVERY)
    launches = {"nof_fwd": nf.nof_fwd.launches,
                "nof_bwd": nf.nof_bwd.launches}
    want = {"nof_fwd": 2 * STAGE2_STEPS + 2 * n_val,
            "nof_bwd": 2 * STAGE2_STEPS}
    if launches != want:
        raise AssertionError(f"stage 2: launches {launches}, want {want} "
                             f"({STAGE2_STEPS} steps, {n_val} val steps)")
    losses = {k: float(v) for k, v in tr.losses.items()}
    val = tr.val_metrics
    moved = max(float(np.abs(v - _flatten(init)[k]).max())
                for k, v in _flatten(tr.params).items())
    if not all(np.isfinite(v) for v in (*losses.values(), *val.values())) \
            or not 0 < moved < 1 or tr.clock.step != STAGE2_STEPS:
        raise AssertionError(f"stage 2: losses {losses}, val {val}, params "
                             f"moved {moved}, step {tr.clock.step}")
    log(f"[17 stage-2 slice] {STAGE2_STEPS} steps of 2 x "
        f"{STAGE2_POINTS // 2} points on 8 frames of a {smpl.num_vertices}-"
        f"vertex body; val every {STAGE2_VAL_EVERY} steps ({n_val} val steps "
        f"of {VAL_POINTS} points); launches {launches}; last losses "
        f"{json.dumps(losses)}, last val {json.dumps(val)}, params moved "
        f"{moved:.2e}")
    # the KNN at the step's shape: time, and the same bits in other chunks,
    # with TF32 allowed by the caller and as the plain BLAS formula of
    # JAX (and of the port before stage 2: 8192-row chunks)
    d = tr.draw(0).to(tr.device)
    verts = tr._corr.verts[d.frame]
    query = torch.cat([d.cube, verts[d.pick] + 0.1 * d.noise])
    ref = knn.nearest_neighbor(verts, query)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        other = knn.nearest_neighbor(verts, query, chunk=4096)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32

    def blas():
        return knn_ab.chunked(knn_ab.blas, verts, query, 8192)

    plain = blas()
    for what, got in (("chunks of 4096 under TF32", other),
                      ("the BLAS formula", plain)):
        if not (torch.equal(ref[1], got[1]) and torch.equal(
                ref[0].view(torch.int32), got[0].view(torch.int32))):
            raise AssertionError(f"KNN: other bits in {what}")
    knn_ms = cuda_ms(lambda: knn.nearest_neighbor(verts, query), reps=5)
    blas_ms = cuda_ms(blas, reps=5)
    chunk = knn.chunk_rows(verts.shape[0])
    by_chunk = {c: cuda_ms(lambda: knn.nearest_neighbor(  # noqa: B023
        verts, query, chunk=c), reps=3) for c in (8192, 2048, 1024, 512)}
    log("[17 stage-2 slice] the KNN by chunk rows: " + ", ".join(
        f"{c} {t:.2f} ms" for c, t in by_chunk.items()) + f"; the BLAS "
        f"formula (ref_sq - 2 q@v, 8192-row chunks) {blas_ms:.2f} ms, the "
        f"same bits on {card}")
    torch.cuda.reset_peak_memory_stats()
    ms = _timed_steps(tr, warm=2, steps=5)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms_val = cuda_ms(tr.val_step, reps=3)
    log(f"[17 stage-2 slice] fp32 step {ms:.2f} ms ({STAGE2_POINTS} points "
        f"through both NoFs = {STAGE2_POINTS / ms * 1e3:.0f} points/s), "
        f"peak memory {peak:.2f} GiB; the KNN {knn_ms:.2f} ms a step "
        f"({query.shape[0]} x {verts.shape[0]} in launches of at most "
        f"{chunk} rows, the same bits in chunks of 4096 and with TF32 "
        f"allowed); val step "
        f"{ms_val:.2f} ms on {card}")
    _profile_step(tr, card, "[17 stage-2 slice] profiled fp32",
                  "stage2_step_profile.txt", "chip_smoke_stage2",
                  STAGE2_GROUPS)
    final = os.path.join(tr.job_dir, "ckpts", "final")
    tr.save_ckpt("final")
    return {"launches": launches, "step_ms": ms, "knn_ms": knn_ms,
            "knn_blas_ms": blas_ms,
            "peak_gib": peak, "val_ms": ms_val, "final": final + ".npz"}


# per-op launches a stage-3 step with both chains: #9 five times a sample
# set (bw; local fw; global fw, bw, fw) on the coarse and the new depths,
# plus nof_points (bw in msk, bw and fw in full); #8 the coarse and the fine
# pass
PALLAS_LAUNCHES = {"none": {"nerf_pallas": 2, "nof_pallas": 10},
                   "msk": {"nerf_pallas": 2, "nof_pallas": 11},
                   "full": {"nerf_pallas": 2, "nof_pallas": 12}}
PALLAS_RUNS = ((4999, 2), (9999, 2))       # full, none; none, msk


# The fitted field of phase 21 (sigma swings by ~170 over a fraction of a
# cell, through the top PE band) lifts fp32's own rounding above TOL, in
# sigma and in rgb, and bf16's above its gap. There a kernel's output is
# held against the exact function (the plain version in fp64) instead: each
# element within EXACT_FACTOR times the plain version's largest distance
# from it in the launch (sigma, rgb and warped points each their own), plus
# TOL; in bf16 the kernel's largest distance also within EXACT_FACTOR times
# the plain bf16 version's (the gap's counterpart). The factor comes from
# the readings that _hold_exact logs, of sound kernels and of the wrong
# kernels that the fp32 hold must reject (PERF.md §6); an element's own
# distance is no scale, as fp32 lands on the exact value by chance.
EXACT_FACTOR = 4.0


def _window_max(x: torch.Tensor, h: int) -> torch.Tensor:
    """The largest of x over the ``h`` elements on either side along the
    last axis (the samples of a ray), ``h`` None: over the whole axis."""
    if h is None:
        return x.amax(dim=-1, keepdim=True).expand_as(x)
    flat = x.reshape(-1, 1, x.shape[-1])
    return torch.nn.functional.max_pool1d(flat, 2 * h + 1, 1,
                                          h).reshape(x.shape)


def _hold_exact(name: str, parts: dict, atol: float, rtol: float,
                bf16: bool = False) -> float:
    """Hold of one launch against the exact function; ``parts``: {part:
    (kernel, plain version in the kernel's dtype, plain version in fp64)},
    the samples along the last axis. Each element within TOL of the plain
    version, or within EXACT_FACTOR x that part's largest distance of the
    plain version from the fp64 one, plus TOL, of the fp64 one; ``bf16``:
    also the part's largest distance from fp64 within EXACT_FACTOR x the
    plain version's. Logs, where TOL does not hold, the factor that the
    check would need with the plain version's distance taken at the
    element, over +-2 and +-8 samples, over the ray and over the launch,
    and the element that needs the most over the launch. Raises after every
    part is checked; returns the largest |kernel - plain|."""
    worst, faults = 0.0, []
    for part, (ko, po, p64) in parts.items():
        if not torch.isfinite(ko).all():
            faults.append(f"{part}: non-finite kernel output")
            continue
        err = (ko - po).abs()
        worst = max(worst, err.max().item())
        k64 = (ko.double() - p64).abs()
        p32 = (po.double() - p64).abs()
        if bf16:
            need = k64.max().item() / max(p32.max().item(), 1e-300)
            log(f"{name} {part}: from fp64: kernel {k64.max().item():.3e}, "
                f"plain {p32.max().item():.3e} (factor {need:.3f}; held: "
                f"{EXACT_FACTOR:g})")
            if need > EXACT_FACTOR:
                faults.append(f"{part}: the kernel's largest distance from "
                              f"fp64 is {need:.3f} x the plain version's")
        out = err > atol + rtol * po.abs()
        if not out.any():
            continue
        tol = atol + rtol * p64.abs()
        over = out & (k64 > tol)
        need = {}
        for h, what in ((0, "element"), (2, "+-2"), (8, "+-8"),
                        (None, "ray")):
            ref = _window_max(p32, h)
            need[what] = torch.where(over, (k64 - tol) / ref,
                                     torch.zeros_like(ref)).max().item()
        lead = (k64 - tol) * over
        need["launch"] = (lead.max() / p32.max()).item()
        i = int(lead.argmax())
        at = json.dumps({k: float(f"{v.flatten()[i].item():.6e}")
                         for k, v in (("exact", p64), ("kernel", ko),
                                      ("plain", po), ("plain from exact", p32),
                                      ("plain from exact +-8",
                                       _window_max(p32, 8)))})
        log(f"{name} {part}: {int(out.sum())} of {out.numel()} elements "
            f"outside TOL of the plain version (max |d| "
            f"{err.max().item():.3e}); from fp64: kernel "
            f"{k64.max().item():.3e}, plain {p32.max().item():.3e}; "
            f"factor needed with the plain distance over "
            f"{json.dumps({k: round(v, 3) for k, v in need.items()})} "
            f"(held: {EXACT_FACTOR:g} over the launch); the element that "
            f"needs the most: {at}")
        bad = over & (k64 > EXACT_FACTOR * p32.max() + tol)
        if bad.any():
            faults.append(f"{part}: {int(bad.sum())} elements outside both "
                          f"TOL and {EXACT_FACTOR:g} x the plain "
                          f"version's distance from the fp64 one + TOL")
    if faults:
        raise AssertionError(f"{name}: " + "; ".join(faults))
    return worst


def _pass_ref64(op, rays_o, rays_d, z_vals):
    """#7's plain version in fp64 (operands, products and sums)."""
    import dataclasses
    from moco_flow_tpu_torch.ops import render_pass as rpm

    def d64(x):
        return None if x is None else x.double()
    op64 = dataclasses.replace(
        op, dtype=torch.float64, nerf_ws=[d64(w) for w in op.nerf_ws],
        nof_ws=[d64(w) for w in op.nof_ws],
        partials=[d64(p) for p in op.partials], p_extra=d64(op.p_extra))
    mm = rpm.matmul
    rpm.matmul = lambda x, w, dt=None: x.double() @ w.double()
    try:
        return rpm._pass_ref(op64, rays_o.double(), rays_d.double(),
                             z_vals.double())
    finally:
        rpm.matmul = mm


def _hold_launches(err: dict, tag: str, where: str, spent: list,
                   exact: bool = False):
    """Wrap #7's, #3's, #8's and #9's launches so that the first launch of
    each shape is held against its plain version on its own arguments
    before it runs, in fp32 and bf16: within TOL, bf16 also within the
    plain version's bf16-vs-fp32 gap (a bf16 #7 / #8 / #9 launch that
    misses either is held against the fp64 plain version by
    ``_hold_exact``). ``exact``: #7, #8 and #9 against the fp64 plain
    version in both dtypes, and on the first full #7 and #8 shapes two
    wrong kernels that the fp32 hold must reject. These
    launches do not count; ``err`` keeps the largest |diff| a kernel,
    ``spent[0]`` the seconds the checks took. Returns the function that
    unwraps."""
    import dataclasses
    from moco_flow_tpu_torch.ops import fused_mlp as fm
    from moco_flow_tpu_torch.ops import nof_rays as nf
    from moco_flow_tpu_torch.ops import render_pass as rpm
    launch = {"pass": rpm._launch, "nof": nf._fwd_launch,
              "nerf_mlp": fm._nerf_launch, "nof_mlp": fm._nof_launch}
    seen = set()
    dtypes = (("fp32", None), ("bf16", torch.bfloat16))

    def hold(key, name, what, run, run64=None, parts=None, mutants=()):
        """``run(dt)`` -> (kernel output, plain output), once a key;
        ``run64()`` -> the plain version in fp64, ``parts(x)`` -> {part:
        x's part, samples last} for ``_hold_exact``; ``mutants``: (what,
        run(dt)) of wrong kernels that the exact fp32 hold must reject."""
        if key in seen:
            return
        seen.add(key)
        t = time.time()
        counters = _kernel_counters()
        saved = {k: f.launches for k, f in counters.items()}
        exact_here = exact and run64 is not None
        p64 = []

        def held(k, p):
            if not p64:
                p64.append(parts(run64()))
            return {n: (k[n], p[n], p64[0][n]) for n in p64[0]}
        try:
            got = {}
            for dname, dt in dtypes:
                ko, po = run(dt)
                torch.cuda.synchronize()
                atol, rtol = TOL[dname]
                label, bf16 = f"{tag} {what} {dname}", dt is not None
                if exact_here:
                    e = _hold_exact(label, held(parts(ko), parts(po)), atol,
                                    rtol, bf16=bf16)
                    for wrong, run_wrong in () if bf16 else mutants:
                        try:
                            _hold_exact(f"{label} ({wrong})",
                                        held(parts(run_wrong(dt)),
                                             parts(po)), atol, rtol)
                        except AssertionError as ex:
                            log(f"{tag} the exact hold rejects a kernel "
                                f"with {wrong}: {ex}")
                        else:
                            raise AssertionError(
                                f"{tag} {what}: the exact hold passed a "
                                f"kernel with {wrong}")
                else:
                    try:
                        e = check_close(label, ko, po, atol, rtol)
                        gap = (po - got["fp32"][0]).abs().max().item() \
                            if bf16 else e
                        if not e <= gap:
                            raise AssertionError(
                                f"{label}: kernel vs plain {e:.3e} exceeds "
                                f"the plain version's bf16-vs-fp32 gap "
                                f"{gap:.3e}")
                    except AssertionError as ex:
                        # bf16 is held against fp64 where its gap or TOL
                        # is no scale (PERF.md §6)
                        if not bf16 or run64 is None:
                            raise
                        log(f"{ex}; held against the fp64 plain version")
                        e = _hold_exact(label, held(parts(ko), parts(po)),
                                        atol, rtol, bf16=True)
                err[name] = max(err.get(name, 0.0), e)
                got[dname] = (po, e)
        finally:
            for k, f in counters.items():
                f.launches = saved[k]
        spent[0] += time.time() - t
        gap = (got["bf16"][0] - got["fp32"][0]).abs().max().item()
        log(f"{tag} kernel vs plain at {where} {what}: max|d| fp32 "
            f"{got['fp32'][1]:.3e}, bf16 {got['bf16'][1]:.3e} (the plain "
            f"version's bf16-vs-fp32 gap {gap:.3e})")

    def wrong_weights(ws, run):
        """(what, run(dt)) of the two wrong kernels on the flat NeRF
        weights ``ws``: the second trunk layer's weights off by 1e-3 of
        themselves; the rgb head's red and green swapped."""
        swap = [1, 0, 2]

        def changed(changes):
            out = list(ws)
            for i, f in changes.items():
                out[i] = f(out[i])
            return lambda dt: run(out, dt)
        return (("trunk layer 1's weights x (1 + 1e-3)",
                 changed({2: lambda w: w * (1 + 1e-3)})),
                ("the rgb head's red and green swapped",
                 changed({-2: lambda w: w[:, swap],
                          -1: lambda b: b[..., swap]})))

    def first_full(kind, key, sigma_only):
        """Whether this launch is the wrapper's first full one of ``kind``
        under ``exact`` (the one that runs the wrong kernels)."""
        if exact and not sigma_only and kind not in seen and key not in seen:
            seen.add(kind)
            return True
        return False

    def pass_parts(x):
        return {"sigma": x[0]} if x.shape[0] == 1 else {"sigma": x[0],
                                                        "rgb": x[1:]}

    def pass_launch(op, rays_o, rays_d, z_vals):
        def run(dt):
            o = dataclasses.replace(op, dtype=dt or torch.float32)
            ks, kr = launch["pass"](o, rays_o, rays_d, z_vals)
            ps, pr = rpm._pass_ref(o, rays_o, rays_d, z_vals)
            return ((ks[None], ps[None]) if kr is None else
                    (torch.cat([ks[None], kr]), torch.cat([ps[None], pr])))

        def run64():
            s64, r64 = _pass_ref64(op, rays_o, rays_d, z_vals)
            return s64[None] if r64 is None else torch.cat([s64[None], r64])

        def wrong(ws, dt):
            o = dataclasses.replace(op, nerf_ws=ws,
                                    dtype=dt or torch.float32)
            ks, kr = launch["pass"](o, rays_o, rays_d, z_vals)
            return torch.cat([ks[None], kr])
        n, s = z_vals.shape
        sigma_only, nof = op.nerf.sigma_only, op.nof is not None
        key = ("pass", n, s, sigma_only, nof, op.nerf.depth, op.nerf.width)
        wrongs = wrong_weights(op.nerf_ws, wrong) if first_full(
            "pass mutants", key, sigma_only) else ()
        hold(key, "render_pass",
             f"render_pass N={n} S={s} {'sigma-only' if sigma_only else 'full'}"
             f"{' nof' if nof else ''}", run, run64, pass_parts, wrongs)
        return launch["pass"](op, rays_o, rays_d, z_vals)

    def nof_launch(spec, dt, n_pe, xyz_t, parts, ws_bw, ws_fw,
                   entry="chain_fwd"):
        if entry == "nof_fwd":
            def run(d):
                ko, = launch["nof"](spec, d, n_pe, xyz_t, parts, ws_bw,
                                    None, entry="nof_fwd")
                return ko, nf._nof_fwd_ref(spec.nof, d, xyz_t, parts, ws_bw)
            hold(("nof",) + tuple(xyz_t.shape), "nof_fwd",
                 f"nof_fwd N={xyz_t.shape[1]} S={xyz_t.shape[2]}", run)
        return launch["nof"](spec, dt, n_pe, xyz_t, parts, ws_bw, ws_fw,
                             entry=entry)

    def mlp_parts(net):
        def f(x):
            if net == "nof":
                return {"warp": x.T}
            if x.shape[1] == 1:
                return {"sigma": x.T}
            return {"sigma": x[:, 3:].T, "rgb": x[:, :3].T}
        return f

    def mlp_launch(net):
        plain = fm._nerf_pallas_ref if net == "nerf" else fm._nof_pallas_ref

        def f(cfg, dt, *args):
            held = [a.detach().float() if torch.is_tensor(a) else a
                    for a in args]

            def run64():
                mm = fm.matmul
                fm.matmul = lambda x, w, dt=None: x.double() @ w.double()
                try:
                    return plain(cfg, None, *[
                        a.double() if torch.is_tensor(a) else a
                        for a in held]).double()
                finally:
                    fm.matmul = mm
            what = f"{net} rows={args[0].shape[0]}" + (
                f" {'sigma-only' if args[2] else 'full'}" if net == "nerf"
                else "")
            what += f" {cfg.depth}x{cfg.width} in {args[0].shape[1]}"
            key = (net, cfg, args[0].shape[0]) + (
                (args[2],) if net == "nerf" else ())
            wrongs = ()
            if net == "nerf" and first_full("nerf mutants", key, args[2]):
                wrongs = wrong_weights(held[3], lambda ws, d: launch[
                    "nerf_mlp"](cfg, d, *held[:3], ws))
            hold(key, f"{net}_pallas", what,
                 lambda d: (launch[f"{net}_mlp"](cfg, d, *held),
                            plain(cfg, d, *held)), run64, mlp_parts(net),
                 wrongs)
            return launch[f"{net}_mlp"](cfg, dt, *args)
        return f

    rpm._launch, nf._fwd_launch = pass_launch, nof_launch
    fm._nerf_launch, fm._nof_launch = mlp_launch("nerf"), mlp_launch("nof")

    def unwrap():
        rpm._launch, nf._fwd_launch = launch["pass"], launch["nof"]
        fm._nerf_launch, fm._nof_launch = (launch["nerf_mlp"],
                                           launch["nof_mlp"])
    return unwrap


def phase_pallas_steps(card: str) -> dict:
    """The stage-3 step under mlp_impl: pallas at c2f.yaml's widths through
    train(config, args): full -> none + freeze, none -> msk, bf16 and fp32,
    with #8 / #9 launches a step, and #8 / #9 against their plain versions
    on the arguments of the first launch of each shape in those steps;
    then msk / full / none step times beside the fused route's on the same
    trainer, and the val step."""
    import dataclasses
    from moco_flow_tpu_torch.data.dataset import get_dataset
    from moco_flow_tpu_torch.ops import fused_mlp as fm
    from moco_flow_tpu_torch.train.__main__ import parse_args as train_args
    from moco_flow_tpu_torch.train.__main__ import train
    from moco_flow_tpu_torch.train.stage_mocoflow import MoCoFlowTrainer
    counters = (fm.nerf_pallas, fm.nof_pallas)
    scene = body_scene()
    val_scene = body_scene(VAL_SIZE, 300.0 * VAL_SIZE / 256)
    orig = MoCoFlowTrainer.train_func
    record = []

    def counted(self):
        before = {f.__name__: f.launches for f in counters}
        out = orig(self)
        record.append((self.clock.step, self.phase(self.clock.step)[0],
                       {f.__name__: f.launches - before[f.__name__]
                        for f in counters}))
        return out

    counts = {"nerf_pallas": 0, "nof_pallas": 0}
    result, err = {}, {"nerf_pallas": 0.0, "nof_pallas": 0.0}
    spent = [0.0]
    MoCoFlowTrainer.train_func = counted
    unwrap = None
    try:
        for dtype in ("bfloat16", "float32"):
            # #8 / #9 against their plain versions at the steps' own shapes
            # and arguments (the first launch of each shape)
            unwrap = _hold_launches(err, f"[18 pallas steps] {dtype}",
                                    "a step's", spent)
            cfg = phases_config(dtype)
            cfg["save_dir"] += "_pallas"
            cfg["model"]["mlp_impl"] = "pallas"
            params = init_params(torch.Generator().manual_seed(0),
                                 build_statics(cfg["model"]), with_nof=True,
                                 with_fw_nof=True)
            for net in ("coarse_NeRF", "fine_NeRF"):
                params[net]["sigma"]["b"] += 1.0
            for start, n_steps in PALLAS_RUNS:
                cfg["trainer"]["num_iters"] = start + n_steps
                seed = os.path.join(cfg["save_dir"], f"seeded{start}")
                save_checkpoint(seed, {"params": params}, extra={
                    "clock": {"epoch": 1, "minibatch": 0, "step": start}})
                record.clear()
                for f in counters:
                    f.launches = 0
                tr = train(cfg, train_args(["-c", "(dict)", "-r",
                                            seed + ".npz", "-n",
                                            f"smoke{start}", "--device",
                                            DEVICE]), scene=scene)
                torch.cuda.synchronize()
                for step, mode, got in record:
                    if got != PALLAS_LAUNCHES[mode]:
                        raise AssertionError(
                            f"pallas step {step} ({mode}): launches {got}, "
                            f"want {PALLAS_LAUNCHES[mode]}")
                for f in counters:
                    counts[f.__name__] += f.launches
                losses = {k: float(v) for k, v in tr.losses.items()}
                if not all(np.isfinite(v) for v in losses.values()):
                    raise AssertionError(f"pallas {dtype} from {start}: "
                                         f"{losses}")
                log(f"[18 pallas steps] {dtype} from {start}: "
                    + ", ".join(f"{st} {m} #8/#9 {g['nerf_pallas']}/"
                                f"{g['nof_pallas']}" for st, m, g in record)
                    + f"; last losses {json.dumps(losses)}")
            unwrap()
            unwrap = None
            # step times on the msk run's trainer: each phase on the per-op
            # route, then on the fused route (the same weights and draws)
            times = {}
            pallas_rcfg = tr.rcfg_train
            for route in ("pallas", "fused"):
                tr.rcfg_train = dataclasses.replace(pallas_rcfg,
                                                    mlp_impl=route)
                for mode, step, deleted in (("msk", 10000, True),
                                            ("full", 4000, False),
                                            ("none", 6000, True)):
                    tr.clock.step = step
                    tr.nof_opt_deleted, tr.opt = deleted, None
                    torch.cuda.reset_peak_memory_stats()
                    times[(mode, route)] = (
                        _timed_steps(tr, warm=2, steps=3),
                        torch.cuda.max_memory_allocated() / 2 ** 30)
            tr.rcfg_train = pallas_rcfg
            tr.clock.step = 10000
            tr.val_dataset = get_dataset(dict(cfg["dataloader"],
                                              val_size=[VAL_SIZE, VAL_SIZE]),
                                         "val", scene=val_scene)
            for f in counters:
                f.launches = 0
            val = tr.val_func()
            n_val = {f.__name__: f.launches for f in counters}
            if n_val != {"nerf_pallas": 2, "nof_pallas": 2} or not all(
                    np.isfinite(v) for v in val.values()):
                raise AssertionError(f"pallas val: {val}, launches {n_val}")
            for f in counters:
                counts[f.__name__] += f.launches
            ms_val = cuda_ms(tr.val_step, reps=2)
            result[dtype] = {"times": times, "val_ms": ms_val}
            log(f"[18 pallas steps] {dtype}, ms a step (peak GiB), pallas "
                "vs fused: " + "; ".join(
                    f"{m} {times[(m, 'pallas')][0]:.1f} "
                    f"({times[(m, 'pallas')][1]:.2f}) vs "
                    f"{times[(m, 'fused')][0]:.1f} "
                    f"({times[(m, 'fused')][1]:.2f})"
                    for m in ("msk", "full", "none"))
                + f"; pallas val step {ms_val:.1f} ms ({VAL_SIZE}x"
                f"{VAL_SIZE}, #8/#9 {n_val['nerf_pallas']}/"
                f"{n_val['nof_pallas']}; {json.dumps(val)}) on {card}")
            del tr
            torch.cuda.empty_cache()
    finally:
        MoCoFlowTrainer.train_func = orig
        if unwrap is not None:
            unwrap()
    result["launches"] = counts
    result["err"] = err
    log(f"[18 pallas steps] holding #8 / #9 against their plain versions "
        f"took {spent[0]:.1f} s")
    return result


HANDOVER_STEPS = 3


def phase_handover(card: str, nerf_final: str, nof_final: str) -> dict:
    """Stage 3 at c2f.yaml's model built from phase 14's stage-1 final and
    phase 17's stage-2 final (pretrained_nerf / pretrained_nof): the moved
    tensors equal the finals' and the rest is the fresh draw; then
    HANDOVER_STEPS fused steps from step 0 (full, the density frozen)
    through train(config, args), after which the frozen trunk and sigma
    head still hold stage 1's weights while the NoFs and the rgb branch
    (final, rgb) have moved, and every step's coarse and fine samples hold
    some with alpha >= 0.01 (the per-op route's quadrature of the step)."""
    from moco_flow_tpu_torch.ops import nof_rays as nf
    from moco_flow_tpu_torch.ops import nerf_rays as nr
    from moco_flow_tpu_torch.ops import nof_chain as nc
    from moco_flow_tpu_torch.train.__main__ import parse_args as train_args
    from moco_flow_tpu_torch.train.__main__ import train
    import dataclasses
    from moco_flow_tpu_torch.render import volume
    from moco_flow_tpu_torch.train import stage_mocoflow as sm
    from moco_flow_tpu_torch.train.checkpoint import _flatten, load_checkpoint
    from moco_flow_tpu_torch.train.stage_mocoflow import MoCoFlowTrainer
    cfg = phases_config("float32")
    cfg["save_dir"] = os.path.join(HERE, "build", "chip_smoke_handover")
    shutil.rmtree(cfg["save_dir"], ignore_errors=True)
    cfg["model"].update(pretrained_nerf=nerf_final, pretrained_nof=nof_final)
    cfg["trainer"]["num_iters"] = HANDOVER_STEPS
    s1 = _flatten(load_checkpoint(nerf_final)[0]["params"]["fine_NeRF"])
    s2 = _flatten(load_checkpoint(nof_final)[0]["params"])
    fresh = _flatten(init_params(torch.Generator().manual_seed(0),
                                 build_statics(cfg["model"]), with_nof=True,
                                 with_fw_nof=True))
    tr = MoCoFlowTrainer(cfg, device=DEVICE)
    tr.build_model(cfg["model"])
    moved = 0
    for k, v in _flatten(tr.params).items():
        net, rest = k.split("/", 1)
        from_s1 = rest.split("/")[0] in ("trunk", "sigma", "final")
        want = (s2[k] if net.endswith("NoF") else
                s1[rest] if from_s1 else fresh[k])
        if not np.array_equal(v, want):
            raise AssertionError(f"hand-over {k}: not the expected tensor")
        moved += net.endswith("NoF") or from_s1
    del tr
    scene = body_scene()
    counters = (nr.nerf_fwd, nr.nerf_bwd, nc.chain_fwd, nc.chain_bwd,
                nf.nof_fwd, nf.nof_bwd)
    # each step's render also runs, without gradients, on the per-op route,
    # whose quadrature gives the alphas that the fused kernels keep inside:
    # the density that the rgb branch trains through (these launches do not
    # count)
    alphas = {"coarse": [], "fine": []}
    render, composite = sm.render_rays, volume.composite

    def probed(params, statics, anneal, rays, bg, rcfg, draws=None):
        out = render(params, statics, anneal, rays, bg, rcfg, draws=draws)
        saved = [f.launches for f in counters]
        got = []

        def spy(*a, **k):
            got.append(composite(*a, **k))
            return got[-1]

        volume.composite = spy
        try:
            with torch.no_grad():
                render(params, statics, anneal, rays, bg, dataclasses.replace(
                    rcfg, mlp_impl="pallas"), draws=draws)
        finally:
            volume.composite = composite
        for f, n in zip(counters, saved):
            f.launches = n
        for name, (a, _) in zip(("coarse", "fine"), got):
            alphas[name].append(float((a >= 0.01).float().mean()))
        return out

    for f in counters:
        f.launches = 0
    sm.render_rays = probed
    try:
        tr = train(cfg, train_args(["-c", "(dict)", "-n", "smoke",
                                    "--device", DEVICE]), scene=scene)
    finally:
        sm.render_rays = render
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in counters}
    want = {k: 2 * HANDOVER_STEPS for k in launches}
    if launches != want:
        raise AssertionError(f"hand-over steps: launches {launches}, want "
                             f"{want}")
    losses = {k: float(v) for k, v in tr.losses.items()}
    now = _flatten(tr.params)
    for net in ("coarse_NeRF", "fine_NeRF"):
        for k, v in s1.items():
            branch = k.split("/")[0]
            if branch in ("trunk", "sigma") and not np.array_equal(
                    now[f"{net}/{k}"], v):
                raise AssertionError(f"{net}/{k} moved while frozen")
    # the NoFs train on their L1 supervision, the rgb branch (final, and
    # extra / rgb from the fresh draw) through the transferred density
    nof_moved = max(float(np.abs(now[k] - v).max()) for k, v in s2.items()
                    if k in now)
    final_moved = max(float(np.abs(now[f"{net}/{k}"] - v).max())
                      for net in ("coarse_NeRF", "fine_NeRF")
                      for k, v in s1.items() if k.startswith("final/"))
    rgb_moved = max(float(np.abs(v - fresh[k]).max())
                    for k, v in now.items() if "NeRF/rgb/" in k)
    dense = {k: min(v) for k, v in alphas.items()}
    if not all(np.isfinite(v) for v in losses.values()) or \
            not nof_moved > 0 or not final_moved > 0 or \
            not rgb_moved > 0 or len(alphas["fine"]) != HANDOVER_STEPS \
            or not min(dense.values()) > 0:
        raise AssertionError(f"hand-over steps: {losses}, NoFs moved "
                             f"{nof_moved}, final moved {final_moved}, rgb "
                             f"moved {rgb_moved}, shares of alpha >= 0.01 "
                             f"{alphas}")
    log(f"[19 hand-over] stage 3 at c2f's widths from the stage-1 final "
        f"({os.path.relpath(nerf_final, HERE)}) and the stage-2 final "
        f"({os.path.relpath(nof_final, HERE)}): {moved} tensors moved "
        f"exactly, the rest the fresh draw; {HANDOVER_STEPS} fused fp32 "
        f"full steps from step 0, launches {launches}, trunk and sigma "
        f"still stage 1's (frozen), NoFs moved {nof_moved:.2e}, final "
        f"moved {final_moved:.2e}, rgb moved {rgb_moved:.2e}; samples with "
        f"alpha >= 0.01 a step: coarse "
        f"{', '.join(f'{a:.4f}' for a in alphas['coarse'])}, fine "
        f"{', '.join(f'{a:.4f}' for a in alphas['fine'])}; last losses "
        f"{json.dumps(losses)} on {card}")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# Phase 20: the published runs through the CLIs
# ---------------------------------------------------------------------------

CONFIGS = os.path.join(HERE, "configs", "people_snapshot", "male-3-casual")
# each stage's YAML and the steps of its first call (the second takes one
# more)
CLI_STAGES = (("init_nerf", 1), ("init_nof", 2), ("c2f", 1))
CLI_SIZE = 1080          # the YAMLs' dataloader.size
CLI_RENDER = 135         # the synthetic frames are drawn at 135^2, upsampled
CLI_VAL_EVERY = 2
CLI_RESO = 128
CLI_GRID = 256
CLI_DIR = os.path.join(HERE, "build", "chip_smoke_cli")


def _kernel_counters() -> dict:
    from moco_flow_tpu_torch.ops import fused_mlp as fm
    from moco_flow_tpu_torch.ops import nerf_rays as nr
    from moco_flow_tpu_torch.ops import nof_chain as nc
    from moco_flow_tpu_torch.ops import nof_rays as nf
    return {f.__name__: f for f in (
        render_pass, nr.nerf_fwd, nr.nerf_bwd, nf.nof_fwd, nf.nof_bwd,
        nc.chain_fwd, nc.chain_bwd, fm.nerf_pallas, fm.nof_pallas)}


def _count_launches(fn) -> tuple:
    """(fn's result, the launches of every kernel during it)."""
    counters = _kernel_counters()
    saved = {k: f.launches for k, f in counters.items()}
    for f in counters.values():
        f.launches = 0
    try:
        out = fn()
        torch.cuda.synchronize()
        got = {k: f.launches for k, f in counters.items()}
    finally:
        for k, f in counters.items():
            f.launches = saved[k]
    return out, got


def _write_cli_scene(root: str, smpl) -> None:
    """The synthetic 8-frame scene as files at the YAMLs' 1080^2: frames
    drawn at CLI_RENDER^2 (the splat renderer's memory grows with the
    pixels times the vertices), upsampled with the port's bilinear resize,
    written with its PNG writer, and the JSON meta's intrinsics scaled to
    match."""
    from moco_flow_tpu_torch.utils.image import resize_bilinear, write_png
    scene = make_synthetic_scene(None, n_frames=8, size=CLI_RENDER,
                                 focal=300.0 * CLI_RENDER / 256, smpl=smpl)
    k = CLI_SIZE / CLI_RENDER
    meta = dict(scene.meta, image_height=CLI_SIZE, image_width=CLI_SIZE,
                camera_focal=float(scene.meta["camera_focal"]) * k,
                camera_c=[float(c) * k for c in scene.meta["camera_c"]])
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for fr, im in zip(meta["frames"], scene.images):
        write_png(os.path.join(root, "images", fr["file_path"]),
                  resize_bilinear(im, (CLI_SIZE, CLI_SIZE)))

    def plain(o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (np.floating, np.integer)):
            return o.item()
        raise TypeError(type(o))
    for name in ("train.json", "val.json"):
        with open(os.path.join(root, name), "w") as f:
            json.dump(meta, f, default=plain)


def _seeded_stage1(cfg: dict, path: str) -> float:
    """Stage 1's first checkpoint: the seeded init with both sigma heads'
    biases moved by one offset, so that the canonical density field
    straddles visualize_mesh's threshold of 10 (a fresh NeRF's field is far
    below it, and its mesh would be empty). The field stays as flat as a
    fresh NeRF's (a span of thousandths): sharpening the heads to a spread
    of units scales them ~4000-fold, and the bf16 holds of #7 then see the
    rounding of a ~100-unit dot product that the bias cancels. Returns the
    offset."""
    from moco_flow_tpu_torch.train import vis
    from moco_flow_tpu_torch.train.stage_nerf import NeRFTrainer
    tr = NeRFTrainer(cfg, device=DEVICE, seed=0)
    tr.build_model(cfg["model"])
    tr.num_frames = 8
    grid = vis.sigma_grid(tr, -1, n_grid=64, clip_negative=False)
    shift = 10.0 - float(np.median(grid))
    for net in ("coarse_NeRF", "fine_NeRF"):
        tr.params[net]["sigma"]["b"] += shift
    save_checkpoint(path, {"params": tr.params}, extra={
        "clock": {"epoch": 1, "minibatch": 0, "step": 0}})
    return shift


def _read_records(job: str) -> list:
    with open(os.path.join(job, "log", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _check_run(stage: str, tr, cfg: dict, steps: int, first: bool) -> dict:
    """The layout, config.yaml, the code snapshot, the records (a first run
    from step 0 has train/ and valid/ ones) and the visualisations of one
    CLI run; returns counts of what it wrote."""
    from moco_flow_tpu_torch.utils.config import load_yaml
    from moco_flow_tpu_torch.utils.image import read_png
    job = tr.job_dir
    for rel in ("config.yaml", "ckpts/final.npz", "log/log.txt",
                "log/metrics.jsonl", "code/moco_flow_tpu_torch/__init__.py",
                "code/moco_flow_tpu_torch/ops/csrc/render_pass.cu"):
        if not os.path.exists(os.path.join(job, rel)):
            raise AssertionError(f"{stage}: {rel} missing under {job}")
    if load_yaml(os.path.join(job, "config.yaml")) != cfg:
        raise AssertionError(f"{stage}: config.yaml does not read back")
    recs = _read_records(job)
    train = [r for r in recs if any(k.startswith("train/") for k in r)]
    valid = [r for r in recs if any(k.startswith("valid/") for k in r)]
    vals = [v for r in train + valid for k, v in r.items()
            if k.startswith(("train/", "valid/"))]
    if tr.clock.step != steps or (first and not (train and valid)) or \
            not all(np.isfinite(vals)):
        raise AssertionError(f"{stage}: step {tr.clock.step}, "
                             f"{len(train)} train and {len(valid)} valid "
                             "records, or a non-finite value")
    out = {"train_records": len(train), "valid_records": len(valid)}
    if stage == "init_nof":
        return out
    log_dir = os.path.join(job, "log")
    frames = [os.path.join(d, f) for d, _, fs in os.walk(log_dir)
              if os.path.basename(d).startswith("images_epoch_")
              for f in fs if f.endswith(".png")]
    orbits = [d for d, _, _ in os.walk(log_dir)
              if d.endswith("canonical_images")]
    meshes = [os.path.join(d, f) for d, _, fs in os.walk(log_dir)
              if os.path.basename(d).startswith("mesh_epoch_")
              for f in fs if f.endswith(".obj")]
    if not frames or not orbits or not meshes or any(
            len(os.listdir(d)) != 90 for d in orbits):
        raise AssertionError(f"{stage}: frames {frames}, orbits {orbits}, "
                             f"meshes {meshes}")
    h, w = cfg["dataloader"]["val_size"]
    strip = read_png(frames[0])
    if strip.shape[0] != h or strip.shape[1] % w:
        raise AssertionError(f"{stage}: frame strip {strip.shape}")
    out.update(frames=len(frames), orbits=len(orbits), meshes=len(meshes))
    return out


def _time_view(tr, card: str, what: str) -> float:
    """One spherical view of the canonical space through train/vis.py, ms
    (CUDA events, after a warm view)."""
    from moco_flow_tpu_torch.train import vis
    ds = tr.val_dataset

    def view():
        return vis._render_view(tr, ds, 0, c2w4=ds.spherical_poses[7],
                                white_bkgd=True, use_nof=False)
    ms = cuda_ms(view, reps=2)
    n = int(ds.frame_mask(0, c2w4=ds.spherical_poses[7]).sum())
    log(f"[20 cli] one spherical view of {what} at {ds.size[0]}x"
        f"{ds.size[1]} (fp32, {n} rays in the hull): {ms:.1f} ms on {card}")
    return ms


def phase_cli(card: str) -> dict:
    """The three published YAMLs through the CLIs, then every test.py mode
    on the stage-3 final, on the fused route and under mlp_impl: pallas."""
    from moco_flow_tpu_torch.geometry.smpl import (save_smpl_data,
                                                   synthetic_smpl_data)
    from moco_flow_tpu_torch.ops import mcubes
    from moco_flow_tpu_torch.test import main as test_main
    from moco_flow_tpu_torch.train import vis
    from moco_flow_tpu_torch.train.__main__ import main as train_main
    from moco_flow_tpu_torch.utils.config import dump_config, load_yaml
    t_phase = time.time()
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    scene_dir = os.path.join(CLI_DIR, "scene")
    smpl = synthetic_smpl_data(6890)
    _write_cli_scene(scene_dir, smpl)
    os.environ["SMPL_MODEL_DIR"] = os.path.dirname(
        save_smpl_data(smpl, os.path.join(CLI_DIR, "smpl")))
    log(f"[20 cli] scene: 8 RGBA frames of {CLI_SIZE}x{CLI_SIZE} PNG, a "
        f"6890-vertex SMPL pickle; {time.time() - t_phase:.1f} s")
    launches = {k: 0 for k in _kernel_counters()}
    err, spent = {}, [0.0]
    unwrap = _hold_launches(err, "[20 cli]", "a view's", spent)
    finals, result, trainers = {}, {"walls": {}}, {}
    try:
        for stage, steps in CLI_STAGES:
            cfg = load_yaml(os.path.join(CONFIGS, f"{stage}.yaml"))
            cfg["dataloader"]["root_dir"] = scene_dir
            cfg["save_dir"] = os.path.join(CLI_DIR, "log")
            tcfg = cfg["trainer"]
            tcfg.update(num_iters=steps, val_every_n_step=CLI_VAL_EVERY)
            if "vis_mesh_video_every_n_val" in tcfg:
                tcfg["vis_mesh_video_every_n_val"] = 1
            if stage == "c2f":
                cfg["model"].update(pretrained_nerf=finals["init_nerf"],
                                    pretrained_nof=finals["init_nof"])
            for run, n in (("run1", steps), ("run2", steps + 1)):
                tcfg["num_iters"] = n
                path = os.path.join(CLI_DIR, f"{stage}_{run}.yaml")
                dump_config(cfg, path)
                argv = ["-c", path, "-n", run, "-s", "0", "--device", DEVICE,
                        "--num_devices", "1"]
                if stage == "init_nerf" and run == "run1":
                    seed = os.path.join(CLI_DIR, "seed", "ckpts", "seeded")
                    shift = _seeded_stage1(cfg, seed)
                    log(f"[20 cli] init_nerf starts from the seeded init, "
                        f"sigma biases moved by {shift:+.3f}")
                    argv += ["-r", seed + ".npz"]
                t = time.time()
                tr, got = _count_launches(lambda: train_main(argv))
                wall = time.time() - t
                for k, v in got.items():
                    launches[k] += v
                info = _check_run(stage, tr, cfg, n, run == "run1")
                if run == "run2":
                    with open(os.path.join(tr.job_dir, "log",
                                           "log.txt")) as f:
                        text = f.read()
                    first = os.path.join(CLI_DIR, "log", cfg["exp_name"],
                                         "run1", "ckpts", "final")
                    if f"loaded checkpoint {first}" not in text:
                        raise AssertionError(f"{stage} run2: no resume line "
                                             f"for {first} in log.txt")
                    finals[stage] = os.path.join(tr.job_dir, "ckpts",
                                                 "final.npz")
                    trainers[stage] = tr
                result["walls"][f"{stage} {run}"] = wall
                ran = {k: v for k, v in got.items() if v}
                losses = {k: float(v) for k, v in tr.losses.items()}
                log(f"[20 cli] python -m moco_flow_tpu_torch.train -c "
                    f"{os.path.relpath(path, HERE)} {' '.join(argv[2:])}: "
                    f"{wall:.1f} s, step {tr.clock.step}, {json.dumps(info)}"
                    f", launches {json.dumps(ran)}; last losses "
                    f"{json.dumps(losses)} on {card}")
            if stage != "init_nof":
                result[f"view_ms {stage}"] = _time_view(
                    tr, card, f"the {stage} final")
        # the sigma grids of the stage-3 final: canonical and frame 0 (the
        # warp through #3), their thresholds, and marching cubes
        tr = trainers["c2f"]
        grids, thr = {}, {}
        for frame in (-1, 0):
            t = time.time()
            g, got = _count_launches(lambda: vis.sigma_grid(tr, frame,
                                                            n_grid=CLI_GRID))
            ms = (time.time() - t) * 1e3
            for k, v in got.items():
                launches[k] += v
            grids[frame] = g
            thr[frame] = float(np.quantile(g, 0.75))
            if not g.min() < thr[frame] < g.max():
                raise AssertionError(f"sigma grid {frame}: flat field")
            result[f"grid_ms {frame}"] = ms
            log(f"[20 cli] sigma_grid({frame}) at {CLI_GRID}^3: {ms:.1f} ms "
                f"(host clock, fp32 nerf_sigma, #3 launches "
                f"{got['nof_fwd']}); sigma in [{g.min():.3f}, {g.max():.3f}],"
                f" threshold (0.75 quantile) {thr[frame]:.4f} on {card}")
        t = time.time()
        verts, tris = mcubes.marching_cubes(grids[-1], thr[-1])
        result["mcubes_ms"] = (time.time() - t) * 1e3
        log(f"[20 cli] marching_cubes at {CLI_GRID}^3: "
            f"{result['mcubes_ms']:.1f} ms (host clock), {len(verts)} "
            f"vertices, {len(tris)} triangles, on the host of {card}")
        del trainers, tr
        torch.cuda.empty_cache()
        # every test.py mode on the stage-3 final, fused then pallas
        c2f_cfg = load_yaml(os.path.join(CLI_DIR, "c2f_run2.yaml"))
        for impl in ("xla", "pallas"):
            cfg = dict(c2f_cfg, model=dict(c2f_cfg["model"], mlp_impl=impl))
            path = os.path.join(CLI_DIR, f"test_{impl}.yaml")
            dump_config(cfg, path)
            out = os.path.join(CLI_DIR, f"test_{impl}")
            common = ["-c", path, "--render_gt", "--reso", str(CLI_RESO),
                      "-s", "0", "--device", DEVICE, "--out_dir", out,
                      "--extract_mesh", "--N_grid", str(CLI_GRID),
                      "--num_devices", "1"]
            calls = (common + ["--render_training_poses",
                               "--render_spherical_poses",
                               "--render_bullet_time", "--mesh_frame", "-1",
                               "--sigma_threshold", str(thr[-1]),
                               "--render_frame", "0", "--eval_metrics"],
                     common + ["--mesh_frame", "0", "--sigma_threshold",
                               str(thr[0]), "--render_frame", "-1"])
            for argv in calls:
                t = time.time()
                tt, got = _count_launches(lambda: test_main(argv))
                wall = time.time() - t
                for k, v in got.items():
                    launches[k] += v
                mesh = tt.mesh_path
                v = np.array([[float(x) for x in line.split()[1:]]
                              for line in open(mesh) if line.startswith("v ")])
                if not len(v) or not np.isfinite(v).all():
                    raise AssertionError(f"{impl}: mesh {mesh} empty or "
                                         "non-finite")
                if "--eval_metrics" in argv:
                    if not np.isfinite(tt.metrics["psnr"]):
                        raise AssertionError(f"{impl}: metrics {tt.metrics}")
                    result.setdefault("metrics", {})[impl] = tt.metrics
                result["walls"][f"test {impl} {len(result['walls'])}"] = wall
                log(f"[20 cli] python -m moco_flow_tpu_torch.test "
                    f"{' '.join(argv[2:])} ({impl}): {wall:.1f} s, mesh "
                    f"{len(v)} vertices, launches "
                    f"{json.dumps({k: n for k, n in got.items() if n})}"
                    + (f", metrics {json.dumps(tt.metrics)}"
                       if "--eval_metrics" in argv else "") + f" on {card}")
                del tt
            counts = {}
            for d, _, fs in os.walk(out):
                n = len([f for f in fs if f.endswith((".png", ".obj"))])
                if n:
                    counts[os.path.relpath(d, out)] = n
            want = {"videos": 8, "spherical": 90, "bullet": 120,
                    "mesh": 2, "images": 2}
            for prefix, n in want.items():
                if sum(c for d, c in counts.items()
                       if d.startswith(prefix)) != n:
                    raise AssertionError(f"{impl}: files {counts}")
            log(f"[20 cli] test modes ({impl}) wrote {json.dumps(counts)}")
    finally:
        unwrap()
    result["err"] = err
    result["launches"] = launches
    log(f"[20 cli] launches on the CLI paths {json.dumps(launches)}; phase "
        f"{time.time() - t_phase:.1f} s, of which {spent[0]:.1f} s held the "
        f"kernels against their plain versions, on {card}")
    return result


# ---------------------------------------------------------------------------
# Phase 21: occupancy-grid skipping and the packed stream of views
# ---------------------------------------------------------------------------

OCC_RES, OCC_SUPERSAMPLE, OCC_THRESHOLD = 192, 2, 5.0   # bench.py's grid
OCC_VIEWS = 16
OCC_PALLAS_VIEWS = 4     # of the orbit, packed vs a view at a time on #8/#9
OCC_SCALE = 4            # frame_rays_scaled: 1024^2 from the 256^2 camera
OCC_CLI_RES = 64
# scripts/bench_occupancy.py's distill_sharp_field target and schedule
FIT = {"steps": 400, "lr": 3e-3, "sigma_in": 150.0, "sigma_out": -20.0,
       "shell": 0.15}


def occupancy_config() -> dict:
    """Phase 5's stage-3 model as c2f.yaml runs it (fp32, 'xla': the fused
    route), with occupancy skipping at bench.py's grid."""
    cfg = slice_config()
    cfg["model"].update(compute_dtype="float32", mlp_impl="xla",
                        occ_res=OCC_RES, occ_supersample=OCC_SUPERSAMPLE,
                        occ_threshold=OCC_THRESHOLD)
    return cfg


def fit_body_field(tr, verts: torch.Tensor, steps: int, lr: float,
                   sigma_in: float, sigma_out: float, shell: float) -> float:
    """Scaffolding, not a feature of the package: the fine NeRF regressed
    to a body-shaped field, then copied into the coarse one
    (scripts/bench_occupancy.py's distill_sharp_field in plain torch): raw
    sigma ``sigma_in`` within ``shell`` of the body's vertices and
    ``sigma_out`` elsewhere, rgb the position colormap; each step's 16384
    points a third uniform in the cube, a third around the vertices
    (sigma 0.3), a third in the shell; Adam; c2f annealing off, so the
    renders evaluate the function that was fitted. A fresh NeRF's field is
    near flat and has no empty space to skip. Returns the last loss."""
    import copy
    from moco_flow_tpu_torch.nn.nerf import nerf_apply
    from moco_flow_tpu_torch.train.checkpoint import _flatten
    tr.c2f = False
    statics, dev = tr.statics, tr.device
    cfg = statics.fine
    net = tr.params["fine_NeRF"]
    leaves = list(_flatten(net, leaf=lambda t: t).values())
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=lr)
    lo, hi = verts.min(0).values, verts.max(0).values
    ind = embed_padded(torch.zeros((1, 1), device=dev), statics.nerf_ind,
                       cfg.extra_feat_dim)
    gen = torch.Generator(device=dev).manual_seed(0)

    def pick(n):
        return verts[torch.randint(0, verts.shape[0], (n,), device=dev,
                                   generator=gen)]
    for _ in range(steps):
        x = torch.cat([
            torch.rand((5462, 3), device=dev, generator=gen) * 3.0 - 1.5,
            torch.randn((5462, 3), device=dev, generator=gen) * 0.3
            + pick(5462),
            torch.randn((5460, 3), device=dev, generator=gen) * (shell / 3)
            + pick(5460)])
        out = nerf_apply(net, embed_padded(x, statics.nerf_xyz,
                                           cfg.in_channels_xyz),
                         ind.expand(x.shape[0], -1), cfg)
        near = torch.cdist(x, verts).min(dim=1).values < shell
        t_sig = torch.where(near, sigma_in, sigma_out)
        t_rgb = ((x - lo) / (hi - lo + 1e-6)).clamp(0.0, 1.0)
        loss = (((out[:, 3] - t_sig) / 50.0) ** 2).mean() \
            + ((out[:, :3] - t_rgb) ** 2).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    for t in leaves:
        t.requires_grad_(False)
    tr.params["coarse_NeRF"] = copy.deepcopy(net)
    return float(loss.detach())


def _event_ms(fn) -> tuple:
    """(fn's result, its ms between two CUDA events)."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    return out, e0.elapsed_time(e1)


def _same_bits(tag: str, got: list, want: list) -> None:
    for i, (a, b) in enumerate(zip(got, want)):
        if set(a) != set(b):
            raise AssertionError(f"{tag}: view {i} keys {set(a)} {set(b)}")
        for k in a:
            if not torch.equal(a[k], b[k]):
                d = (a[k] - b[k]).abs().max().item()
                raise AssertionError(f"{tag}: view {i} {k} differs, max "
                                     f"|d| {d:.3e}")
    if len(got) != len(want):
        raise AssertionError(f"{tag}: {len(got)} views, {len(want)} wanted")


def _psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(-10.0 * torch.log10(((a - b) ** 2).mean()))


def phase_occupancy(card: str) -> dict:
    """Occupancy skipping on a body-shaped field at c2f.yaml's widths: the
    grids' build times (canonical, frame 0 direct and warp), a view's
    tighten, a 256^2 frame exact and with occupancy (and with occ_tighten 0
    its kept rays equal to the exact render's bits), a 16-view orbit packed
    against a view at a time (equal bits), a 1024^2 frame_rays_scaled view;
    4 of the orbit's views packed against a view at a time under
    mlp_impl: pallas (equal bits); #3/#7/#8/#9 held against their plain
    versions on each first shape."""
    import dataclasses
    from moco_flow_tpu_torch.render.occupancy import build_occupancy_grid
    from moco_flow_tpu_torch.train.stage_mocoflow import MoCoFlowTrainer
    t_phase = time.time()
    scene = body_scene()
    cfg = occupancy_config()
    tr = MoCoFlowTrainer(cfg, device=DEVICE, seed=0, scene=scene)
    tr.build_model(cfg["model"])
    tr.prepare_dataloader(cfg["dataloader"])
    ds = tr.val_dataset
    verts = torch.as_tensor(ds._verts[0], dtype=torch.float32,
                            device=DEVICE)
    t = time.time()
    loss = fit_body_field(tr, verts, **FIT)
    torch.cuda.synchronize()
    log(f"[21 occupancy] body field: c2f widths, fine NeRF fitted to sigma "
        f"{FIT['sigma_in']:g} within {FIT['shell']} of the {len(verts)} "
        f"vertices, {FIT['sigma_out']:g} elsewhere, {FIT['steps']} Adam "
        f"steps at lr {FIT['lr']:g}: loss {loss:.4f}, "
        f"{time.time() - t:.1f} s (scaffolding)")
    out = {}
    rcfg, anneal = tr.rcfg_test, tr.anneal()
    rays = ds.frame_rays(0)
    n, side = rays.shape[0], ds.size[0]
    white = torch.ones((n, 3), device=DEVICE)
    extent = tr._occ_auto_extent(0)
    occ_kw = dict(resolution=OCC_RES, supersample=OCC_SUPERSAMPLE,
                  threshold=OCC_THRESHOLD, extent=extent)
    err, spent = {}, [0.0]
    unwrap = _hold_launches(err, "[21 occupancy]", "the occupancy path's",
                            spent, exact=True)

    def body():
        # the grids: warm at 16^3 (every launch shape), then timed
        small = dict(occ_kw, resolution=16)
        cano16 = build_occupancy_grid(tr, -1, **small)
        build_occupancy_grid(tr, 0, **small)
        build_occupancy_grid(tr, 0, builder="warp", cano_grid=cano16,
                             **small)
        cano, ms_c = _event_ms(lambda: build_occupancy_grid(tr, -1,
                                                            **occ_kw))
        direct, ms_d = _event_ms(lambda: build_occupancy_grid(tr, 0,
                                                              **occ_kw))
        warp, ms_w = _event_ms(lambda: build_occupancy_grid(
            tr, 0, builder="warp", cano_grid=cano, **occ_kw))
        fr = {k: g.occupancy_fraction for k, g in
              (("canonical", cano), ("direct", direct), ("warp", warp))}
        if not all(0 < f < 1 for f in fr.values()):
            raise AssertionError(f"occupied fractions {fr}")
        # the pullback's lattice-empirical gap: direct cells it misses
        gap = int((direct.occ & ~warp.occ).sum())
        out.update(grid_ms={"canonical": ms_c, "direct": ms_d,
                            "warp": ms_w}, occupied=fr, warp_misses=gap)
        log(f"[21 occupancy] grids at {OCC_RES}^3 (supersample "
            f"{OCC_SUPERSAMPLE}, extent {extent:.4f}): canonical "
            f"{ms_c:.1f} ms, frame 0 direct {ms_d:.1f} ms, frame 0 warp "
            f"{ms_w:.1f} ms (CUDA events); occupied {json.dumps(fr)}; "
            f"{gap} cells occupied in the direct grid but not in the warp "
            f"grid, on {card}")
        tr._occ_grids.update({-1: cano, 0: direct})
        # a view's tighten
        tr.tighten_rays(rays, 0)
        _, ms_t = _event_ms(lambda: tr.tighten_rays(rays, 0))
        st = tr._occ_stats
        out.update(tighten_ms=ms_t, empty_frac=float(st["empty_frac"]),
                   range_ratio=float(st["range_ratio"]),
                   kept=int(st["kept_count"]))
        log(f"[21 occupancy] tighten of a {side}^2 view: {ms_t:.2f} ms, "
            f"coarse {st['coarse']}, n_probe {st['n_probe']}, empty_frac "
            f"{out['empty_frac']:.4f}, range_ratio {out['range_ratio']:.4f}"
            f", {out['kept']} rays kept, on {card}")
        if not 0 < out["empty_frac"] < 1:
            raise AssertionError(f"empty_frac {out['empty_frac']}")
        # a 256^2 frame, exact and with occupancy
        exact_fn = lambda: tr.render_rays_chunked(  # noqa: E731
            rays, white, rcfg, anneal=anneal)
        occ_fn = lambda: tr.commit_view(  # noqa: E731
            tr.prepare_view(rays, 0), white, rcfg, anneal=anneal)
        exact_fn()
        exact, ms_e = _event_ms(exact_fn)
        occ_fn()
        frame, ms_o = _event_ms(occ_fn)
        psnr = _psnr(frame["rgb_fine"], exact["rgb_fine"])
        out.update(frame_exact_ms=ms_e, frame_occ_ms=ms_o, psnr=psnr)
        log(f"[21 occupancy] {side}^2 frame ({n} rays, {rcfg.n_samples}+"
            f"{rcfg.n_importance}, fp32): "
            f"exact {ms_e:.1f} ms, with occupancy {ms_o:.1f} ms; PSNR of "
            f"the occupancy frame against the exact one {psnr:.2f} dB, on "
            f"{card}")
        if not psnr >= 30.0:   # inf where the frames are equal
            raise AssertionError(f"occupancy frame PSNR {psnr} dB")
        # occ_tighten 0: every kept ray renders the exact render's bits
        tr.config["model"]["occ_tighten"] = 0
        try:
            same = occ_fn()
            keep = tr.occ_keep_mask()
        finally:
            tr.config["model"]["occ_tighten"] = 1
        for k in ("rgb_fine", "opacity_fine"):
            if not torch.equal(same[k][keep], exact[k][keep]):
                raise AssertionError(f"occ_tighten 0: kept rays' {k} differ "
                                     "from the exact render")
        log(f"[21 occupancy] occ_tighten 0: the {int(keep.sum())} kept "
            "rays' rgb and opacity equal the exact render's bits")
        # a 16-view orbit of frame 0: packed against a view at a time
        poses = ds.spherical_poses[::len(ds.spherical_poses) // OCC_VIEWS]
        jobs = [(ds.frame_rays(0, c2w4=p), 0, white,
                 ds.frame_mask(0, c2w4=p)) for p in poses[:OCC_VIEWS]]

        def packed(views):
            return list(tr.render_views_pipelined(views, rcfg,
                                                  anneal=anneal))

        def per_view(views):
            return [tr.commit_view(tr.prepare_view(r, f, extra_mask=m), bg,
                                   rcfg, anneal=anneal)
                    for r, f, bg, m in views]
        packed(jobs[:2])   # warm
        per_view(jobs[:2])
        got, ms_p = _event_ms(lambda: packed(jobs))
        want, ms_v = _event_ms(lambda: per_view(jobs))
        _same_bits("packed vs a view at a time", got, want)
        kept = sum(int(tr.prepare_view(r, f, extra_mask=m)[3])
                   for r, f, _, m in jobs)
        out.update(packed_ms_a_view=ms_p / len(jobs),
                   per_view_ms_a_view=ms_v / len(jobs), orbit_kept=kept)
        log(f"[21 occupancy] {len(jobs)}-view orbit of frame 0 at {side}^2 "
            f"({kept} kept rays in all): packed {ms_p / len(jobs):.1f} ms a "
            f"view, a view at a time {ms_v / len(jobs):.1f} ms a view; "
            f"equal to the bit, on {card}")
        # the same under mlp_impl: pallas (#8 / #9 a packed segment)
        rp = dataclasses.replace(rcfg, mlp_impl="pallas")
        few = jobs[:OCC_PALLAS_VIEWS]
        packed_p = lambda: list(tr.render_views_pipelined(  # noqa: E731
            few, rp, anneal=anneal))
        per_view_p = lambda: [tr.commit_view(  # noqa: E731
            tr.prepare_view(r, f, extra_mask=m), bg, rp, anneal=anneal)
            for r, f, bg, m in few]
        _same_bits("pallas: packed vs a view at a time", packed_p(),
                   per_view_p())   # the first launch of each shape held
        _, ms_pp = _event_ms(packed_p)
        _, ms_pv = _event_ms(per_view_p)
        out.update(pallas_packed_ms_a_view=ms_pp / len(few),
                   pallas_per_view_ms_a_view=ms_pv / len(few))
        log(f"[21 occupancy] mlp_impl pallas, {len(few)} of the orbit's "
            f"views: packed {ms_pp / len(few):.1f} ms a view, a view at a "
            f"time {ms_pv / len(few):.1f} ms a view; equal to "
            f"the bit, on {card}")
        # one 1024^2 view of frame_rays_scaled
        big = ds.frame_rays_scaled(0, OCC_SCALE)
        mask = ds.frame_mask(0, scale=OCC_SCALE)
        res, ms_s = _event_ms(lambda: tr.commit_view(
            tr.prepare_view(big, 0, extra_mask=mask), torch.ones(
                (big.shape[0], 3), device=DEVICE), rcfg, anneal=anneal))
        rgb = res["rgb_fine"]
        if rgb.shape != (big.shape[0], 3) or not torch.isfinite(rgb).all():
            raise AssertionError(f"scaled view: {tuple(rgb.shape)}")
        out.update(scaled_ms=ms_s,
                   scaled_kept=int(tr._occ_keep.sum()))
        log(f"[21 occupancy] one {side * OCC_SCALE}^2 frame_rays_scaled view "
            f"with occupancy: {ms_s:.1f} ms, {int(mask.sum())} rays in the "
            f"hull, {out['scaled_kept']} kept by the grid, on {card}")

    try:
        _, launches = _count_launches(body)
    finally:
        unwrap()
    out.update(err=err, launches=launches, trainer=tr)
    log(f"[21 occupancy] launches {json.dumps(launches)}; phase "
        f"{time.time() - t_phase:.1f} s, of which {spent[0]:.1f} s held the "
        f"kernels against their plain versions, on {card}")
    return out


def phase_occ_cli(card: str, cli: dict) -> dict:
    """``moco_flow_tpu_torch.test.main --occ_res`` on phase 20's stage-3
    final, --render_frame 0 and --eval_metrics, on both routes."""
    from moco_flow_tpu_torch.test import main as test_main
    t_phase = time.time()
    launches = {k: 0 for k in _kernel_counters()}
    err, spent = {}, [0.0]
    unwrap = _hold_launches(err, "[21 occupancy cli]", "a view's", spent)
    try:
        for impl in ("xla", "pallas"):
            out = os.path.join(CLI_DIR, f"occ_{impl}")
            argv = ["-c", os.path.join(CLI_DIR, f"test_{impl}.yaml"),
                    "--render_gt", "--reso", str(CLI_RESO), "-s", "0",
                    "--device", DEVICE, "--out_dir", out, "--occ_res",
                    str(OCC_CLI_RES), "--render_frame", "0",
                    "--eval_metrics", "--num_devices", "1"]
            t = time.time()
            tt, got = _count_launches(lambda: test_main(argv))
            wall = time.time() - t
            for k, v in got.items():
                launches[k] += v
            m = tt.metrics
            files = [f for _, _, fs in os.walk(out) for f in fs]
            if not np.isfinite(m["psnr"]) or files != ["frame_0.png"] or \
                    tt._occ_stats is None:
                raise AssertionError(f"occ {impl}: metrics {m}, files "
                                     f"{files}")
            log(f"[21 occupancy cli] python -m moco_flow_tpu_torch.test "
                f"{' '.join(argv[2:])} ({impl}): {wall:.1f} s, metrics "
                f"{json.dumps(m)} (without --occ_res "
                f"{json.dumps(cli['metrics'][impl])}), empty_frac of the "
                f"last frame {float(tt._occ_stats['empty_frac']):.4f}, "
                f"launches {json.dumps({k: v for k, v in got.items() if v})}"
                f" on {card}")
            del tt
    finally:
        unwrap()
    log(f"[21 occupancy cli] phase {time.time() - t_phase:.1f} s, of which "
        f"{spent[0]:.1f} s held the kernels")
    return {"err": err, "launches": launches}


# -- phase 22: the training options and the render-time models -------------

DISTILL = {"depth": 4, "width": 128, "steps": 3000, "batch": 16384}
# scripts/bench_hashgrid.py's hash config and its 2x64 MLP
HASH_GRID = {"n_levels": 8, "n_features": 2, "log2_table_size": 16,
             "base_res": 16, "max_res": 256, "extent": 1.5}
HASH_NERF = {"type": "NeRF", "D": 2, "W": 64, "skips": [],
             "extra_feat_type": "dir", "extra_feat_dim": 27,
             "encoding": "hashgrid", "hash": HASH_GRID}
HASH_SIZE, HASH_RAYS, HASH_SAMPLES, HASH_STEPS = 128, 1024, 64, 3
HYBRIDS = ("fused_nof", "fused_nerf", "fused", "pallas")
OPTIONS = [({"type": "sgd", "lr": 1e-4, "momentum": 0.9},),
           ({"type": "adam", "lr": 1e-4, "weight_decay": 1e-4},),
           ({"type": "adamw", "lr": 1e-4, "weight_decay": 1e-4,
             "warmup": 100},),
           ({"type": "ranger", "lr": 1e-4},),
           ({"type": "radam", "lr": 1e-4, "weight_decay": 1e-4},)]
SCHEDULES = ({"type": "explr", "lr_decay": 0.99999},
             {"type": "cosine", "num_epochs": 2200000},
             {"type": "poly", "num_epochs": 2200000, "poly_exp": 0.9})


def _hold_new_shapes(dev, card: str, tag: str, err: dict) -> None:
    """#7 and #8 at the student's widths (4x128, skip 2) on a seeded init,
    the way phase 3 holds #7 at the published widths: fp32 and bf16 within
    TOL, bf16 also within the plain version's bf16-vs-fp32 gap (the fitted
    field's frames are held in fp32 by _hold_exact as they run)."""
    from moco_flow_tpu_torch.ops import fused_mlp as fm
    from moco_flow_tpu_torch.render.distill import student_config
    gen = torch.Generator().manual_seed(22)
    scfg = student_config(NeRFConfig(extra_feat_type="ind",
                                     extra_feat_dim=5), **{
        k: DISTILL[k] for k in ("depth", "width")})
    fcfg = NoFConfig()
    params = {"coarse_NeRF": init_nerf(gen, scfg, dev),
              "bw_NoF": init_nof(gen, fcfg, dev)}
    an_n = anneal_weights(505000, 10, 5000, 1005000).to(dev)
    an_f = anneal_weights(505000, 5, 5000, 1005000).to(dev)

    def held(what, run):
        out = {}
        for dname, dt in (("fp32", None), ("bf16", torch.bfloat16)):
            k, p = run(True, dt), run(False, dt)
            torch.cuda.synchronize()
            atol, rtol = TOL[dname]
            out[dname] = (check_close(f"{tag} {what} {dname}", k, p, atol,
                                      rtol), p)
        gap = (out["bf16"][1] - out["fp32"][1]).abs().max().item()
        if not out["bf16"][0] <= gap:
            raise AssertionError(f"{tag} {what}: bf16 kernel vs plain "
                                 f"{out['bf16'][0]:.3e} > gap {gap:.3e}")
        log(f"{tag} {what}: max|d| fp32 {out['fp32'][0]:.3e}, bf16 "
            f"{out['bf16'][0]:.3e} (plain bf16-vs-fp32 gap {gap:.3e}) on "
            f"{card}")
        return max(out["fp32"][0], out["bf16"][0])

    for s, sigma_only in ((128, True), (256, False)):
        o, d, z, ind = _full_width_inputs(4096, s, dev, seed=22 + s)
        extra = embed_padded(ind, EmbeddingSpec(2, in_channels=1), 5)
        ind_emb = embed_padded(ind, EmbeddingSpec(16, in_channels=1), 33)

        def run(kernel, dt):
            args = (params, "coarse_NeRF", scfg, fcfg, 10, 5, True, True,
                    an_n, an_f, o, d, z, None if sigma_only else extra,
                    ind_emb, True, sigma_only, dt)
            ks, kr = (render_pass if kernel else render_pass_ref)(*args)
            return ks[None] if kr is None else torch.cat([ks[None], kr])
        e = held(f"render_pass {scfg.depth}x{scfg.width} N=4096 S={s} "
                 f"{'sigma-only' if sigma_only else 'full'} nof", run)
        err["render_pass"] = max(err.get("render_pass", 0.0), e)
    x = torch.rand(16384, scfg.in_channels_xyz, generator=gen).to(dev)
    ex = torch.rand(16384, 5, generator=gen).to(dev)
    ws = fm._nerf_weights_flat(params["coarse_NeRF"], False)
    e = held(f"nerf_pallas {scfg.depth}x{scfg.width} rows=16384 full",
             lambda kernel, dt: (fm.nerf_pallas if kernel
                                 else fm._nerf_pallas_ref)(
                 scfg, dt, x, ex, False, ws))
    err["nerf_pallas"] = max(err.get("nerf_pallas", 0.0), e)


def phase_student(card: str, occ: dict) -> dict:
    """22a: phase 21's body-fitted c2f field distilled into a 4x128
    student (distill_with_restarts: 3000 Adam steps of 16384 points), its
    256^2 frame exact in fp32 and bf16 beside the teacher's (PSNR against
    the teacher's fp32 frame), the occupancy grid rebuilt on the student
    and its frame with occupancy; #7 / #8 held on every first shape."""
    import dataclasses
    from moco_flow_tpu_torch.render.distill import (distill_student,
                                                    distill_with_restarts,
                                                    render_psnr_vs_teacher)
    t_phase = time.time()
    tr = occ["trainer"]
    dev = tr.device
    ds = tr.val_dataset
    rays = ds.frame_rays(0)
    white = torch.ones((rays.shape[0], 3), device=DEVICE)
    anneal = tr.anneal()
    rcfg = {"fp32": tr.rcfg_test,
            "bf16": dataclasses.replace(tr.rcfg_test,
                                        compute_dtype="bfloat16")}
    err, spent, out = {}, [0.0], {}
    _hold_new_shapes(dev, card, "[22a student]", err)

    def frame(rc):
        f = lambda: tr.render_rays_chunked(rays, white, rc,  # noqa: E731
                                           anneal=anneal)
        f()
        return _event_ms(f)

    def body():
        t_cfg = tr.statics.fine
        teacher = {k: frame(rc) for k, rc in rcfg.items()}
        unwrap = _hold_launches(err, "[22a student]",
                                "the distillation's and the student's",
                                spent, exact=True)
        try:
            # one step first, outside the timed run: the holds of the
            # teacher's and the student's first #8 launches
            distill_student(tr, **dict(DISTILL, steps=1), swap=False)
            (_, scfg, loss, seed), ms = _event_ms(lambda: (
                distill_with_restarts(tr, **DISTILL)))
            ran = (seed + 1) * DISTILL["steps"]
            try:
                tr.train_step()
            except RuntimeError as ex:
                log(f"[22a student] train_step after the swap raises: {ex}")
            else:
                raise AssertionError("train_step ran after swap_render_nerf")
            student = {k: frame(rc) for k, rc in rcfg.items()}
        finally:
            unwrap()
        ref = teacher["fp32"][0]["rgb_fine"]
        psnr = {k: _psnr(v[0]["rgb_fine"], ref) for k, v in student.items()}
        psnr_t = render_psnr_vs_teacher(
            student["fp32"][0]["rgb_fine"].cpu().numpy(), ref.cpu().numpy())
        grid, ms_g = _event_ms(lambda: tr.occupancy_grid(0))
        f_occ = lambda: tr.commit_view(  # noqa: E731
            tr.prepare_view(rays, 0), white, rcfg["fp32"], anneal=anneal)
        f_occ()
        occ_frame, ms_o = _event_ms(f_occ)
        p_occ = _psnr(occ_frame["rgb_fine"], student["fp32"][0]["rgb_fine"])
        out.update(loss=loss, seed=seed, distill_ms_a_step=ms / ran,
                   teacher_ms={k: v[1] for k, v in teacher.items()},
                   student_ms={k: v[1] for k, v in student.items()},
                   psnr=psnr, grid_ms=ms_g, occ_frame_ms=ms_o,
                   occ_psnr=p_occ,
                   occupied=float(grid.occupancy_fraction))
        log(f"[22a student] distilled {scfg.depth}x{scfg.width} (skips "
            f"{list(scfg.skips)}) from the fitted {t_cfg.depth}x"
            f"{t_cfg.width} teacher: "
            f"{DISTILL['steps']} steps of {DISTILL['batch']} points, loss "
            f"{loss:.5f} at seed {seed}, {ms / ran:.3f} ms a step (CUDA "
            f"events over the {ran} steps of every seed tried) on {card}")
        log(f"[22a student] {ds.size[0]}^2 frame exact: teacher fp32 "
            f"{teacher['fp32'][1]:.1f} ms, bf16 {teacher['bf16'][1]:.1f} "
            f"ms; student fp32 {student['fp32'][1]:.1f} ms, bf16 "
            f"{student['bf16'][1]:.1f} ms; PSNR against the teacher's fp32 "
            f"frame fp32 {psnr['fp32']:.2f} dB ({psnr_t} by "
            f"render_psnr_vs_teacher), bf16 {psnr['bf16']:.2f} dB on {card}")
        log(f"[22a student] occupancy on the student: frame 0's grid "
            f"{ms_g:.1f} ms (occupied {out['occupied']:.4f}), the frame with "
            f"occupancy {ms_o:.1f} ms, {p_occ:.2f} dB against the student's "
            f"exact frame on {card}")
        if loss >= 0.1:
            log(f"[22a student] no seed of {DISTILL} reached a loss below "
                "0.1 (bench.py's restart bound)")
        if not (np.isfinite(loss) and p_occ >= 30.0
                and min(psnr.values()) > 15.0):
            raise AssertionError(f"student: loss {loss}, PSNR {psnr}, "
                                 f"occupancy PSNR {p_occ}")

    _, launches = _count_launches(body)
    out.update(err=err, launches=launches)
    log(f"[22a student] launches {json.dumps(launches)}; phase "
        f"{time.time() - t_phase:.1f} s ({spent[0]:.1f} s of holds) on "
        f"{card}")
    return out


def hash_config(dtype: str, encoding: str) -> dict:
    """scripts/bench_hashgrid.py's stage-1 config: init_nerf.yaml's run on
    a 128^2 scene, 1024 rays x (64 + 64), the hash NeRF (or the 8x256 PE
    one), radam at 1e-2 (1e-3 for PE)."""
    cfg = stage1_config(dtype, impl="auto" if encoding == "hash" else "xla")
    cfg["save_dir"] = os.path.join(HERE, "build", "chip_smoke_hash",
                                   f"{encoding}_{dtype}")
    cfg["dataloader"].update(size=[HASH_SIZE] * 2, val_size=[HASH_SIZE] * 2)
    cfg["model"].update(N_rand=HASH_RAYS, N_samples=HASH_SAMPLES,
                        N_importance=HASH_SAMPLES)
    if encoding == "hash":
        cfg["model"].update(coarse_NeRF=dict(HASH_NERF),
                            fine_NeRF=dict(HASH_NERF))
        cfg["optimizer"]["lr"] = 1e-2
    cfg["trainer"]["num_iters"] = HASH_STEPS
    return cfg


def phase_hashgrid(card: str) -> dict:
    """22b: stage 1 with the hash-grid NeRF through train() in fp32 and
    bf16 (3 steps and a val step; auto -> fused_nof: the encode in PyTorch,
    the NeRF on #8), beside the PE NeRF in the same cell; then one stage-3
    full step with a hash NeRF under auto; #8 held at the hash shapes."""
    from moco_flow_tpu_torch.train.__main__ import parse_args as train_args
    from moco_flow_tpu_torch.train.__main__ import train
    from moco_flow_tpu_torch.train.checkpoint import _flatten
    t_phase = time.time()
    scene = make_synthetic_scene(None, n_frames=8, size=HASH_SIZE,
                                 focal=300.0 * HASH_SIZE / 256)
    err, spent, out = {}, [0.0], {}
    unwrap = _hold_launches(err, "[22b hash grid]", "the hash steps'", spent)

    def body():
        for dtype in ("float32", "bfloat16"):
            for enc in ("hash", "pe"):
                cfg = hash_config(dtype, enc)
                shutil.rmtree(cfg["save_dir"], ignore_errors=True)
                tr = train(cfg, train_args(["-c", "(dict)", "-n", "smoke",
                                            "--device", DEVICE]),
                           scene=scene)
                if enc == "hash" and tr.rcfg_train.mlp_impl != "fused_nof":
                    raise AssertionError(tr.rcfg_train.mlp_impl)
                p0 = {k: v.clone() for k, v in _flatten(
                    tr.params, leaf=lambda t: t.detach()).items()}
                ms = _timed_steps(tr, warm=1, steps=HASH_STEPS)
                moved = {k: float((v.detach() - p0[k]).abs().max())
                         for k, v in _flatten(tr.params,
                                              leaf=lambda t: t).items()}
                val = tr.val_func()
                losses = {k: float(v) for k, v in tr.losses.items()}
                key = "fine_NeRF/hash" if enc == "hash" else None
                if not (all(np.isfinite(v) for v in losses.values())
                        and all(np.isfinite(v) for v in val.values())
                        and (moved[key] if key else max(moved.values()))
                        > 0):
                    raise AssertionError(f"{enc} {dtype}: {losses} {val} "
                                         f"{moved}")
                out[(enc, dtype)] = ms
                log(f"[22b hash grid] stage 1 {enc} {dtype} "
                    f"({tr.rcfg_train.mlp_impl}): {HASH_RAYS} rays x "
                    f"({HASH_SAMPLES}+{HASH_SAMPLES}) at {HASH_SIZE}^2, step "
                    f"{ms:.2f} ms = {HASH_RAYS / ms * 1e3:.0f} rays/s, last "
                    f"losses {json.dumps(losses)}, val {json.dumps(val)}"
                    + (f", the table moved {moved['fine_NeRF/hash']:.2e}"
                       if enc == "hash" else "") + f" on {card}")
                del tr
        # stage 3, full phase, a hash NeRF under auto
        hnerf = dict(HASH_NERF, extra_feat_type="ind", extra_feat_dim=5)
        tr = _stage3_trainer("hash", 4000, coarse_NeRF=dict(hnerf),
                             fine_NeRF=dict(hnerf), mlp_impl="auto")
        losses = {k: float(v) for k, v in tr.losses.items()}
        if tr.rcfg_train.mlp_impl != "fused_nof" or "nof_bw" not in losses \
                or not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"hash stage 3: {tr.rcfg_train.mlp_impl} "
                                 f"{losses}")
        ms = _timed_steps(tr, warm=0, steps=1)
        out["stage3_full_ms"] = ms
        log(f"[22b hash grid] stage 3 full step with a hash NeRF (2x64, "
            f"ind extra) under auto -> fused_nof, c2f's NoFs, 1024 rays x "
            f"(128+128): {ms:.1f} ms, losses {json.dumps(losses)} on {card}")

    try:
        _, launches = _count_launches(body)
    finally:
        unwrap()
    out.update(err=err, launches=launches)
    log(f"[22b hash grid] launches {json.dumps(launches)}; phase "
        f"{time.time() - t_phase:.1f} s ({spent[0]:.1f} s of holds) on "
        f"{card}")
    return out


def _stage3_trainer(tag: str, start: int, **model):
    """Phase 18's cell in fp32 (c2f's model at its widths, the phases
    config; ``model`` overrides keys of its model block), a seeded init
    with sigma biases + 1 trained one step through train() from
    ``start``."""
    from moco_flow_tpu_torch.train.__main__ import parse_args as train_args
    from moco_flow_tpu_torch.train.__main__ import train
    cfg = phases_config("float32")
    cfg["save_dir"] += f"_{tag}"
    cfg["model"].update(model)
    cfg["trainer"]["num_iters"] = start + 1
    params = init_params(torch.Generator().manual_seed(0),
                         build_statics(cfg["model"]), with_nof=True,
                         with_fw_nof=True)
    for net in ("coarse_NeRF", "fine_NeRF"):
        params[net]["sigma"]["b"] += 1.0
    seed = os.path.join(cfg["save_dir"], f"seeded{start}")
    save_checkpoint(seed, {"params": params}, extra={
        "clock": {"epoch": 1, "minibatch": 0, "step": start}})
    return train(cfg, train_args(["-c", "(dict)", "-r", seed + ".npz", "-n",
                                  f"smoke{start}", "--device", DEVICE]),
                 scene=body_scene())


def phase_hybrids(card: str) -> dict:
    """22c: phase 18's cell on one trainer: the msk / full / none steps in
    bf16 and fp32 under fused_nof and fused_nerf beside fused and pallas (2
    warm and 3 timed steps each), and a 256^2 fp32 test frame under each
    hybrid; #3 / #7 / #8 / #9 held on their first shapes. Returns the
    trainer too (phase_options steps it)."""
    import dataclasses
    t_phase = time.time()
    err, spent, out = {}, [0.0], {}
    unwrap = _hold_launches(err, "[22c hybrids]",
                            "the hybrid steps' and frames'", spent)

    tr = _stage3_trainer("hybrids", 9999)
    rcfg, rtest = tr.rcfg_train, tr.rcfg_test

    def body():
        for dtype in ("bfloat16", "float32"):
            times = {}
            for route in HYBRIDS:
                tr.rcfg_train = dataclasses.replace(rcfg, mlp_impl=route,
                                                    compute_dtype=dtype)
                for mode, step, deleted in (("msk", 10000, True),
                                            ("full", 4000, False),
                                            ("none", 6000, True)):
                    tr.clock.step = step
                    tr.nof_opt_deleted, tr.opt = deleted, None
                    m = tr.train_step()
                    if not all(torch.isfinite(v) for v in m.values()):
                        raise AssertionError(f"{route} {mode} {dtype}: {m}")
                    times[(mode, route)] = _timed_steps(tr, warm=1, steps=3)
            tr.rcfg_train = rcfg
            out[dtype] = times
            log(f"[22c hybrids] {dtype}, ms a step (phase 18's cell), "
                + "; ".join(f"{m}: " + ", ".join(
                    f"{r} {times[(m, r)]:.1f}" for r in HYBRIDS)
                    for m in ("msk", "full", "none")) + f" on {card}")
            if dtype == "float32":
                ds = tr.val_dataset
                rays = ds.frame_rays(0)
                white = torch.ones((rays.shape[0], 3), device=DEVICE)
                frames = {}
                for route in ("fused_nof", "fused_nerf", "fused"):
                    rc = dataclasses.replace(rtest, mlp_impl=route)

                    @torch.no_grad()
                    def f():
                        return tr.render_rays_chunked(rays, white, rc,
                                                      anneal=tr.anneal())
                    f()
                    frames[route] = _event_ms(f)
                ref = frames["fused"][0]["rgb_fine"]
                out["frame_ms"] = {k: v[1] for k, v in frames.items()}
                for route in ("fused_nof", "fused_nerf"):
                    d = (frames[route][0]["rgb_fine"] - ref).abs().max()
                    if not d < 1e-3:
                        raise AssertionError(f"{route} frame vs fused {d}")
                log(f"[22c hybrids] 256^2 test frame fp32: " + ", ".join(
                    f"{k} {v:.1f} ms" for k, v in out["frame_ms"].items())
                    + f" (the hybrids' rgb within 1e-3 of fused) on {card}")

    try:
        _, launches = _count_launches(body)
    finally:
        unwrap()
    out.update(err=err, launches=launches, trainer=tr)
    log(f"[22c hybrids] launches {json.dumps(launches)}; phase "
        f"{time.time() - t_phase:.1f} s ({spent[0]:.1f} s of holds) on "
        f"{card}")
    return out


def phase_options(card: str, tr) -> dict:
    """22d: one stage-3 full step (both optimizers) per optimizer x
    schedule, and one with noise_std 1.0, on phase 18's cell (phase 22c's
    trainer) in fp32: finite losses, moving parameters, the optimizers'
    opt_named round trip."""
    import dataclasses
    from moco_flow_tpu_torch.train.optim import make_optimizer
    t_phase = time.time()
    out = {}

    def body():
        named = tr._named()
        for (ocfg,) in OPTIONS:
            for sched in SCHEDULES:
                tr.configure_optimizers({"moco": ocfg, "nof": ocfg}, sched)
                tr.clock.step, tr.nof_opt_deleted = 4000, False
                p0 = {k: t.detach().clone() for k, t in named.items()}
                losses = tr.train_step()
                moved = max(float((t.detach() - p0[k]).abs().max())
                            for k, t in named.items())
                st = tr._opt_state_named()
                back = make_optimizer(list(named.values()), ocfg, sched,
                                      names=list(named))
                back.load_named(st, "['moco']")
                rt = back.state_named("['moco']")
                same = all(np.array_equal(np.asarray(rt[k]),
                                          np.asarray(st[k])) for k in rt)
                ok = all(torch.isfinite(v) for v in losses.values())
                if not (ok and moved > 0 and same and set(rt) <= set(st)):
                    raise AssertionError(f"{ocfg} {sched}: finite {ok}, "
                                         f"moved {moved}, round trip {same}")
                out[(ocfg["type"], sched["type"])] = moved
        tr.rcfg_train = dataclasses.replace(tr.rcfg_train, noise_std=1.0)
        tr.configure_optimizers({"moco": OPTIONS[1][0],
                                 "nof": OPTIONS[1][0]}, None)
        tr.clock.step = 4000
        draws = tr.draw(4000)
        if draws.sigma_noise_fine is None:
            raise AssertionError("noise_std 1.0: no sigma noise drawn")
        p0 = {k: t.detach().clone() for k, t in named.items()}
        losses = tr.train_step(draws=draws)
        moved = max(float((t.detach() - p0[k]).abs().max())
                    for k, t in named.items())
        if not (all(torch.isfinite(v) for v in losses.values())
                and moved > 0):
            raise AssertionError(f"noise step: {losses} {moved}")
        log(f"[22d options] {len(OPTIONS)} optimizers x "
            f"{len(SCHEDULES)} schedules, a full step each (moco + nof): "
            "largest update " + ", ".join(
                f"{o}/{s} {m:.2e}" for (o, s), m in out.items())
            + f"; noise_std 1.0 step moved {moved:.2e}"
            f", losses {json.dumps({k: float(v) for k, v in losses.items()})}"
            f" on {card}")

    _, launches = _count_launches(body)
    out = {"launches": launches, "err": {}, "moved": out}
    log(f"[22d options] launches {json.dumps(launches)}; phase "
        f"{time.time() - t_phase:.1f} s on {card}")
    return out


# ---------------------------------------------------------------------------
# Data parallelism (phase 23)
# ---------------------------------------------------------------------------

DP_WORLD = 2
DP_START, DP_STEPS = 4990, 3         # full steps 4990, 4992, 4994 (c2f: 5000)
DP_DIR = os.path.join(HERE, "build", "chip_smoke_dp")
DP_REDUCE_REPS = 10
DP_RESO = 256
DP_FRAME_REPS = 2


def _dp_sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _dp_replay(rank: int, dev) -> dict:
    """The DP fixture's steps on this rank
    (scripts/make_torch_port_dp_golden.py)."""
    from scripts import make_torch_port_dp_golden as gd
    arrs = gd.load()
    return {stage: gd.port_run(arrs, stage, rank, dev) for stage in gd.RUNS}


def _check_dp_replay(results: list, tag: str) -> tuple:
    """Each rank's replay within STEP_TOL of JAX's mesh steps, the ranks'
    parameters and metrics equal to the bit. Returns (worst metric rel,
    worst param |diff|)."""
    from scripts import make_torch_port_dp_golden as gd
    arrs = gd.load()
    worst = perr = 0.0
    for stage, (_, n_steps) in gd.RUNS.items():
        for r in results:
            metrics, params = r["replay"][stage]
            for i, m in enumerate(metrics):
                want = gd.unflatten_prefix(arrs, f"{stage}/metrics/{i}")
                if set(m) != set(want):
                    raise AssertionError(f"{tag} {stage} step {i}: keys "
                                         f"{sorted(m)} vs {sorted(want)}")
                for k, v in m.items():
                    w = float(want[k])
                    rel = abs(v - w) / max(abs(w), 1e-30)
                    worst = max(worst, rel)
                    if rel > STEP_TOL["metrics_rtol"]:
                        raise AssertionError(f"{tag} {stage} step {i} {k}: "
                                             f"port {v} JAX {w}")
            want = gd.unflatten_prefix(arrs, f"{stage}/params{n_steps}")
            for k, v in params.items():
                d = float(np.abs(v - want[k]).max())
                perr = max(perr, d)
                if d > STEP_TOL["params_atol"]:
                    raise AssertionError(f"{tag} {stage} params {k}: "
                                         f"max|diff| {d:.3e}")
        (m0, p0), (m1, p1) = (r["replay"][stage] for r in results)
        if m0 != m1 or any(p0[k].tobytes() != p1[k].tobytes() for k in p0):
            raise AssertionError(f"{tag} {stage}: the ranks' metrics or "
                                 "parameters differ")
    return worst, perr


def _dp_train(dev, cfg: dict, seed: str, scene, extra=()) -> tuple:
    """train(config, args) on this rank, each step's metrics recorded:
    (trainer, [metrics per step])."""
    from moco_flow_tpu_torch.train.__main__ import parse_args as train_args
    from moco_flow_tpu_torch.train.__main__ import train
    from moco_flow_tpu_torch.train.base import BaseTrainer
    args = ["-c", "(dict)", "-n", "dp", "--device", str(dev), *extra]
    if seed:
        args += ["-r", seed]
    record = []
    orig = BaseTrainer.train_func

    def recorded(self):
        out = orig(self)
        record.append({k: float(v) for k, v in out.items()
                       if k != "state/nerf"})
        return out

    BaseTrainer.train_func = recorded
    try:
        tr = train(copy.deepcopy(cfg), train_args(args), scene=scene)
    finally:
        BaseTrainer.train_func = orig
    if tr.logger is not None:
        tr.logger.close()
    _dp_sync(dev)
    return tr, record


def _host_ms(dev, fn, reps: int) -> float:
    """ms a call of ``fn`` on the host's clock, the device synchronised
    (every rank calls it together, so a collective inside is timed whole)."""
    import torch.distributed as dist
    fn()
    _dp_sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _dp_sync(dev)
    return (time.perf_counter() - t0) * 1e3 / reps


def _dp_rank(rank: int, world: int, dev, job: dict) -> dict:
    """Phase 23 on one rank: (a) the fixture, then with ``job["full"]`` (b)
    the stage-3 full steps through train() and their times, (c) a stage-1
    and a stage-2 step, (d) test() --eval_metrics and the sharded frame."""
    from moco_flow_tpu_torch.parallel.mesh import all_reduce_mean
    from moco_flow_tpu_torch.train.checkpoint import _flatten
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"replay": _dp_replay(rank, dev)}
    if not job.get("full"):
        return out
    counters = _kernel_counters()
    for f in counters.values():
        f.launches = 0
    cuda = torch.device(dev).type == "cuda"
    for dtype, (cfg, seed) in job["s3"].items():
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        tr, record = _dp_train(dev, cfg, seed, job["scene"])
        res = {"metrics": record, "clock": tr.clock.step,
               "params": {k: v.copy() for k, v in _flatten(tr.params).items()}}
        res["step_ms"] = _host_ms(dev, tr.train_step, 3)
        named = list(tr._named().values())
        res["reduce_bytes"] = 4 * sum(t.numel() for t in named
                                      if t.grad is not None)
        res["reduce_ms"] = _host_ms(
            dev, lambda: all_reduce_mean(named, {}, world), DP_REDUCE_REPS)
        res["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30
                           if cuda else 0.0)
        out[dtype] = res
        del tr
    for stage, (cfg, scene) in job["stages"].items():
        tr, record = _dp_train(dev, cfg, None, scene)
        out[stage] = {"metrics": record, "params": _flatten(tr.params),
                      "clock": tr.clock.step}
        del tr
    for impl, (cfg, argv) in job["test"].items():
        args = parse_args(argv + ["--device", str(dev)])
        tr = test(copy.deepcopy(cfg), args, scene=job["scene"])
        ds = tr.val_dataset
        rays = ds.frame_rays(0)

        def render():
            return tr.render_rays_chunked(rays, ds.bkgd_img, tr.rcfg_test,
                                          anneal=tr.anneal())
        with torch.no_grad():
            ms = _host_ms(dev, render, DP_FRAME_REPS)
            frame = {k: v.cpu().numpy() for k, v in render().items()}
        out[impl] = {"metrics": tr.metrics, "frame": frame, "ms": ms}
        del tr
    _dp_sync(dev)
    out["launches"] = {k: f.launches for k, f in counters.items()}
    return out


def _dp_reference(cfg: dict, seed: str, scene) -> tuple:
    """One process on the card in place of DP_WORLD ranks: each step runs
    every rank's draws on the same parameters, averages their gradients
    and metrics as the all-reduce does ((g0 + g1) / 2 in fp32) and applies
    the same Adam updates. Returns ([metrics per step], params)."""
    from moco_flow_tpu_torch.train.__main__ import parse_args as train_args
    from moco_flow_tpu_torch.train.__main__ import train
    from moco_flow_tpu_torch.train.checkpoint import _flatten
    ref = copy.deepcopy(cfg)
    ref["save_dir"] = cfg["save_dir"] + "_reference"
    ref["trainer"]["num_iters"] = DP_START             # build and load only
    shutil.rmtree(ref["save_dir"], ignore_errors=True)
    tr = train(ref, train_args(["-c", "(dict)", "-r", seed, "-n", "ref",
                                "--device", DEVICE]), scene=scene)
    tr.world_size = DP_WORLD       # the ranks' milestones and draws
    tr.opt = tr.opt_nof = None
    tr.reduce_grads = lambda metrics: metrics
    named = list(tr._named().values())
    metrics = []
    for _ in range(DP_STEPS):
        step = tr.clock.step
        opts = [tr._optimizers(), tr.opt_nof]
        grads, ms = [], []
        for o in opts:
            o.step = lambda: None
        try:
            for r in range(DP_WORLD):
                tr.rank = r
                ms.append(tr.train_step(draws=tr.draw(step)))
                grads.append([None if t.grad is None else t.grad.clone()
                              for t in named])
        finally:
            for o in opts:
                del o.step
        for j, t in enumerate(named):
            if grads[0][j] is not None:
                t.grad = sum(g[j] for g in grads) / DP_WORLD
        for o in opts:
            o.step()
        metrics.append({k: float(sum(m[k] for m in ms) / DP_WORLD)
                        for k in ms[0]})
        tr.clock.tick(DP_WORLD)
    _dp_sync(DEVICE)
    return metrics, _flatten(tr.params)


def _dp_jobs(scratch: str) -> dict:
    """Phase 23's configs, checkpoints and scenes, made here for the ranks."""
    scene = body_scene()
    shutil.rmtree(scratch, ignore_errors=True)
    job = {"full": True, "scene": scene, "s3": {}, "stages": {}, "test": {}}
    for dtype in ("float32", "bfloat16"):
        cfg = phases_config(dtype)
        cfg["save_dir"] = os.path.join(scratch, "s3", dtype)
        cfg["trainer"]["num_iters"] = DP_START + DP_WORLD * DP_STEPS
        cfg["trainer"]["log_freq"] = 1
        params = init_params(torch.Generator().manual_seed(0),
                             build_statics(cfg["model"]), with_nof=True,
                             with_fw_nof=True)
        for net in ("coarse_NeRF", "fine_NeRF"):
            params[net]["sigma"]["b"] += 1.0
        seed = os.path.join(scratch, "seeds", f"s3_{dtype}")
        save_checkpoint(seed, {"params": params}, extra={
            "clock": {"epoch": 1, "minibatch": 0, "step": DP_START}})
        job["s3"][dtype] = (cfg, seed + ".npz")
    s1 = stage1_config("float32", "xla")
    s1["save_dir"] = os.path.join(scratch, "s1")
    s1["trainer"].update(num_iters=DP_WORLD, log_freq=1)
    s2 = stage2_config()
    s2["save_dir"] = os.path.join(scratch, "s2")
    s2["trainer"].update(num_iters=DP_WORLD, val_every_n_step=0, log_freq=1)
    job["stages"] = {"stage1": (s1, scene), "stage2": (s2, body_scene(64))}
    for impl in ("fused", "pallas"):
        cfg = slice_config()
        cfg["save_dir"] = os.path.join(scratch, "test", impl)
        cfg["model"].update(compute_dtype="float32", mlp_impl=impl)
        ckpt = seeded_checkpoint(cfg, os.path.join(scratch, "seeds",
                                                   f"test_{impl}"))
        job["test"][impl] = (cfg, ["-c", "(dict)", "-r", ckpt, "--render_gt",
                                   "--reso", str(DP_RESO), "--eval_metrics",
                                   "--eval_max_frames", "1"])
    return job


def _same_bits_dict(tag: str, got: dict, want: dict) -> None:
    if set(got) != set(want):
        raise AssertionError(f"{tag}: keys {sorted(got)} vs {sorted(want)}")
    for k, v in want.items():
        g = got[k]
        if g.dtype != v.dtype or g.shape != v.shape or \
                g.tobytes() != v.tobytes():
            d = (np.abs(g.astype(np.float64) - v.astype(np.float64)).max()
                 if g.shape == v.shape else float("nan"))
            raise AssertionError(f"{tag} {k}: not the same bits (max |diff| "
                                 f"{d:.3e})")


def phase_dp(card: str, devices=None) -> dict:
    """Phase 23: data parallelism, DP_WORLD ranks (two on cuda:0 over gloo,
    which share its SMs: no scaling figure), against JAX's mesh fixture, a
    single process averaging the ranks' gradients, and world 1's frame."""
    from moco_flow_tpu_torch.parallel import multihost
    t_phase = time.time()
    devices = devices or [torch.device("cuda", 0)] * DP_WORLD
    backend = multihost.backend_for(devices)
    job = _dp_jobs(DP_DIR)
    torch.cuda.empty_cache()
    t = time.time()
    ranks = multihost.launch(_dp_rank, devices, job)
    log(f"[23 dp] {DP_WORLD} ranks on {[str(d) for d in devices]} over "
        f"{backend} (they share the card's SMs): {time.time() - t:.1f} s "
        "with the processes' start")
    worst, perr = _check_dp_replay(ranks, "[23a]")
    log(f"[23a dp fixture] JAX's make_mesh(2) steps (stage 3 full x 2, "
        f"stage 1, stage 2 x 2) on {DP_WORLD} ranks: loss terms max rel "
        f"{worst:.2e} (tol {STEP_TOL['metrics_rtol']:g}), params max|diff| "
        f"{perr:.2e} (tol {STEP_TOL['params_atol']:g}); the ranks' "
        "parameters equal to the bit")
    result = {"launches": {k: sum(r["launches"][k] for r in ranks)
                           for k in ranks[0]["launches"]}}
    for dtype, (cfg, seed) in job["s3"].items():
        want_m, want_p = _dp_reference(cfg, seed, job["scene"])
        for r in ranks:
            got = r[dtype]
            if got["clock"] != DP_START + DP_WORLD * DP_STEPS:
                raise AssertionError(f"[23b] {dtype}: clock {got['clock']}")
            if got["metrics"] != want_m:
                raise AssertionError(f"[23b] {dtype} rank metrics "
                                     f"{got['metrics']} vs the reference "
                                     f"{want_m}")
            _same_bits_dict(f"[23b] {dtype} rank params vs the reference",
                            got["params"], want_p)
        moved = max(float(np.abs(want_p[k] - v).max()) for k, v in
                    _dp_seed_params(seed).items())
        r0, r1 = ranks[0][dtype], ranks[1][dtype]
        result[dtype] = {k: (r0[k], r1[k]) for k in
                         ("step_ms", "reduce_ms", "reduce_bytes", "peak_gib")}
        log(f"[23b dp train] {dtype}: {DP_STEPS} full steps from {DP_START} "
            f"through train() on each rank equal the single-process "
            f"reference to the bit (params moved up to {moved:.3e}); last "
            f"losses {json.dumps(r0['metrics'][-1])}; a step "
            f"{r0['step_ms']:.1f} / {r1['step_ms']:.1f} ms (rank 0 / 1, host "
            f"clock), the gradient all-reduce of {r0['reduce_bytes']} bytes "
            f"{r0['reduce_ms']:.3f} / {r1['reduce_ms']:.3f} ms, peak "
            f"{r0['peak_gib']:.2f} / {r1['peak_gib']:.2f} GiB; two ranks "
            f"sharing one card, on {card}")
    for stage in job["stages"]:
        (m0, p0, c0), (m1, p1, c1) = ((r[stage]["metrics"], r[stage]["params"],
                                      r[stage]["clock"]) for r in ranks)
        if m0 != m1 or not c0 == c1 == DP_WORLD or not all(
                np.isfinite(v) for m in m0 for v in m.values()):
            raise AssertionError(f"[23c] {stage}: metrics {m0} / {m1}, "
                                 f"clock {c0} / {c1}")
        _same_bits_dict(f"[23c] {stage} rank 1 vs rank 0", p1, p0)
        log(f"[23c dp {stage}] one step on {DP_WORLD} ranks: "
            f"{json.dumps(m0[-1])}; the ranks' parameters equal to the bit")
    for impl, (cfg, argv) in job["test"].items():
        args = parse_args(argv + ["--device", DEVICE])
        tr = test(copy.deepcopy(cfg), args, scene=job["scene"])
        ds = tr.val_dataset
        rays = ds.frame_rays(0)
        with torch.no_grad():
            def render():
                return tr.render_rays_chunked(rays, ds.bkgd_img,
                                              tr.rcfg_test,
                                              anneal=tr.anneal())
            ms1 = cuda_ms(render, reps=DP_FRAME_REPS)
            want = {k: v.cpu().numpy() for k, v in render().items()}
        for r in ranks:
            _same_bits_dict(f"[23d] {impl} sharded frame vs world 1",
                            r[impl]["frame"], want)
            if r[impl]["metrics"] != tr.metrics:
                raise AssertionError(f"[23d] {impl}: metrics "
                                     f"{r[impl]['metrics']} vs {tr.metrics}")
        result[impl] = (ranks[0][impl]["ms"], ranks[1][impl]["ms"], ms1)
        log(f"[23d dp test {impl}] test() --eval_metrics on {DP_WORLD} ranks "
            f"{json.dumps(tr.metrics)}, equal to world 1's; the 256x256 "
            f"fp32 frame equal to world 1's to the bit: "
            f"{ranks[0][impl]['ms']:.1f} / {ranks[1][impl]['ms']:.1f} ms on "
            f"the ranks (host clock) against {ms1:.1f} ms at world 1 (CUDA "
            f"events), two ranks sharing one card, on {card}")
        del tr
    if torch.cuda.device_count() >= DP_WORLD:
        cards = [torch.device("cuda", i) for i in range(DP_WORLD)]
        nccl = multihost.launch(_dp_rank, cards, {"full": False})
        worst, perr = _check_dp_replay(nccl, "[23e]")
        log(f"[23e dp nccl] the fixture on {cards} over "
            f"{multihost.backend_for(cards)}: max rel {worst:.2e}, params "
            f"max|diff| {perr:.2e}, the ranks equal to the bit")
    else:
        log(f"[23e dp nccl] not run: {torch.cuda.device_count()} card(s) "
            "here, NCCL needs one rank a card")
    log(f"[23] phase 23 took {time.time() - t_phase:.1f} s on {card}; "
        f"launches on the ranks {json.dumps(result['launches'])}")
    return result


def _dp_seed_params(seed: str) -> dict:
    from moco_flow_tpu_torch.train.checkpoint import _flatten, load_checkpoint
    tree, _ = load_checkpoint(seed)
    return _flatten(tree["params"])


# ---------------------------------------------------------------------------
# Phase 24: the offline toolchain (moco_flow_tpu_torch/scripts/)
# ---------------------------------------------------------------------------

TOOL_DIR = os.path.join(HERE, "build", "chip_smoke_toolchain")
TOOL_SIZE = 1080         # preprocess_data.py's default --size
TOOL_VIEWS = 120         # its --num_init_views
TOOL_FRAMES = 30
TOOL_CPU_VIEWS = 2       # views drawn again by the CPU plain version
# the runbook's steps a stage: the fewest (of 30, 100, 200) whose trained
# field beats the render-nothing baseline by the runbook's 1 dB on the CPU
# (30 and 100 steps render the white background, PSNR equal to it)
TOOL_PIPE_STEPS = 200
PIPE_TIMEOUT = 600


def _vibe_pkl(path: str, n_frames: int, seed: int = 0) -> str:
    """A seeded single-person VIBE output: poses, betas and orig_cam
    (scale ~1, a small image-plane shift) for ``n_frames`` frames."""
    import pickle
    rng = np.random.default_rng(seed)
    poses = np.zeros((n_frames, 72), np.float32)
    poses[:, 3:] = rng.normal(scale=0.1, size=(n_frames, 69))
    cam = np.tile([1.0, 1.0, 0.0, 0.1], (n_frames, 1))
    cam[:, 2:] += rng.normal(scale=0.02, size=(n_frames, 2))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({1: {"frame_ids": np.arange(n_frames), "pose": poses,
                         "betas": np.zeros((n_frames, 10), np.float32),
                         "orig_cam": cam}}, f)
    return path


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def phase_toolchain(card: str) -> dict:
    """Phase 24: (a) a VIBE pkl -> train/val.json and the init_nerf views on
    the card, the rasterizer held against its CPU plain version; (b) the
    median background on the card against the CPU; (c) two init_nerf.yaml
    steps through the training CLI on those views; (d) a reference .pth of
    a c2f-wide model converted by the CLI renders the same bits; (e) the
    pipeline runbook through its CLI, in a process of its own beside (c)
    and (d), started once the card's timings of (a) and (b) are taken."""
    from moco_flow_tpu_torch.geometry.smpl import (load_smpl_data,
                                                   save_smpl_data,
                                                   synthetic_smpl_data)
    from moco_flow_tpu_torch.scripts import data_utils as du
    from moco_flow_tpu_torch.scripts.rasterizer import rasterize_mesh
    from moco_flow_tpu_torch.utils.image import read_png
    t_phase = time.time()
    shutil.rmtree(TOOL_DIR, ignore_errors=True)
    out = {"launches": {k: 0 for k in _kernel_counters()}}
    size = (TOOL_SIZE, TOOL_SIZE)
    os.environ["SMPL_MODEL_DIR"] = os.path.dirname(save_smpl_data(
        synthetic_smpl_data(6890), os.path.join(TOOL_DIR, "smpl")))
    smpl = load_smpl_data()

    # (a) the dataset and the init_nerf views
    data = {d: os.path.join(TOOL_DIR, d) for d in ("data", "data_cpu")}
    pkls = {d: _vibe_pkl(os.path.join(p, "vibe_output.pkl"), TOOL_FRAMES)
            for d, p in data.items()}
    du.create_moco_flow_data(pkls["data"], size)
    du.create_moco_flow_data(pkls["data_cpu"], size)
    for name in ("train.json", "val.json"):
        if _read(os.path.join(data["data"], name)) != _read(
                os.path.join(data["data_cpu"], name)):
            raise AssertionError(f"[24a] {name} differs between two runs")
    torch.cuda.synchronize()
    t = time.time()
    meta = du.create_init_nerf_data(pkls["data"], size, num_images=TOOL_VIEWS,
                                    device="cuda")
    build_s = time.time() - t
    init_dir = os.path.join(data["data"], "init_nerf")
    imgs = sorted(os.listdir(os.path.join(init_dir, "images")))
    if len(meta["frames"]) != TOOL_VIEWS or len(imgs) != TOOL_VIEWS:
        raise AssertionError(f"[24a] {len(imgs)} views written")
    fr0 = meta["frames"][0]
    verts = du.posed_vertices(smpl, fr0["pose"], fr0["betas"], fr0["transl"],
                              "cuda")
    colors = du.position_colors(verts)
    focal, cam_c = meta["camera_focal"], meta["camera_c"]

    def draw(i, device):
        c2w = np.asarray(meta["frames"][i]["camera_pose"])
        return rasterize_mesh(verts, smpl.faces, colors, c2w, focal, cam_c,
                              size, device=device)
    card_ms = [cuda_ms(lambda: draw(i, "cuda"), reps=3)
               for i in range(TOOL_CPU_VIEWS)]
    out.update(view_ms=card_ms, build_s=build_s)

    # (b) the median background of 30 and 31 frames (the views above) on
    # the card; the CPU's checks follow beside (e)
    medians = {}
    for n in (TOOL_FRAMES, TOOL_FRAMES + 1):
        src = os.path.join(TOOL_DIR, f"frames{n}")
        os.makedirs(src)
        for name in imgs[:n]:
            os.symlink(os.path.join(init_dir, "images", name),
                       os.path.join(src, name))
        t = time.time()
        bg = du.median_background(src, None, os.path.join(
            TOOL_DIR, f"bg{n}.png"), device="cuda")
        wall = time.time() - t
        stack = torch.from_numpy(np.stack(
            [read_png(os.path.join(src, f))[..., :3] for f in imgs[:n]]))
        gpu_stack = stack.cuda()
        out[f"median_ms {n}"] = cuda_ms(lambda: du.median_stack(gpu_stack),
                                        reps=3)
        del gpu_stack
        medians[n] = (bg, stack, wall)

    # (e) starts here as the CLI in a process of its own, beside the CPU's
    # checks of (a) and (b), and (c) and (d)
    pipe_dir = os.path.join(TOOL_DIR, "pipe")
    os.makedirs(pipe_dir)
    t_pipe = time.time()
    pipe_log = open(os.path.join(pipe_dir, "run.log"), "w")
    pipe = subprocess.Popen(
        [sys.executable, "-m", "moco_flow_tpu_torch.scripts.drive_pipeline_e2e",
         "--steps", str(TOOL_PIPE_STEPS), "--base", pipe_dir, "--device",
         "cuda", "--occ_eval", "0"], cwd=HERE, stdout=pipe_log,
        stderr=subprocess.STDOUT)
    try:
        t = time.time()
        cpu = [draw(i, "cpu") for i in range(TOOL_CPU_VIEWS)]
        cpu_ms = (time.time() - t) / TOOL_CPU_VIEWS * 1e3
        n_px = TOOL_SIZE * TOOL_SIZE
        for i, want in enumerate(cpu):
            got = draw(i, "cuda").cpu()
            a_off = int((got[..., 3] != want[..., 3]).sum())
            both = (got[..., 3] > 0) & (want[..., 3] > 0)
            rgb = (got[..., :3] - want[..., :3]).abs()[both]
            rgb_err = rgb.max().item() if rgb.numel() else 0.0
            png = read_png(os.path.join(init_dir, "images", imgs[i]))
            if a_off > 1e-4 * n_px or rgb_err > 1e-5 or not np.array_equal(
                    png, du.rgba_bytes(got)):
                raise AssertionError(
                    f"[24a] view {i}: alpha differs on {a_off} pixels, rgb "
                    f"{rgb_err:.3e}, or its PNG is not the card's render")
            log(f"[24a] view {i} at {TOOL_SIZE}^2: card vs CPU plain "
                f"version: alpha off on {a_off} of {n_px} pixels (bound "
                f"0.01%), max |d rgb| {rgb_err:.3e} where both cover (bound "
                f"1e-5); {int(both.sum())} covered pixels")
        log(f"[24a] rasterize_mesh, {len(smpl.faces)} faces at "
            f"{TOOL_SIZE}^2: {card_ms[0]:.2f} / {card_ms[1]:.2f} ms a view "
            f"on the card (CUDA events), {cpu_ms:.1f} ms a view by the CPU "
            f"plain version (host clock, {TOOL_CPU_VIEWS} views, beside "
            f"(e)); create_init_nerf_data of {TOOL_VIEWS} views "
            f"{build_s:.2f} s (host clock, PNG writes included); train.json "
            f"/ val.json equal to the bit to a second run, on {card}")
        out["cpu_view_ms"] = cpu_ms
        for n, (bg, stack, wall) in medians.items():
            want = du.median_stack(stack).numpy()
            t = time.time()
            ref = np.median(stack.numpy(), axis=0).astype(np.uint8)
            np_ms = (time.time() - t) * 1e3
            if not (np.array_equal(bg, want) and np.array_equal(bg, ref)):
                raise AssertionError(f"[24b] median of {n} frames differs "
                                     "from the CPU plain version or "
                                     "np.median")
            log(f"[24b] median_background of {n} frames at {TOOL_SIZE}^2: "
                f"the median {out[f'median_ms {n}']:.2f} ms on the card "
                f"(CUDA events), np.median {np_ms:.1f} ms (host clock, "
                f"beside (e)); the call {wall:.2f} s with its PNG reads and "
                f"write; equal to the CPU plain version and to np.median on "
                f"{card}")
        del medians
        _toolchain_cd(card, out, init_dir)
        pipe.wait(timeout=PIPE_TIMEOUT)
    finally:
        if pipe.poll() is None:
            pipe.kill()
            pipe.wait()
        pipe_log.close()
    wall = time.time() - t_pipe
    with open(os.path.join(pipe_dir, "run.log")) as f:
        lines = f.read().splitlines()
    done = [ln for ln in lines if ln.startswith("PIPELINE OK ")]
    if pipe.returncode != 0 or not done:
        raise AssertionError("[24e] drive_pipeline_e2e failed (rc "
                             f"{pipe.returncode}):\n" + "\n".join(lines[-30:]))
    res = json.loads(done[-1][len("PIPELINE OK "):])
    for ln in lines:
        if ln.startswith("== "):
            log(f"[24e] {ln[3:]}")
    log(f"[24e] python -m moco_flow_tpu_torch.scripts.drive_pipeline_e2e "
        f"--steps {TOOL_PIPE_STEPS}: PSNR {res['psnr']:.4f}, SSIM "
        f"{res['ssim']:.4f} (render-nothing baseline "
        f"{res['baseline_psnr']:.4f} dB); {wall:.1f} s beside the CPU's "
        f"checks, (c) and (d) on {card}")
    out["pipeline"] = res
    log(f"[24] phase 24 took {time.time() - t_phase:.1f} s on {card}")
    return out


def _toolchain_cd(card: str, out: dict, init_dir: str):
    """Phase 24 (c) and (d); their launches go to ``out["launches"]``."""
    from moco_flow_tpu_torch.scripts import convert_ref_ckpt as conv
    from moco_flow_tpu_torch.train.__main__ import main as train_main
    from moco_flow_tpu_torch.train.checkpoint import load_checkpoint
    from moco_flow_tpu_torch.utils.config import dump_config, load_yaml

    # (c) two init_nerf.yaml steps on the views
    cfg = load_yaml(os.path.join(CONFIGS, "init_nerf.yaml"))
    cfg["dataloader"]["root_dir"] = init_dir
    cfg["save_dir"] = os.path.join(TOOL_DIR, "log")
    cfg["trainer"].update(num_iters=2, val_every_n_step=0,
                          save_every_n_step=0)
    path = os.path.join(TOOL_DIR, "init_nerf.yaml")
    dump_config(cfg, path)
    t = time.time()
    tr, got = _count_launches(lambda: train_main(
        ["-c", path, "-n", "run", "-s", "0", "--device", DEVICE,
         "--num_devices", "1"]))
    wall = time.time() - t
    for k, v in got.items():
        out["launches"][k] += v
    losses = {k: float(v) for k, v in tr.losses.items()}
    if tr.clock.step != 2 or tr.num_frames != TOOL_VIEWS or not all(
            np.isfinite(list(losses.values()))) or not os.path.exists(
            os.path.join(tr.job_dir, "ckpts", "final.npz")):
        raise AssertionError(f"[24c] step {tr.clock.step}, frames "
                             f"{tr.num_frames}, losses {losses}")
    log(f"[24c] init_nerf.yaml, 2 steps on the {TOOL_VIEWS} views: "
        f"{wall:.1f} s with the dataset's set-up, losses "
        f"{json.dumps(losses)}, launches "
        f"{json.dumps({k: v for k, v in got.items() if v})} on {card}")
    del tr
    torch.cuda.empty_cache()

    # (d) a reference .pth of a c2f-wide model through the converter's CLI
    cfg = slice_config()
    cfg["model"]["compute_dtype"] = "float32"
    seed = seeded_checkpoint(cfg, os.path.join(TOOL_DIR, "seeded"))
    tree, extra = load_checkpoint(seed)
    c2f = os.path.join(CONFIGS, "c2f.yaml")
    save_dict, skipped = conv.reverse_checkpoint(
        tree, extra, **conv.config_channels(c2f))
    pth = os.path.join(TOOL_DIR, "reference.pth")
    torch.save(save_dict, pth)
    stem = os.path.join(TOOL_DIR, "converted")
    conv.main([pth, stem, "--config", c2f])
    scene = make_synthetic_scene(None, n_frames=8, size=256, focal=300.0)
    frames = []
    for ckpt in (seed, stem + ".npz"):
        args = parse_args(["-c", "(dict)", "-r", ckpt, "--render_gt",
                           "--reso", "256", "--device", "cuda"])
        tt = test(copy.deepcopy(cfg), args, scene=scene)
        rays = tt.val_dataset.frame_rays(0)
        res, got = _count_launches(lambda: tt.render_rays_chunked(
            rays, tt.val_dataset.bkgd_img, tt.rcfg_test,
            anneal=tt.anneal()))
        for k, v in got.items():
            out["launches"][k] += v
        frames.append(res["rgb_fine"])
        del tt
    if not torch.equal(frames[0], frames[1]) or not torch.isfinite(
            frames[0]).all():
        raise AssertionError("[24d] the converted model's frame differs "
                             "from the original's")
    log(f"[24d] c2f-wide seeded model -> reverse_checkpoint -> "
        f"reference.pth ({len(save_dict) - 1} nets, skipped {skipped}) -> "
        f"convert_ref_ckpt --config c2f.yaml: its 256^2 fp32 frame equals "
        f"the original's to the bit on {card}")


def main():
    card = phase_card()
    dev = torch.device("cuda")
    phase_build()
    torch.cuda.synchronize()
    phase_wg_probe(dev)
    k = phase_kernel_vs_plain(dev)
    phase_golden(dev)
    launches = phase_slice(card)
    torch.cuda.synchronize()
    tk = phase_train_kernels(dev, card)
    torch.cuda.synchronize()
    phase_train_golden(dev)
    torch.cuda.synchronize()
    tsl = phase_train_slice(card)
    torch.cuda.synchronize()
    nk = phase_nof_kernels(dev, card)
    torch.cuda.synchronize()
    phase_phases_golden(dev)
    torch.cuda.synchronize()
    psl = phase_phases_slice(card)
    torch.cuda.synchronize()
    mk = phase_mlp_kernels(dev, card)
    torch.cuda.synchronize()
    phase_stage1_golden(dev)
    torch.cuda.synchronize()
    s1 = phase_stage1_slice(card)
    torch.cuda.synchronize()
    pf = phase_pallas_frame(card)
    torch.cuda.synchronize()
    phase_stage2_golden(dev)
    torch.cuda.synchronize()
    s2 = phase_stage2_slice(card)
    torch.cuda.synchronize()
    ps = phase_pallas_steps(card)
    torch.cuda.synchronize()
    ho = phase_handover(card, s1["float32"]["final"], s2["final"])
    torch.cuda.synchronize()
    cli = phase_cli(card)
    torch.cuda.synchronize()
    occ = phase_occupancy(card)
    torch.cuda.synchronize()
    occ_cli = phase_occ_cli(card, cli)
    torch.cuda.synchronize()
    t22 = time.time()
    p22 = [phase_student(card, occ)]
    del occ["trainer"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    p22.append(phase_hashgrid(card))
    p22.append(phase_hybrids(card))
    p22.append(phase_options(card, p22[-1].pop("trainer")))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[22] phase 22 took {time.time() - t22:.1f} s on {card}")
    dp = phase_dp(card)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    tool = phase_toolchain(card)
    torch.cuda.synchronize()
    fine = k["times"]["fine S=256 N=4096 nof bf16"]
    n_fine = 4096 * 256
    rp_work = (2 * (NERF_MACS + NOF_MACS) * n_fine,
               n_fine * (4 + 16) + 4096 * 6 * 4)
    rp_bound, rp_by = bound_ms(*rp_work, "bf16")
    log(f"[3 kernel vs plain] render_pass bound at fine S=256 N=4096 nof: "
        f"bf16 {rp_bound:.4f} ms, fp32 {bound_ms(*rp_work, 'fp32')[0]:.4f} ms "
        f"({rp_by}: {rp_work[0] / 1e12:.3f} TFLOP)")
    # the CLI paths of phases 20 and 21, phase 21's occupancy path,
    # phase 22's student, hash-grid, hybrid and option paths, phase 23's
    # ranks and phase 24's training CLI and converted model's frames
    cl = {k: cli["launches"][k] + occ["launches"][k]
          + occ_cli["launches"][k] + sum(p["launches"][k] for p in p22)
          + dp["launches"][k] + tool["launches"][k]
          for k in cli["launches"]}
    ce = {k: max(d.get(k, 0.0) for d in (cli["err"], occ["err"],
                                         occ_cli["err"],
                                         *(p["err"] for p in p22)))
          for k in cl}
    kernels = [{
        "name": "render_pass", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES, "launches": launches + cl["render_pass"],
        "max_abs_err": max(k["max_abs_err"], ce.get("render_pass", 0.0)),
        "ms": fine[0], "plain_ms": fine[1],
        "bound_ms": rp_bound, "bound_by": rp_by, "library_ms": None}]
    for name, src, rep in TRAIN_KERNELS:
        t = tk["times"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": (tsl["launches"][name] + ho["launches"][name]
                         + cl[name]),
            "max_abs_err": max(tk["err"][name], ce.get(name, 0.0)),
            "ms": t[0], "plain_ms": t[1],
            "bound_ms": t[2], "bound_by": t[3], "library_ms": None})
    for name, src, rep in NOF_KERNELS:
        t = nk["times"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": (psl["launches"][name] + s2["launches"][name]
                         + ho["launches"][name] + cl[name]),
            "max_abs_err": max(nk["err"][name], ce.get(name, 0.0)),
            "ms": t[0], "plain_ms": t[1],
            "bound_ms": t[2], "bound_by": t[3], "library_ms": None})
    # #8 runs on three main paths (the stage-1 steps and val steps of phase
    # 14, the pallas frames of phase 15, the pallas stage-3 steps and val
    # steps of phase 18), #9 on the last two
    mlp_launches = {k: pf["launches"][k] + ps["launches"][k] + cl[k]
                    for k in ("nerf_pallas", "nof_pallas")}
    mlp_launches["nerf_pallas"] += s1["launches"]
    for name, rep in MLP_KERNELS:
        t = mk["times"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": MLP_SOURCE,
            "replaces": rep, "launches": mlp_launches[name],
            "max_abs_err": max(mk["err"][name], ps["err"][name],
                               ce.get(name, 0.0)),
            "ms": t[0], "plain_ms": t[1],
            "bound_ms": t[2], "bound_by": t[3], "library_ms": None})
    for kern in kernels:
        if kern["launches"] <= 0:
            raise AssertionError(f"{kern['name']}: no launch on its main path")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
