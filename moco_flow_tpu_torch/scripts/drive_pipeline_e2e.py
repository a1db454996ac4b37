"""End-to-end three-stage pipeline on a synthetic scene, through the CLIs.

Port of ``scripts/drive_pipeline_e2e.py``:

    python -m moco_flow_tpu_torch.scripts.drive_pipeline_e2e [--steps 600] \
        [--base build/pipe_e2e] [--device cuda|cpu] [--occ_eval 1]

Builds the synthetic scene (6 frames of 128^2), writes its SMPL body as
the SMPL pickle (``geometry/smpl.py::save_smpl_data``, so the CLIs' real
``load_smpl_data`` runs), renders stage 1's init_nerf views of the frame-0
posed body (``data_utils.create_init_nerf_data``, 12 views), then trains
stage 1 (canonical NeRF), stage 2 (NoF) and stage 3 (joint, from the
stage-1/2 ``final`` checkpoints) each as ``python -m
moco_flow_tpu_torch.train``, and evaluates with ``python -m
moco_flow_tpu_torch.test --eval_metrics`` through the fine-budget /
coarse-probe render. The eval PSNR must beat a render of nothing (the
white background) by 1 dB. With ``--occ_eval`` it then renders a frame of
the trained stage-3 field exactly and with occupancy skipping, and reports
the dB between them and both rays/s (CUDA events; not measured on the
CPU). The configs are small stage configs (NeRF 4x64, NoF 2x64) kept here.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import os.path as osp
import pickle
import subprocess
import sys
import time

import numpy as np
import torch

from ..data.synthetic import make_synthetic_scene
from ..geometry.smpl import save_smpl_data
from ..train import get_trainer
from ..train.__main__ import require_device
from ..utils.config import Config, dump_config, load_yaml
from ..utils.image import read_png
from .data_utils import create_init_nerf_data

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))


# -- the small stage configs ------------------------------------------------

def nerf_config(root: str, save_dir: str) -> dict:
    """Stage 1: a 4x64 coarse + fine NeRF, softplus, 'dir' extra."""
    return {
        "save_dir": save_dir, "exp_name": "t_nerf",
        "dataloader": {
            "type": "moco_flow", "root_dir": root, "imgs_dir": "images",
            "size": [48, 48], "val_size": [48, 48],
            "aabb": [[1.2, 1.2, 1.2], [0, 0, 0]], "bkgd": 1.0, "interval": 1,
        },
        "model": {
            "type": "nerf", "pretrained_path": None,
            "N_rand": 128, "chunk": 2048, "N_samples": 16, "N_importance": 16,
            "use_disp": False, "perturb": 1.0, "noise_std": 0.0,
            "nerf_activate_type": "softplus",
            "nerf_embedding_xyz": {"type": "Embedding", "in_channels": 3,
                                   "N_freqs": 6, "logscale": True},
            "nerf_embedding_dir": {"type": "Embedding", "in_channels": 3,
                                   "N_freqs": 4, "logscale": True},
            "nerf_embedding_ind": None,
            "coarse_NeRF": {"type": "NeRF", "D": 4, "W": 64,
                            "in_channels_xyz": 39, "skips": [2],
                            "extra_feat_type": "dir", "extra_feat_dim": 27},
            "fine_NeRF": {"type": "NeRF", "D": 4, "W": 64,
                          "in_channels_xyz": 39, "skips": [2],
                          "extra_feat_type": "dir", "extra_feat_dim": 27},
        },
        "loss": {"type": "MSE"},
        "optimizer": {"type": "radam", "lr": 5e-3, "weight_decay": 0},
        "scheduler": {"type": "steplr", "decay_step": [100000],
                      "decay_gamma": 0.5},
        "trainer": {"num_iters": 60, "val_every_n_step": 0,
                    "save_every_n_step": 0, "log_freq": 10},
    }


def _nof() -> dict:
    return {"type": "NoF", "D": 2, "W": 64, "in_channels_xyz": 33,
            "skips": [1], "extra_feat_type": "ind", "extra_feat_dim": 33,
            "use_quat": True}


def nof_config(root: str, save_dir: str) -> dict:
    """Stage 2: bw / fw NoFs of 2x64 with quaternion heads."""
    return {
        "save_dir": save_dir, "exp_name": "t_nof",
        "dataloader": {"type": "nof", "root_dir": root, "interval": 1},
        "model": {
            "type": "nof", "pretrained_path": None, "pretrained_nof": None,
            "N_sampled": 512,
            "nof_embedding_xyz": {"in_channels": 3, "N_freqs": 5,
                                  "logscale": True},
            "nof_embedding_ind": {"in_channels": 1, "N_freqs": 16,
                                  "logscale": True},
            "fw_NoF": _nof(), "bw_NoF": _nof(),
        },
        "loss": {"type": "L1"},
        "optimizer": {"type": "adam", "lr": 1e-3, "weight_decay": 0},
        "scheduler": {"type": "steplr", "decay_step": [300000],
                      "decay_gamma": 0.5},
        "trainer": {"num_iters": 40, "val_every_n_step": 0,
                    "save_every_n_step": 0, "log_freq": 10},
    }


def moco_config(root: str, save_dir: str, pretrained_nerf=None,
                pretrained_nof=None) -> dict:
    """Stage 3: stage 1's NeRF (relu, 'ind' extra) with stage 2's NoFs,
    both consensus chains, coarse-to-fine."""
    return {
        "save_dir": save_dir, "exp_name": "t_moco",
        "dataloader": {
            "type": "moco_flow", "root_dir": root, "imgs_dir": "images",
            "size": [48, 48], "val_size": [48, 48],
            "aabb": [[1.2, 1.2, 1.4], [0, 0, 0]], "bkgd": "rand",
            "interval": 1,
        },
        "model": {
            "type": "moco_flow", "pretrained_path": None,
            "pretrained_nerf": pretrained_nerf,
            "pretrained_nof": pretrained_nof,
            "coarse_to_fine": True,
            "N_rand": 64, "N_sampled": 128, "chunk": 2048,
            "N_samples": 12, "N_importance": 12, "use_disp": False,
            "perturb": 1.0, "noise_std": 0.0, "nerf_activate_type": "relu",
            "nof_embedding_xyz": {"in_channels": 3, "N_freqs": 5,
                                  "logscale": True},
            "nof_embedding_ind": {"in_channels": 1, "N_freqs": 16,
                                  "logscale": True},
            "fw_NoF": _nof(), "bw_NoF": _nof(),
            "nerf_embedding_xyz": {"in_channels": 3, "N_freqs": 6,
                                   "logscale": True},
            "nerf_embedding_dir": None,
            "nerf_embedding_ind": {"in_channels": 1, "N_freqs": 2,
                                   "logscale": True},
            "coarse_NeRF": {"type": "NeRF", "D": 4, "W": 64,
                            "in_channels_xyz": 39, "skips": [2],
                            "extra_feat_type": "ind", "extra_feat_dim": 5},
            "fine_NeRF": {"type": "NeRF", "D": 4, "W": 64,
                          "in_channels_xyz": 39, "skips": [2],
                          "extra_feat_type": "ind", "extra_feat_dim": 5},
        },
        "loss": {
            "chain_local": True, "nof_local_weight": 0.2,
            "chain_global": True, "nof_global_weight": 0.2,
            "img_loss": {"type": "MSE", "weight": 1},
            "nof_loss": {"type": "L1", "weight": 10},
            "msk_loss": {"type": "BCE", "weight": 10},
        },
        "optimizer": {
            "moco": {"type": "adam", "lr": 1e-3, "weight_decay": 0},
            "nof": {"type": "adam", "lr": 1e-3, "weight_decay": 0},
        },
        "scheduler": {"type": "steplr", "decay_step": [1050000],
                      "decay_gamma": 0.5},
        "trainer": {"num_iters": 30, "coarse2fine_start_iter": 8,
                    "coarse2fine_end_iter": 20, "val_every_n_step": 0,
                    "save_every_n_step": 0, "log_freq": 10},
    }


# -- the runbook's steps ----------------------------------------------------

def run_stage(cfg: dict, name: str, base: str, save: str, env: dict,
              timeout: int, device: str) -> str:
    """Train one stage through ``python -m moco_flow_tpu_torch.train`` and
    return its ``final`` checkpoint."""
    cfg["save_dir"] = save
    cfg["exp_name"] = name
    path = osp.join(base, f"{name}.yaml")
    dump_config(cfg, path)
    t = time.time()
    r = subprocess.run([sys.executable, "-m", "moco_flow_tpu_torch.train",
                        "-c", path, "-n", "job", "--device", device],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=timeout)
    print(f"== {name}: rc={r.returncode}, {time.time() - t:.1f} s",
          flush=True)
    if r.returncode != 0:
        raise RuntimeError(f"stage {name} failed (rc {r.returncode}):\n"
                           f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
    cks = glob.glob(osp.join(save, name, "*", "ckpts", "final.npz"))
    if not cks:
        raise RuntimeError(f"no final checkpoint for {name}")
    return cks[0]


def white_baseline_psnr(root: str, n_frames: int = 2) -> float:
    """PSNR of a pure-white render (an empty field on the white eval
    background) against the first ``n_frames`` GT images: the score of a
    model that learned nothing."""
    mses = []
    for p in sorted(glob.glob(osp.join(root, "images", "*")))[:n_frames]:
        g = read_png(p).astype(np.float32) / 255.0
        rgb = g[..., :3]
        if g.shape[-1] == 4:
            rgb = rgb * g[..., 3:4] + (1.0 - g[..., 3:4])
        mses.append(np.mean((rgb - 1.0) ** 2))
    return float(-10.0 * np.log10(np.mean(mses) + 1e-12))


def _rays_per_sec(fn, n_rays: int, reps: int, device) -> float | None:
    """Rays/s of ``fn`` over ``reps`` calls after a warm one, by CUDA
    events; None on the CPU (no device time to take)."""
    fn()
    if torch.device(device).type != "cuda":
        return None
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return n_rays * reps / (e0.elapsed_time(e1) / 1e3)


def occ_eval_trained_field(base: str, smpl, device: str, reso: int = 256,
                           occ_res: int = 64, frame: int = 1, reps: int = 3,
                           n_samples: int = 0) -> dict:
    """Occupancy skipping on the pipeline's trained stage-3 field (per-frame
    NoF warps): frame ``frame`` at ``reso``^2 rendered exactly and with the
    grid's tightening and ray skipping, the dB between the two and the rays/s
    of each."""
    cfg3 = load_yaml(osp.join(base, "s3.yaml"))
    cfg3["dataloader"]["val_size"] = [reso, reso]
    cfg3["model"]["occ_res"] = occ_res
    cfg3["model"]["pretrained_nerf"] = None
    cfg3["model"]["pretrained_nof"] = None
    if n_samples:
        cfg3["model"]["N_samples"] = n_samples
        cfg3["model"]["N_importance"] = n_samples
    cks = sorted(glob.glob(osp.join(base, "save", "s3", "*", "ckpts",
                                    "final.npz")))
    if not cks:
        raise RuntimeError(f"no trained stage-3 checkpoint under "
                           f"{base}/save/s3")
    trainer = get_trainer(Config(cfg3, mode="test"), device=device,
                          smpl_data=smpl)
    trainer.build_model(cfg3["model"])
    trainer.load_ckpt(cks[-1])
    trainer.prepare_dataloader(cfg3["dataloader"])
    ds = trainer.val_dataset
    trainer.num_frames = ds.num_frames
    rays = torch.as_tensor(ds.frame_rays(frame)).to(device, torch.float32)
    bg = torch.ones((rays.shape[0], 3), device=device)
    rcfg = trainer.rcfg_test
    out = {}

    def exact():
        out["exact"] = trainer.render_rays_chunked(rays, bg, rcfg,
                                                   anneal=trainer.anneal())

    def occ():
        rr = trainer.tighten_rays(rays, frame, size=ds.size)
        out["occ"] = trainer.render_masked_image(
            rr, trainer.occ_keep_mask(), bg, rcfg, anneal=trainer.anneal())

    with torch.no_grad():
        r_exact = _rays_per_sec(exact, rays.shape[0], reps, device)
        trainer.occupancy_grid(frame)     # the grid is built once a frame
        r_occ = _rays_per_sec(occ, rays.shape[0], reps, device)
    typ = "fine" if "rgb_fine" in out["exact"] else "coarse"
    mse = float(((out["occ"][f"rgb_{typ}"].float()
                  - out["exact"][f"rgb_{typ}"].float()) ** 2).mean())
    grid = trainer.occupancy_grid(frame)
    rec = {
        "metric": "trained_field_occ_eval", "device": str(device),
        "reso": reso, "occ_res": occ_res, "frame": frame,
        "n_samples": int(rcfg.n_samples),
        "n_importance": int(rcfg.n_importance),
        "render_exact_rays_per_sec": r_exact,
        "render_occ_skip_rays_per_sec": r_occ,
        "psnr_occ_vs_exact": -10.0 * float(np.log10(mse + 1e-12)),
        "empty_frac": float(trainer._occ_stats["empty_frac"]),
        "grid_occupancy_frac": float(grid.occupancy_fraction),
        "fine_budget": rcfg.fine_budget, "coarse_probe": rcfg.coarse_probe,
    }
    print("OCC_EVAL " + json.dumps(rec), flush=True)
    return rec


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="three-stage pipeline, end "
                                             "to end, on a synthetic scene")
    ap.add_argument("--base", default=osp.join(REPO, "build", "pipe_e2e"))
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--stage_timeout", type=int, default=2700)
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu for the plain versions")
    ap.add_argument("--occ_eval", type=int, default=1,
                    help="after the pipeline: occupancy skipping's dB and "
                         "rays/s on the trained stage-3 field at --occ_reso")
    ap.add_argument("--occ_reso", type=int, default=256)
    ap.add_argument("--occ_res", type=int, default=64)
    ap.add_argument("--occ_samples", type=int, default=0,
                    help="N_samples / N_importance of the occ eval (0 = the "
                         "training config's): at toy counts the quadrature "
                         "error of both renders exceeds the tau bound")
    ap.add_argument("--eval_budget", type=int, default=24,
                    help="test --fine_budget of the eval (0 = exact)")
    ap.add_argument("--eval_probe", type=int, default=6,
                    help="test --coarse_probe; must divide N_samples (12)")
    ap.add_argument("--occ_only", action="store_true",
                    help="only the occupancy eval, on an existing --base "
                         "(the seeded scene is rebuilt identically)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """The runbook; returns the eval metrics (PSNR, SSIM, ...), the
    baseline PSNR, the wall seconds and, with ``--occ_eval``, its record."""
    args = parse_args(argv)
    require_device(args.device)
    t0 = time.time()
    base = args.base
    os.makedirs(base, exist_ok=True)
    root = osp.join(base, "scene")
    smpl = make_synthetic_scene(root, n_frames=6, size=128, focal=150.0).smpl
    smpl_dir = osp.dirname(save_smpl_data(smpl, osp.join(base, "smpl")))

    if args.occ_only:
        return {"occ": occ_eval_trained_field(
            base, smpl, args.device, reso=args.occ_reso,
            occ_res=args.occ_res, n_samples=args.occ_samples)}

    save = osp.join(base, "save")
    env = dict(os.environ, SMPL_MODEL_DIR=smpl_dir)

    def quiet(cfg):
        cfg["trainer"]["num_iters"] = args.steps
        cfg["trainer"]["val_every_n_step"] = 0
        cfg["trainer"]["save_every_n_step"] = 0
        return cfg

    # Stage 1 trains on the init_nerf views of the static frame-0 body, as
    # the real pipeline does (one static NeRF fit to every frame of the
    # moving scene has contradictory supervision).
    fr0 = json.load(open(osp.join(root, "train.json")))["frames"][0]
    vibe_pkl = osp.join(base, "vibe.pkl")
    with open(vibe_pkl, "wb") as f:
        pickle.dump({1: {"frame_ids": np.arange(1),
                         "pose": np.asarray([fr0["pose"]], np.float32),
                         "betas": np.asarray([fr0["betas"]], np.float32),
                         "transls": np.asarray([fr0["transl"]],
                                               np.float32)}}, f)
    create_init_nerf_data(vibe_pkl, (128, 128), focal=150.0, num_images=12,
                          smpl_data=smpl, device=args.device)

    # softplus in stage 1 and relu in stage 3, as the published YAMLs: on
    # the static views the stage-1 body keeps positive raw sigma, so relu
    # keeps its volume and gradient after the hand-over
    ck1 = run_stage(quiet(nerf_config(osp.join(base, "init_nerf"), save)),
                    "s1", base, save, env, args.stage_timeout, args.device)
    ck2 = run_stage(quiet(nof_config(root, save)), "s2", base, save, env,
                    args.stage_timeout, args.device)
    c3 = quiet(moco_config(root, save))
    c3["model"]["pretrained_nerf"] = ck1
    c3["model"]["pretrained_nof"] = ck2
    # coarse-to-fine off at this scale: zeroing every PE band at the start
    # of stage 3 and ramping them back within a few hundred steps drives
    # the relu field's raw sigma below 0 everywhere first; the freeze
    # window still applies, scaled to the run
    c3["model"]["coarse_to_fine"] = False
    c3["trainer"]["coarse2fine_start_iter"] = max(1, args.steps // 10)
    c3["trainer"]["coarse2fine_end_iter"] = max(2, args.steps // 3)
    run_stage(c3, "s3", base, save, env, args.stage_timeout, args.device)

    t = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "moco_flow_tpu_torch.test", "-c",
         osp.join(base, "s3.yaml"), "--render_gt", "--reso", "128",
         "--eval_metrics", "--eval_max_frames", "2", "--fine_budget",
         str(args.eval_budget), "--coarse_probe", str(args.eval_probe),
         "--device", args.device],
        cwd=REPO, env=env, capture_output=True, text=True,
        timeout=args.stage_timeout)
    print(f"== test: rc={r.returncode}, {time.time() - t:.1f} s", flush=True)
    print(r.stdout[-600:])
    if r.returncode != 0:
        raise RuntimeError(f"eval failed (rc {r.returncode}):\n"
                           f"{r.stderr[-3000:]}")
    metrics = None
    for line in r.stdout.splitlines():
        line = line.strip()
        if line.startswith("{") and '"psnr"' in line:
            metrics = json.loads(line)
    if metrics is None:
        raise RuntimeError("no eval PSNR in the test CLI's output")
    # the eval must beat rendering nothing, else the pipeline shows only
    # that it runs, not that it learns
    base_psnr = white_baseline_psnr(root, n_frames=2)
    psnr = metrics["psnr"]
    print(f"== eval PSNR {psnr:.2f} SSIM {metrics['ssim']:.4f} vs "
          f"render-nothing baseline {base_psnr:.2f} (margin "
          f"{psnr - base_psnr:+.2f} dB)", flush=True)
    if not psnr > base_psnr + 1.0:
        raise RuntimeError(
            f"e2e PSNR {psnr:.2f} does not beat the pure-background "
            f"baseline {base_psnr:.2f} by 1 dB: the trained field renders "
            "(almost) nothing")
    out = dict(metrics, baseline_psnr=base_psnr, device=args.device,
               steps=args.steps)
    if args.occ_eval:
        out["occ"] = occ_eval_trained_field(
            base, smpl, args.device, reso=args.occ_reso,
            occ_res=args.occ_res, n_samples=args.occ_samples)
    out["wall_s"] = time.time() - t0
    print("PIPELINE OK " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
