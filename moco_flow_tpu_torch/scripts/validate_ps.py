"""People-Snapshot quality runbook: one command from the GT annotations to
PSNR / SSIM (/ LPIPS).

Port of ``scripts/validate_ps.py``:

    # real data, train from scratch and evaluate:
    python -m moco_flow_tpu_torch.scripts.validate_ps \
        --gt_dir data/male-3-casual --work build/vps --steps 200000

    # real data, evaluate a converted reference stage-3 checkpoint:
    python -m moco_flow_tpu_torch.scripts.validate_ps \
        --gt_dir data/male-3-casual --work build/vps \
        --ref_ckpt ref/ckpts/model_200000.pth

    # no data: the whole chain on fabricated fixtures (the CPU test runs
    # this with --device cpu --reso 24 --frames 2 --steps 6):
    python -m moco_flow_tpu_torch.scripts.validate_ps --fixtures

The chain: the GT triplet (``camera.pkl`` / ``consensus.pkl`` /
``reconstructed_poses.hdf5``, read with h5py) -> ``converted.pkl`` ->
``train.json`` / ``val.json`` and the init_nerf views
(``preprocess_snapshot_data.py``, ``data_utils.py``) -> three stages
through ``python -m moco_flow_tpu_torch.train`` (or ``--ref_ckpt``
through ``convert_ref_ckpt.py``) -> ``python -m moco_flow_tpu_torch.test
--eval_metrics``, whose JSON is printed with the mode as the last line.
LPIPS is added where ``$LPIPS_WEIGHTS_NPZ`` names the weights
(``nn/lpips.py``). ``--fixtures`` fabricates a schema-exact GT triplet, a
synthetic SMPL pickle and the frames, drawn by ``rasterizer.py``; real
data needs the frame images at ``<work>/data/images``
(``preprocess_snapshot_data.py`` extracts and mattes them).
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import pickle
import subprocess
import sys

import numpy as np
import torch

from ..geometry.smpl import save_smpl_data, synthetic_smpl_data
from ..train.__main__ import require_device
from ..train.checkpoint import save_checkpoint
from ..utils.config import dump_config
from ..utils.image import write_png
from .convert_ref_ckpt import convert_checkpoint
from .data_utils import (create_init_nerf_data, create_moco_flow_data,
                         posed_vertices, position_colors, rgba_bytes)
from .drive_pipeline_e2e import (REPO, moco_config, nerf_config, nof_config,
                                 run_stage)
from .preprocess_snapshot_data import convert_snapshot_gt
from .rasterizer import rasterize_mesh


def fabricate_fixtures(work: str, n_frames: int, reso: int, focal: float):
    """A schema-exact GT triplet and a synthetic SMPL pickle: the stand-in
    for a real People-Snapshot subject directory. Returns (GT dir, SMPL
    dir, the SMPL body)."""
    import h5py
    gt_dir = osp.join(work, "gt")
    os.makedirs(gt_dir, exist_ok=True)
    rng = np.random.default_rng(1)
    smpl = synthetic_smpl_data(256, seed=1)
    smpl_dir = osp.dirname(save_smpl_data(smpl, osp.join(work, "smpl")))

    poses = np.zeros((n_frames, 72), np.float32)
    poses[:, 3:] = rng.normal(scale=0.08, size=(n_frames, 69))
    trans = np.tile(np.array([0.0, 0.0, 2.8], np.float32), (n_frames, 1))
    with open(osp.join(gt_dir, "camera.pkl"), "wb") as f:
        pickle.dump({"camera_f": np.array([focal, focal]),
                     "camera_c": np.array([reso / 2, reso / 2]),
                     "camera_k": np.zeros(5)}, f)
    with open(osp.join(gt_dir, "consensus.pkl"), "wb") as f:
        pickle.dump({"betas": np.zeros(10, np.float32)}, f)
    with h5py.File(osp.join(gt_dir, "reconstructed_poses.hdf5"), "w") as h5:
        h5.create_dataset("pose", data=poses)
        h5.create_dataset("trans", data=trans)
    return gt_dir, smpl_dir, smpl


def rasterize_frames(root: str, smpl, size, device):
    """The fixture subject's frame images: each frame's posed SMPL in the
    position colour map under the dataset's camera (``camera_pose``
    diag(1,-1,-1,1)), drawn on ``device``."""
    with open(osp.join(root, "train.json")) as f:
        meta = json.load(f)
    cam_c = np.asarray(meta["camera_c"], np.float32)
    out_dir = osp.join(root, "images")
    os.makedirs(out_dir, exist_ok=True)
    for fr in meta["frames"]:
        verts = posed_vertices(smpl, fr["pose"], fr["betas"], fr["transl"],
                               device)
        rgba = rasterize_mesh(verts, smpl.faces, position_colors(verts),
                              np.asarray(fr["camera_pose"], np.float32),
                              float(meta["camera_focal"]), cam_c, size,
                              bkgd=1.0, device=device)
        write_png(osp.join(out_dir, fr["file_path"]), rgba_bytes(rgba))


def build_dataset(gt_dir: str, work: str, size, smpl=None, device="cuda"):
    """GT triplet -> converted.pkl -> train/val.json + init_nerf data (the
    convert_snapshot_gt leg of ``preprocess_snapshot_data.py``). Returns
    (dataset root, focal)."""
    import h5py
    root = osp.join(work, "data")
    os.makedirs(root, exist_ok=True)
    with h5py.File(osp.join(gt_dir, "reconstructed_poses.hdf5"), "r") as h5:
        n = h5["pose"].shape[0]
    pkl = osp.join(root, "converted.pkl")
    _, focal, c = convert_snapshot_gt(gt_dir, pkl, 0, n, 1)
    create_moco_flow_data(pkl, size, focal=focal, c=c)
    create_init_nerf_data(pkl, size, focal=focal, c=c, num_images=12,
                          smpl_data=smpl, device=device)
    return root, focal


def eval_ckpt(cfg_path: str, env: dict, reso: int, budget: int, probe: int,
              max_frames: int | None, timeout: int, device: str) -> dict:
    """``python -m moco_flow_tpu_torch.test --eval_metrics`` on the config's
    newest checkpoint; its metrics JSON."""
    cmd = [sys.executable, "-m", "moco_flow_tpu_torch.test", "-c", cfg_path,
           "--render_gt", "--reso", str(reso), "--eval_metrics",
           "--fine_budget", str(budget), "--coarse_probe", str(probe),
           "--device", device]
    if max_frames:
        cmd += ["--eval_max_frames", str(max_frames)]
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=timeout)
    if r.returncode != 0:
        raise RuntimeError(f"eval failed (rc {r.returncode}):\n"
                           f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
    for line in reversed(r.stdout.strip().splitlines()):
        try:
            return json.loads(line)
        except json.JSONDecodeError:
            continue
    raise RuntimeError("no metrics JSON in the test CLI's output")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="People-Snapshot quality "
                                             "runbook")
    ap.add_argument("--gt_dir", default=None,
                    help="People-Snapshot subject GT dir (camera.pkl + "
                         "consensus.pkl + reconstructed_poses.hdf5); frame "
                         "images must already be at <work>/data/images")
    ap.add_argument("--fixtures", action="store_true",
                    help="no real data: fabricate the GT triplet, SMPL "
                         "pickle and frames, then run the same chain")
    ap.add_argument("--work", default=osp.join(REPO, "build", "validate_ps"))
    ap.add_argument("--reso", type=int, default=512)
    ap.add_argument("--frames", type=int, default=4,
                    help="fixture mode: number of fabricated frames")
    ap.add_argument("--steps", type=int, default=600,
                    help="training steps a stage (not with --ref_ckpt); the "
                         "reference trains 200k / 600k / 2.2M")
    ap.add_argument("--ref_ckpt", default=None,
                    help="reference stage-3 .pth: convert and evaluate it "
                         "instead of training")
    ap.add_argument("--eval_budget", type=int, default=0,
                    help="test --fine_budget (0 = exact sampling)")
    ap.add_argument("--eval_probe", type=int, default=0)
    ap.add_argument("--eval_max_frames", type=int, default=None)
    ap.add_argument("--stage_timeout", type=int, default=100000)
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu for the plain versions")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    require_device(args.device)
    os.makedirs(args.work, exist_ok=True)
    smpl = None
    if args.fixtures:
        gt_dir, smpl_dir, smpl = fabricate_fixtures(
            args.work, args.frames, args.reso, focal=args.reso * 1.2)
        env = dict(os.environ, SMPL_MODEL_DIR=smpl_dir)
    else:
        if not args.gt_dir:
            raise SystemExit("--gt_dir or --fixtures required")
        gt_dir, env = args.gt_dir, dict(os.environ)

    size = (args.reso, args.reso)
    root, _ = build_dataset(gt_dir, args.work, size, smpl=smpl,
                            device=args.device)
    if args.fixtures:
        rasterize_frames(root, smpl, size, args.device)

    save = osp.join(args.work, "save")

    def sized(cfg):
        cfg["dataloader"]["size"] = [args.reso, args.reso]
        cfg["dataloader"]["val_size"] = [args.reso, args.reso]
        cfg["trainer"]["num_iters"] = args.steps
        cfg["trainer"]["val_every_n_step"] = 0
        cfg["trainer"]["save_every_n_step"] = 0
        return cfg

    c3 = sized(moco_config(root, save))
    if args.ref_ckpt:
        # a reference checkpoint holds Python objects (its clock and
        # optimizer state); the file is the user's own
        ckpt = torch.load(args.ref_ckpt, map_location="cpu",
                          weights_only=False)
        tree, extra, skipped = convert_checkpoint(ckpt)
        if skipped:
            print(f"converter skipped: {skipped}", file=sys.stderr)
        stem = osp.join(args.work, "ref_converted")
        save_checkpoint(stem, tree, extra)
        c3["model"]["pretrained_path"] = stem + ".npz"
    else:
        c1 = sized(nerf_config(osp.join(root, "init_nerf"), save))
        ck1 = run_stage(c1, "s1", args.work, save, env, args.stage_timeout,
                        args.device)
        ck2 = run_stage(sized(nof_config(root, save)), "s2", args.work,
                        save, env, args.stage_timeout, args.device)
        c3["model"]["pretrained_nerf"] = ck1
        c3["model"]["pretrained_nof"] = ck2
        c3["model"]["coarse_to_fine"] = args.steps >= 20000
        run_stage(c3, "s3", args.work, save, env, args.stage_timeout,
                  args.device)

    cfg_path = osp.join(args.work, "s3.yaml")
    dump_config(c3, cfg_path)
    metrics = eval_ckpt(cfg_path, env, args.reso, args.eval_budget,
                        args.eval_probe, args.eval_max_frames,
                        args.stage_timeout, args.device)
    out = {"mode": "ref_ckpt" if args.ref_ckpt else "trained",
           "work": args.work, **metrics}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
