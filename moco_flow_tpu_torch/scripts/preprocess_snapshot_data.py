"""People-Snapshot preprocessing CLI: the dataset's ground-truth camera,
shape and poses -> the MoCo-Flow JSON schema.

Port of ``scripts/preprocess_snapshot_data.py``:

    python -m moco_flow_tpu_torch.scripts.preprocess_snapshot_data \
        --input_video data/male-3-casual.mp4 --output_folder data/m3c \
        [--start_frame 0] [--end_frame -1] [--interval 1] [--gender m] \
        [--skip_matting] [--device cuda|cpu]

Clips the video (cv2), mattes the person (RobustVideoMatting), takes the
median background, reads the GT ``camera.pkl`` / ``consensus.pkl`` /
``reconstructed_poses.hdf5`` (h5py) from the directory named like the video
and writes a VIBE-schema ``converted.pkl``, then ``train.json`` /
``val.json`` and the init_nerf renders. cv2, h5py and the matting model are
needed only by the steps that use them.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import pickle

import numpy as np

from ..train.__main__ import require_device
from ..utils.image import read_png
from .data_utils import (
    clip_video,
    create_init_nerf_data,
    create_moco_flow_data,
    median_background,
    run_matting,
)


def load_pickle(path: str):
    """A People-Snapshot annotation pickle (written by Python 2: latin1).
    The files are trusted dataset downloads."""
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def convert_snapshot_gt(gt_dir: str, out_pkl: str, start_frame: int,
                        end_frame: int, interval: int = 1):
    """People-Snapshot GT (camera.pkl / consensus.pkl /
    reconstructed_poses.hdf5) -> a VIBE-schema pkl: per-frame pose and
    trans from the hdf5 over ``range(start_frame, end_frame, interval)``,
    the one consensus beta vector for every frame, sequential frame_ids.

    Returns ``(converted_dict, focal, camera_c)``.
    """
    import h5py
    camera = load_pickle(osp.join(gt_dir, "camera.pkl"))
    consensus = load_pickle(osp.join(gt_dir, "consensus.pkl"))
    idx = list(range(start_frame, end_frame, interval))
    with h5py.File(osp.join(gt_dir, "reconstructed_poses.hdf5"),
                   "r") as poses_h5:
        converted = {1: {
            "frame_ids": np.arange(len(idx)),
            "betas": np.stack([np.asarray(consensus["betas"]) for _ in idx]),
            "pose": np.stack([poses_h5["pose"][i] for i in idx]),
            "transls": np.stack([poses_h5["trans"][i] for i in idx]),
        }}
    with open(out_pkl, "wb") as f:
        pickle.dump(converted, f)
    focal = float(np.asarray(camera["camera_f"])[0])
    c = np.asarray(camera["camera_c"])
    return converted, focal, c


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="People-Snapshot -> MoCo-Flow")
    ap.add_argument("--input_video", required=True,
                    help="People-Snapshot subject video (.mp4); the GT pkls "
                         "are expected in the same-named directory")
    ap.add_argument("--output_folder", required=True)
    ap.add_argument("--start_frame", type=int, default=0)
    ap.add_argument("--end_frame", type=int, default=-1)
    ap.add_argument("--interval", type=int, default=1)
    ap.add_argument("--gender", default="m")
    ap.add_argument("--skip_matting", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu for the plain versions")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    require_device(args.device)
    out = args.output_folder
    os.makedirs(osp.join(out, "images_w_bkgd"), exist_ok=True)

    n = clip_video(args.input_video, osp.join(out, "images_w_bkgd"),
                   args.start_frame,
                   None if args.end_frame == -1 else args.end_frame)
    end_frame = args.end_frame if args.end_frame != -1 else args.start_frame + n
    print(f"extracted {n} frames")

    if not args.skip_matting:
        run_matting(osp.join(out, "images_w_bkgd"), osp.join(out, "images"),
                    device=args.device)
    median_background(osp.join(out, "images_w_bkgd"), None,
                      osp.join(out, "background.png"), device=args.device)

    gt_dir = args.input_video.replace(".mp4", "")
    _, focal, c = convert_snapshot_gt(gt_dir, osp.join(out, "converted.pkl"),
                                      args.start_frame, end_frame,
                                      args.interval)

    h, w = read_png(osp.join(out, "images_w_bkgd", "0000.png")).shape[:2]
    create_moco_flow_data(osp.join(out, "converted.pkl"), (h, w), focal=focal,
                          c=c, gender=args.gender)
    create_init_nerf_data(osp.join(out, "converted.pkl"), (h, w), focal=focal,
                          c=c, gender=args.gender, device=args.device)
    print(f"dataset ready at {out}")


if __name__ == "__main__":
    main()
