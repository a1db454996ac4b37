"""In-the-wild preprocessing CLI: phone video -> MoCo-Flow training data.

Port of ``scripts/preprocess_data.py``:

    python -m moco_flow_tpu_torch.scripts.preprocess_data --video v.mp4 \
        --out_dir data/me [--vibe_pkl vibe_output.pkl | --vibe_dir VIBE] \
        [--skip_matting] [--size 1080 1080] [--focal 2000] \
        [--num_init_views 120] [--device cuda|cpu]

1. clip the video into frames (cv2);
2. alpha-matte the person (RobustVideoMatting, ``torch.hub``);
3. estimate the static background (per-pixel median, on the device);
4. run VIBE for per-frame SMPL pose estimates (an external checkout, as a
   subprocess), unless ``--vibe_pkl`` gives its output;
5. convert the VIBE pkl into ``train.json`` / ``val.json``;
6. render the init_nerf views of the frame-0 posed SMPL (on the device;
   the SMPL pickle from ``$SMPL_MODEL_DIR`` or ``./data/smpl``).

Steps 2 and 4 need the network or external tools and fail with a clear
error without them. ``--device cuda`` (the default) raises where there is
no card.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import shutil
import subprocess
import sys

from ..train.__main__ import require_device
from .data_utils import (
    clip_video,
    create_init_nerf_data,
    create_moco_flow_data,
    median_background,
    run_matting,
)


def run_vibe(vibe_dir: str, video_path: str, out_dir: str):
    """Run the external VIBE checkout's ``demo.py`` on the video."""
    if not vibe_dir or not osp.isdir(vibe_dir):
        raise RuntimeError(
            "VIBE repo not found; pass --vibe_dir or provide the vibe pkl "
            "directly with --vibe_pkl.")
    subprocess.run(
        [sys.executable, "demo.py", "--vid_file", osp.abspath(video_path),
         "--output_folder", osp.abspath(out_dir)],
        cwd=vibe_dir, check=True)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="video -> MoCo-Flow data")
    ap.add_argument("--video", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--end", type=int, default=None)
    ap.add_argument("--size", type=int, nargs=2, default=[1080, 1080])
    ap.add_argument("--focal", type=float, default=2000.0)
    ap.add_argument("--gender", default="neutral")
    ap.add_argument("--vibe_dir", default=None,
                    help="path to a VIBE checkout (external)")
    ap.add_argument("--vibe_pkl", default=None,
                    help="precomputed VIBE output pkl (skips VIBE)")
    ap.add_argument("--skip_matting", action="store_true")
    ap.add_argument("--num_init_views", type=int, default=120)
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu for the plain versions")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    require_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    raw_dir = osp.join(args.out_dir, "raw_images")
    imgs_dir = osp.join(args.out_dir, "images")

    n = clip_video(args.video, raw_dir, args.start, args.end, args.size)
    print(f"extracted {n} frames")

    if args.skip_matting:
        imgs_dir = raw_dir
    else:
        run_matting(raw_dir, imgs_dir, device=args.device)
        print("matting done")

    median_background(raw_dir, None, osp.join(args.out_dir, "background.png"),
                      device=args.device)

    pkl = args.vibe_pkl
    if pkl is None:
        vibe_out = osp.join(args.out_dir, "vibe")
        run_vibe(args.vibe_dir, args.video, vibe_out)
        pkl = osp.join(vibe_out, "vibe_output.pkl")
    # the JSONs land beside the pkl, so it goes into out_dir
    if osp.dirname(osp.abspath(pkl)) != osp.abspath(args.out_dir):
        shutil.copy(pkl, osp.join(args.out_dir, "vibe_output.pkl"))
        pkl = osp.join(args.out_dir, "vibe_output.pkl")

    create_moco_flow_data(pkl, args.size, focal=args.focal,
                          gender=args.gender)
    create_init_nerf_data(pkl, args.size, focal=args.focal,
                          gender=args.gender, num_images=args.num_init_views,
                          device=args.device)
    print(f"dataset ready at {args.out_dir}")


if __name__ == "__main__":
    main()
