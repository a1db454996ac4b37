"""Rendering / evaluation CLI of the port (counterpart of the root test.py).

    python -m moco_flow_tpu_torch.test -c cfg.yaml [-r ckpt.npz] --render_gt \
        --reso N [--eval_metrics [--eval_max_frames K]] [--render_frame F] \
        [--device cuda|cpu]

Renders the validation sequence of a stage-3 checkpoint (a ``.npz`` written
by either package) at test time. ``--eval_metrics`` prints mean PSNR / SSIM
/ DSSIM as JSON; ``--render_frame F`` writes a GT | prediction | depth PNG
(frame -1: the canonical space). ``test(config, args)`` takes the config as
a dict, so callers can skip YAML. The config's ``model.mlp_impl`` picks the
kernels (``train/factory.py::render_config``): ``pallas`` renders through
the per-op MLPs #8/#9, where ``--fine_budget`` / ``--coarse_probe`` raise.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp

import numpy as np

from .train.checkpoint import find_latest_checkpoint
from .train.stage_mocoflow import MoCoFlowTrainer

# test.py modes of the JAX package that wait for a later slice
_NOT_PORTED = {
    "render_training_poses": "ROADMAP 'Modules to port' item 4",
    "render_spherical_poses": "ROADMAP 'Modules to port' item 4",
    "render_bullet_time": "ROADMAP 'Modules to port' item 4",
    "extract_mesh": "ROADMAP 'Modules to port' item 4 (needs ops/mcubes)",
    "test_json": "ROADMAP 'Modules to port' item 4",
    "occ_res": "ROADMAP 'Modules to port' item 6",
}


def render_frame(trainer: MoCoFlowTrainer, frame_idx: int,
                 save_path: str) -> np.ndarray:
    """GT | pred | depth strip of one val frame as a PNG; frame -1 renders
    the canonical space (no NoF warp) from frame 0's camera. The depth panel
    is min-max normalized gray."""
    ds = trainer.val_dataset
    idx = frame_idx if frame_idx != -1 else 0
    rcfg = trainer.rcfg_test if frame_idx != -1 else trainer.rcfg_test_cano
    res = trainer.render_rays_chunked(ds.frame_rays(idx), ds.bkgd_img, rcfg,
                                      anneal=trainer.anneal())
    typ = "fine" if "rgb_fine" in res else "coarse"
    h, w = ds.size
    img = res[f"rgb_{typ}"].reshape(h, w, 3).float().cpu().numpy()
    depth = res[f"depth_{typ}"].reshape(h, w).float().cpu().numpy()
    depth = (depth - depth.min()) / (depth.max() - depth.min() + 1e-8)
    panels = [img, np.repeat(depth[..., None], 3, axis=-1)]
    gt = ds.frame_rgbs(idx)
    if gt is not None:
        panels.insert(0, gt.reshape(h, w, 3).numpy())
    strip = np.concatenate(panels, axis=1)
    from PIL import Image
    name = f"frame_{frame_idx}" if frame_idx != -1 else "canonical"
    out = osp.join(save_path, f"images_step_{trainer.step}", f"{name}.png")
    os.makedirs(osp.dirname(out), exist_ok=True)
    Image.fromarray((np.clip(strip, 0, 1) * 255).astype(np.uint8)).save(out)
    return strip


def test(config: dict, args, smpl_data=None, scene=None) -> MoCoFlowTrainer:
    """Build the model, load the checkpoint and run the requested modes.

    ``scene``: an in-memory ``SyntheticScene`` in place of the files under
    ``dataloader.root_dir``."""
    for mode, item in _NOT_PORTED.items():
        if getattr(args, mode, None):
            raise NotImplementedError(f"--{mode} is not ported yet ({item})")
    if not args.render_gt:
        raise ValueError("provide --render_gt (--test_json is not ported)")
    config["dataloader"]["val_size"] = [args.reso, args.reso]
    config["model"]["pretrained_nerf"] = None
    config["model"]["pretrained_nof"] = None
    config["dataloader"]["bkgd"] = 1.0
    if getattr(args, "fine_budget", None) is not None:
        config["model"]["fine_budget"] = args.fine_budget
    if getattr(args, "coarse_probe", None) is not None:
        config["model"]["coarse_probe"] = args.coarse_probe
    seed = int(args.seed) if getattr(args, "seed", None) is not None else 0
    trainer = MoCoFlowTrainer(config, device=getattr(args, "device", "cuda"),
                              seed=seed, smpl_data=smpl_data, scene=scene)
    trainer.build_model(config["model"])
    ckpt = args.resume or find_latest_checkpoint(osp.join(
        config.get("save_dir", "./log"), config.get("exp_name", "exp"), "*",
        "ckpts", "*.npz"))
    if ckpt:
        trainer.load_ckpt(ckpt)
    trainer.prepare_dataloader(config["dataloader"])

    out_dir = args.out_dir or osp.join(config.get("save_dir", "./log"),
                                       config.get("exp_name", "exp"), "test")
    if args.render_frame is not None:
        render_frame(trainer, args.render_frame, out_dir)
    if args.eval_metrics:
        trainer.metrics = trainer.evaluate_sequence(
            max_frames=args.eval_max_frames)
        print(json.dumps(trainer.metrics))
    return trainer


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="test-time rendering (port)")
    p.add_argument("-c", "--config", required=True, type=str)
    p.add_argument("-r", "--resume", default=None, type=str)
    p.add_argument("-s", "--seed", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (the plain versions)")
    p.add_argument("--out_dir", default=None, type=str)
    p.add_argument("--reso", default=512, type=int)
    p.add_argument("--render_gt", action="store_true")
    p.add_argument("--render_frame", default=None, type=int)
    p.add_argument("--eval_metrics", action="store_true")
    p.add_argument("--eval_max_frames", default=None, type=int)
    p.add_argument("--fine_budget", default=None, type=int,
                   help="fine samples kept per ray (0/absent = all, exact)")
    p.add_argument("--coarse_probe", default=None, type=int,
                   help="strided coarse probe size, must divide N_samples "
                        "(0/absent = exact)")
    for mode in ("render_training_poses", "render_spherical_poses",
                 "render_bullet_time", "extract_mesh"):
        p.add_argument(f"--{mode}", action="store_true",
                       help=f"not ported yet ({_NOT_PORTED[mode]})")
    p.add_argument("--test_json", default=None, type=str,
                   help=f"not ported yet ({_NOT_PORTED['test_json']})")
    p.add_argument("--occ_res", default=None, type=int,
                   help=f"not ported yet ({_NOT_PORTED['occ_res']})")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import yaml
    path = args.config
    if args.resume:
        # as the JAX CLI: the config saved beside the checkpoint's run wins
        saved = osp.join(osp.dirname(osp.dirname(args.resume)), "config.yaml")
        if osp.exists(saved):
            path = saved
    with open(path) as f:
        config = yaml.safe_load(f)
    test(config, args)


if __name__ == "__main__":
    main()
