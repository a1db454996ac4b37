"""Rendering / evaluation CLI of the port (counterpart of the root test.py).

    python -m moco_flow_tpu_torch.test -c cfg.yaml [-r ckpt.npz] [--reso N] \
        [--render_gt | --test_json path] [--render_training_poses] \
        [--render_spherical_poses [--spherical_poses_frame F]] \
        [--render_bullet_time [--bullet_time_frame F]] \
        [--extract_mesh [--mesh_frame F] [--N_grid N] [--sigma_threshold T]] \
        [--render_frame F] [--eval_metrics [--eval_max_frames K]] \
        [--occ_res N] [--out_dir DIR] [--device cuda|cpu] \
        [--num_devices N] [--dist] [--coordinator_address HOST:PORT \
        --num_processes N --process_id R]

JAX's ``test.py`` surface through ``get_trainer``, so a checkpoint of any
rendering stage (``nerf``, ``moco_flow``) of either package renders: the
training poses' video, the spherical orbit and the bullet-time track of a
frame, the mesh (canonical or of a posed frame), one frame's strip
(``train/vis.py``), and ``--eval_metrics``' mean PSNR / SSIM / DSSIM (and
LPIPS with ``$LPIPS_WEIGHTS_NPZ``) as JSON. Frame -1 is the canonical space.
Outputs go under ``--out_dir`` (default: the job's ``log`` directory). The
checkpoint is ``-r`` or the experiment's newest. ``--test_json`` reads the
sequence from that file's directory. ``model.mlp_impl`` picks the kernels
(``train/factory.py::render_config``): ``pallas`` renders through the
per-op MLPs #8/#9, where ``--fine_budget`` / ``--coarse_probe`` raise.
``--occ_res N`` sets ``model.occ_res``: every mode's views, and the frames
of ``--eval_metrics``, render through the per-frame occupancy grid
(``render/occupancy.py``; 0 = off; a softplus NeRF raises).
``test(config, args)`` takes the config as a dict or a ``Config``.

``main`` runs on the ranks that ``train``'s CLI would (torchrun, ``--dist``
and the multi-host flags, one rank a card, or ``--num_devices`` gloo ranks
on the CPU): every rank renders its share of each frame's tiles and gets
the whole frame (``BaseTrainer.render_rays_chunked``), and rank 0 writes
the images, meshes and the ``--eval_metrics`` JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp

from .train import get_trainer
from .train.__main__ import add_dist_args, as_config, require_device, run_ranks
from .train.base import BaseTrainer
from .train.checkpoint import find_latest_checkpoint
from .train.vis import (visualize_bullet_time, visualize_frame,
                        visualize_mesh, visualize_spherical, visualize_video)
from .utils.config import Config

def test(config, args, smpl_data=None, scene=None) -> BaseTrainer:
    """Build the model, load the checkpoint and run the requested modes.

    ``scene``: an in-memory ``SyntheticScene`` in place of the files under
    ``dataloader.root_dir``."""
    device = getattr(args, "device", "cuda")
    require_device(device)
    config = as_config(config, args, "test")
    trainer = get_trainer(config, device=device, seed=config.seed or 0,
                          smpl_data=smpl_data, scene=scene)
    config.raw["dataloader"]["val_size"] = [args.reso, args.reso]
    config.raw["model"]["pretrained_nerf"] = None
    config.raw["model"]["pretrained_nof"] = None
    config.raw["dataloader"]["bkgd"] = 1.0
    if getattr(args, "fine_budget", None) is not None:
        config.raw["model"]["fine_budget"] = args.fine_budget
    if getattr(args, "coarse_probe", None) is not None:
        config.raw["model"]["coarse_probe"] = args.coarse_probe
    if getattr(args, "occ_res", None) is not None:
        config.raw["model"]["occ_res"] = args.occ_res
    trainer.build_model(config["model"])
    trainer.broadcast_params()
    ckpt = config.resume or find_latest_checkpoint(osp.join(
        config.save_dir, config.exp_name, "*", "ckpts", "*.npz"))
    if ckpt:
        trainer.load_ckpt(ckpt)

    out_dir = getattr(args, "out_dir", None)
    if out_dir and trainer.is_main:
        os.makedirs(out_dir, exist_ok=True)
    if not args.render_gt:
        if not getattr(args, "test_json", None):
            raise ValueError("provide --test_json or --render_gt")
        config.raw["dataloader"]["root_dir"] = osp.dirname(args.test_json)
    trainer.prepare_dataloader(config["dataloader"])
    trainer.num_frames = trainer.val_dataset.num_frames

    if getattr(args, "render_training_poses", False):
        visualize_video(trainer, vis_novel_view=False, save_path=out_dir)
    if getattr(args, "render_spherical_poses", False):
        visualize_spherical(trainer, args.spherical_poses_frame,
                            save_path=out_dir)
    if getattr(args, "render_bullet_time", False):
        visualize_bullet_time(trainer, args.bullet_time_frame,
                              save_path=out_dir)
    if getattr(args, "extract_mesh", False):
        trainer.mesh_path = visualize_mesh(
            trainer, args.mesh_frame, n_grid=args.N_grid,
            sigma_threshold=args.sigma_threshold, save_path=out_dir)
    if args.render_frame is not None:
        visualize_frame(trainer, args.render_frame, save_path=out_dir)
    if args.eval_metrics:
        trainer.metrics = trainer.evaluate_sequence(
            max_frames=args.eval_max_frames)
        if trainer.is_main:
            print(json.dumps(trainer.metrics))
    return trainer


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="test-time rendering (port)")
    p.add_argument("-m", "--mode", default="test", type=str)
    p.add_argument("-c", "--config", required=True, type=str)
    p.add_argument("-r", "--resume", default=None, type=str)
    p.add_argument("-n", "--job_name", default=None, type=str)
    p.add_argument("-s", "--seed", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels) or cpu (the plain versions)")
    p.add_argument("--out_dir", default=None, type=str)
    p.add_argument("--reso", default=512, type=int)
    p.add_argument("--render_gt", action="store_true")
    p.add_argument("--test_json", default=None, type=str)
    p.add_argument("--render_training_poses", action="store_true")
    p.add_argument("--render_spherical_poses", action="store_true")
    p.add_argument("--spherical_poses_frame", default=-1, type=int)
    p.add_argument("--render_bullet_time", action="store_true")
    p.add_argument("--bullet_time_frame", default=0, type=int)
    p.add_argument("--extract_mesh", action="store_true")
    p.add_argument("--mesh_frame", default=-1, type=int)
    p.add_argument("--N_grid", default=512, type=int)
    p.add_argument("--sigma_threshold", default=10, type=float)
    p.add_argument("--render_frame", default=None, type=int)
    p.add_argument("--fine_budget", default=None, type=int,
                   help="fine samples kept per ray (0/absent = all, exact)")
    p.add_argument("--coarse_probe", default=None, type=int,
                   help="strided coarse probe size, must divide N_samples "
                        "(0/absent = exact)")
    p.add_argument("--occ_res", default=None, type=int,
                   help="occupancy grid resolution: skip the rays it proves "
                        "empty and tighten the others (0/absent = off)")
    p.add_argument("--eval_metrics", action="store_true",
                   help="mean PSNR / SSIM / DSSIM (and LPIPS with "
                        "$LPIPS_WEIGHTS_NPZ) over the val sequence")
    p.add_argument("--eval_max_frames", default=None, type=int)
    add_dist_args(p)
    return p.parse_args(argv)


def _test_config(args) -> Config:
    return Config.from_args(args, mode="test")


def main(argv=None) -> BaseTrainer | None:
    """The CLI: renders on the ranks of the run and returns the trainer of
    this process's rank, or None where the ranks were spawned."""
    return run_ranks(parse_args(argv), _test_config, test)


if __name__ == "__main__":
    main()
