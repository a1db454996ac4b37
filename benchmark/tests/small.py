"""The small sizes at which the CPU tests run the cells: the published
widths cut, a few rays and samples, a 32 x 32 frame."""

SMALL_NERF = {"D": 4, "W": 32, "skips": [2]}
SMALL_NOF = {"D": 3, "W": 16, "skips": [1]}
SMALL = {"dataloader": {"size": [32, 32]},
         "scene": {"num_verts": 64, "focal": 60.0},
         "model": {"N_rand": 8, "N_samples": 8, "N_importance": 8,
                   "N_sampled": 16, "coarse_NeRF": SMALL_NERF,
                   "fine_NeRF": SMALL_NERF, "bw_NoF": SMALL_NOF,
                   "fw_NoF": SMALL_NOF}}
CELLS = ("c2f.train_msk", "init_nerf.train")
SEED = 2 ** 31 + 12345
