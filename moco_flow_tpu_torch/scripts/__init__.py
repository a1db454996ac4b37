"""The offline toolchain: pose estimates -> a training dataset, the
init_nerf renders, reference-checkpoint conversion and the runbooks that
chain it all (port of the repository's ``scripts/`` of the same names).
Each CLI runs as ``python -m moco_flow_tpu_torch.scripts.<name>``."""
