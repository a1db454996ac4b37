"""MoCo-Flow in PyTorch + CUDA for one NVIDIA H100.

The port of ``moco_flow_tpu`` (JAX on a TPU). It keeps that package's layout:
each module here sits under the same path, with the same function names, as
the JAX module it replaces, and is held against it by ``tests/test_torch_*``.

It covers the three training stages (``train/``: stage 1's canonical NeRF,
stage 2's NoF pretraining, the stage 1/2 -> 3 hand-over and the stage-3
step in every NoF phase), the run's surface (``utils/config.py``'s YAML
reader and experiment layout, ``utils/logging.py``'s ``log.txt`` and
``metrics.jsonl``), visualisation and mesh extraction (``train/vis.py``,
``ops/mcubes.py``), LPIPS (``nn/lpips.py``), occupancy-grid empty-space
skipping and the packed stream of views (``render/occupancy.py``,
``render/packed.py``), student distillation (``render/distill.py``), the
hash-grid encoding (``nn/hashgrid.py``), every optimizer and schedule
(``train/optim.py``) and every ``test.py`` mode, on each of the JAX
package's kernel routes: the whole-ray kernels (``mlp_impl`` ``fused``,
``xla`` or ``auto``), the per-op MLPs (``pallas``) and the hybrids
(``fused_nof``, ``fused_nerf``). Each of the nine Pallas kernels is a
hand-written CUDA kernel under ``ops/csrc/`` with its plain PyTorch
version beside it. Training and test-time rendering run data-parallel
over several ranks (``parallel/``: one gradient all-reduce a step, tiles
shared out over the ranks, rank 0's side effects). The offline toolchain
(``scripts/``) turns pose estimates into a dataset, renders stage 1's
init_nerf views on the device, converts reference checkpoints and runs the
pipeline's runbooks.

It never imports ``jax`` or ``moco_flow_tpu``, nor ``yaml``, ``PIL``,
``cv2`` or ``imageio``: YAML, PNG and the JET colour table are its own
(``utils/config.py``, ``utils/image.py``), so the CLIs take the published
YAMLs on a machine without those packages. The exception is the video
decode, ``scripts/data_utils.py::clip_video``, which imports cv2 where it
runs, as JAX's script does. ``tensorboardX`` is used where it is
importable.
"""
