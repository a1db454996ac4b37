"""MoCo-Flow in PyTorch + CUDA for one NVIDIA H100.

The port of ``moco_flow_tpu`` (JAX on a TPU). It keeps that package's layout:
each module here sits under the same path, with the same function names, as
the JAX module it replaces, and is held against it by ``tests/test_torch_*``.

It covers the test-time render of a stage-3 model (``test.py``), the
stage-3 training step in every NoF phase and stage 1's canonical NeRF
(``train/``), on both of the JAX package's kernel routes: the whole-ray
kernels (``mlp_impl`` ``fused``, ``xla`` or ``auto``) and the per-op MLPs
(``pallas``). Each of the nine Pallas kernels is a hand-written CUDA
kernel under ``ops/csrc/`` with its plain PyTorch version beside it.
Stage 2 and the other CLI modes come in later slices (ROADMAP.md).

It never imports ``jax`` or ``moco_flow_tpu``. ``yaml`` and ``PIL`` are
imported only inside the CLI functions that read a YAML file or a PNG.
"""
