"""The program's own CUDA kernels by name, as the device trace shows them
(``moco_flow_tpu_torch/ops/csrc``): those of kernels #1-#6 of a training
step, and every other of its own."""

from __future__ import annotations

from .trace import short_name

# nerf_rays.cu (#1, #2), chain_bwd.cu (#3-#6), wgrad.cu (#2, #4, #6's
# weight gradients)
STEP_KERNELS = ("nerf_fwd_kernel", "nerf_fwd_pass", "nerf_walk_pass",
                "chain_fwd_kernel", "chain_fwd_pass", "chain_walk_pass",
                "nof_fwd_kernel", "nof_fwd_pass", "nof_walk_pass",
                "matrix_mma_kernel", "matrix_ffma_kernel", "colsum_kernel",
                "segsum_kernel", "reduce_kernel")
# render_pass.cu (#7), fused_mlp.cu (#8, #9), wg_probe.cu
OTHER_KERNELS = ("render_pass_wg_kernel", "render_pass_tf32_kernel",
                 "nerf_wg_kernel", "nof_wg_kernel", "nerf_tf32_kernel",
                 "nof_tf32_kernel", "wg_probe_kernel")


def is_step_kernel(name: str) -> bool:
    """Whole names only: PyTorch has an ``at::native::reduce_kernel``."""
    return short_name(name) in STEP_KERNELS


def is_port_kernel(name: str) -> bool:
    return short_name(name) in STEP_KERNELS + OTHER_KERNELS
