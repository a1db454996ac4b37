"""``kernel_roofline.points``: ``kernel_roofline.train``'s reading of a
stage-2 cell: the bound of each of #3/#4's launches at stage 2's shapes
(``counts.nof_launches`` on ``2 * N_sampled`` points, for each NoF) over
the device time of the kernels that run them (``nof_fwd_kernel``,
``nof_fwd_pass``, ``nof_walk_pass`` and ``wgrad.cu``'s dW), in percent."""

from benchmark.cells import metric_reader

read = metric_reader("kernel_roofline.train")
