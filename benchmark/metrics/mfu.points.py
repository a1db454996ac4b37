"""``mfu.points``: ``mfu.train``'s reading of a stage-2 cell: the model
operations of the traced window's steps over its time, as a share of the
dense TF32 peak, in percent. A stage-2 step's ``work['model_flops']`` is
both NoFs' forward plus twice the forward on its ``2 * N_sampled`` points
(``kinds/nof_step.py::step_work``)."""

from benchmark.cells import metric_reader

read = metric_reader("mfu.train")
