"""``idle_share.points``: ``idle_share.train``'s reading of a stage-2
cell: the share of the traced window in which no kernel, copy or set ran
on the device, in percent."""

from benchmark.cells import metric_reader

read = metric_reader("idle_share.train")
