"""Kinds of work, one module a kind, found by the ``kind`` of a traffic
mix (``traffic/<mix>.json``): ``kinds/<kind>.py``. A traffic mix is data;
what it is data for lives here, so a kind of work that the benchmark does
not have yet (a render orbit, a stage-2 step) is a new file.

A kind module defines:

- ``FAULTS``: the names of the faults that it can plant under its timed
  path, each of which has to come out not ``correct``;
- ``setup(cell, seed, device, fault=None, lap=None) -> job``: everything
  before the window, from ``seed`` alone: the inputs, the program's object
  under test and every shape of the step warmed (``lap(what)`` marks a part
  of set-up as done);
- ``control(cell, seed, device) -> dict``: the comparison's numbers of the
  reference put in the program's place, one precision below the
  configuration's.
- optionally ``witness(cell, seed, device) -> dict``: the reference
  against itself one precision above, for ``calibrate.py --witness``.

and the job that ``setup`` returns:

- ``job.work``: what one step counts, for the metric readers
  (``trace.Window.work``);
- ``job.step(i) -> tensor``: the ``i``-th step of the window, one number
  back whose being finite says the step did not fail;
- ``job.finish()``: frees the program's state, once the window has closed;
- ``job.compare() -> dict``: the comparison's numbers against the plain
  reference, each with a limit in ``limits/<cell>.json``;
- ``job.diagnose``: a dict of both sides' readings, for ``calibrate.py``.
"""
