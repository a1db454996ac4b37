"""``kernel_roofline.train``: the bound of every launch of kernels #1-#6
in the traced window (``work['launches']`` a step, from
``counts.step_launches``: operations over the TF32 peak or bytes over the
bandwidth, whichever is longer) over the device time of those kernels,
matched by their names (``work['roofline_kernel']``), in percent. Nothing
when no kernel of theirs ran."""


def read(w):
    launches, named = w.work.get("launches"), w.work.get("roofline_kernel")
    if not (w.on_card and w.traced and w.steps and launches and named):
        return None
    busy = w.busy_s(named)
    if busy <= 0:
        return None
    return 100.0 * w.steps * sum(x.bound_s for x in launches) / busy
