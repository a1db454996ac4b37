"""``idle_share.train``: the share of the traced window in which no kernel,
copy or set ran on the device, 1 - (union of the device's busy intervals /
the window), in percent."""


def read(w):
    if not (w.on_card and w.traced and w.device):
        return None
    return 100.0 * (1.0 - w.busy_s() / w.window_s)
