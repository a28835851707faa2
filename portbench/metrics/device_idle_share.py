"""device_idle_share: the share of the traced window in which no kernel,
copy or set ran on the card (1 - the union of busy intervals over the
window), in percent."""


def read(run):
    t = run.trace
    if t is None or not t.in_window() or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
