"""h2d_ms_per_GB: the profiler's device time of host-to-device copies
(``Memcpy HtoD``) in the window, in ms per 10^9 real document bytes."""


def read(run):
    t = run.trace
    real = sum(c.nbytes for c in run.calls if c.answered)
    if t is None or not t.in_window() or not real:
        return None
    h2d = t.device_s(lambda name: name.startswith("Memcpy HtoD"))
    return h2d * 1e3 / (real / 1e9)
