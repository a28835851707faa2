"""scan_roofline: the least time the card needs for the window's matching,
counted from the inputs alone (``peaks.membership_least_s``: K lookups a
real byte at the shared-memory load rate, or the documents, tables and
decisions moved once through HBM), over the profiler's device time of every
kernel in the window that is no copy or set, in percent."""

from portbench import peaks


def read(run):
    t = run.trace
    if t is None:
        return None
    kernels = t.device_s(lambda name: not name.startswith(("Memcpy", "Memset")))
    if kernels <= 0:
        return None
    least = sum(peaks.membership_least_s(c.nbytes, run.k, run.table_bytes,
                                         c.decisions)
                for c in run.calls if c.answered)
    return 100.0 * least / kernels
