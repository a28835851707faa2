"""facade_idle_share: the share of the traced window in which the card is
idle while the host runs the matcher facade's own code, in percent: the
window's idle intervals (``Trace.idle()``) intersected with the facade's
self time, each ``repro_torch.matcher.membership_batch`` range less its
``repro_torch.executor.run`` and ``repro_torch.matcher.readback`` children
(the program's spans, recorded while the profiler records)."""

PREFIX = "repro_torch."


def spans(trace, name: str) -> list:
    """The window's host ranges of the program's span ``name``, clipped to
    the window, as [start, end] in microseconds."""
    full = PREFIX + name
    return [[max(s, trace.w0), min(e, trace.w1)] for n, s, e in trace.host
            if n == full and e > trace.w0 and s < trace.w1]


def union(intervals: list) -> list:
    """Disjoint, sorted [start, end] intervals covering ``intervals``."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def subtract(a: list, b: list) -> list:
    """The parts of ``union(a)`` outside ``union(b)``."""
    out, cut, j = [], union(b), 0
    for s, e in union(a):
        while j < len(cut) and cut[j][1] <= s:
            j += 1
        k = j
        while k < len(cut) and cut[k][0] < e:
            if cut[k][0] > s:
                out.append([s, cut[k][0]])
            s = max(s, cut[k][1])
            k += 1
        if e > s:
            out.append([s, e])
    return out


def overlap_us(a: list, b: list) -> float:
    """Microseconds that ``union(a)`` and ``union(b)`` share."""
    a, b = union(a), union(b)
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def facade_self(trace) -> list:
    """The facade's self time: its calls less the executor and the
    read-back."""
    return subtract(spans(trace, "matcher.membership_batch"),
                    spans(trace, "executor.run")
                    + spans(trace, "matcher.readback"))


def read(run):
    t = run.trace
    if t is None or not t.in_window() or t.window_s <= 0:
        return None
    if not spans(t, "matcher.membership_batch"):
        return None
    return 100.0 * overlap_us(t.idle(), facade_self(t)) / (t.w1 - t.w0)
