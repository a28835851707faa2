"""match_MBps: real document bytes whose decisions completed in the window,
over the window's seconds (host clock), in 10^6 bytes a second."""


def read(run):
    if run.window_s <= 0:
        return None
    return sum(c.nbytes for c in run.calls if c.answered) / run.window_s / 1e6
