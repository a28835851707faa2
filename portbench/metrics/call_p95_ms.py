"""call_p95_ms: the 95th percentile, over every call of the window, of one
``membership_batch`` call on the host clock, ending in its numpy result.  A
call that raised counts with the time it took."""

import numpy as np


def read(run):
    if not run.calls:
        return None
    return float(np.percentile([c.t1 - c.t0 for c in run.calls], 95)) * 1e3
