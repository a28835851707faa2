"""scan_launches_per_call: launches of the matching kernels (``dfa_match``'s
``launches``: B1, B2 and B6) in the window, over the window's calls.  Read
from the driver's snapshots before and after the window."""

KERNELS = ("spec_match_merge", "spec_match_merge_lanes", "spec_match")


def read(run):
    before = run.before.get("launches")
    after = run.after.get("launches")
    if before is None or after is None or not run.calls:
        return None
    n = sum(after.get(k, 0) - before.get(k, 0) for k in KERNELS)
    return n / len(run.calls)
