"""pack_ms_per_call: the host time the matcher facade spends packing bucket
tiles (the program's ``repro_torch.matcher.pack`` spans: the tile buffer,
the row copies, the lengths and entry operands) in the traced window, in ms
over the window's calls."""


def read(run):
    t = run.trace
    if t is None or not run.calls:
        return None
    packs = [(max(s, t.w0), min(e, t.w1)) for n, s, e in t.host
             if n == "repro_torch.matcher.pack" and e > t.w0 and s < t.w1]
    if not packs:
        return None
    return sum(e - s for s, e in packs) / 1e3 / len(run.calls)
