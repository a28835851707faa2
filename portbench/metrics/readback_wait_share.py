"""readback_wait_share: the share of the traced window the host spends
reading each tile's results back from the card (the program's
``repro_torch.matcher.readback`` spans, which wait for the scan to finish),
in percent."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    waits = [(max(s, t.w0), min(e, t.w1)) for n, s, e in t.host
             if n == "repro_torch.matcher.readback" and e > t.w0 and s < t.w1]
    if not waits:
        return None
    return 100.0 * sum(e - s for s, e in waits) / (t.w1 - t.w0)
