"""upload_ms_per_GB: the host time the executor spends uploading each
tile's operands (the program's ``repro_torch.executor.upload`` spans; the
host blocks in a pageable copy) in the traced window, in ms per 10^9 real
document bytes: the host's side of ``h2d_ms_per_GB``."""


def read(run):
    t = run.trace
    real = sum(c.nbytes for c in run.calls if c.answered)
    if t is None or not real:
        return None
    ups = [(max(s, t.w0), min(e, t.w1)) for n, s, e in t.host
           if n == "repro_torch.executor.upload" and e > t.w0 and s < t.w1]
    if not ups:
        return None
    return sum(e - s for s, e in ups) / 1e3 / (real / 1e9)
