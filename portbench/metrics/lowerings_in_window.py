"""lowerings_in_window: programs the executor lowered inside the traced
window (the program's ``repro_torch.executor.lower`` spans, one on each
cache miss, that start in the window); 0 once the warm calls have lowered
every shape.  None where the program records no ``executor.run`` span."""


def read(run):
    t = run.trace
    if t is None:
        return None
    def starts(name):
        return [s for n, s, _ in t.host
                if n == "repro_torch." + name and t.w0 <= s < t.w1]
    if not starts("executor.run"):
        return None
    return len(starts("executor.lower"))
