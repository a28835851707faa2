"""setup_s: process start to the first timed call (host clock): imports,
CUDA init, loading (or, in a fresh checkout, building) the kernels, pattern
compilation, the device tables, the input pool and the warm calls."""


def read(run):
    return run.setup_s
