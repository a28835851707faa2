"""repro_torch: the speculative parallel DFA membership test on PyTorch and
hand-written CUDA kernels for an NVIDIA H100 (the port of ``repro``)."""

__version__ = "0.1.0"
