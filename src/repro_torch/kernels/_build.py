"""Build the CUDA sources of this package at first use and load them.

Every ``csrc/*.cu`` compiles with ``nvcc`` into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), under
``build/repro_torch/`` at the repository root.  The file name carries a hash
of the sources and flags, so an edited source rebuilds and an unchanged one
is reused.  The libraries load with ``ctypes``; callers pass pointers and the
stream as ``c_void_p`` and sizes as ``c_int``.  A missing ``nvcc`` or a
failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build_all", "load", "build_logs"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # source stem -> nvcc's output (ptxas -v)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "build only where the CUDA toolkit is installed")
    return path


def _target(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(dep.read_bytes())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every stale source (one ``nvcc`` each, all started together)
    and load every library; returns ``{source stem: CDLL}``."""
    with _lock:
        srcs = [s for s in sorted(CSRC.glob("*.cu")) if s.stem not in _libs]
        jobs = []
        for src in srcs:
            out = _target(src)
            if out.is_file():
                jobs.append((src, out, None, None))
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                     str(src)], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((src, out, tmp, proc))
        for src, out, tmp, proc in jobs:
            if proc is not None:
                log, _ = proc.communicate()
                build_logs[src.stem] = log
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {src.name} "
                                       f"(exit {proc.returncode}):\n{log}")
                os.replace(tmp, out)
            _libs[src.stem] = ctypes.CDLL(str(out))
        return dict(_libs)


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on demand)."""
    lib = _libs.get(stem)
    return lib if lib is not None else build_all()[stem]
