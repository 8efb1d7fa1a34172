"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source exposes a plain C interface. It is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library and loaded with
``ctypes``; nothing includes PyTorch's headers, so a build takes seconds.
Builds go to ``csrc/build/`` (git-ignored) at first use, named by a hash of
the source and flags, so an edited source is never served a stale library.
Several sources build in parallel, one ``nvcc`` process each.

Nothing here runs at import: the CPU tests import every module of the port
on a host with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built on the GPU host")


def lib_path(source: str) -> Path:
    """Shared library path for ``csrc/<source>``, keyed by content + flags."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build(sources) -> dict:
    """Compile every source whose library is missing, all at once.

    Returns ``{source: {"seconds": float, "ptxas": str}}`` for the sources
    built in this call (empty when everything was already built). Raises
    with the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for source in sources:
        out = lib_path(source)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        procs[source] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True),
                         tmp, out, time.perf_counter())
    report = {}
    failures = []
    for source, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{source} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)   # atomic: a reader never sees a partial file
        report[source] = {"seconds": seconds, "ptxas": log}
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return report


def load(source: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<source>``, building it if needed."""
    lib = _LOADED.get(source)
    if lib is None:
        build([source])
        lib = ctypes.CDLL(str(lib_path(source)))
        _LOADED[source] = lib
    return lib
