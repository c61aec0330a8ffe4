"""Build and bind the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled with ``nvcc`` for Hopper (sm_90a)
into a shared library under ``build/`` at its first use (once per version
of the source: the file name carries a hash of its bytes) and bound through
its plain C entry points with ``ctypes``. Nothing is built when a module is
imported: the CPU tests import every module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[1] / "build"


def _nvcc(source: Path) -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found: {source.name} cannot be built")
    return path


@functools.lru_cache(maxsize=None)
def build(source: Path) -> ctypes.CDLL:
    """Compile ``source`` (once per source version) into a shared library
    under ``build/`` and load it; ptxas's report lands beside it."""
    src = source.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    so = BUILD_DIR / f"{source.stem}_{tag}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(source), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
               "-Xcompiler", "-fPIC", "-o", str(tmp), str(source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"{source.name} build failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp, so)
        so.with_suffix(".ptxas.txt").write_text(res.stderr)
    return ctypes.CDLL(str(so))


@functools.lru_cache(maxsize=None)
def entry(source: Path, name: str, argtypes: tuple):
    """The C entry point ``name`` of the library built from ``source``,
    with its ``argtypes``; it returns the ``cudaError_t`` of its launch."""
    fn = getattr(build(source), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
