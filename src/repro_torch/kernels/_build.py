"""Build the CUDA sources under ``csrc/`` with nvcc and load them by ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into ``build/kernels/lib<name>-<hash>.so`` at the repository root (listed
in ``.gitignore``).  The hash covers the source and the flags, so an edited
source rebuilds and an unchanged one is loaded as it is.  The build runs
at first use.

The flags keep float arithmetic IEEE: ``-fmad=false`` and never
``--use_fast_math``, because the fused kernel's division and argmax are
held bit for bit to the plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("spinner_scores",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: dict = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every named source not built yet, one nvcc each.

    Returns ``{name: (seconds, compiler log)}`` for the sources compiled
    by this call (the log carries ``-Xptxas -v``'s registers and spills).
    Raises with the compiler's output if a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    built = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}")
        os.replace(tmp, out)          # atomic: concurrent builds agree
        built[name] = (time.perf_counter() - t0, proc.stdout)
    return built


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The built library ``name`` (building it first if needed), with
    ``argtypes``/``restype`` declared from ``{function: (restype,
    argtypes)}``."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (restype, argtypes) in signatures.items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _LIBS[name] = lib
    return lib
