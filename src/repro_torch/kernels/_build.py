"""Build the CUDA sources under ``csrc/`` with nvcc and call them by ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into ``build/kernels/lib<name>-<hash>.so`` at the repository root (listed
in ``.gitignore``).  The hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source rebuilds and an
unchanged one is loaded as it is.  The build runs at first use; ``build``
starts one nvcc per source, all together.

The flags keep float arithmetic IEEE: ``-fmad=false`` and never
``--use_fast_math``, because the fused kernel's division and argmax are
held bit for bit to the plain PyTorch version, and PageRank's
``base + damping * acc`` must round as the reference's does.

``check`` and ``launch`` are the wrappers' shared halves: validate a
tensor before its pointer is passed, and call a C entry point on the
tensors' device pointers, raising on the CUDA error it returns.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("spinner_scores", "pregel_combine")
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
    text = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every named source not built yet, one nvcc each, started
    together.

    Returns ``{name: (seconds, compiler log)}`` for the sources compiled
    by this call (the log carries ``-Xptxas -v``'s registers and spills);
    the seconds run from the common start to that source's end.  Raises
    with the compiler's output if a build fails, after every nvcc it
    started has ended.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        running[name] = (out, tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {name: (proc.communicate()[0], time.perf_counter() - t0)
            for name, (_, _, proc) in running.items()}
    failed = [n for n, (_, _, proc) in running.items() if proc.returncode]
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(
            f"{n}.cu:\n{logs[n][0]}" for n in failed))
    built = {}
    for name, (out, tmp, _) in running.items():
        os.replace(tmp, out)          # atomic: concurrent builds agree
        log, seconds = logs[name]
        built[name] = (seconds, log)
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


def check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(lib: str, signatures: dict, fn: str, tensors, *scalars) -> None:
    """Call C entry ``fn`` of library ``lib`` with the tensors' device
    pointers (``None`` passes a null pointer), then the scalars (the
    stream last); raise on the CUDA error it returns."""
    err = getattr(load(lib, signatures), fn)(
        *(None if t is None else t.data_ptr() for t in tensors), *scalars)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed with CUDA error {err}")
