"""Build and load the hand-written Hopper kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  The
build happens at the first use on a CUDA tensor (never at import: the
CPU-only tests import every module), into ``build/kernels/`` at the root
of the checkout, keyed by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one loads at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("decode_layer", "chunk_prefill_attn", "slstm_cell", "decode_attn", "fused_matmul",
           "group_norm", "mlstm_chunk")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each library built
# by this process
ptxas_reports: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc) -> None:
    out = _target(name)
    if proc is None:
        return
    log, _ = proc.communicate()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)          # atomic: concurrent builders never see half a file
    ptxas_reports[name] = log


def build_all() -> dict[str, str]:
    """Compile every kernel source not yet built, one ``nvcc`` per source
    started together; returns the ptxas report of each source built."""
    with _lock:
        procs = {n: _start(n) for n in SOURCES}
        for n, p in procs.items():
            _finish(n, p)
    return dict(ptxas_reports)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = _libs[name] = ctypes.CDLL(str(_target(name)))
        return lib


_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "q": ctypes.c_longlong,
           "f": ctypes.c_float}


def entry(name: str, fn: str, sig: str, restype: str = "i"):
    """C entry point ``fn`` of library ``name`` with argtypes from ``sig``
    ('p' pointer or stream, 'i' int, 'q' long long, 'f' float) and an
    int (or ``restype``) result."""
    f = getattr(load(name), fn)
    if f.argtypes is None:
        f.argtypes = [_CTYPES[c] for c in sig]
        f.restype = _CTYPES[restype]
    return f


def ptr(t) -> int | None:
    """Device pointer of a tensor (None for a missing optional operand)."""
    return None if t is None else t.data_ptr()


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed: cudaError_t {err}")


DTYPE_CODES = {"float32": 0, "bfloat16": 1}


def dtype_code(t) -> int:
    name = str(t.dtype).removeprefix("torch.")
    if name not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[name]
