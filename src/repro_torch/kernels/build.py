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
# bytes of an encoded TMA tensor map (CUtensorMap)
TENSOR_MAP_BYTES = 128
# The nominal grid every split count aims at: the serving default of 4
# instances x 4 slots (16 decode lanes, 4 prefill lanes) on an H100's 132
# SMs.  A split reads these and the problem's shapes, never the call's
# instance or lane count nor the card's SM count, so a lane's sums are
# added in one order whoever shares its call.  The CUDA sources get them
# as macros.
NOMINAL_INSTANCES, NOMINAL_LANES, NOMINAL_PREFILL_LANES, NOMINAL_SMS = 4, 16, 4, 132
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              f"-DNOMINAL_INSTANCES={NOMINAL_INSTANCES}", f"-DNOMINAL_LANES={NOMINAL_LANES}",
              f"-DNOMINAL_SMS={NOMINAL_SMS}")

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


_entries: dict[tuple[str, str], object] = {}


def entry(name: str, fn: str, sig: str, restype: str = "i"):
    """C entry point ``fn`` of library ``name`` with argtypes from ``sig``
    ('p' pointer or stream, 'i' int, 'q' long long, 'f' float) and an
    int (or ``restype``) result; resolved once."""
    f = _entries.get((name, fn))
    if f is None:
        f = getattr(load(name), fn)
        f.argtypes = [_CTYPES[c] for c in sig]
        f.restype = _CTYPES[restype]
        _entries[(name, fn)] = f
    return f


def ptr(t) -> int | None:
    """Device pointer of a tensor (None for a missing optional operand)."""
    return None if t is None else t.data_ptr()


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


_sms: dict[int, int] = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (the launch plans size
    their grids by it), read once per device."""
    import torch
    i = device.index if device.index is not None else torch.cuda.current_device()
    if i not in _sms:
        _sms[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _sms[i]


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


class TensorMaps:
    """The TMA tensor maps of the kernels' weights, encoded once each.

    A map describes a (n2, n1, n0) array (n0 contiguous, f32 or bf16) by
    its address, extents and strides, read in boxes of (1, b1, b0)
    elements, in the 128-byte swizzle (the wgmma operands) or dense.  Maps
    are kept by (device, data pointer, shape, strides, dtype, box,
    swizzle), everything the encoding reads, so a hit is always the map a
    fresh encode would give, even for another tensor at a reused address.
    ``encodes`` counts the maps encoded; a serve that reuses its weights
    encodes each once.  ``encode`` (tests) replaces the C encoder:
    fn(out, ptr, dt, n0, n1, n2, b0, b1, swizzle) -> 0 on success."""

    def __init__(self, encode=None, limit: int = 4096):
        self._encode = encode
        self._maps: dict[tuple, ctypes.Array] = {}
        self.limit = limit
        self.encodes = 0

    @staticmethod
    def key(t, b1: int, b0: int = 64, swizzle: bool = True) -> tuple:
        return (t.device, t.data_ptr(), t.shape, t.stride(), t.dtype, b1, b0, swizzle)

    def get(self, t, b1: int, lib: str = "fused_matmul", b0: int = 64,
            swizzle: bool = True) -> int:
        """Host address of the map of ``t`` (a contiguous 3-d tensor, or 2-d
        as one plane of one) with boxes of b1 rows of b0 elements; encoded
        with library ``lib``'s encoder on first use."""
        key = self.key(t, b1, b0, swizzle)
        buf = self._maps.get(key)
        if buf is None:
            name = str(t.dtype).removeprefix("torch.")
            if t.dim() not in (2, 3) or not t.is_contiguous() or name not in DTYPE_CODES:
                raise ValueError("a tensor map needs a contiguous 2-d or 3-d float32 or "
                                 f"bfloat16 tensor, got {tuple(t.shape)} {t.dtype}")
            n2, n1, n0 = (1, *t.shape) if t.dim() == 2 else tuple(t.shape)
            if len(self._maps) >= self.limit:
                self.clear()
            buf = ctypes.create_string_buffer(TENSOR_MAP_BYTES)
            encode = self._encode or entry(lib, "tensor_map_encode", "ppiiiiiii")
            check(encode(ctypes.addressof(buf), t.data_ptr(), DTYPE_CODES[name], n0, n1, n2, b0,
                         b1, int(swizzle)), "tensor map")
            self._maps[key] = buf
            self.encodes += 1
        return ctypes.addressof(buf)

    def clear(self) -> None:
        self._maps.clear()


tensor_maps = TensorMaps()
