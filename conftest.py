"""Suite-wide guard against the kernel's per-process memory-map limit.

XLA:CPU keeps three memory mappings (code, read-only data, data) for every
kernel it has JIT-compiled, and frees them only when the executable is
dropped from JAX's caches.  One hybrid chunked-prefill test maps ~33k and
its Pallas variant ~45k, so a pytest-xdist worker that runs a few such
tests in a row crosses ``vm.max_map_count`` (65530 by default) and XLA
segfaults inside ``backend_compile``.  Before each test, a process that
already holds a quarter of the limit drops JAX's compiled executables;
tests recompile what they need.
"""
import gc
import sys

_MAPS = "/proc/self/maps"
_MAX_MAP_COUNT = "/proc/sys/vm/max_map_count"


def _count_lines(path):
    try:
        with open(path, "rb") as f:
            return f.read().count(b"\n")
    except OSError:
        return None


def _read_int(path):
    try:
        with open(path) as f:
            return int(f.read())
    except (OSError, ValueError):
        return None


def pytest_runtest_setup(item):
    jax = sys.modules.get("jax")
    limit = _read_int(_MAX_MAP_COUNT)
    if jax is None or limit is None:
        return
    maps = _count_lines(_MAPS)
    if maps is not None and maps > limit // 4:
        jax.clear_caches()
        gc.collect()
