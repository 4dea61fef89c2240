"""Native host code of the port, built from the repository's sources at
first use with ``g++`` into ``dfs_tpu_torch/_build/`` (keyed by a hash of
the source and the flags; compiled to a temporary name and renamed over
the target, so a concurrent loader never maps a half-written file):

- ``cdc_core.cpp``: the ``cdc`` strategy's sequential Gear cut selection,
  bound with ctypes (:func:`native_gear_cuts`);
- ``sidecar_client.cpp``: a dependency-free C++ client of the sidecar's
  gRPC contract (:func:`build_sidecar_client`).

A missing compiler or a failed build raises and carries the compiler's
error: nothing falls back to a Python version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_BUILD_ROOT = _DIR.parent / "_build"
# portable code (no -march=native): a build directory may be reused on
# another host of the same architecture
_LIB_FLAGS = ["-O3", "-shared", "-fPIC"]
_BIN_FLAGS = ["-O2"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _target(src: Path, flags: list[str], suffix: str) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(src.read_bytes())
    return _BUILD_ROOT / f"{src.stem}-{h.hexdigest()[:16]}{suffix}"


def _compile(src: Path, flags: list[str], dst: Path) -> Path:
    """g++ ``src`` into ``dst`` unless it is there already; raises with
    the compiler's output on failure."""
    if dst.is_file():
        return dst
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH: {src.name} cannot be "
                           "built")
    dst.parent.mkdir(parents=True, exist_ok=True)
    tmp = dst.with_name(f"{dst.name}.tmp{os.getpid()}-"
                        f"{threading.get_ident()}")
    r = subprocess.run([gxx, *flags, "-o", str(tmp), str(src)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {src.name} "
                           f"(rc {r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, dst)
    return dst


def get_lib() -> ctypes.CDLL:
    """The ``cdc_core`` library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            src = _DIR / "cdc_core.cpp"
            lib = ctypes.CDLL(str(_compile(src, _LIB_FLAGS,
                                           _target(src, _LIB_FLAGS, ".so"))))
            lib.dfs_gear_cuts.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
                ctypes.c_uint32, ctypes.c_uint64, ctypes.c_uint64,
                ctypes.c_void_p, ctypes.c_uint64]
            lib.dfs_gear_cuts.restype = ctypes.c_int64
            _lib = lib
        return _lib


def native_gear_cuts(data: bytes | np.ndarray, table: np.ndarray, mask: int,
                     min_size: int, max_size: int) -> np.ndarray:
    """Sequential CDC cut selection in C++: the exclusive cut offsets
    (int64), the last one == len(data)."""
    lib = get_lib()
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)) else np.ascontiguousarray(
        data, dtype=np.uint8)
    n = arr.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    cap = n // min_size + 2
    cuts = np.empty(cap, dtype=np.uint64)
    table32 = np.ascontiguousarray(table, dtype=np.uint32)
    wrote = lib.dfs_gear_cuts(arr.ctypes.data, n, table32.ctypes.data,
                              mask, min_size, max_size,
                              cuts.ctypes.data, cap)
    if wrote < 0:
        raise RuntimeError("dfs_gear_cuts overflowed its cut buffer")
    return cuts[:wrote].astype(np.int64)


def build_sidecar_client() -> Path:
    """Build (once per source) the dependency-free C++ sidecar client —
    POSIX sockets and a hand-written HTTP/2 subset, no gRPC library —
    and return the binary's path. Usage: ``sidecar_client <host> <port>
    <file> [ChunkHashStream|ChunkHash|ChunkHashDuplex|Health]``."""
    src = _DIR / "sidecar_client.cpp"
    with _lock:
        return _compile(src, _BIN_FLAGS, _target(src, _BIN_FLAGS, ""))
