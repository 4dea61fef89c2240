"""Native host code of the port, built from the repository's sources at
first use with ``g++`` into ``dfs_tpu_torch/_build/`` (keyed by a hash of
the source and the flags; compiled to a temporary name and renamed over
the target, so a concurrent loader never maps a half-written file):

- ``cdc_core.cpp``: the ``cdc`` strategy's sequential Gear cut selection
  (:func:`native_gear_cuts`), the ``cdc-anchored`` host engine's spans
  (:func:`native_anchored_spans`, :func:`native_anchored_spans_region`)
  and a batched SHA-256 (:func:`native_sha256_many`), bound with ctypes;
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
            lib.dfs_sha256_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
                ctypes.c_void_p]
            lib.dfs_sha256_batch.restype = None
            lib.dfs_anchored_spans.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32,
                ctypes.c_uint32, ctypes.c_uint64, ctypes.c_uint64,
                ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
                ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p,
                ctypes.c_uint64]
            lib.dfs_anchored_spans.restype = ctypes.c_int64
            lib.dfs_anchored_spans_region.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p,
                ctypes.c_uint64, ctypes.c_int, ctypes.c_uint32,
                ctypes.c_uint32, ctypes.c_uint64, ctypes.c_uint64,
                ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
                ctypes.c_uint64, ctypes.c_uint64, ctypes.c_void_p,
                ctypes.c_uint64, ctypes.c_void_p]
            lib.dfs_anchored_spans_region.restype = ctypes.c_int64
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


def _u8(data) -> np.ndarray:
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(
        data, (bytes, bytearray, memoryview)) else data
    return np.ascontiguousarray(arr)       # .ctypes.data needs C order


def native_sha256_many(chunks: list[bytes]) -> list[str]:
    """SHA-256 of each message in C++ (``dfs_sha256_batch``): the C ABI a
    host in another language links; Python paths hash with hashlib."""
    lib = get_lib()
    if not chunks:
        return []
    data = b"".join(chunks)
    offsets = np.zeros(len(chunks) + 1, dtype=np.uint64)
    np.cumsum([len(c) for c in chunks], out=offsets[1:])
    out = np.empty(len(chunks) * 32, dtype=np.uint8)
    buf = np.frombuffer(data, dtype=np.uint8)
    lib.dfs_sha256_batch(buf.ctypes.data if buf.size else None,
                         offsets.ctypes.data, len(chunks), out.ctypes.data)
    raw = out.tobytes()
    return [raw[32 * i:32 * (i + 1)].hex() for i in range(len(chunks))]


def _span_capacity(n: int, params) -> int:
    # one cut per min_blocks plus one forced tail per segment
    return n // (params.chunk.min_blocks * 64) + n // params.seg_min + 3


def native_anchored_spans(data: bytes | np.ndarray, params) -> np.ndarray:
    """Anchored two-level CDC spans of a whole stream in C++, equal to
    ``ops.cdc_anchored.chunk_spans_anchored_np``: [n, 2] int64 (offset,
    length)."""
    from dfs_tpu_torch.ops.cdc_anchored import TILE_BYTES

    lib = get_lib()
    arr = _u8(data)
    n = int(arr.shape[0])
    if n == 0:
        return np.zeros((0, 2), dtype=np.int64)
    cp = params.chunk
    cap = _span_capacity(n, params)
    spans = np.empty((cap, 2), dtype=np.uint64)
    wrote = lib.dfs_anchored_spans(
        arr.ctypes.data, n, params.seed, params.seg_mask, params.seg_min,
        params.seg_max, TILE_BYTES, cp.seed, cp.mask, cp.min_blocks,
        cp.max_blocks, spans.ctypes.data, cap)
    if wrote < 0:
        raise RuntimeError("dfs_anchored_spans overflowed its span buffer")
    return spans[:wrote].astype(np.int64)


def native_anchored_spans_region(data: bytes | np.ndarray,
                                 lookback: np.ndarray, start0: int,
                                 final: bool, params
                                 ) -> tuple[np.ndarray, int]:
    """One window of a stream (``ops.cdc_anchored.region_spans_np``'s
    contract) in C++: ([n, 2] int64 window-local (offset, length),
    consumed). The window's stream offset must be tile-aligned."""
    from dfs_tpu_torch.ops.cdc_anchored import TILE_BYTES

    lib = get_lib()
    arr = _u8(data)
    n = int(arr.shape[0])
    if n == 0:
        return np.zeros((0, 2), dtype=np.int64), start0
    cp = params.chunk
    cap = _span_capacity(n, params)
    spans = np.empty((cap, 2), dtype=np.uint64)
    lb = np.ascontiguousarray(lookback, dtype=np.uint8)
    consumed = ctypes.c_uint64(0)
    wrote = lib.dfs_anchored_spans_region(
        arr.ctypes.data, n, lb.ctypes.data, start0, int(final),
        params.seed, params.seg_mask, params.seg_min, params.seg_max,
        TILE_BYTES, cp.seed, cp.mask, cp.min_blocks, cp.max_blocks,
        spans.ctypes.data, cap, ctypes.byref(consumed))
    if wrote < 0:
        raise RuntimeError("dfs_anchored_spans_region overflowed its span "
                           "buffer")
    return spans[:wrote].astype(np.int64), int(consumed.value)


def build_sidecar_client() -> Path:
    """Build (once per source) the dependency-free C++ sidecar client —
    POSIX sockets and a hand-written HTTP/2 subset, no gRPC library —
    and return the binary's path. Usage: ``sidecar_client <host> <port>
    <file> [ChunkHashStream|ChunkHash|ChunkHashDuplex|Health]``."""
    src = _DIR / "sidecar_client.cpp"
    with _lock:
        return _compile(src, _BIN_FLAGS, _target(src, _BIN_FLAGS, ""))
