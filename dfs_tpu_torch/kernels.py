"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds. All sources build in parallel (one
``nvcc`` process each, all started together) at first use, into
``dfs_tpu_torch/_build/<hash>/`` keyed by a hash of the sources and flags;
a later process finds the libraries there. A missing ``nvcc`` or a failed
build raises.

Every C entry point enqueues its kernel on the stream it is given and
returns ``cudaGetLastError()`` as an int. :func:`launch` calls it with the
tensors' card made the CUDA runtime's current device (the C code launches
there) and PyTorch's current stream on that card, raises on a non-zero
code and counts the launch. The counters let a run prove that its main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parent / "_build"

# kernel name -> (source file, C entry point, ctypes argtypes)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNELS: dict[str, tuple[str, str, list]] = {
    "strip_chunk_states": (
        "strip_chunk_states.cu", "dfs_strip_chunk_states",
        # words_t, real_blocks, cutflag, since, states, bps, s,
        # seed, mask, min_b, max_b, sel_lanes, wide, scratch, stream
        [_P, _P, _P, _P, _P, _I, _I, ctypes.c_uint, ctypes.c_uint, _I, _I,
         _I, _I, _P, _P]),
    "repack_lanes": (
        "repack_lanes.cu", "dfs_repack_lanes",
        # words, m_total, w_off, sh8, out, s_pad, lane_words, stream
        [_P, _L, _P, _P, _P, _I, _I, _P]),
    "bswap_transpose": (
        "bswap_transpose.cu", "dfs_bswap_transpose",
        # x, out, rows, cols, stream
        [_P, _P, _I, _I, _P]),
    "select_walk": (
        "select_walk.cu", "dfs_select_walk",
        # tiles, m_tiles, scal(start0, n, final), bounds, cap,
        # seg_min, seg_max, tile_shift, records, stream
        [_P, _I, _P, _P, _I, _I, _I, _I, _P, _P]),
    "strip_states": (
        "strip_states.cu", "dfs_strip_states",
        # words_t, cutflag, states, bps, s, wide, scratch, stream
        [_P, _P, _P, _I, _I, _I, _P, _P]),
    "sha256_blocks": (
        "sha256_blocks.cu", "dfs_sha256_blocks",
        # words, nblocks, out, rows, blocks, stream
        [_P, _P, _P, _I, _I, _P]),
    "sha256_spans": (
        "sha256_spans.cu", "dfs_sha256_spans",
        # data, m, spans (starts, lens, order), out, n_spans, stream
        [_P, _L, _P, _P, _I, _P]),
}

# kernel name -> the CUDA functions one wrapper call launches (what a
# device trace names; K1 and K4 launch two each)
DEVICE_FUNCS: dict[str, tuple[str, ...]] = {
    "strip_chunk_states": ("select_cuts_kernel", "chunk_chains_kernel"),
    "repack_lanes": ("repack_lanes_kernel",),
    "bswap_transpose": ("bswap_transpose_kernel",),
    "select_walk": ("select_records_kernel", "select_walk_kernel"),
    "strip_states": ("chunk_chains_kernel",),
    "sha256_blocks": ("sha256_blocks_kernel",),
    "sha256_spans": ("sha256_spans_kernel",),
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_launches: dict[str, int] = {name: 0 for name in KERNELS}
_count_lock = threading.Lock()
build_log: dict[str, str] = {}     # kernel -> ptxas report of its build


def _nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        p = Path(home) / "bin" / "nvcc"
        cand = str(p) if p.is_file() else None
    if cand is None:
        raise RuntimeError("nvcc not found (PATH or CUDA_HOME/bin): the "
                           "CUDA kernels cannot be built")
    return cand


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.c*")) + sorted(_CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile (where not already built) and load every kernel library;
    returns {name: CDLL}. The nvcc processes run in parallel."""
    with _lock:
        if len(_libs) == len(KERNELS):
            return dict(_libs)
        out_dir = _build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        todo = {name: out_dir / f"lib{name}.so" for name in KERNELS
                if not (out_dir / f"lib{name}.so").is_file()}
        procs = {}
        if todo:
            nvcc = _nvcc()
            for name, so in todo.items():
                tmp = so.with_suffix(f".so.tmp{os.getpid()}")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                       str(_CSRC / KERNELS[name][0])]
                procs[name] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True), tmp, so)
        failed = []
        for name, (proc, tmp, so) in procs.items():
            log, _ = proc.communicate()
            build_log[name] = log
            if proc.returncode != 0:
                failed.append(f"{name} (nvcc rc {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, so)
        if failed:
            raise RuntimeError("CUDA kernel build failed: " +
                               "\n".join(failed))
        for name in KERNELS:
            lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
            fn = getattr(lib, KERNELS[name][1])
            fn.argtypes = KERNELS[name][2]
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return dict(_libs)


def library(name: str) -> ctypes.CDLL:
    """Kernel ``name``'s loaded library (built on first use), for the
    plain helpers a source exports beside its entry point."""
    return _libs.get(name) or build_all()[name]


def launch(name: str, device, *args) -> None:
    """Call kernel ``name``'s C entry point (builds on first use) on
    ``device``'s current stream, raise on a CUDA error code, and count the
    launch. ``args`` are the entry point's arguments before the stream."""
    import torch

    lib = library(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, KERNELS[name][1])(*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
    with _count_lock:        # walks of concurrent uploads run in threads
        _launches[name] += 1


def launch_counts() -> dict[str, int]:
    with _count_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _count_lock:
        for name in _launches:
            _launches[name] = 0


def check_cuda(name: str, t, dtype=None, ndim: int | None = None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of the expected
    dtype/rank — what the kernels take."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
