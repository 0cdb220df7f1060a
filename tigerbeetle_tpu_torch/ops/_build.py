"""Build and load the port's CUDA kernels.

Each kernel source under `csrc/` is compiled by `nvcc` for `sm_90a` into
a shared library with a plain C interface, at first use, and bound with
`ctypes`. The library's name carries a hash of its source, so an edited
source is rebuilt and a stale library is never loaded. Build outputs go
to `tigerbeetle_tpu_torch/build/` (git-ignored). A failed build raises.

The C interfaces: each entry point takes an array of segment structures
(mirrored below as `ctypes.Structure`s, field for field), their count
and the CUDA stream, and returns `cudaGetLastError()` of its launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict = {}

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong


class RowGatherSegment(ctypes.Structure):
    """csrc/row_gather.cu's segment: out[i] = table[clamp(rows[i])] &
    mask over a contiguous (n_rows, width) table of 32-bit words."""
    _fields_ = [("table", _VP), ("rows", _VP), ("out", _VP),
                ("n_rows", _LL), ("n", _LL), ("width", _LL),
                ("rows_are_64", ctypes.c_int), ("mask", ctypes.c_uint)]


class ProbeSegment(ctypes.Structure):
    """csrc/ht_probe.cu's segment: one table and its queries."""
    _fields_ = [("packed", _VP), ("n_buckets", _LL), ("k_hi", _VP),
                ("k_lo", _VP), ("n", _LL), ("found", _VP), ("val", _VP)]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its library is already built.
    Returns the library path; raises with nvcc's output on failure."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {name} ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load(name: str, fn_name: str, segment):
    """Build (if needed) and load csrc/<name>.cu; returns its entry point
    `fn_name(segments, n_seg, stream) -> int` with the C signature
    declared."""
    with _lock:
        fn = _libs.get(name)
        if fn is None:
            fn = getattr(ctypes.CDLL(str(build(name))), fn_name)
            fn.argtypes = [ctypes.POINTER(segment), ctypes.c_int, _VP]
            fn.restype = ctypes.c_int
            _libs[name] = fn
        return fn


def load_ht_probe():
    """The ht_probe entry point, `ht_probe_launch`."""
    return _load("ht_probe", "ht_probe_launch", ProbeSegment)


def load_row_gather():
    """The row_gather entry point, `row_gather_launch`."""
    return _load("row_gather", "row_gather_launch", RowGatherSegment)
