"""ctypes binding to the native storage engine (csrc/storage_engine.cpp,
a copy of the JAX package's native/storage_engine.cpp).

Builds the shared library at first use with `g++ -O2 -fPIC -shared
-pthread` into the git-ignored `tigerbeetle_tpu_torch/build/`, its name
carrying a hash of the sources (an edited source is rebuilt, a stale
library never loaded), and falls back to the pure-Python paths when no
toolchain is there. The checksum is bit-identical to `vsr/checksum.py`
(RFC 7693 keyed BLAKE2b-128).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "csrc", "storage_engine.cpp")
_HDR = os.path.join(_PKG, "csrc", "blake2b.h")
BUILD_DIR = os.path.join(_PKG, "build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    """Where the library for the current sources lives."""
    h = hashlib.sha256()
    for src in (_SRC, _HDR):
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libtb_storage_{h.hexdigest()[:16]}.so")


def _build(lib: str) -> bool:
    """Compile into a temporary file, then rename it into place: processes
    building at once never load a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O2", "-fPIC", "-shared", "-pthread", "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.SubprocessError):
        # No g++, a failed or timed-out build: the plain-IO paths serve.
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, building it if needed; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SRC):
            return None
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        u64 = ctypes.c_uint64
        u32 = ctypes.c_uint32
        p = ctypes.c_char_p
        lib.tbs_checksum.argtypes = [p, u64, p, u64, p]
        lib.tbs_open.argtypes = [p, u64, ctypes.c_int]
        lib.tbs_open.restype = ctypes.c_int
        lib.tbs_close.argtypes = [ctypes.c_int]
        lib.tbs_read.argtypes = [ctypes.c_int, u64, p, u64]
        lib.tbs_read.restype = ctypes.c_int64
        lib.tbs_write.argtypes = [ctypes.c_int, u64, p, u64]
        lib.tbs_write.restype = ctypes.c_int64
        lib.tbs_sync.argtypes = [ctypes.c_int]
        lib.tbs_wal_scan.argtypes = [
            ctypes.c_int, u64, u64, u32, u64, p, u64, p, u64, p, p, p]
        lib.tbs_wal_scan.restype = ctypes.c_int
        lib.tbs_wal_append.argtypes = [
            ctypes.c_int, u64, u64, u32, u64, p, u64]
        lib.tbs_wal_append.restype = ctypes.c_int
        vp = ctypes.c_void_p
        lib.tbio_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.tbio_create.restype = vp
        lib.tbio_submit_write.argtypes = [vp, u64, p, u64]
        lib.tbio_submit_write.restype = ctypes.c_long
        lib.tbio_submit_write_pair.argtypes = [vp, u64, p, u64, u64, p, u64]
        lib.tbio_submit_write_pair.restype = ctypes.c_long
        lib.tbio_submit_read.argtypes = [vp, u64, u64]
        lib.tbio_submit_read.restype = ctypes.c_long
        lib.tbio_poll.argtypes = [vp, ctypes.POINTER(u64), ctypes.c_long]
        lib.tbio_poll.restype = ctypes.c_long
        lib.tbio_fetch.argtypes = [vp, u64, p, u64]
        lib.tbio_fetch.restype = ctypes.c_long
        lib.tbio_drain.argtypes = [vp, ctypes.c_int]
        lib.tbio_drain.restype = ctypes.c_int
        lib.tbio_destroy.argtypes = [vp]
        _lib = lib
        return _lib


def checksum_native(data: bytes, key: bytes) -> Optional[int]:
    lib = load()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(16)
    lib.tbs_checksum(data, len(data), key, len(key), out)
    return int.from_bytes(out.raw, "little")


class NativeFile:
    """Native pread/pwrite file handle (storage engine core)."""

    def __init__(self, path: str, size: int, create: bool):
        lib = load()
        assert lib is not None, "native engine unavailable"
        self.lib = lib
        self.fd = lib.tbs_open(path.encode(), size, 1 if create else 0)
        if self.fd < 0:
            raise OSError(f"tbs_open failed for {path}")

    def read(self, offset: int, size: int) -> bytes:
        buf = ctypes.create_string_buffer(size)
        n = self.lib.tbs_read(self.fd, offset, buf, size)
        if n < 0:
            raise OSError("tbs_read failed")
        return buf.raw

    def write(self, offset: int, data: bytes) -> None:
        if self.lib.tbs_write(self.fd, offset, data, len(data)) < 0:
            raise OSError("tbs_write failed")

    def sync(self) -> None:
        if self.lib.tbs_sync(self.fd) != 0:
            raise OSError("tbs_sync (fsync) failed")

    def close(self) -> None:
        if self.fd >= 0:
            self.lib.tbs_close(self.fd)
            self.fd = -1

    # -------------------------------------------------------------- WAL ops

    def wal_scan(self, hdr_zone_off: int, prep_zone_off: int,
                 slot_count: int, prepare_size_max: int,
                 hdr_key: bytes, body_key: bytes):
        """Returns (states: bytes[slot_count], headers: bytes)."""
        headers = ctypes.create_string_buffer(slot_count * 256)
        states = ctypes.create_string_buffer(slot_count)
        scratch = ctypes.create_string_buffer(prepare_size_max + 256)
        rc = self.lib.tbs_wal_scan(
            self.fd, hdr_zone_off, prep_zone_off, slot_count,
            prepare_size_max, hdr_key, len(hdr_key), body_key, len(body_key),
            headers, states, scratch)
        if rc != 0:
            raise OSError("tbs_wal_scan failed")
        return states.raw, headers.raw

    def wal_append(self, hdr_zone_off: int, prep_zone_off: int, slot: int,
                   prepare_size_max: int, msg: bytes) -> None:
        rc = self.lib.tbs_wal_append(
            self.fd, hdr_zone_off, prep_zone_off, slot, prepare_size_max,
            msg, len(msg))
        if rc != 0:
            raise OSError("tbs_wal_append failed")


def available() -> bool:
    return load() is not None


class AsyncEngine:
    """Submission/completion IO engine over a native file descriptor
    (csrc/storage_engine.cpp tbio_* — the io_uring-shaped layer,
    reference: src/io/linux.zig). Writes copy their payload at submit;
    drain() is the completion + durability barrier."""

    def __init__(self, native_file: "NativeFile", workers: int = 4):
        self.lib = native_file.lib
        self.handle = self.lib.tbio_create(native_file.fd, workers)
        if not self.handle:
            raise OSError("tbio_create failed")

    def submit_write(self, offset: int, data: bytes) -> int:
        op = self.lib.tbio_submit_write(self.handle, offset, data, len(data))
        assert op > 0
        return op

    def submit_read(self, offset: int, size: int) -> int:
        op = self.lib.tbio_submit_read(self.handle, offset, size)
        assert op > 0
        return op

    def submit_write_pair(self, off1: int, data1: bytes,
                          off2: int, data2: bytes) -> int:
        """Tracked ordered write pair (the async WAL append: prepare body
        strictly before its redundant header); completion via poll/fetch."""
        op = self.lib.tbio_submit_write_pair(
            self.handle, off1, data1, len(data1), off2, data2, len(data2))
        assert op > 0
        return op

    def submit_write_tracked(self, offset: int, data: bytes) -> int:
        """Tracked single write (a pair with an empty second leg): the
        caller reaps the completion via fetch — used where the reader
        needs to wait on ONE write, not the whole engine."""
        op = self.lib.tbio_submit_write_pair(
            self.handle, offset, data, len(data), 0, b"", 0)
        assert op > 0
        return op

    def poll(self, max_ids: int = 4096) -> list[int]:
        """Nonblocking: ids of completions ready to fetch (reads and
        tracked writes). The window must exceed any realistic number of
        unreaped completions, or tokens beyond it are invisible to
        callers that gate progress on them."""
        arr = (ctypes.c_uint64 * max_ids)()
        n = self.lib.tbio_poll(self.handle, arr, max_ids)
        return [int(arr[i]) for i in range(n)]

    def fetch(self, op_id: int, size: int = 0) -> bytes:
        buf = ctypes.create_string_buffer(size) if size else None
        n = self.lib.tbio_fetch(self.handle, op_id, buf, size)
        if n == -2:
            raise KeyError(f"async op {op_id} unknown or already fetched")
        if n < 0:
            raise OSError(f"async op {op_id} failed ({n})")
        return buf.raw[:n] if buf is not None else b""

    def drain(self, sync: bool = False) -> None:
        rc = self.lib.tbio_drain(self.handle, 1 if sync else 0)
        if rc != 0:
            # Distinct from IOError: block-level IOError is handled by
            # repair paths; a failed async WRITE means durability is
            # compromised and must propagate (the failure is sticky in
            # the engine — every later drain re-reports it).
            raise RuntimeError(
                "async write failed (sticky): storage compromised")

    def close(self) -> None:
        if self.handle:
            self.lib.tbio_destroy(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
