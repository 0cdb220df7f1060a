"""The fused two-choice hash probe: a hand-written CUDA kernel for Hopper,
up to two tables a launch.

Replaces the Pallas TPU kernel `ht_lookup_fused`
(tigerbeetle_tpu/ops/pallas_kernels.py:80). The kernel is
`csrc/ht_probe.cu`, built with nvcc for sm_90a at first use and bound
with ctypes (`_build.py`). `ht_lookup_fused(table, k_hi, k_lo)` has the
contract of `hash_table.ht_lookup`, its plain PyTorch twin: (found:
bool[N], val: int32[N]). `ht_lookup_fused_multi([(table, k_hi, k_lo),
...])` probes up to two tables in ONE launch and returns one (found,
val) pair a segment: create_transfers probes the account table and the
transfer table at the same stage.

What bounds it on an H100 at the main path's sizes is latency, not
bytes: each query reads its 16-byte key, the 128-byte key halves of two
random bucket rows, one 32-byte sector of vals when it hits, and writes
5 bytes — ~4.7 MB at N = 16384, ~1.4 us at 3.35 TB/s, less than a
launch and the two dependent device-memory round trips every query
pays (chip_smoke.py on an H100 80GB HBM3 at 700 W: one query
0.0016–0.0019 ms, 16,384 cold transfer-table queries 0.0041–0.0045 ms;
PERF.md). The transfer table (~201 MB at the default capacities) fits
neither shared memory nor the 50 MB L2, so the TPU kernel's
VMEM-resident table and its 12 MiB admission gate do not carry over:
the kernel reads both rows straight from device memory, 8 lanes a
query, one slot a lane, each lane issuing both rows' key-half loads
before any compare (see the source note), and hashes the key in the kernel so no bucket-index
tensors are made. Two tables share one launch, and the launch path here
does little on the host: the C entry point is resolved once, the
segment structures are filled with ctypes directly, the outputs of all
segments share one allocation, the stream is read as a raw handle (no
Stream object is made), and the checks are direct comparisons.

Routing is by the device of the tensors alone: CUDA tensors launch the
kernel (or raise), CPU tensors run the plain twin. `LAUNCHES` counts
kernel launches and nothing else. `COST`, None but while the
observatory's cost model counts a tier run (`trace/profiler.py`), takes
each call and charges it `bound_bytes`: a dispatch mode sees no kernel.
"""

from __future__ import annotations

import torch

from . import _build
from .hash_table import SLOTS, _buckets, ht_lookup

LAUNCHES = 0
COST = None
ROW_KEY_BYTES = 16 * 8      # the key_hi and key_lo halves of a bucket row
SECTOR_BYTES = 32           # the least a read from device memory moves

MAX_SEGMENTS = 2

_launch = None  # the C entry point, resolved at the first launch


def _check(packed, k_hi, k_lo) -> None:
    for name, t in (("packed", packed), ("k_hi", k_hi), ("k_lo", k_lo)):
        if t.dtype != torch.int64 or not t.is_contiguous():
            raise ValueError(f"ht_lookup_fused: {name} must be a contiguous "
                             f"int64 tensor, got {t.dtype}")
    b = packed.shape[0] - 1
    if (packed.dim() != 2 or packed.shape[1] != 3 * SLOTS or b < 1
            or b & (b - 1)):
        raise ValueError(f"ht_lookup_fused: table shape {tuple(packed.shape)}"
                         " is not (B+1, 24) with B a power of two")
    if k_hi.dim() != 1 or k_hi.shape != k_lo.shape:
        raise ValueError("ht_lookup_fused: k_hi/k_lo must be equal-length "
                         "vectors")


def ht_lookup_fused_multi(segments):
    """Probe each (table, k_hi, k_lo) of `segments` (at most
    MAX_SEGMENTS) for its int64-carried u128 keys, in ONE kernel launch.
    Returns one (found, val) pair a segment, in order."""
    segments = list(segments)
    if COST is not None:
        return COST.kernel("ht_probe", _probe_multi, bound_bytes, segments)
    return _probe_multi(segments)


def bound_bytes(segments, outs) -> int:
    """The bytes one probe of `segments` must move (its PERF.md bound):
    the keys in and (found, val) out once each; the key halves of every
    bucket row a non-zero key hashes to (one row when both choices
    coincide); one 32-byte sector of the val half per key found."""
    total = 0
    for (table, k_hi, k_lo), (found, _) in zip(segments, outs):
        b1, b2 = _buckets(k_hi, k_lo, table["packed"].shape[0] - 1)
        live = (k_hi != 0) | (k_lo != 0)
        rows = int((live.to(torch.int64)
                    * (1 + (b1 != b2).to(torch.int64))).sum())
        total += (k_hi.numel() * (16 + 5) + rows * ROW_KEY_BYTES
                  + int(found.sum()) * SECTOR_BYTES)
    return total


def _probe_multi(segments):
    global LAUNCHES, _launch
    if not 1 <= len(segments) <= MAX_SEGMENTS:
        raise ValueError(f"ht_lookup_fused: {len(segments)} segments; one "
                         f"launch takes 1 to {MAX_SEGMENTS}")
    dev = segments[0][1].device
    total = 0
    for table, k_hi, k_lo in segments:
        _check(table["packed"], k_hi, k_lo)
        total += k_hi.shape[0]
        if (table["packed"].device != dev or k_hi.device != dev
                or k_lo.device != dev):
            raise ValueError(
                f"ht_lookup_fused: tensors on {table['packed'].device}, "
                f"{k_hi.device} and {k_lo.device} beside {dev}; expected all "
                "on one CUDA device (or all on the CPU)")
    if dev.type == "cpu":
        return [ht_lookup(t, h, l) for t, h, l in segments]
    if dev.type != "cuda":
        raise ValueError(f"ht_lookup_fused: tensors on {dev}; expected all "
                         "on one CUDA device (or all on the CPU)")
    # One allocation holds every segment's val (int32) and then found
    # (bool) outputs.
    out = torch.empty(5 * total, dtype=torch.uint8, device=dev)
    val = out[:4 * total].view(torch.int32)
    found = out[4 * total:].view(torch.bool)
    if len(segments) == 1:
        outs = [(found, val)]
    else:
        n0 = segments[0][1].shape[0]
        outs = [(found[:n0], val[:n0]), (found[n0:], val[n0:])]
    if total == 0:
        return outs
    segs = (_build.ProbeSegment * len(segments))()
    f_ptr, v_ptr = found.data_ptr(), val.data_ptr()
    off = 0
    for s, (table, k_hi, k_lo) in zip(segs, segments):
        packed = table["packed"]
        s.packed = packed.data_ptr()
        s.n_buckets = packed.shape[0] - 1
        s.k_hi = k_hi.data_ptr()
        s.k_lo = k_lo.data_ptr()
        s.n = k_hi.shape[0]
        s.found = f_ptr + off
        s.val = v_ptr + 4 * off
        off += s.n
    if _launch is None:
        _launch = _build.load_ht_probe()
    rc = _launch(segs, len(segments),
                 torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"ht_probe launch failed: cudaError {rc}")
    LAUNCHES += 1
    return outs


def ht_lookup_fused(table: dict, k_hi, k_lo):
    """Probe `table` for the int64-carried u128 keys (k_hi, k_lo):
    `ht_lookup_fused_multi` of one segment."""
    return ht_lookup_fused_multi(((table, k_hi, k_lo),))[0]
