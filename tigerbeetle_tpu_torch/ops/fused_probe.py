"""The fused two-choice hash probe: a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel `ht_lookup_fused`
(tigerbeetle_tpu/ops/pallas_kernels.py:80). The kernel is
`csrc/ht_probe.cu`, built with nvcc for sm_90a at first use and bound
with ctypes (`_build.py`). Same contract as `hash_table.ht_lookup`, its
plain PyTorch twin: (found: bool[N], val: int32[N]).

What bounds it on an H100 is bytes: each query reads its 16-byte key,
the 128-byte key halves of two random bucket rows, one 32-byte sector of
vals when it hits, and writes 5 bytes — ~4.7 MB at N = 16384, ~1.4 us
at 3.35 TB/s, less than the launch itself. The
transfer table (~201 MB at the default capacities) fits neither shared
memory nor the 50 MB L2, so the TPU kernel's VMEM-resident table and
its 12 MiB admission gate do not carry over: the kernel reads the two
rows straight from device memory, an 8-lane group per query (one lane
per slot, coalesced 64-byte reads, a shuffle reduction), and hashes the
key in the kernel so no bucket-index tensors are made.

Routing is by the device of the tensors alone: CUDA tensors launch the
kernel (or raise), CPU tensors run the plain twin. `LAUNCHES` counts
kernel launches and nothing else.
"""

from __future__ import annotations

import torch

from . import _build
from .hash_table import ht_lookup

LAUNCHES = 0


def ht_lookup_fused(table: dict, k_hi, k_lo):
    """Probe `table` for the int64-carried u128 keys (k_hi, k_lo)."""
    global LAUNCHES
    packed = table["packed"]
    devs = {packed.device.type, k_hi.device.type, k_lo.device.type}
    if devs == {"cpu"}:
        return ht_lookup(table, k_hi, k_lo)
    if devs != {"cuda"} or len({packed.device, k_hi.device,
                                k_lo.device}) != 1:
        raise ValueError(
            f"ht_lookup_fused: tensors on {sorted(map(str, devs))}; "
            "expected all on one CUDA device (or all on the CPU)")
    for name, t in (("packed", packed), ("k_hi", k_hi), ("k_lo", k_lo)):
        if t.dtype != torch.int64 or not t.is_contiguous():
            raise ValueError(f"ht_lookup_fused: {name} must be a contiguous "
                             f"int64 tensor, got {t.dtype}")
    b = packed.shape[0] - 1
    if packed.dim() != 2 or packed.shape[1] != 24 or b < 1 or b & (b - 1):
        raise ValueError(f"ht_lookup_fused: table shape {tuple(packed.shape)}"
                         " is not (B+1, 24) with B a power of two")
    if k_hi.dim() != 1 or k_hi.shape != k_lo.shape:
        raise ValueError("ht_lookup_fused: k_hi/k_lo must be equal-length "
                         "vectors")
    n = k_hi.shape[0]
    found = torch.empty(n, dtype=torch.bool, device=packed.device)
    val = torch.empty(n, dtype=torch.int32, device=packed.device)
    if n == 0:
        return found, val
    lib = _build.load_ht_probe()
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    rc = lib.ht_probe_launch(packed.data_ptr(), b, k_hi.data_ptr(),
                             k_lo.data_ptr(), n, found.data_ptr(),
                             val.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"ht_probe launch failed: cudaError {rc}")
    LAUNCHES += 1
    return found, val
