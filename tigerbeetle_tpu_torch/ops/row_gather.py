"""Row gather: a hand-written CUDA kernel for Hopper.

`row_gather(table, rows, mask)` is `table[clamp(rows, 0, B - 1)] & mask`
over a contiguous (B, W) table of 32- or 64-bit words: every row gather
of the create_transfers path (the account and transfer role gathers,
the in-window pending view, the balance bases, the insert plan's bucket
rows, the ledger's lookups).

It replaces the eight Pallas TPU kernels that are formulations of this
one function on a (4097, 48) u32 table at 8,192 rows:
`onchip/gather_probe.py:31` k_take, `:35` k_taa, `:40` k_loop, `:47`
k_onehot (low 16-bit limb), `onchip/gather_probe2.py:31` k_smem_loop,
`:56` k_taa32, `:74` k_onehot32 (low 16-bit limb) and `:101` k_blk.
None of them lowered on the TPU, so the JAX package gathers with XLA's
`x[rows]`; the port's kernel is `csrc/row_gather.cu`, built with nvcc
for sm_90a at first use and bound with ctypes (`_build.py`).

What bounds it on an H100 is bytes: the output written once, each
distinct gathered row read once in 32-byte sectors, the indexes read
once — over 3.35 TB/s. The kernel moves 16 bytes a thread where the row
width allows (see the source note).

An int64 table is gathered through its int32 view (`table.view(
torch.int32)`, twice the width), which is what the probes planned for
the u64 stores; the view needs a contiguous table, so a strided one
raises. A mask applies to 32-bit words only, so it is refused on an
int64 table.

Routing is by the device of the tensors alone: CUDA tensors launch the
kernel (or raise), CPU tensors run the plain twin. `LAUNCHES` counts
kernel launches and nothing else.
"""

from __future__ import annotations

import torch

from . import _build

LAUNCHES = 0

FULL_MASK = 0xFFFFFFFF
_INDEX_DTYPES = (torch.int32, torch.int64)
_TABLE_DTYPES = (torch.int32, torch.int64)


def _check(table, rows, mask) -> None:
    if table.dtype not in _TABLE_DTYPES or table.dim() != 2:
        raise ValueError(f"row_gather: table must be a 2-D int32 or int64 "
                         f"tensor, got {table.dtype} {tuple(table.shape)}")
    if not table.is_contiguous():
        raise ValueError("row_gather: table must be contiguous (its rows "
                         "are read as 32-bit words)")
    if table.shape[0] < 1:
        raise ValueError("row_gather: table has no rows")
    if rows.dtype not in _INDEX_DTYPES or rows.dim() != 1:
        raise ValueError(f"row_gather: rows must be a 1-D int32 or int64 "
                         f"tensor, got {rows.dtype} {tuple(rows.shape)}")
    if not rows.is_contiguous():
        raise ValueError("row_gather: rows must be contiguous")
    if mask is not None:
        if not 0 <= mask <= FULL_MASK:
            raise ValueError(f"row_gather: mask {mask:#x} is not a 32-bit "
                             "word")
        if table.dtype != torch.int32 and mask != FULL_MASK:
            raise ValueError("row_gather: a mask applies to 32-bit tables "
                             "only")


def _signed32(mask: int) -> int:
    return mask - (1 << 32) if mask >> 31 else mask


def row_gather_plain(table, rows, mask=None):
    """The plain PyTorch twin: table[rows.clamp(0, B - 1)] & mask."""
    out = table[rows.clamp(0, table.shape[0] - 1)]
    if mask is not None and mask != FULL_MASK:
        out = out & _signed32(mask)
    return out


def row_gather(table, rows, mask=None):
    """Gather rows of `table` at `rows` (clamped), masked per 32-bit
    word by `mask` (None: every bit)."""
    global LAUNCHES
    _check(table, rows, mask)
    devs = {table.device.type, rows.device.type}
    if devs == {"cpu"}:
        return row_gather_plain(table, rows, mask)
    if devs != {"cuda"} or table.device != rows.device:
        raise ValueError(
            f"row_gather: table on {table.device}, rows on {rows.device}; "
            "expected both on one CUDA device (or both on the CPU)")
    n = rows.shape[0]
    out = torch.empty((n, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if n == 0 or table.shape[1] == 0:
        return out
    words = table.view(torch.int32)
    lib = _build.load_row_gather()
    stream = torch.cuda.current_stream(table.device).cuda_stream
    rc = lib.row_gather_launch(
        words.data_ptr(), words.shape[0], words.shape[1], rows.data_ptr(),
        int(rows.dtype == torch.int64), n,
        FULL_MASK if mask is None else mask, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"row_gather launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out
