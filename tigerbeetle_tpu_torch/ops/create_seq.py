"""The sequential create_transfers / create_accounts kernels: one
hand-written CUDA kernel each for Hopper (`csrc/create_seq.cu`), one
launch a batch.

No Pallas counterpart: they replace the JAX package's XLA kernels
`create_transfers_kernel` and `create_accounts_kernel`
(tigerbeetle_tpu/ops/create_kernels.py:664, :792), lax.fori_loops over
the batch. In PyTorch the plain form is a loop over the events, which on
the card would pay a launch for each. Each kernel is one block: a
parallel pre-pass decodes every event and folds every check that reads
only immutable inputs, then one warp walks the events in order (the
plain twins run the same two stages). The transfers walk branches on
each event's path; the accounts walk takes a chunk of 32 events in one
warp step where nothing but key_max carries between them. What bounds
them is latency (the walk's chain of dependent steps), not bytes; see
the source note.

`create_transfers_seq(tin)` / `create_accounts_seq(tin)` take the
prefetched inputs on one device (`create_kernels.inputs_to_device`) and
return the kernel's carry as a dict of tensors, the same dict as their
plain twins `create_kernels.create_transfers_seq_plain` /
`create_accounts_seq_plain` return. Routing is by the tensors' device
alone: CUDA tensors launch the kernel (or raise), CPU tensors run the
plain twin. The wrapper allocates the outputs uninitialised (the kernel
writes every one), hands the kernel every tensor's pointer in the order
of the source's `Ptr` enums (`CT_PTRS` / `CA_PTRS`), a buffer for its
%globaltimer stamps and a scratch buffer of the size the source asks
for, and launches once on the current stream. `LAUNCHES` counts kernel
launches and nothing else (`KIND_LAUNCHES` the same by kernel); `STAMPS`
holds each kernel's last stamps (`device_ms(kind)` and `stage_ms(kind)`
read them: device time without a profiler).

`run_create_transfers` / `run_create_accounts` are prefetch -> kernel ->
apply on a host state in one call, the port's counterpart of the JAX
package's `engine="kernel"`. Each records its three steps' host-clock
ms in `SPANS`.
"""

from __future__ import annotations

import ctypes
import time

import torch

from . import _build
from .batch import (
    accounts_to_arrays,
    prefetch_create_accounts,
    prefetch_create_transfers,
    transfers_to_arrays,
)
from .create_kernels import (
    CA_OUT_DTYPES,
    CT_OUT_DTYPES,
    _B,
    apply_create_accounts,
    apply_create_transfers,
    create_accounts_seq_plain,
    create_transfers_seq_plain,
    inputs_to_device,
    outputs_to_numpy,
)
from .device import resolve_device

LAUNCHES = 0
# The same launches by kernel.
KIND_LAUNCHES = {"transfers": 0, "accounts": 0}

# Each kernel's last launch's %globaltimer ns (a device tensor), at its
# five stage boundaries (STAGES).
STAMPS: dict = {}
STAGES = ("stage", "prepass", "walk", "unstage")

# Host-clock ms of the last run_create_* call: "prefetch" (the host
# prefetch and the copy of its inputs to the device), "kernel" (the
# launch and the copy of its outputs to the host, which waits for the
# kernel) and "apply" (the outputs applied to the host state).
SPANS: dict = {}

_EV_U128 = ("id", "dr", "cr", "amt", "pid", "ud128")
_LIMBS = tuple(f"{f}_{h}" for f in _EV_U128 for h in ("hi", "lo"))

# (group, key) of each pointer, in the order of csrc/create_seq.cu's
# `ct::Ptr` / `ca::Ptr` enums (group "st" is the carry).
CT_PTRS = (
    *(("event", k) for k in _LIMBS + (
        "ud64", "ud32", "timeout", "ledger", "code", "flags", "ts",
        "dr_idx", "cr_idx", "exists_idx", "slot", "pending_cache_idx",
        "pending_slot", "valid", "orphaned", "acct_ts_collision")),
    *(("acct", k) for k in ("exists", "ledger", "ts")),
    *(("tc", k) for k in ("dr_idx", "cr_idx") + _LIMBS[2:] + (
        "ud64", "ud32", "timeout", "ledger", "code", "flags", "ts",
        "expires_at")),
    *(("st", k) for k in (
        "a_dp_hi", "a_dp_lo", "a_dpos_hi", "a_dpos_lo", "a_cp_hi",
        "a_cp_lo", "a_cpos_hi", "a_cpos_lo", "a_flags",
        "s_created", "s_orphaned", "s_amt_hi", "s_amt_lo", "s_dr_hi",
        "s_dr_lo", "s_cr_hi", "s_cr_lo", "s_pid_hi", "s_pid_lo",
        "s_ud128_hi", "s_ud128_lo", "s_ud64", "s_ud32", "s_timeout",
        "s_ledger", "s_code", "s_flags", "s_ts", "s_pstat", "s_expires",
        "s_dr_idx", "s_cr_idx",
        "tc_pstat",
        "rb_kind", "rb_dr_idx", "rb_cr_idx", "rb_amt_hi", "rb_amt_lo",
        "rb_pamt_hi", "rb_pamt_lo", "rb_p_idx", "rb_p_batch",
        "rb_dr_closed", "rb_cr_closed",
        "r_ts", "r_status",
        "key_max", "pulse_next", "chain_key_max", "chain_start",
        "chain_broken")),
    *(("acct", k) for k in ("dp_hi", "dp_lo", "dpos_hi", "dpos_lo", "cp_hi",
                            "cp_lo", "cpos_hi", "cpos_lo", "flags")),
    ("tc", "pending_status"),
)
CA_PTRS = (
    *(("event", k) for k in (
        "id_hi", "id_lo", "dp_hi", "dp_lo", "dpos_hi", "dpos_lo", "cp_hi",
        "cp_lo", "cpos_hi", "cpos_lo", "ud128_hi", "ud128_lo", "ud64",
        "ud32", "reserved", "ledger", "code", "flags", "ts", "exists_idx",
        "slot", "valid", "transfer_ts_collision")),
    *(("ac", k) for k in ("ud128_hi", "ud128_lo", "ud64", "ud32", "ledger",
                          "code", "flags", "ts")),
    *(("st", k) for k in (
        "s_created", "s_ud128_hi", "s_ud128_lo", "s_ud64", "s_ud32",
        "s_ledger", "s_code", "s_flags", "s_ts", "r_ts", "r_status",
        "key_max", "chain_key_max", "chain_start", "chain_broken")),
)

_launch = {}  # kind -> the C entry point, resolved at its first launch


def _device_of(tin: dict, name: str) -> torch.device:
    """The one device every input tensor lies on; raises on a mix, a
    dtype other than int64 / bool, or a non-contiguous tensor."""
    devs = set()
    for group in tin.values():
        if not isinstance(group, dict):
            continue
        for k, t in group.items():
            if (t.dtype not in (torch.int64, torch.bool)
                    or not t.is_contiguous()):
                raise ValueError(f"{name}: input {k} must be a contiguous "
                                 f"int64 or bool tensor, got {t.dtype}")
            devs.add(t.device)
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on {sorted(map(str, devs))}; "
                         "expected all on one CUDA device (or all on the "
                         "CPU)")
    return devs.pop()


def _outputs(tin: dict, dtypes: dict) -> dict:
    """A sequential kernel's outputs, uninitialised (it writes every
    one): the twin's keys, shapes and dtypes."""
    ev = tin["event"]
    dev = ev["id_lo"].device

    def shape(k):
        if k.startswith("a_"):  # the account cache's rows
            return tin["acct"]["exists"].shape
        if k == "tc_pstat":     # the committed cache's rows
            return tin["tc"]["pending_status"].shape
        if k.startswith(("s_", "rb_", "r_")):  # a lane's
            return ev["id_lo"].shape
        return ()               # the scalars

    return {k: torch.empty(shape(k), device=dev,
                           dtype=torch.bool if dt == _B else torch.int64)
            for k, dt in dtypes.items()}


def _seq_args(ptrs, tin: dict, st: dict):
    """The argument block: every pointer in the source's enum order, the
    scalars (the kind's key_max among them) and, for create_transfers,
    the cache sizes and pulse_next."""
    args = _build.SeqArgs()
    for k, (group, key) in enumerate(ptrs):
        args.p[k] = (st if group == "st" else tin[group])[key].data_ptr()
    args.timestamp = tin["timestamp"]
    args.n = tin["n_events"]
    args.N = tin["event"]["id_lo"].shape[0]
    if "tc" in tin:
        args.a_rows = tin["acct"]["exists"].shape[0]
        args.t_rows = tin["tc"]["pending_status"].shape[0]
        args.key_max = tin["transfers_key_max"]
        args.pulse_next = tin["pulse_next"]
    else:
        args.key_max = tin["accounts_key_max"]
    return args


def _run(kind: str, ptrs, dtypes, plain, tin: dict) -> dict:
    global LAUNCHES
    name = f"create_{kind}_seq"
    dev = _device_of(tin, name)
    if dev.type == "cpu":
        return plain(tin)
    if dev.type != "cuda":
        raise ValueError(f"{name}: inputs on {dev}; expected a CUDA device "
                         "(or the CPU)")
    st = _outputs(tin, dtypes)
    args = _seq_args(ptrs, tin, st)
    fn = _launch.get(kind)
    if fn is None:
        fn = _launch[kind] = _build.load_create_seq(kind)
    stamps = torch.empty(len(STAGES) + 1, dtype=torch.int64, device=dev)
    args.stamps = stamps.data_ptr()
    scratch = torch.empty(_build.create_seq_scratch_bytes(kind, args),
                          dtype=torch.uint8, device=dev)
    args.scratch = scratch.data_ptr()
    rc = fn(ctypes.byref(args), 1,
            torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES += 1
    KIND_LAUNCHES[kind] += 1
    STAMPS[kind] = stamps
    return st


def stage_ms(kind: str) -> dict:
    """The last launch of `kind`'s kernel ("transfers" or "accounts"):
    its device ms in each stage, from its %globaltimer stamps (waits for
    the launch)."""
    t = STAMPS[kind].cpu().tolist()
    return {s: (t[k + 1] - t[k]) / 1e6 for k, s in enumerate(STAGES)}


def device_ms(kind: str) -> float:
    """The last launch of `kind`'s kernel ("transfers" or "accounts"):
    its device ms from its first to its last %globaltimer stamp (waits
    for the launch)."""
    t = STAMPS[kind].cpu().tolist()
    return (t[-1] - t[0]) / 1e6


def create_transfers_seq(tin: dict) -> dict:
    """One create_transfers batch through the sequential kernel: the CUDA
    kernel for CUDA inputs, the plain twin for CPU inputs."""
    return _run("transfers", CT_PTRS, CT_OUT_DTYPES,
                create_transfers_seq_plain, tin)


def create_accounts_seq(tin: dict) -> dict:
    """One create_accounts batch through the sequential kernel."""
    return _run("accounts", CA_PTRS, CA_OUT_DTYPES,
                create_accounts_seq_plain, tin)


# ======================================================== one-call wrappers

def _run_create(state, arrays, prefetch, kernel, dtypes, apply, timestamp,
                device) -> list:
    device = resolve_device(device)
    t0 = time.perf_counter()
    inputs, aux = prefetch(state, arrays, timestamp)
    tin = inputs_to_device(inputs, device)
    t1 = time.perf_counter()
    out = outputs_to_numpy(kernel(tin), dtypes)
    t2 = time.perf_counter()
    res = apply(state, inputs, aux, out)
    t3 = time.perf_counter()
    SPANS.update(prefetch=(t1 - t0) * 1e3, kernel=(t2 - t1) * 1e3,
                 apply=(t3 - t2) * 1e3)
    return res


def run_create_transfers(state, transfers, timestamp: int,
                         device=None) -> list:
    """prefetch -> kernel -> apply on a host state (the port's
    `StateMachineOracle`): a drop-in for its create_transfers that
    validates on `device` (None: the card; "cpu": the plain twin)."""
    return _run_create(state, transfers_to_arrays(transfers),
                       prefetch_create_transfers, create_transfers_seq,
                       CT_OUT_DTYPES, apply_create_transfers, timestamp,
                       device)


def run_create_accounts(state, accounts, timestamp: int,
                        device=None) -> list:
    """run_create_transfers for create_accounts."""
    return _run_create(state, accounts_to_arrays(accounts),
                       prefetch_create_accounts, create_accounts_seq,
                       CA_OUT_DTYPES, apply_create_accounts, timestamp,
                       device)
