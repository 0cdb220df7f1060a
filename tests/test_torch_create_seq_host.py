"""`csrc/create_seq.cu` itself on the CPU.

The sequential kernels are CUDA and run only on the card, where
chip_smoke.py holds them to their plain twins. Here g++ builds the same
source for the host under `cuda_host_emulation.h` (one block of
std::threads; barriers for __syncthreads and the warp intrinsics; the
inline PTX of %globaltimer and cp.async replaced by a zero and a copy),
and both kernels run on CPU tensors through the wrapper's own argument
block and output allocation (`create_seq._seq_args`, `_outputs`), held
to the twins on every output: the hazard batches of both kernels, a
fuzzed sequence, and lanes enough that the hot region leaves shared
memory. A fault in a kernel's split between its pre-pass and its walk
shows here before a card run.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as CS
from tigerbeetle_tpu_torch import types as TT
from tigerbeetle_tpu_torch.oracle import StateMachineOracle
from tigerbeetle_tpu_torch.ops import _build, create_seq
from tigerbeetle_tpu_torch.ops import batch as PB
from tigerbeetle_tpu_torch.ops import create_kernels as PK

HERE = Path(__file__).resolve().parent
KINDS = ("transfers", "accounts")


def _host_source() -> str:
    """create_seq.cu with its CUDA-only lines made host C++."""
    src = (_build.CSRC / "create_seq.cu").read_text()
    subs = [
        ("#include <cuda_runtime.h>", '#include "cuda_host_emulation.h"'),
        (r'asm volatile\("mov\.u64 %0, %%globaltimer;" : "=l"\(t\)\);',
         "t = 0;"),
        (r'asm volatile\("cp\.async\.cg\.shared\.global \[%0\], \[%1\], '
         r'16;\\n" ::"r"\(s\),\s*"l"\(src\)\s*: "memory"\);',
         "(void)s; std::memcpy(dst, src, 16);"),
        (r'asm volatile\("cp\.async\.commit_group;\\n" ::: "memory"\);', ""),
        (r'asm volatile\("cp\.async\.wait_group 0;\\n" ::: "memory"\);', ""),
        (r"extern __shared__ __align__\(16\) unsigned char smem\[\];",
         "unsigned char* smem = emu_smem;"),
        (r"(\w+)<<<1, (\w+), .*?>>>\(\*args\);",
         r"emu_launch(\1, \2, *args);"),
    ]
    for pattern, repl in subs:
        src, n = re.subn(pattern, repl, src, flags=re.S)
        assert n, f"create_seq.cu no longer has {pattern!r}"
    assert "asm volatile" not in src, \
        "create_seq.cu has inline PTX the host lacks"
    return src


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """create_seq.cu built for the host; {kind: (launch, scratch)}."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build create_seq.cu for the host")
    d = tmp_path_factory.mktemp("create_seq_host")
    cpp = d / "create_seq_host.cpp"
    cpp.write_text(_host_source())
    lib = d / "libcreate_seq_host.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
         f"-I{HERE}", "-o", str(lib), str(cpp)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    so = ctypes.CDLL(str(lib))
    out = {}
    for kind in KINDS:
        launch = getattr(so, f"create_{kind}_seq_launch")
        launch.argtypes = [ctypes.POINTER(_build.SeqArgs), ctypes.c_int,
                           ctypes.c_void_p]
        launch.restype = ctypes.c_int
        scratch = getattr(so, f"create_{kind}_seq_scratch")
        scratch.argtypes = [ctypes.POINTER(_build.SeqArgs)]
        scratch.restype = ctypes.c_longlong
        out[kind] = (launch, scratch)
    return out


def _run_host(host_lib, kind: str, tin: dict) -> dict:
    """One launch of `kind`'s kernel on the host, as `create_seq._run`
    launches it on the card; its outputs start as garbage."""
    launch, scratch_bytes = host_lib[kind]
    ptrs = create_seq.CT_PTRS if kind == "transfers" else create_seq.CA_PTRS
    dtypes = PK.CT_OUT_DTYPES if kind == "transfers" else PK.CA_OUT_DTYPES
    st = create_seq._outputs(tin, dtypes)
    for t in st.values():
        t.fill_(True) if t.dtype == torch.bool else t.fill_(-7)
    args = create_seq._seq_args(ptrs, tin, st)
    stamps = torch.zeros(len(create_seq.STAGES) + 1, dtype=torch.int64)
    args.stamps = stamps.data_ptr()
    scratch = torch.full((scratch_bytes(ctypes.byref(args)),), 0xAB,
                         dtype=torch.uint8)
    args.scratch = scratch.data_ptr()
    assert launch(ctypes.byref(args), 1, None) == 0
    return st


def _same_as_twin(host_lib, kind: str, inputs: dict) -> dict:
    tin = PK.inputs_to_device(inputs, "cpu")
    plain = (PK.create_transfers_seq_plain if kind == "transfers"
             else PK.create_accounts_seq_plain)
    want = plain(tin)
    got = _run_host(host_lib, kind, tin)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), (kind, k)
    return want


def _prefetch(kind, state, events, ts, **kw):
    if kind == "transfers":
        return PB.prefetch_create_transfers(
            state, PB.transfers_to_arrays(events), ts, **kw)
    return PB.prefetch_create_accounts(
        state, PB.accounts_to_arrays(events), ts, **kw)


HAZARDS = [("transfers", *c) for c in CS.seq_hazard_cases(
    TT.Transfer, TT.TransferFlags)] + [("accounts", *c) for c in
                                       CS.seq_account_hazard_cases(
                                           TT.Account, TT.AccountFlags)]


@pytest.mark.parametrize("kind, name, events, ts, expect", HAZARDS,
                         ids=[f"{c[0]}: {c[1]}" for c in HAZARDS])
def test_kernels_match_the_twins_on_the_hazard_batches(
        host_lib, kind, name, events, ts, expect):
    state = StateMachineOracle()
    for op, evs, at in CS.seq_hazard_setup(TT.Account, TT.AccountFlags,
                                          TT.Transfer, TT.TransferFlags):
        getattr(state, f"create_{op}")(evs, at)
    inputs, _ = _prefetch(kind, state, events, ts)
    want = _same_as_twin(host_lib, kind, inputs)
    codes = PK._TS if kind == "transfers" else PK._AS
    for k, status in expect.items():
        assert int(want["r_status"][k]) == codes[status], (name, k)


def test_kernels_match_the_twins_on_a_fuzzed_sequence(host_lib):
    """Mixed and imported batches of both kinds on one state, each
    applied (from the twin's outputs) before the next."""
    rng = np.random.default_rng(11)
    state = StateMachineOracle()
    accounts = CS.seq_mixed_accounts(TT.Account, TT.AccountFlags, rng, 60, 1)
    for a in accounts:
        a.flags &= ~int(TT.AccountFlags.linked)
    ts = 10**12
    state.create_accounts(accounts, ts)
    pend = [TT.Transfer(id=10**6 + j, debit_account_id=1 + j % 60,
                        credit_account_id=1 + (j + 5) % 60, amount=50 + j,
                        ledger=1, code=1, flags=TT.TransferFlags.pending,
                        timeout=j % 2) for j in range(40)]
    state.create_transfers(pend, ts + 1000)
    steps = []
    for b in range(2):
        ts += 10**4
        steps.append(("transfers", CS.seq_mixed_transfers(
            TT.Transfer, TT.TransferFlags, rng, 150, 2 * 10**6 + b * 10**4,
            60, [t.id for t in pend]), ts))
        ts += 10**4
        steps.append(("accounts", CS.seq_mixed_accounts(
            TT.Account, TT.AccountFlags, rng, 150, 10**5 + b * 10**4,
            imported_after=ts - 5000 if b else None), ts))
    for kind, events, at in steps:
        inputs, aux = _prefetch(kind, state, events, at)
        want = _same_as_twin(host_lib, kind, inputs)
        dtypes = PK.CT_OUT_DTYPES if kind == "transfers" else PK.CA_OUT_DTYPES
        apply = getattr(PK, f"apply_create_{kind}")
        apply(state, inputs, aux, PK.outputs_to_numpy(want, dtypes))


@pytest.mark.parametrize("kind", KINDS)
def test_kernels_match_the_twins_with_the_hot_region_in_global_memory(
        host_lib, kind):
    """24,576 lanes: each kernel's hot region no longer fits in shared
    memory and lives in the global scratch."""
    rng = np.random.default_rng(12)
    state = StateMachineOracle()
    state.create_accounts([TT.Account(id=i, ledger=1, code=1)
                           for i in range(1, 41)], 10**9)
    if kind == "transfers":
        events = CS.seq_mixed_transfers(TT.Transfer, TT.TransferFlags, rng,
                                        300, 5 * 10**6, 40, [])
    else:
        events = CS.seq_mixed_accounts(TT.Account, TT.AccountFlags, rng,
                                       300, 10**5)
    inputs, _ = _prefetch(kind, state, events, 10**12, n_pad=24_576)
    _same_as_twin(host_lib, kind, inputs)
