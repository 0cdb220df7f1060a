"""The port's sequential create kernels against the JAX package's.

- `prefetch_create_*` against the JAX package's, field by field;
- the plain twins `create_*_seq_plain` against the JAX kernels
  `create_transfers_kernel` / `create_accounts_kernel` on every output,
  at two compiled shapes (one a kernel: the JAX kernels compile for each
  cache shape, so every batch is padded to the same one): a fuzzed
  sequence, and the transfers kernel's hazard batches
  (`chip_smoke.seq_hazard_cases`) and the accounts kernel's
  (`seq_account_hazard_cases`), where a check that a twin's pre-pass
  took for immutable would read state an earlier event wrote;
- `run_create_*` on the CPU (the plain twin) against the JAX oracle on
  several seeds, results and whole state;
- the CUDA wrapper's routing and its argument block: the pointer order,
  the status codes and the order of the checks behind each mask bit of
  `csrc/create_seq.cu` agree with the Python side (the kernel itself
  runs only on the card: chip_smoke.py holds it against the plain twin
  there).

Inputs are made from numpy seeds by chip_smoke.py's generators.
"""

import dataclasses
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chip_smoke as CS
import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)
from tigerbeetle_tpu.oracle import StateMachineOracle as JaxOracle
from tigerbeetle_tpu.ops import batch as JB
from tigerbeetle_tpu.ops import create_kernels as JK
from tigerbeetle_tpu.types import Account, Transfer
from tigerbeetle_tpu_torch import types as TT
from tigerbeetle_tpu_torch.oracle import StateMachineOracle
from tigerbeetle_tpu_torch.ops import batch as PB
from tigerbeetle_tpu_torch.ops import create_kernels as PK
from tigerbeetle_tpu_torch.ops import create_seq

# One intra-op thread: these tests share the CPU with the rest of the
# suite, some of whose tests time themselves.
torch.set_num_threads(1)

N_ACCOUNTS = 60
CU = Path(__file__).resolve().parent.parent / \
    "tigerbeetle_tpu_torch" / "csrc" / "create_seq.cu"
# The one compiled shape of each JAX kernel here: events, and rows of
# each cache.
N_PAD = 128
CACHE_ROWS = 512


def _objs(objs, cls):
    return [cls(**dataclasses.asdict(o)) for o in objs]


def _res(results):
    return [(r.timestamp, int(r.status)) for r in results]


def _states_equal(port, ref):
    from test_torch_oracle import state_of
    assert state_of(port) == state_of(ref)


def steps_for(seed: int, n: int = 100):
    """(op, events on the port's types, timestamp): accounts, committed
    pendings, mixed and imported transfer batches, imported and mixed
    account batches."""
    rng = np.random.default_rng(seed)
    ts = 10**12
    accounts = CS.seq_mixed_accounts(TT.Account, TT.AccountFlags, rng,
                                     N_ACCOUNTS, 1)
    for a in accounts:
        a.flags &= ~int(TT.AccountFlags.linked)
    pend = [TT.Transfer(id=10**6 + j, debit_account_id=1 + j % N_ACCOUNTS,
                        credit_account_id=1 + (j + 5) % N_ACCOUNTS,
                        amount=50 + j, ledger=1, code=1,
                        flags=TT.TransferFlags.pending,
                        timeout=(1 if j % 3 == 0 else 0))
            for j in range(40)]
    pend_ids = [t.id for t in pend]
    steps = [("accounts", accounts, ts), ("transfers", pend, ts + 1000)]
    ts += 10**4
    for b in range(2):
        ts += 10**4
        steps.append(("transfers", CS.seq_mixed_transfers(
            TT.Transfer, TT.TransferFlags, rng, n, 2 * 10**6 + b * 10**4,
            N_ACCOUNTS, pend_ids), ts))
    ts += 10**4
    steps.append(("transfers", CS.seq_mixed_transfers(
        TT.Transfer, TT.TransferFlags, rng, n, 3 * 10**6, N_ACCOUNTS,
        pend_ids, imported_after=ts - 5000), ts))
    ts += 10**4
    steps.append(("accounts", CS.seq_mixed_accounts(
        TT.Account, TT.AccountFlags, rng, n, 10**5,
        imported_after=ts - 5000), ts))
    ts += 10**4
    steps.append(("accounts", CS.seq_mixed_accounts(
        TT.Account, TT.AccountFlags, rng, n, 2 * 10**5), ts))
    return steps


def _prefetch(kind, port, ref, events, ts, **kw):
    if kind == "transfers":
        return (PB.prefetch_create_transfers(
                    port, PB.transfers_to_arrays(events), ts, **kw),
                JB.prefetch_create_transfers(
                    ref, JB.transfers_to_arrays(_objs(events, Transfer)),
                    ts, **kw))
    return (PB.prefetch_create_accounts(
                port, PB.accounts_to_arrays(events), ts, **kw),
            JB.prefetch_create_accounts(
                ref, JB.accounts_to_arrays(_objs(events, Account)), ts,
                **kw))


def _assert_same_arrays(got: dict, want: dict, where: str):
    assert set(got) == set(want), where
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_same_arrays(got[k], w, f"{where}.{k}")
            continue
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.dtype == w.dtype, (where, k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{where}.{k}")


def _apply_both(kind, port, ref, p_in, p_aux, p_out, j_in, j_aux, j_out):
    if kind == "transfers":
        got = PK.apply_create_transfers(port, p_in, p_aux, p_out)
        want = JK.apply_create_transfers(ref, j_in, j_aux, j_out)
    else:
        got = PK.apply_create_accounts(port, p_in, p_aux, p_out)
        want = JK.apply_create_accounts(ref, j_in, j_aux, j_out)
    assert _res(got) == _res(want)


@pytest.mark.parametrize("seed", [0, 1])
def test_prefetch_matches_the_jax_prefetch(seed):
    """Both prefetches, field by field, on every step of a fuzzed
    sequence (each applied to both oracles before the next)."""
    port, ref = StateMachineOracle(), JaxOracle()
    for kind, events, ts in steps_for(seed):
        (p_in, p_aux), (j_in, j_aux) = _prefetch(kind, port, ref, events,
                                                 ts)
        _assert_same_arrays(p_in, j_in, kind)
        for k in ("event_ids", "n") + (("event_pids",)
                                       if kind == "transfers" else ()):
            assert p_aux[k] == j_aux[k]
        idx = "acct_id_to_idx" if kind == "transfers" else "ac_id_to_idx"
        assert p_aux[idx] == j_aux[idx]
        if kind == "transfers":
            assert [dataclasses.astuple(t) for t in p_aux["tc_rows"]] == \
                [dataclasses.astuple(t) for t in j_aux["tc_rows"]]
        op = f"create_{kind}"
        assert _res(getattr(port, op)(events, ts)) == _res(getattr(ref, op)(
            _objs(events, Account if kind == "accounts" else Transfer), ts))


def _fixed_shape(inputs: dict, kind: str) -> dict:
    caches = ("acct", "tc") if kind == "transfers" else ("ac",)
    out = dict(inputs)
    for c in caches:
        out[c] = JB.pad_cache(inputs[c], CACHE_ROWS)
    return out


def _twin_against_jax(kind, port, ref, p_in, p_aux, j_in, j_aux, j_out):
    """The plain twin on the port's inputs against the JAX kernel's
    outputs `j_out`: every output array equal, in the JAX dtypes; then
    each package applies its own outputs and the two states stay equal.
    Returns the twin's results."""
    if kind == "transfers":
        p_st = PK.create_transfers_seq_plain(PK.inputs_to_device(p_in, "cpu"))
        dtypes = PK.CT_OUT_DTYPES
    else:
        p_st = PK.create_accounts_seq_plain(PK.inputs_to_device(p_in, "cpu"))
        dtypes = PK.CA_OUT_DTYPES
    p_out = PK.outputs_to_numpy(p_st, dtypes)
    assert set(p_st) == set(dtypes)
    _assert_same_arrays(p_out, {k: np.asarray(v) for k, v
                                in j_out.items()}, kind)
    _apply_both(kind, port, ref, p_in, p_aux, p_out, j_in, j_aux, j_out)
    _states_equal(port, ref)
    return p_out


HAZARDS = {name: (events, ts, expect) for name, events, ts, expect
           in CS.seq_hazard_cases(TT.Transfer, TT.TransferFlags)}
ACCOUNT_HAZARDS = {
    name: (events, ts, expect) for name, events, ts, expect
    in CS.seq_account_hazard_cases(TT.Account, TT.AccountFlags)}


def _hazard_runs(kind: str, cases: dict) -> dict:
    """Each hazard batch of `cases` on both packages' oracles after
    chip_smoke.seq_hazard_setup: (port, ref, the port's and the JAX
    package's prefetched inputs, the JAX kernel's outputs)."""
    kernel = (JK.create_transfers_kernel if kind == "transfers"
              else JK.create_accounts_kernel)
    out = {}
    for name, (events, ts, _) in cases.items():
        port, ref = StateMachineOracle(), JaxOracle()
        for op, evs, at in CS.seq_hazard_setup(
                TT.Account, TT.AccountFlags, TT.Transfer, TT.TransferFlags):
            getattr(port, f"create_{op}")(evs, at)
            getattr(ref, f"create_{op}")(_objs(evs, Account if op ==
                                               "accounts" else Transfer), at)
        (p_in, p_aux), (j_in, j_aux) = _prefetch(kind, port, ref, events,
                                                 ts, n_pad=N_PAD)
        p_in, j_in = _fixed_shape(p_in, kind), _fixed_shape(j_in, kind)
        out[name] = (port, ref, p_in, p_aux, j_in, j_aux,
                     jax.device_get(kernel(j_in)))
    return out


@pytest.fixture(scope="module")
def jax_hazards():
    """The transfers hazard batches (chip_smoke.seq_hazard_cases) through
    both packages (`_hazard_runs`)."""
    return _hazard_runs("transfers", HAZARDS)


@pytest.fixture(scope="module")
def jax_account_hazards():
    """The accounts hazard batches (chip_smoke.seq_account_hazard_cases)
    through both packages (`_hazard_runs`)."""
    return _hazard_runs("accounts", ACCOUNT_HAZARDS)


@pytest.mark.parametrize("case", ["fuzzed", *HAZARDS, *ACCOUNT_HAZARDS])
def test_plain_twins_match_the_jax_kernels_on_every_output(case, request):
    """The plain twins against the JAX kernels on the same inputs, every
    output. "fuzzed": every step of a fuzzed sequence, each applied to
    both oracles before the next. The others: one hazard batch of a
    twin's two stages each (chip_smoke.seq_hazard_cases for transfers,
    seq_account_hazard_cases for accounts), whose key events must also
    end with the statuses the case names."""
    if case in HAZARDS:
        kind, fixture, expect = "transfers", "jax_hazards", HAZARDS[case][2]
        status = {int(s): s.name for s in TT.CreateTransferStatus}
    elif case in ACCOUNT_HAZARDS:
        kind, fixture = "accounts", "jax_account_hazards"
        expect = ACCOUNT_HAZARDS[case][2]
        status = {int(s): s.name for s in TT.CreateAccountStatus}
    if case != "fuzzed":
        got = _twin_against_jax(kind, *request.getfixturevalue(fixture)[case])
        for k, name in expect.items():
            assert status[int(got["r_status"][k])] == name, (case, k)
        return
    port, ref = StateMachineOracle(), JaxOracle()
    for kind, events, ts in steps_for(7):
        (p_in, p_aux), (j_in, j_aux) = _prefetch(kind, port, ref, events,
                                                 ts, n_pad=N_PAD)
        p_in, j_in = _fixed_shape(p_in, kind), _fixed_shape(j_in, kind)
        kernel = (JK.create_transfers_kernel if kind == "transfers"
                  else JK.create_accounts_kernel)
        _twin_against_jax(kind, port, ref, p_in, p_aux, j_in, j_aux,
                          jax.device_get(kernel(j_in)))


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_run_create_matches_the_jax_oracle(seed):
    """run_create_* on the CPU (prefetch -> plain twin -> apply) against
    the JAX oracle: results and whole state after every step, then the
    expiry pulse on both states."""
    port, ref = StateMachineOracle(), JaxOracle()
    for kind, events, ts in steps_for(seed, n=60):
        if kind == "transfers":
            got = create_seq.run_create_transfers(port, events, ts,
                                                  device="cpu")
            want = ref.create_transfers(_objs(events, Transfer), ts)
        else:
            got = create_seq.run_create_accounts(port, events, ts,
                                                 device="cpu")
            want = ref.create_accounts(_objs(events, Account), ts)
        assert _res(got) == _res(want)
        _states_equal(port, ref)
    later = 10**13
    assert port.pulse_needed(later) and ref.pulse_needed(later)
    assert port.expire_pending_transfers(later) == \
        ref.expire_pending_transfers(later) > 0
    _states_equal(port, ref)


def test_wrappers_route_by_device():
    """CPU tensors run the plain twin; inputs on another device, or on
    two devices, are refused; run_create_* defaults to the card."""
    sm = StateMachineOracle()
    sm.create_accounts([TT.Account(id=i, ledger=1, code=1)
                        for i in (1, 2)], 10)
    events = [TT.Transfer(id=5, debit_account_id=1, credit_account_id=2,
                          amount=3, ledger=1, code=1)]
    inputs, _ = PB.prefetch_create_transfers(
        sm, PB.transfers_to_arrays(events), 100)
    tin = PK.inputs_to_device(inputs, "cpu")
    before = create_seq.LAUNCHES
    got = create_seq.create_transfers_seq(tin)
    want = PK.create_transfers_seq_plain(tin)
    assert create_seq.LAUNCHES == before
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)

    meta = PK.inputs_to_device(inputs, "meta")
    with pytest.raises(ValueError, match="expected a CUDA device"):
        create_seq.create_transfers_seq(meta)
    mixed = dict(tin, tc=meta["tc"])
    with pytest.raises(ValueError, match="one CUDA device"):
        create_seq.create_transfers_seq(mixed)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_seq.run_create_transfers(sm, events, 100)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_seq.run_create_accounts(
                sm, [TT.Account(id=3, ledger=1, code=1)], 200)


def _enum(text: str, namespace: str) -> list:
    body = re.search(rf"namespace {namespace} {{\s*enum Ptr {{(.*?)}};",
                     text, re.S).group(1)
    names = [n.strip() for n in body.replace("\n", " ").split(",")]
    return [n for n in names if n and n != "NPTR"]


@pytest.mark.parametrize("namespace, ptrs", [("ct", create_seq.CT_PTRS),
                                             ("ca", create_seq.CA_PTRS)])
def test_kernel_pointer_order_matches_the_wrapper(namespace, ptrs):
    prefix = {"event": "EV", "acct": "AC", "ac": "AC", "tc": "TC",
              "st": "ST"}
    want = [f"{prefix[g]}_{k.upper()}" for g, k in ptrs]
    assert _enum(CU.read_text(), namespace) == want
    # Every carry output and every input the kernel reads has a pointer.
    outs = PK.CT_OUT_DTYPES if namespace == "ct" else PK.CA_OUT_DTYPES
    assert {k for g, k in ptrs if g == "st"} == set(outs)


@pytest.mark.parametrize("array, codes", [("kPvCodes", PK._PV_CODES),
                                          ("kRegCodes", PK._REG_CODES)])
def test_kernel_check_orders_match_the_twin(array, codes):
    """The kernel's mask bits name the twin's checks in the twin's
    order."""
    body = re.search(rf"{array}\[(\d+)\] = {{(.*?)}};", CU.read_text(),
                     re.S)
    names = re.findall(r"ts::(\w+)", body.group(2))
    assert int(body.group(1)) == len(names) == len(codes)
    assert [int(TT.CreateTransferStatus[n]) for n in names] == list(codes)


@pytest.mark.parametrize("namespace, enum", [
    ("ts", TT.CreateTransferStatus), ("as", TT.CreateAccountStatus)])
def test_kernel_status_codes_match_the_enums(namespace, enum):
    body = re.search(rf"namespace {namespace} {{(.*?)}}  // namespace",
                     CU.read_text(), re.S).group(1)
    codes = dict(re.findall(r"(\w+) = (\d+)", body))
    assert codes
    for name, code in codes.items():
        assert int(code) == int(enum[name]), name
