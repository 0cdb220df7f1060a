"""Chain-route smoke: the gate's quick differential for the default
whole-window chain dispatch.

The port's counterpart of the JAX package's `testing/chain_smoke.py`.
Drives the real serving route — DeviceLedger.submit_window /
resolve_windows with a write-through mirror in serving (ring-recycle)
mode — and asserts the serving contract:

  1. eligible windows take the CHAIN route by default (route counters);
  2. results are bit-exact against the synchronous window path AND the
     pure-Python oracle, a window with an ineligible prepare included
     (per-prepare fallback: the clean prefix stays committed, the suffix
     replays);
  3. plain windows make ZERO host fallbacks;
  4. the committed op budget (the newest trace/opbudget_r*.json) carries
     the chain entries, the body within the per-batch plain tier's
     heavy_total (the census itself is `torchhound/opbudget.py`'s job).

``chain_smoke(device=None)`` runs on the card unless given a device;
``python -m tigerbeetle_tpu_torch.testing.chain_smoke [--device cpu]``.
"""

from __future__ import annotations

import json

import numpy as np

CLUSTER_SEED = 29
N_ACCOUNTS = 64
N_WINDOWS = 3
CAPS = (1 << 10, 1 << 13)


def _mk_serving(device, caps=CAPS, n_accounts: int = N_ACCOUNTS):
    from ..oracle import StateMachineOracle
    from ..ops.ledger import DeviceLedger
    from ..types import Account

    led = DeviceLedger(caps[0], caps[1], write_through=StateMachineOracle(),
                       device=device)
    led.create_accounts([Account(id=i, ledger=1, code=1)
                         for i in range(1, n_accounts + 1)], 120)
    led.recycle_events = True
    return led


def _windows(rng, n_windows: int, k: int = 3, n: int = 64,
             base: int = 10 ** 6, poison_window=None):
    """n_windows windows of k prepares of n transfers between accounts
    1..64; with poison_window, that window's prepare 1 repeats its first
    id in its last event (a per-prepare e2 fallback)."""
    from ..types import Transfer

    out, nid, ts = [], base, 10 ** 12
    for w in range(n_windows):
        evs, tss = [], []
        for b in range(k):
            batch = []
            for _ in range(n):
                dr = int(rng.integers(1, 65))
                batch.append(Transfer(
                    id=nid, debit_account_id=dr,
                    credit_account_id=dr % 64 + 1,
                    amount=int(rng.integers(1, 100)), ledger=1, code=1))
                nid += 1
            if poison_window == w and b == 1:
                batch[-1] = Transfer(
                    id=batch[0].id, debit_account_id=1,
                    credit_account_id=2, amount=1, ledger=1, code=1)
            ts += n + 10
            evs.append(batch)
            tss.append(ts)
        out.append((evs, tss))
    return out


def _pipelined(led, windows) -> list:
    """The pipelined loop: submit, resolve the oldest at depth 2, take the
    synchronous window path for a window submit_window refuses."""
    from ..ops.batch import transfers_to_arrays

    pending, res = [], []
    for evs, tss in windows:
        arrays = [transfers_to_arrays(b) for b in evs]
        tk = led.submit_window(arrays, tss)
        if tk is None:
            led.resolve_windows()
            while pending:
                res.append(pending.pop(0).results[1])
            res.append(led.create_transfers_window(arrays, tss))
            continue
        pending.append(tk)
        if len(pending) > 1:
            led.resolve_windows(count=1)
            while pending and pending[0].results is not None:
                res.append(pending.pop(0).results[1])
    led.resolve_windows()
    res.extend(tk.results[1] for tk in pending)
    return res


def _norm(results) -> list:
    return [[(np.asarray(st).astype(np.int64).tolist(),
              np.asarray(ts).astype(np.uint64).tolist()) for st, ts in w]
            for w in results]


def check_budget(budget: dict) -> None:
    """The committed op budget carries the chain entries, the body within
    the per-batch plain tier's heavy_total."""
    for tier in ("chain_w8", "chain_body_w8"):
        assert tier in budget, f"the op budget lacks {tier}"
    assert (budget["chain_body_w8"]["heavy_total"]
            <= budget["plain"]["heavy_total"]), \
        "the chain body must stay within the per-batch plain tier's budget"


def chain_smoke(device=None, batch: int = 64, caps: tuple = CAPS) -> dict:
    """Both arms (clean, window 1 poisoned) on `device` (None: the card),
    N_WINDOWS windows of 3 prepares of `batch` transfers on ledgers at
    `caps`. Returns {arm: {history, pipelined / sync: {host_fallbacks,
    window_fallbacks, routes, staging}}} and the budget's chain entries;
    raises on any failure."""
    from ..oracle import StateMachineOracle
    from ..ops.batch import transfers_to_arrays
    from ..ops.device import resolve_device
    from ..torchhound.core import newest_budget_path
    from ..types import Account

    device = resolve_device(device)
    rng = np.random.default_rng(CLUSTER_SEED)
    summary = {}
    for poison in (None, 1):
        windows = _windows(rng, N_WINDOWS, n=batch, poison_window=poison,
                           base=(1 + (poison or 0)) * 10 ** 6)
        led_p = _mk_serving(device, caps)
        led_s = _mk_serving(device, caps)
        orc = StateMachineOracle()
        orc.create_accounts([Account(id=i, ledger=1, code=1)
                             for i in range(1, N_ACCOUNTS + 1)], 120)
        res_p = _pipelined(led_p, windows)
        res_s = []
        for evs, tss in windows:
            res_s.append(led_s.create_transfers_window(
                [transfers_to_arrays(b) for b in evs], tss))
            for b, tb in zip(evs, tss):
                orc.create_transfers(b, tb)
        assert len(res_p) == len(res_s), (len(res_p), len(res_s))
        hist_p, hist_s = _norm(res_p), _norm(res_s)
        assert hist_p == hist_s, "pipelined windows diverged from sync"
        hp, hs = led_p.to_host(), led_s.to_host()
        assert hp.accounts == hs.accounts == orc.accounts
        assert hp.transfers == hs.transfers == orc.transfers
        arm = {}
        for name, led in (("pipelined", led_p), ("sync", led_s)):
            stats = led.fallback_stats()
            assert stats["routes"]["windows"].get("chain", 0) >= 1, \
                "eligible windows must default to the chain route"
            if poison is None:
                assert stats["host_fallbacks"] == 0, stats
                assert stats["window_fallbacks"] == 0, stats
            else:
                assert stats["routes"]["chain_batch_fallbacks"].get(
                    "e2_collision", 0) >= 1, stats
            arm[name] = {k: stats[k] for k in ("host_fallbacks",
                                               "window_fallbacks", "routes")}
            arm[name]["staging"] = led.staging_summary()
            led.release()
        arm["history"] = hist_p
        summary["poisoned" if poison is not None else "clean"] = arm
    with open(newest_budget_path()) as f:
        budget = json.load(f)["budget"]
    check_budget(budget)
    summary["budget"] = {t: budget[t]["heavy_total"]
                         for t in ("chain_w8", "chain_body_w8", "plain")}
    return summary


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    out = chain_smoke(args.device)
    print("[chain-smoke] ok: chain default route, per-prepare fallback, "
          f"oracle parity, budgets present {out['budget']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
