"""Full-semantics sharded create_transfers over an in-process device mesh,
on every kernel tier: plain, limit fixpoint (closing native, in-window
pending references), balancing and imported.

Decomposition (the JAX package's `parallel/full_sharded.py`, whose
shard_map the port restates in one process, `shard_utils.Mesh`):

  1. per-event stage (sharded): each shard takes its contiguous slice of
     the padded batch, on its device, and runs per_event_status() (the
     fused probe and the row gathers, the order-independent checks)
     against its device's replica of the ledger state. Its event
     timestamps count from the slice's global offset. The imported
     tier's batch context is computed replicated and sliced.
  2. all-gather (`shard_utils.all_gather`): the shards' compact
     per-event bundles, concatenated in mesh order, on every distinct
     device.
  3. global tail (replicated): create_transfers_fast with the gathered
     bundle as its per_event: the eligibility reductions, the in-window
     join and its substitution (the spmd join, fixpoint tiers), the
     fixpoint rounds, chains, row planning and the state application,
     on each distinct device's replica. Determinism keeps the replicas
     equal.

Each sharded step returns the (state, out) of its single-chip sibling
(create_transfers_fast under the same tier kwargs), bit for bit.

`ShardedRouter` is the host-side driver: the flag pre-route to a tier,
the plain -> fixpoint escalation, per-cause fallback counters, and the
degraded mode: while a mesh device is marked lost, batches take the
single-chip step on the first shard's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fast_kernels import (LIMIT_FIXPOINT_ROUNDS_WINDOW_DEEP,
                                create_transfers_fast, imported_batch_ctx,
                                per_event_status)
from ..ops.ledger import events_to_device
from ..ops.u64 import s64
from ..trace import Event, NullTracer
from .shard_utils import Mesh, all_gather

__all__ = ["make_sharded_create_transfers", "shard_batch", "ShardedRouter",
           "MODES"]

MODES = ("plain", "fixpoint", "balancing", "imported")

# Tail kwargs per tier: the single-chip tiers' own flags, so the sharded
# step is the single-chip kernel with the per-event stage plugged in.
_MODE_KWARGS = {
    "plain": {},
    "fixpoint": dict(limit_rounds=LIMIT_FIXPOINT_ROUNDS_WINDOW_DEEP),
    "balancing": dict(limit_rounds=LIMIT_FIXPOINT_ROUNDS_WINDOW_DEEP,
                      balancing_mode=True),
    "imported": dict(limit_rounds=LIMIT_FIXPOINT_ROUNDS_WINDOW_DEEP,
                     imported_mode=True),
}


def shard_batch(mesh: Mesh, ev: dict) -> tuple:
    """Cut a padded host event dict (pad_transfer_events') into
    contiguous slices, one a shard, each on its shard's device. The
    padded length must divide by the mesh size."""
    n = len(ev["id_lo"])
    if n % mesh.size:
        raise ValueError(f"{n} lanes do not divide over {mesh.size} shards")
    w = n // mesh.size
    return tuple(events_to_device({k: v[i * w:(i + 1) * w]
                                   for k, v in ev.items()}, d)
                 for i, d in enumerate(mesh.devices))


def make_sharded_create_transfers(mesh: Mesh, mode: str = "plain"):
    """The full-semantics sharded step over `mesh` for one kernel tier
    (`mode` in MODES): step(state, shards, timestamp, n) -> (state, out),
    `state` the replicated state (`shard_utils.replicate`), `shards` the
    batch as `shard_batch` cuts it, timestamp and n Python ints; out is
    the first replica's. Every replica is updated in place."""
    assert mode in MODES, mode
    kwargs = _MODE_KWARGS[mode]

    def step(state, shards, timestamp: int, n: int):
        state = tuple(state)
        assert len(state) == len(mesh.distinct), \
            "state must be replicated over the mesh's distinct devices"
        replica = dict(zip(mesh.distinct, state))
        evs = all_gather(mesh, shards)
        N = evs[0]["id_lo"].shape[0]
        w = N // mesh.size
        ctx_slices = [None] * mesh.size
        if mode == "imported":
            # The batch context, replicated: global reductions and the
            # account-timestamp probe over the whole batch, sliced to the
            # shards; key_max stays a replicated scalar.
            for d, ev in zip(mesh.distinct, evs):
                idxs = torch.arange(N, dtype=torch.int64, device=d)
                ts_full = idxs + s64(int(timestamp) - int(n) + 1)
                ctx = imported_batch_ctx(replica[d], ev, ts_full,
                                         ev["valid"], idxs)
                key_max = ctx.pop("key_max")
                for i, sd in enumerate(mesh.devices):
                    if sd == d:
                        ctx_slices[i] = dict(
                            {k: v[i * w:(i + 1) * w] for k, v in ctx.items()},
                            key_max=key_max)
        parts, codes = [], None
        for i, (d, ev_shard) in enumerate(zip(mesh.devices, shards)):
            # Global event positions of this shard: ts_event =
            # timestamp - n + i + 1 counts from the slice's offset.
            ts_event = (torch.arange(w, dtype=torch.int64, device=d)
                        + s64(int(timestamp) - int(n) + 1 + i * w))
            pe = per_event_status(replica[d], ev_shard, ts_event,
                                  imported_ctx=ctx_slices[i])
            pe.pop("_gathers")
            # The imported codes are a static tuple, not a lane.
            codes = pe.pop("after_regress_codes", codes)
            parts.append(pe)
        bundles = all_gather(mesh, parts)
        out0 = None
        for d, ev, bundle in zip(mesh.distinct, evs, bundles):
            if codes is not None:
                bundle["after_regress_codes"] = codes
            _, out = create_transfers_fast(replica[d], ev, timestamp, n,
                                           per_event=bundle, **kwargs)
            if out0 is None:
                out0 = out
        return state, out0

    return step


def _host_flags(ev) -> np.ndarray:
    """The flags lane of an event dict or of `shard_batch`'s slices."""
    parts = [ev] if isinstance(ev, dict) else list(ev)
    return np.concatenate([np.asarray(
        p["flags"].cpu() if isinstance(p["flags"], torch.Tensor)
        else p["flags"]).astype(np.int64) for p in parts])


class ShardedRouter:
    """Host-side tier router over the sharded steps: inspects each
    batch's flags, runs the matching sharded step, redispatches
    device-resolvable escalations (plain -> fixpoint: the plain kernel
    left the state untouched) and counts host fallbacks by cause, so
    "zero fallbacks on a mixed balancing + imported + closing window" is
    a measured number."""

    def __init__(self, mesh: Mesh, tracer=None):
        self.mesh = mesh
        self.tracer = tracer if tracer is not None else NullTracer()
        self._steps: dict = {}
        self.batches = 0
        self.escalations = 0
        self.host_fallbacks = 0
        self.fallback_causes: dict = {}
        # Degraded mode: mesh devices marked lost. While any is, every
        # batch re-routes to the single-chip step (the same
        # create_transfers_fast without the mesh): results stay exact,
        # and the reroute is a counted event.
        self.lost_devices: set = set()
        self.shard_loss_reroutes = 0

    def drop_device(self, device) -> None:
        """Mark one mesh device lost. The state is replicated, so the
        single-chip path on the first shard's device can serve until
        restore_devices()."""
        self.lost_devices.add(device)

    def restore_devices(self) -> None:
        """The mesh healed: route back to the sharded steps."""
        self.lost_devices.clear()

    def _step(self, mode: str):
        fn = self._steps.get(mode)
        if fn is None:
            fn = self._steps[mode] = make_sharded_create_transfers(
                self.mesh, mode=mode)
        return fn

    def _single_step(self, mode: str):
        """The single-chip sibling of the sharded step: the same
        create_transfers_fast with the same tier kwargs, on the first
        replica and the whole batch on its device; the other replicas
        then take its state, so they stay equal."""
        mesh = self.mesh

        def step(state, shards, timestamp: int, n: int):
            state = tuple(state)
            ev = all_gather(mesh, shards)[0]
            _, out = create_transfers_fast(state[0], ev, timestamp, n,
                                           **_MODE_KWARGS[mode])
            for other in state[1:]:
                _copy_into(other, state[0])
            return state, out

        return step

    @staticmethod
    def route(ev) -> str:
        """Flag-derived tier of one event dict (or `shard_batch`'s
        slices). Same precedence as DeviceLedger: imported > balancing >
        closing; limit breaches and in-batch pending references are
        invisible to flags and escalate from the plain step instead."""
        from ..types import TransferFlags as TF

        flags = _host_flags(ev)
        if (flags & int(TF.imported)).any():
            return "imported"
        if (flags & int(TF.balancing_debit | TF.balancing_credit)).any():
            return "balancing"
        if (flags & int(TF.closing_debit | TF.closing_credit)).any():
            return "fixpoint"
        return "plain"

    def step(self, state, ev, timestamp: int, n: int):
        """Run one padded batch (`shard_batch`'s slices) on the
        replicated `state`. Returns (state, out, fell_back); on
        fell_back the state is untouched and the caller owns the
        exact-path replay."""
        self.batches += 1
        mode = self.route(ev)
        degraded = bool(self.lost_devices)
        if degraded:
            self.shard_loss_reroutes += 1
            self.tracer.count(Event.router_reroute)
        pick = self._single_step if degraded else self._step
        self.tracer.count(
            Event.dispatch_route,
            route=("single_chip_" if degraded else "sharded_") + mode)
        with self.tracer.span(Event.router_step, mode=mode,
                              degraded=int(degraded)):
            state, out = pick(mode)(state, ev, int(timestamp), int(n))
            fallback, limit_only = (bool(x) for x in torch.stack(
                (out["fallback"], out["limit_only"])).tolist())
            if fallback and limit_only and mode == "plain":
                # Breach / collision / closing: resolvable on the
                # fixpoint step (the plain kernel left state untouched).
                self.escalations += 1
                state, out = pick("fixpoint")(state, ev, int(timestamp),
                                              int(n))
                fallback = bool(out["fallback"])
        if fallback:
            self.host_fallbacks += 1
            for k, v in out["fb_causes"].items():
                if bool(v):
                    self.fallback_causes[k] = (
                        self.fallback_causes.get(k, 0) + 1)
                    self.tracer.count(Event.router_fallback, cause=k)
        return state, out, fallback

    def stats(self) -> dict:
        return {
            "batches": self.batches,
            "escalations": self.escalations,
            "host_fallbacks": self.host_fallbacks,
            "causes": dict(self.fallback_causes),
            "lost_devices": len(self.lost_devices),
            "shard_loss_reroutes": self.shard_loss_reroutes,
        }


def _copy_into(dst: dict, src: dict) -> None:
    """Copy a state dict into another of its shapes, in place."""
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v)
        else:
            dst[k].copy_(v)
