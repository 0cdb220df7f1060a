"""Commit windows as captured CUDA graphs.

A window route of the ledger (`ledger.DeviceLedger.create_transfers_window`
/ `submit_window`) runs one function over the ledger state and a packed
window: thousands of small device ops a window, each of which PyTorch
issues from the host one at a time when run eagerly. On CUDA tensors this
module runs the window as ONE replay of a `torch.cuda.CUDAGraph` captured
from that function, one graph a key (route, W, n_pad):

  - the first window of a key runs eagerly: PyTorch's pre-capture warm-up,
    which also builds and loads the CUDA kernels outside any capture;
  - the second is captured (capture records and runs nothing) and the
    graph is replayed once, so no window is applied twice;
  - every later one is a replay.

On the CPU every window runs eagerly: the same function, the same inputs.
No switch chooses between the two; the device of the state does.

What a replay relies on:
  - inputs: the packed window (one int64 lane matrix, written straight
    into pinned host memory, by a stager thread when the ledger staged
    it) goes into a static device buffer, one a shape, with one
    non-blocking copy a window on the main stream (`upload`); the previous
    window's poison flag is copied device to device into the static
    force_fallback buffer, so reading it takes no host sync;
  - state: the tiers write every state tensor in place, so a window leaves
    each tensor's storage where it was. A storage that moved (a state
    rebuilt by `from_host`, one assigned from outside) changes the
    state's pointer signature, and the next window drops every graph
    (`drops` counts it) and starts over with an eager window;
  - outputs: they live in the graph's memory pool, and the next replay of
    the same graph overwrites them; `Harvest` copies them out in stream
    order right after the dispatch;
  - no host sync in the function: an op that is illegal under capture
    raises out of the capture (capture_error_mode "global"); nothing
    catches it and carries on eagerly.

Each graph keeps its own memory pool, its window's peak working set, so
the graphs' memory grows with the keys: a ledger keeps at most
MAX_GRAPHS of them, dropping the least recently replayed one (after a
sync) before it captures another; a dropped key starts over with an
eager window.

A key is (route, W, n_pad), plus "ring" for the ring window kernels
(they consume the event ring from row 0: another graph). The partitioned
attach mode's chain windows (`parallel/partitioned.py`) take the key
("partitioned_chain", W, n_pad, overlay entries) over the tuple of
per-shard states: the body a graph captured selects its branches by the
ownership overlay, so live resharding, which changes the overlay three
times a migration (double-write, flip, retire), makes new keys, and the
graphs of earlier overlays age out by the eviction below. A multi-process
mesh is refused (`check_mesh`): its gloo collectives run on the host and
cannot be captured. A write-through ledger's delta gather runs eagerly
right after the dispatch, outside the graph, so it adds no key.

Counters a key: `eager`, `captures` and `replays` (the replay right after
a capture included); `reserved`, the bytes the caching allocator held
(`torch.cuda.memory_reserved`) just before and just after the key's
capture, whose difference is the graph's pool; and `evictions`, the
graphs dropped for room. The kernel wrappers' LAUNCHES move at eager windows
and at captures only, so a kernel's launches on a window path are its
wrapper count plus (replays - captures) times its launches a window.
`CAPTURED` adds up, over every ledger, the probe and row-gather launches
the wrappers counted inside captures (recorded into a graph, not run);
`REPLAYED` the launches the replays ran (a graph's own at each of its
replays). LAUNCHES - CAPTURED + REPLAYED is what the card ran: one
window's kernels a window, as on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

# The graphs a ledger keeps (see the module note): an 8-prepare window's
# pool held at most ~0.4 GB on an H100, a 32-prepare chain's ~1.2 GB
# (chip_smoke.py's window phases, PERF.md).
MAX_GRAPHS = 8

# (probe, row gather) launches counted inside captures, and launches that
# graph replays ran, over every ledger.
CAPTURED = [0, 0]
REPLAYED = [0, 0]


def _wrapper_launches() -> tuple:
    from . import fused_probe, row_gather

    return fused_probe.LAUNCHES, row_gather.LAUNCHES


def _tensors(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensors(tree[k])
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


def state_signature(state) -> tuple:
    """The storage of every state tensor: what a captured graph reads and
    writes. A partitioned state (a tuple of per-shard dicts) spans every
    shard's tensors."""
    return tuple(t.data_ptr() for t in _tensors(state))


class Harvest:
    """A dispatch's outputs ({name: tensor, "fb_causes": {cause:
    tensor}}) copied out in stream order right after the dispatch:
    non-blocking into pinned host buffers on the card (with an event
    behind them), kept as they are on the CPU. `get()` waits for the
    copies and returns numpy arrays."""

    __slots__ = ("_host", "_event")

    def __init__(self, outs: dict, names):
        self._host = {}
        self._event = None
        cuda = False
        for k in names:
            for sub, v in (outs[k].items() if isinstance(outs[k], dict)
                           else ((None, outs[k]),)):
                if v.device.type == "cuda":
                    cuda = True
                    h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    h.copy_(v, non_blocking=True)
                else:
                    h = v
                self._host[(k, sub)] = h
        if cuda:
            self._event = torch.cuda.Event()
            self._event.record()

    def get(self) -> dict:
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        out = {}
        for (k, sub), h in self._host.items():
            a = h.numpy()
            if sub is None:
                out[k] = a
            else:
                out.setdefault(k, {})[sub] = a
        return out


class WindowGraphs:
    """A ledger's window graphs, static buffers and counters."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self._graphs: dict = {}     # key -> (graph, static outputs)
        self._per_replay: dict = {}  # key -> its graph's launches
        self._seen: set = set()     # keys whose eager window ran
        self._inputs: dict = {}     # lane-matrix shape -> static buffer
        self._ff = torch.zeros((), dtype=torch.bool, device=device)
        self._sig = None
        self.eager: dict = {}
        self.captures: dict = {}
        self.replays: dict = {}
        self.reserved: dict = {}
        self.drops = 0
        self.evictions = 0

    def drop(self) -> None:
        """Forget every graph (a state storage moved)."""
        self._graphs.clear()
        self._seen.clear()
        self.drops += 1

    def _make_room(self) -> None:
        """Drop least recently replayed graphs until one more fits. The
        sync lets every queued replay and output copy of a dropped graph
        finish before its pool is given back."""
        while len(self._graphs) >= MAX_GRAPHS:
            if self.cuda:
                torch.cuda.synchronize(self.device)
            old = next(iter(self._graphs))
            del self._graphs[old]
            self._seen.discard(old)
            self.evictions += 1

    @staticmethod
    def check_mesh(mesh) -> None:
        """Refuse a multi-process mesh: its collectives go through
        torch.distributed on the host, which no graph can capture (its
        windows run eagerly, `PartitionedRouter.step_window`)."""
        if getattr(mesh, "process_count", 1) > 1:
            raise ValueError(
                "window graphs: a mesh of several processes cannot be "
                "captured (its gloo collectives run on the host); run its "
                "windows eagerly through PartitionedRouter.step_window")

    def check_state(self, state: dict) -> None:
        sig = state_signature(state)
        if self._sig is not None and sig != self._sig:
            self.drop()
        self._sig = sig

    def host_lanes(self, shape: tuple, fill) -> torch.Tensor:
        """`fill(array)` writes the int64 lane matrix of `shape` into host
        memory, pinned on the card. Touches no device and no buffer of
        this object, so a stager thread may call it."""
        if not self.cuda:
            lanes = np.empty(shape, dtype=np.int64)
            fill(lanes)
            return torch.from_numpy(lanes)
        host = torch.empty(shape, dtype=torch.int64, pin_memory=True)
        fill(host.numpy())
        return host

    def upload(self, host: torch.Tensor) -> torch.Tensor:
        """The packed window on the device: on the card one non-blocking
        copy on the current stream moves `host` into the static buffer of
        its shape (after every replay already queued that reads it)."""
        if not self.cuda:
            return host
        shape = tuple(host.shape)
        buf = self._inputs.get(shape)
        if buf is None:
            buf = torch.empty(shape, dtype=torch.int64, device=self.device)
            self._inputs[shape] = buf
        buf.copy_(host, non_blocking=True)
        return buf

    def run(self, key, call, state: dict, lanes: torch.Tensor, poison=None):
        """call(state, lanes, force_fallback) for one window: eagerly on
        the CPU and for a key's first window, captured and replayed once
        for its second, replayed after that. `lanes` comes from `put`;
        `poison` is the previous window's device fallback flag (None:
        none). Returns the call's outputs (on the card, the graph's: copy
        them out before the next replay of this key)."""
        if not self.cuda:
            ff = (torch.zeros((), dtype=torch.bool) if poison is None
                  else poison)
            self.eager[key] = self.eager.get(key, 0) + 1
            return call(state, lanes, ff)
        if poison is None:
            self._ff.fill_(False)
        else:
            self._ff.copy_(poison)
        hit = self._graphs.pop(key, None)
        if hit is not None:
            self._graphs[key] = hit   # now the most recently replayed
            graph, outs = hit
            graph.replay()
            self._replayed(key)
            return outs
        if key not in self._seen:
            self._seen.add(key)
            self.eager[key] = self.eager.get(key, 0) + 1
            return call(state, lanes, self._ff)
        self._make_room()
        before = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        launched = _wrapper_launches()
        with torch.cuda.graph(graph):
            outs = call(state, lanes, self._ff)
        self._per_replay[key] = tuple(
            a - b for a, b in zip(_wrapper_launches(), launched))
        for i, n in enumerate(self._per_replay[key]):
            CAPTURED[i] += n
        self._graphs[key] = (graph, outs)
        self.captures[key] = self.captures.get(key, 0) + 1
        self.reserved[key] = (before,
                              torch.cuda.memory_reserved(self.device))
        graph.replay()
        self._replayed(key)
        return outs

    def _replayed(self, key) -> None:
        self.replays[key] = self.replays.get(key, 0) + 1
        for i, n in enumerate(self._per_replay[key]):
            REPLAYED[i] += n
