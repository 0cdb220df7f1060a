"""The port's LSM and durable host modules against the JAX package's, on
the CPU.

`tigerbeetle_tpu_torch` keeps its own copies of the JAX package's host
modules (`ewah.py`, `vsr/checksum.py`, `vsr/header.py`, `vsr/storage.py`,
`vsr/superblock.py`, `lsm/*`). Every scenario below runs once against
each package's modules, on the same inputs made from a numpy seed, and
returns plain values (bytes, ints, tuples): the two runs must return
equal values, so every byte the port writes — blocks, tables, manifests,
free sets, checkpoint roots, superblocks — is the JAX package's. The
scenarios repeat the cases of the JAX package's tests/test_lsm.py,
test_forest_schema.py, test_scan.py, test_lsm_serving.py and
test_query_tables.py, each as a parity case on three seeds.
"""

import dataclasses
import importlib
import struct
import tempfile
import types

import numpy as np
import pytest

import tigerbeetle_tpu  # noqa: F401  (enables JAX x64)

SEEDS = (0, 1, 2)
KEY = 8
VAL = 16
TS_MAX = (1 << 63) - 1
MODULES = {
    "ewah": "ewah", "checksum": "vsr.checksum", "header": "vsr.header",
    "storage": "vsr.storage", "superblock": "vsr.superblock",
    "durable": "vsr.durable", "schema": "lsm.schema",
    "cache_map": "lsm.cache_map", "grid": "lsm.grid",
    "manifest_level": "lsm.manifest_level", "table": "lsm.table",
    "tree": "lsm.tree", "forest": "lsm.forest",
    "k_way_merge": "lsm.k_way_merge", "zig_zag": "lsm.zig_zag_merge",
    "scan": "lsm.scan", "query": "lsm.query",
    "state_machine": "state_machine", "types": "types",
    "multi_batch": "multi_batch",
}


def _namespace(pkg: str) -> types.SimpleNamespace:
    ns = types.SimpleNamespace(
        name=pkg, **{k: importlib.import_module(f"{pkg}.{m}")
                     for k, m in MODULES.items()})
    if pkg == "tigerbeetle_tpu_torch":
        ns.sm = lambda engine="oracle": ns.state_machine.StateMachine(
            engine, device="cpu")
    else:
        ns.sm = lambda engine="oracle": ns.state_machine.StateMachine(
            engine=engine)
    return ns


JAX = _namespace("tigerbeetle_tpu")
PORT = _namespace("tigerbeetle_tpu_torch")
SCENARIOS: dict = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def test_every_module_is_the_ports_own():
    for k in MODULES:
        assert getattr(PORT, k).__name__.startswith("tigerbeetle_tpu_torch.")
        assert getattr(JAX, k).__name__.startswith("tigerbeetle_tpu.")


# ------------------------------------------------------------------ helpers

def k(i: int) -> bytes:
    return struct.pack(">Q", i)


def v(i: int) -> bytes:
    return struct.pack(">QQ", i, i * 7)


def grid_of(M, blocks=4096, block_size=4096):
    return M.grid.Grid(M.grid.MemoryDevice(blocks * block_size),
                       block_size=block_size, block_count=blocks)


def device_bytes(grid) -> bytes:
    return bytes(grid.device.data)


def packed(objs) -> list:
    return [o.pack() for o in objs]


def dump_trees(forest) -> dict:
    """Every tree's full contents and memtable, by name."""
    out = {}
    for name, tree in forest.trees.items():
        lo, hi = b"\x00" * tree.key_size, b"\xff" * tree.key_size
        out[name] = (tree.scan(lo, hi), sorted(tree.memtable.items()))
    return out


def grid_zone(storage) -> bytes:
    lay = storage.layout
    return storage.read("grid", 0, lay.grid_block_count * lay.grid_block_size)


# -------------------------------------------------------------- codecs

@scenario
def ewah_round_trip(M, seed):
    rng = np.random.default_rng(seed)
    out = []
    for density in (0.0, 0.02, 0.5, 0.98, 1.0):
        n = int(rng.integers(1, 3000))
        bits = (rng.random(n) < density).tolist()
        # Long runs of both values, as a free set has.
        lo = int(rng.integers(0, n))
        bits[lo:lo + 400] = [bool(seed % 2)] * len(bits[lo:lo + 400])
        blob = M.ewah.encode_bitset(bits)
        assert M.ewah.decode_bitset(blob)[:n] == bits
        words = [int(w) for w in rng.integers(0, 2**63, 20, dtype=np.int64)]
        words += [0] * 7 + [(1 << 64) - 1] * 5
        wblob = M.ewah.encode(words)
        assert M.ewah.decode(wblob) == words
        out.append((blob, wblob))
    return out


@scenario
def checksum_and_header(M, seed):
    rng = np.random.default_rng(seed)
    data = rng.bytes(int(rng.integers(0, 5000)))
    sums = [M.checksum.checksum(data, domain=d)
            for d in (b"", b"sb", b"ckptroot", b"block")]
    H = M.header
    hdrs = []
    for cmd in (H.Command.prepare, H.Command.reply, H.Command.reserved):
        h = H.Header(command=cmd, cluster=int(rng.integers(1, 100)),
                     replica=1, view=3, op=int(rng.integers(1, 10**6)),
                     client=int(rng.integers(1, 2**62)) << 60,
                     timestamp=int(rng.integers(1, 2**62)))
        hdrs.append(h.finalize(data[:100]).pack())
    return sums, hdrs, M.checksum.checksum_bytes(data)


@scenario
def schema_wrap_unwrap(M, seed):
    rng = np.random.default_rng(seed)
    S = M.schema
    out = []
    for kind in S.BlockKind:
        payload = rng.bytes(int(rng.integers(0, 700)))
        raw = S.wrap(kind, payload, tree_id=int(rng.integers(0, 33)))
        assert S.unwrap(raw, kind) == payload
        other = [x for x in S.BlockKind if x != kind][0]
        with pytest.raises(Exception) as err:
            S.unwrap(raw, other)
        out.append((raw, type(err.value).__name__, repr(S.classify(raw))))
    return out


@scenario
def storage_and_superblock(M, seed):
    rng = np.random.default_rng(seed)
    St = M.storage
    layouts = (St.StorageLayout(), St.TEST_LAYOUT)
    offsets = [(lay.zone_offsets, lay.size) for lay in layouts]
    storage = St.MemoryStorage(St.TEST_LAYOUT)
    sb = M.superblock.SuperBlock(
        cluster=int(rng.integers(1, 2**40)), replica_id=0, replica_count=1,
        snapshot_slot=1, snapshot_size=152,
        snapshot_checksum=int(rng.integers(1, 2**62)) << 60)
    sb.store(storage)
    sb.commit_min = sb.op_checkpoint = 16
    sb.store(storage)
    zone = storage.read("superblock", 0,
                        St.SUPERBLOCK_COPIES * St.SUPERBLOCK_COPY_SIZE)
    loaded = M.superblock.SuperBlock.load(storage)
    # A torn update (one copy overwritten) still loads the quorum's copy.
    storage.write("superblock", 0, b"\xff" * 64)
    torn = M.superblock.SuperBlock.load(storage)
    return (offsets, zone, dataclasses.astuple(loaded),
            dataclasses.astuple(torn))


@scenario
def file_storage_bytes(M, seed):
    """FileStorage writes the bytes MemoryStorage holds (the port's plain
    file IO against the JAX package's MemoryStorage)."""
    if M is JAX:
        storage = M.storage.MemoryStorage(M.storage.TEST_LAYOUT)
        close = lambda: None  # noqa: E731
    else:
        tmp = tempfile.TemporaryDirectory()
        storage = M.storage.FileStorage(f"{tmp.name}/data",
                                        M.storage.TEST_LAYOUT, create=True)
        close = lambda: (storage.close(), tmp.cleanup())  # noqa: E731
    rng = np.random.default_rng(seed)
    lay = storage.layout
    for zone in ("wal_headers", "snapshot", "grid"):
        for _ in range(5):
            off = int(rng.integers(0, 4096))
            storage.write(zone, off, rng.bytes(int(rng.integers(1, 900))))
    storage.sync()
    out = [storage.read(z, 0, 8192) for z in ("wal_headers", "snapshot",
                                              "grid")]
    out.append(storage.read("grid", lay.grid_block_size * 7, 100))
    close()
    return out


# ----------------------------------------------------------------- grid

@scenario
def grid_acquire_release_reserve(M, seed):
    rng = np.random.default_rng(seed)
    grid = grid_of(M, blocks=256, block_size=512)
    trace = []
    live = []
    for step in range(300):
        r = rng.random()
        if r < 0.55 or not live:
            data = rng.bytes(int(rng.integers(1, 512)))
            addr = grid.write_block(data)
            live.append((addr, len(data)))
            trace.append(("w", addr.pack()))
        elif r < 0.8:
            addr, _ = live.pop(int(rng.integers(0, len(live))))
            grid.release(addr.index)
            trace.append(("r", addr.index))
        elif r < 0.9:
            count = int(rng.integers(1, 6))
            res = grid.reserve(count)
            used = [res.next_index()
                    for _ in range(int(rng.integers(0, count + 1)))]
            trace.append(("v", used, list(res.unused())))
            grid.forfeit(res)
        else:
            trace.append(("c", grid.checkpoint_free_set()))
    blob = grid.checkpoint_free_set()
    grid2 = grid_of(M, blocks=256, block_size=512)
    grid2.restore_free_set(blob)
    reads = [grid.read_block(a, n) for a, n in live[:20]]
    return (trace, blob, list(grid2.free), reads, device_bytes(grid))


# ---------------------------------------------------------------- tables

@scenario
def table_build_and_read(M, seed):
    rng = np.random.default_rng(seed)
    grid = grid_of(M)
    keys = sorted(set(int(x) for x in rng.integers(0, 10**6, 2500)))
    entries = [(k(i), v(i)) for i in keys]
    info = M.table.write_table(grid, entries, KEY, VAL)
    table = M.table.Table(grid, info, KEY, VAL)
    probes = [int(x) for x in rng.integers(0, 10**6, 50)] + keys[:20]
    gets = [table.get(k(i)) for i in probes]
    assert list(table.iter_entries()) == entries
    many = M.table.write_tables(grid, entries * 1, KEY, VAL)
    # Corruption: a cold read of a damaged index block raises.
    bad = M.table.write_table(grid, [(k(1), v(1))], KEY, VAL)
    grid.device.data[bad.index_address.index * grid.block_size] ^= 0xFF
    grid.cache.clear()
    with pytest.raises(IOError):
        M.table.Table(grid, bad, KEY, VAL)
    return (info.pack(), len(table.block_addresses), gets,
            [i.pack() for i in many], device_bytes(grid))


# ----------------------------------------------------------------- trees

@scenario
def tree_puts_removes_flushes(M, seed):
    rng = np.random.default_rng(seed)
    tree = M.tree.Tree(grid_of(M), key_size=KEY, value_size=VAL)
    model = {}
    for i in range(2000):
        key = int(rng.integers(0, 300))
        if rng.random() < 0.15:
            tree.remove(k(key))
            model.pop(k(key), None)
        else:
            tree.put(k(key), v(i))
            model[k(key)] = v(i)
        tree.compact_beat()
    gets = [tree.get(k(key)) for key in range(310)]
    assert gets[:300] == [model.get(k(key)) for key in range(300)]
    many = tree.get_many([k(key) for key in range(0, 310, 3)])
    scan = tree.scan(k(0), k(299))
    assert scan == sorted(model.items())
    levels = [len(lv) for lv in tree.levels]
    assert sum(levels[1:]) > 0
    tree.flush_memtable()
    return (gets, sorted(many.items()), scan, levels, tree.manifest_pack(),
            device_bytes(tree.grid))


@scenario
def tree_incremental_compaction(M, seed):
    """Compaction paced over the bar's beats: the job plan, the per-beat
    progress and every read at every beat."""
    BAR = M.tree.BAR_LENGTH
    tree = M.tree.Tree(grid_of(M), key_size=8, value_size=16, name="t")
    per_bar = 150 + 25 * seed
    op = 0
    for bar in range(8):
        for beat in range(BAR):
            op += 1
            key = (bar * BAR + beat) % per_bar
            tree.put(key.to_bytes(8, "big"), op.to_bytes(16, "big"))
            tree.compact_beat(op)
    while not tree._jobs:
        op += 1
        tree.put(b"\xff" * 8, op.to_bytes(16, "big"))
        tree.compact_beat(op)
    progress = []
    for _ in range(2 * BAR):
        op += 1
        tree.compact_beat(op)
        progress.append((len(tree._jobs[0].merged) if tree._jobs else None,
                         tree._per_beat,
                         [tree.get(x.to_bytes(8, "big"))
                          for x in (0, 57, 130, per_bar - 1)]))
    return progress, tree.manifest_pack(), device_bytes(tree.grid)


@scenario
def tree_checkpoint_restart_replay(M, seed):
    BAR = M.tree.BAR_LENGTH

    def run(checkpoint_at, restart):
        tree = M.tree.Tree(grid_of(M), key_size=8, value_size=16, name="t")
        for op in range(1, 6 * BAR + 1):
            key = (op * (seed + 1)) % 100
            tree.put(key.to_bytes(8, "big"), op.to_bytes(16, "big"))
            tree.compact_beat(op)
            if op == checkpoint_at:
                raw = tree.manifest_pack()
                if restart:
                    tree.manifest_restore(raw)
        return tree.manifest_pack()

    out = []
    for ckpt in (4 * BAR, 4 * BAR + 3, 4 * BAR + 17, 4 * BAR + 30):
        cont, rest = run(ckpt, False), run(ckpt, True)
        assert cont == rest
        out.append(cont)
    return out


@scenario
def tree_memtable_split_and_snapshots(M, seed):
    tree = M.tree.Tree(grid_of(M), key_size=8, value_size=16, name="t")
    n = 300 + 100 * seed
    for i in range(n):
        tree.put(k(i), v(i))
    tree.compact_beat(32)            # a bar boundary: the memtable freezes
    assert tree._flush is not None
    s = 33
    before = (tree.get(k(123), snapshot=s),
              sorted(tree.scan(k(100), k(130), snapshot=s)))
    reads = []
    for op in range(33, 64):
        reads.append((tree.get(k((op * 37) % n)),
                      tree._flush.pos if tree._flush is not None else None))
        tree.compact_beat(op)
    assert tree._flush is None
    after = (tree.get(k(123), snapshot=s),
             sorted(tree.scan(k(100), k(130), snapshot=s)))
    assert after == before
    tree.put(k(1), v(9999))
    return (reads, before, tree.get(k(123), snapshot=31), tree.get(k(1)),
            [len(lv) for lv in tree.levels], device_bytes(tree.grid))


@scenario
def manifest_level_snapshots(M, seed):
    """The level's (key range x snapshot range) index: inserts, removes,
    prunes, lookups and range queries at pinned snapshots."""
    rng = np.random.default_rng(seed)
    grid = grid_of(M)
    level = M.manifest_level.ManifestLevel(keep_sorted=True)
    tables = []
    for t in range(12):
        lo = t * 100
        entries = [(k(i), v(i)) for i in range(lo, lo + 50)]
        info = M.table.write_table(grid, entries, KEY, VAL)
        table = M.table.Table(grid, info, KEY, VAL)
        tables.append(table)
        level.insert(table, snapshot=t + 1)
    for t in rng.choice(12, 4, replace=False).tolist():
        level.remove(tables[t], snapshot=20 + t)
    pruned = level.prune(25)
    out = [len(level), len(pruned)]
    for snap in (None, 5, 21, 30):
        out.append([e.key_min for e in level.visible(snap)])
        out.append([t.info.pack() for t in level.lookup(k(420),
                                                        snapshot=snap)])
        out.append([t.info.pack() for t in level.query(k(120), k(820),
                                                       snapshot=snap)])
    return out


# ---------------------------------------------------------------- forest

@scenario
def forest_checkpoint_and_open(M, seed):
    grid = grid_of(M)
    schema = {"accounts": (KEY, VAL), "transfers": (KEY, VAL)}
    forest = M.forest.Forest(grid, schema)
    n = 200 + 20 * seed
    for i in range(n):
        forest.trees["accounts"].put(k(i), v(i))
        forest.trees["transfers"].put(k(1000 + i), v(i))
        forest.compact_beat()
    root = forest.checkpoint()
    grid2 = M.grid.Grid(grid.device, block_size=grid.block_size,
                        block_count=grid.block_count)
    forest2 = M.forest.Forest(grid2, schema)
    forest2.open(root)
    reads = [(forest2.trees["accounts"].get(k(i)),
              forest2.trees["transfers"].get(k(1000 + i)))
             for i in range(0, n, 7)]
    for i in range(n, n + 60):
        forest2.trees["accounts"].put(k(i), v(i))
        forest2.compact_beat()
    forest2.trees["accounts"].flush_memtable()
    root2 = forest2.checkpoint()
    return root, reads, root2, dump_trees(forest2), device_bytes(grid)


@scenario
def forest_pending_frees_until_flip(M, seed):
    grid = grid_of(M, blocks=256)
    forest = M.forest.Forest(grid, {"t": (KEY, VAL)})
    tree = forest.trees["t"]
    for i in range(600):
        tree.put(k(i % (40 + seed * 10)), v(i))
        tree.compact_beat()
    pending = sorted(grid.freed_pending)
    free_before = sum(grid.free)
    root = forest.checkpoint()
    assert not grid.freed_pending
    return pending, free_before, sum(grid.free), root, device_bytes(grid)


@scenario
def grid_byte_determinism(M, seed):
    grid = grid_of(M, blocks=512)
    forest = M.forest.Forest(grid, {"a": (KEY, VAL), "b": (KEY, VAL)})
    rng = np.random.default_rng(seed)
    for i in range(1500):
        tree = forest.trees["a" if rng.random() < 0.7 else "b"]
        key = int(rng.integers(0, 200))
        if rng.random() < 0.1:
            tree.remove(k(key))
        else:
            tree.put(k(key), v(i))
        forest.compact_beat()
    return forest.checkpoint(), device_bytes(grid)


# ----------------------------------------------------------------- scans

class _Stream:
    def __init__(self, keys):
        self.keys = sorted(keys)
        self.pos = 0

    def peek(self):
        return self.keys[self.pos] if self.pos < len(self.keys) else None

    def next(self):
        self.pos += 1

    def seek(self, key):
        while self.pos < len(self.keys) and self.keys[self.pos] < key:
            self.pos += 1


@scenario
def k_way_merge_outputs(M, seed):
    rng = np.random.default_rng(seed)
    merge = M.k_way_merge.k_way_merge
    out = [list(merge([[(b"a", 1), (b"c", 1)],
                       [(b"a", 2), (b"b", 2), (b"c", 2), (b"d", 2)]]))]
    sources = []
    for i in range(6):
        keys = {int(x).to_bytes(2, "big")
                for x in rng.integers(0, 500, int(rng.integers(0, 80)))}
        sources.append(sorted((key, (i, j)) for j, key in enumerate(keys)))
    out.append(list(merge(sources)))
    out.append(list(merge([list(reversed(s)) for s in sources],
                          reverse=True)))
    return out


@scenario
def zig_zag_intersections(M, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(30):
        sets = [set(rng.choice(200, int(rng.integers(1, 60)),
                               replace=False).tolist())
                for _ in range(int(rng.integers(2, 5)))]
        got = list(M.zig_zag.zig_zag_intersect([_Stream(s) for s in sets]))
        assert got == sorted(set.intersection(*sets))
        out.append(got)
    return out


def _tree_with(M, entries, removes=()):
    grid = M.grid.Grid(M.grid.MemoryDevice(8192 * 256), block_size=8192,
                       block_count=256)
    tree = M.forest.Forest(grid, {"t": (8, 8)}).trees["t"]
    for op, (key, val) in enumerate(entries, 1):
        tree.put(key, val)
        if op % 7 == 0:
            tree.compact_beat(op * 32)
    for key in removes:
        tree.remove(key)
    return tree


@scenario
def tree_scans_seek_union_intersection(M, seed):
    rng = np.random.default_rng(seed)
    S = M.scan
    entries = [(int(rng.integers(0, 1000)).to_bytes(8, "big"),
                int(rng.integers(0, 2**32)).to_bytes(8, "big"))
               for _ in range(300)]
    keys = sorted({key for key, _ in entries})
    removes = [keys[i] for i in rng.choice(len(keys), 20, replace=False)]
    tree = _tree_with(M, entries, removes)
    lo, hi = (100).to_bytes(8, "big"), (800).to_bytes(8, "big")
    full = list(S.TreeScan(tree, lo, hi))
    scan = S.TreeScan(tree, lo, hi)
    scan.seek((400).to_bytes(8, "big"))
    rest = list(scan)
    t1 = _tree_with(M, [(i.to_bytes(8, "big"), b"1" * 8)
                        for i in range(0, 100, 2 + seed)])
    t2 = _tree_with(M, [(i.to_bytes(8, "big"), b"2" * 8)
                        for i in range(0, 100, 3)])
    lo, hi = (0).to_bytes(8, "big"), (99).to_bytes(8, "big")
    union = list(S.union_scans([S.TreeScan(t1, lo, hi),
                                S.TreeScan(t2, lo, hi)]))
    inter = list(S.intersect_scans([S.TreeScan(t1, lo, hi),
                                    S.TreeScan(t2, lo, hi)]))
    ck = [S.composite_key(x, ts, size) for x, ts, size in
          ((7, 99, 8), (2**127 + seed, 2**62, 16), (3, 1, 2), (1, 5, 1))]
    return full, rest, union, inter, ck


# ----------------------------------------------------------- object cache

@scenario
def object_cache_eviction_order(M, seed):
    rng = np.random.default_rng(seed)
    cache = M.cache_map.ObjectCache(sets=8, ways=2)
    trace = []
    for step in range(400):
        key = int(rng.integers(0, 60))
        r = rng.random()
        if r < 0.5:
            cache.put(key, step)
        elif r < 0.9:
            trace.append(cache.get(key))
        else:
            cache.remove(key)
    lru = M.cache_map.ObjectCache(sets=1, ways=2)
    lru.put(1, "a")
    lru.put(2, "b")
    lru.get(1)
    lru.put(3, "c")
    return (trace, len(cache), cache.capacity, cache.stats(),
            sorted((key, cache.get(key)) for key in range(60)),
            (lru.get(2), lru.get(1), lru.get(3)))


# ------------------------------------------------- the forest of the ledger

def _mk(M):
    return (M.sm("oracle"),
            M.durable.DurableState(M.storage.MemoryStorage(
                M.storage.TEST_LAYOUT)))


def _forest_result(M, sm, durable, extra=()):
    return (dump_trees(durable.forest), durable.checkpoint(sm.state),
            grid_zone(durable.grid.device.storage), list(extra))


@scenario
def schema_closed_and_flag_indexes(M, seed):
    T = M.types
    TF, AF = T.TransferFlags, T.AccountFlags
    sm, durable = _mk(M)
    ts = 1000 + seed
    sm.create_accounts([T.Account(id=i, ledger=1, code=1)
                        for i in (1, 2, 3)], ts)
    sm.create_accounts(
        [T.Account(id=4, ledger=1, code=1, flags=int(AF.imported),
                   timestamp=100),
         T.Account(id=5, ledger=1, code=1, flags=int(AF.imported),
                   timestamp=101)], ts + 50)
    ts += 100
    res = sm.create_transfers([T.Transfer(
        id=10, debit_account_id=1, credit_account_id=2, amount=0, ledger=1,
        code=1, flags=int(TF.pending | TF.closing_debit))], ts)
    durable.flush(sm.state)
    ts += 100
    res += sm.create_transfers([T.Transfer(
        id=11, pending_id=10, ledger=1, code=1,
        flags=int(TF.void_pending_transfer))], ts)
    durable.flush(sm.state)
    res += sm.create_transfers([T.Transfer(
        id=12, debit_account_id=4, credit_account_id=5, amount=777,
        ledger=1, code=1, flags=int(TF.imported), timestamp=500)], ts + 100)
    for i in range(5):
        res += sm.create_transfers([T.Transfer(
            id=100 + i, debit_account_id=2, credit_account_id=3, amount=1,
            ledger=1, code=1)], ts + 200 + 100 * i)
        durable.flush(sm.state)
    return _forest_result(M, sm, durable,
                          [r.pack() for r in res]
                          + [sorted(durable._closed_indexed)])


@scenario
def schema_event_indexes_expiry_and_prune(M, seed):
    T = M.types
    TF, AF = T.TransferFlags, T.AccountFlags
    sm, durable = _mk(M)
    hist = int(AF.history)
    sm.create_accounts([T.Account(id=1, ledger=7, code=1, flags=hist),
                        T.Account(id=2, ledger=7, code=1),
                        T.Account(id=3, ledger=7, code=1)], 1000)
    ts = 2_000_000_000
    for i in range(4 + seed):
        sm.create_transfers([T.Transfer(
            id=100 + i, debit_account_id=1 + i % 2,
            credit_account_id=2 + i % 2, amount=5 + i, ledger=7,
            code=1)], ts)
        ts += 100
    sm.create_transfers([T.Transfer(
        id=10, debit_account_id=1, credit_account_id=2, amount=50, ledger=7,
        code=1, flags=int(TF.pending), timeout=1)], ts)
    expired = sm.state.expire_pending_transfers(10_000_000_000)
    durable.flush(sm.state)
    q = M.query.ForestQuery(durable.forest)
    a1_ts = sm.state.accounts[1].timestamp
    reads = [expired,
             packed(q.account_history_events(a1_ts)),
             q.expiry_event_of_pending(10).transfer_pending.pack(),
             [r.transfer_pending.id
              for r in q.expired_events_by_account(1, "dr")],
             packed(q.get_change_events(
                 T.ChangeEventsFilter(limit=100)))]
    pruned = durable.prune_events(TS_MAX)
    reads += [pruned, packed(q.get_change_events(
        T.ChangeEventsFilter(limit=100)))]
    root = durable.checkpoint(sm.state)
    durable2 = M.durable.DurableState(durable.grid.device.storage)
    restored = durable2.open(root)
    reads += [len(restored.account_events), restored.events_base]
    restored.create_transfers([T.Transfer(
        id=11, debit_account_id=1, credit_account_id=2, amount=6, ledger=7,
        code=1)], 20_000_000_000)
    durable2.flush(restored)
    return (root, dump_trees(durable2.forest),
            grid_zone(durable2.grid.device.storage), reads)


def _query_build(M, seed, n=300):
    """The JAX package's TestForestQuery._build: a StateMachine and its
    DurableState flushed op by op, then checkpointed."""
    T = M.types
    rng = np.random.default_rng(seed)
    sm, durable = _mk(M)
    ts = 10**9
    sm.create_accounts(
        [T.Account(id=i, ledger=1, code=int(rng.choice((1, 2))),
                   user_data_64=int(rng.choice((0, 5))),
                   flags=int(T.AccountFlags.history) if i % 2 else 0)
         for i in range(1, 9)], ts)
    durable.flush(sm.state)
    tid = 1000
    for batch in range(6):
        ts += 10_000
        events = []
        for _ in range(n // 6):
            dr = int(rng.integers(1, 9))
            cr = int(rng.integers(1, 9))
            if cr == dr:
                cr = dr % 8 + 1
            events.append(T.Transfer(
                id=tid, debit_account_id=dr, credit_account_id=cr,
                amount=int(rng.integers(1, 50)), ledger=1,
                code=int(rng.choice((1, 2))),
                user_data_64=int(rng.choice((0, 7))) + (1 << 63),
                flags=(int(T.TransferFlags.pending)
                       if rng.random() < 0.2 else 0)))
            tid += 1
        sm.create_transfers(events, ts)
        durable.flush(sm.state)
        durable.compact_beat(batch * 32)
    durable.checkpoint(sm.state)
    return sm, durable


def _filters(M):
    T = M.types
    AFF, QFF = T.AccountFilterFlags, T.QueryFilterFlags
    both = int(AFF.debits | AFF.credits)
    acct = [
        T.AccountFilter(account_id=1, limit=8190, flags=both),
        T.AccountFilter(account_id=3, limit=8190, flags=int(AFF.debits)),
        T.AccountFilter(account_id=5, limit=8190, flags=int(AFF.credits)),
        T.AccountFilter(account_id=2, limit=10, flags=both),
        T.AccountFilter(account_id=4, limit=8190, code=2, flags=both),
        T.AccountFilter(account_id=6, limit=8190, user_data_64=7 + (1 << 63),
                        flags=both),
        T.AccountFilter(account_id=7, limit=5,
                        flags=both | int(AFF.reversed)),
        T.AccountFilter(account_id=8, limit=8190,
                        timestamp_min=10**9 + 20_000,
                        timestamp_max=10**9 + 40_000, flags=both),
        T.AccountFilter(account_id=0, limit=10, flags=both),
    ]
    query = [
        T.QueryFilter(limit=8190),
        T.QueryFilter(limit=8190, ledger=1),
        T.QueryFilter(limit=8190, code=2),
        T.QueryFilter(limit=10, user_data_64=7 + (1 << 63)),
        T.QueryFilter(limit=5, code=1, flags=int(QFF.reversed)),
        T.QueryFilter(limit=8190, timestamp_min=10**9 + 20_000,
                      timestamp_max=10**9 + 40_000),
        T.QueryFilter(limit=8190, ledger=1, code=2),
    ]
    return acct, query


@scenario
def forest_query_differential(M, seed):
    """ForestQuery answers what the host indexes answer, and the same
    bytes as the JAX package's, before and after a reopen."""
    sm, durable = _query_build(M, 17 + seed)
    q = M.query.ForestQuery(durable.forest)
    acct, query = _filters(M)
    out = []
    for f in acct:
        got = q.get_account_transfers(f)
        assert got == sm.get_account_transfers(f)
        bal = q.get_account_balances(f)
        assert bal == sm.get_account_balances(f)
        out.append((packed(got), packed(bal)))
    for f in query:
        got_t, got_a = q.query_transfers(f), q.query_accounts(f)
        assert got_t == sm.query_transfers(f)
        assert got_a == sm.query_accounts(f)
        out.append((packed(got_t), packed(got_a)))
    ce = q.get_change_events(M.types.ChangeEventsFilter(limit=200))
    assert ce == sm.get_change_events(M.types.ChangeEventsFilter(limit=200))
    root = durable.checkpoint(sm.state)
    fresh = M.durable.DurableState(durable.grid.device.storage)
    fresh.open(root)
    q2 = M.query.ForestQuery(fresh.forest)
    assert q2.get_account_transfers(acct[0]) == q.get_account_transfers(
        acct[0])
    return out, packed(ce), root


def _setup_tables(M):
    """The JAX package's test_query_tables setup, attached to a forest."""
    T = M.types
    TF, AF = T.TransferFlags, T.AccountFlags
    sm, durable = _mk(M)
    sm.attach_durable(durable)
    TS = 10**13
    res = sm.create_accounts([
        T.Account(id=1, ledger=1, code=10, user_data_64=7, user_data_32=3),
        T.Account(id=2, ledger=1, code=10, flags=int(AF.history)),
        T.Account(id=3, ledger=1, code=20, user_data_64=7),
        T.Account(id=4, ledger=2, code=10, user_data_128=5),
    ], TS)
    res += sm.create_transfers([
        T.Transfer(id=101, debit_account_id=1, credit_account_id=2,
                   amount=10, ledger=1, code=5, user_data_64=77),
        T.Transfer(id=102, debit_account_id=2, credit_account_id=3,
                   amount=20, ledger=1, code=5),
        T.Transfer(id=103, debit_account_id=3, credit_account_id=1,
                   amount=30, ledger=1, code=6, user_data_64=77),
        T.Transfer(id=104, debit_account_id=1, credit_account_id=2,
                   amount=40, ledger=1, code=6, flags=int(TF.pending)),
        T.Transfer(id=105, debit_account_id=4, credit_account_id=1,
                   amount=50, ledger=0, code=5),
    ], TS + 100)
    sm.cache_upsert(*durable.flush(sm.state))
    return sm, durable, [r.pack() for r in res]


@scenario
def query_tables_from_the_forest(M, seed):
    T = M.types
    AFF, QFF = T.AccountFilterFlags, T.QueryFilterFlags
    sm, durable, res = _setup_tables(M)
    both = int(AFF.debits | AFF.credits)
    TS = 10**13
    af = [T.AccountFilter(account_id=1, limit=100, flags=int(AFF.debits)),
          T.AccountFilter(account_id=1, limit=100, flags=int(AFF.credits)),
          T.AccountFilter(account_id=1, limit=100 - seed, flags=both),
          T.AccountFilter(account_id=1, limit=1 + seed,
                          flags=both | int(AFF.reversed)),
          T.AccountFilter(account_id=2, limit=100, flags=both,
                          timestamp_min=TS + 100 - 3 + seed),
          T.AccountFilter(account_id=1, limit=100, flags=both,
                          user_data_64=77),
          T.AccountFilter(account_id=1, limit=100, flags=both, code=6),
          T.AccountFilter(account_id=3, limit=100, flags=both)]
    qf = [T.QueryFilter(limit=100, user_data_64=7),
          T.QueryFilter(limit=100, ledger=1, code=10),
          T.QueryFilter(limit=100, user_data_128=5),
          T.QueryFilter(limit=2 + seed, flags=int(QFF.reversed)),
          T.QueryFilter(limit=100, code=5),
          T.QueryFilter(limit=100, user_data_64=77, code=6)]
    out = [res]
    for f in af:
        out.append((packed(sm.get_account_transfers(f)),
                    packed(sm.get_account_balances(f))))
    for f in qf:
        out.append((packed(sm.query_accounts(f)),
                    packed(sm.query_transfers(f))))
    out.append(packed(sm.get_change_events(T.ChangeEventsFilter(limit=50))))
    out.append(packed(sm.lookup_accounts([1, 2, 3, 4, 99])))
    out.append(packed(sm.lookup_transfers([101, 104, 105, 999])))
    return out


def _mk_attached(M, seed, n_accounts=300, n_transfers=2000, cache_sets=8,
                 ways=2):
    """The JAX package's test_lsm_serving fixture: a forest-attached
    StateMachine whose data far exceeds its object caches, and a detached
    twin."""
    T = M.types
    rng = np.random.default_rng(5 + seed)
    durable = M.durable.DurableState(M.storage.MemoryStorage(
        M.storage.TEST_LAYOUT))
    attached = M.sm("oracle")
    attached.attach_durable(durable, cache_sets=cache_sets, ways=ways)
    detached = M.sm("oracle")
    accts = [T.Account(id=i, ledger=1, code=1 + i % 3, user_data_64=i % 7)
             for i in range(1, n_accounts + 1)]
    ts = 10**9
    for sm in (attached, detached):
        sm.create_accounts(accts, ts)
    evs = []
    for i in range(n_transfers):
        dr = int(rng.integers(1, n_accounts + 1))
        cr = int(rng.integers(1, n_accounts + 1))
        if dr == cr:
            cr = dr % n_accounts + 1
        evs.append(T.Transfer(
            id=10**6 + i, debit_account_id=dr, credit_account_id=cr,
            amount=int(rng.integers(1, 100)), ledger=1, code=1 + i % 3,
            user_data_64=i % 5,
            flags=int(T.TransferFlags.pending) if i % 11 == 0 else 0))
    attached.cache_upsert(*durable.flush(attached.state))
    for lo in range(0, n_transfers, 500):
        ts += 600
        for sm in (attached, detached):
            sm.create_transfers(evs[lo:lo + 500], ts)
        attached.cache_upsert(*durable.flush(attached.state))
    return attached, detached, durable


@scenario
def lsm_serving_reads_bounded(M, seed):
    T = M.types
    attached, detached, durable = _mk_attached(M, seed)
    ids = list(range(1, 301))
    got = attached.lookup_accounts(ids)
    assert got == detached.lookup_accounts(ids)
    tids = [10**6 + i for i in range(0, 2000, 7)]
    got_t = attached.lookup_transfers(tids)
    assert got_t == detached.lookup_transfers(tids)
    again = attached.lookup_accounts(ids[:64])
    f = T.AccountFilter(account_id=17, limit=8190, flags=int(
        T.AccountFilterFlags.debits | T.AccountFilterFlags.credits))
    q = T.QueryFilter(code=2, user_data_64=3, limit=200)
    qa = T.QueryFilter(user_data_64=4, limit=100)
    ce = T.ChangeEventsFilter(limit=50)
    reads = [packed(got), packed(got_t), packed(again),
             packed(attached.get_account_transfers(f)),
             packed(attached.query_transfers(q)),
             packed(attached.query_accounts(qa)),
             packed(attached.get_change_events(ce))]
    assert reads[3] == packed(detached.get_account_transfers(f))
    assert reads[6] == packed(detached.get_change_events(ce))
    return (reads, attached._acct_cache.stats(),
            attached._xfer_cache.stats(), len(attached._acct_cache))


@scenario
def lsm_serving_cold_fan_out(M, seed):
    """A cold batch of lookups reaches the storage as a few batched
    fan-outs, and get_many equals get across memtable, frozen memtable,
    levels and tombstones."""
    attached, _, durable = _mk_attached(M, seed)
    for op in range(1, 129):
        durable.compact_beat(op)
    attached._acct_cache.clear()
    attached._xfer_cache.clear()
    durable.grid.cache = type(durable.grid.cache)()
    dev = durable.grid.device
    seen = {"rounds": 0, "reads": 0}
    orig = dev.read_batch

    def counting(reqs):
        seen["rounds"] += 1
        seen["reads"] += len(reqs)
        return orig(reqs)

    dev.read_batch = counting
    try:
        tids = [10**6 + i for i in range(0, 1000, 2 + seed)]
        got = attached.lookup_transfers(tids)
    finally:
        dev.read_batch = orig
    assert [t.id for t in got] == tids
    assert seen["reads"] >= 10 and seen["rounds"] <= 10
    tree = durable.forest.trees["transfers"]
    keys = [(10**6 + i).to_bytes(16, "big") for i in range(0, 2000, 3)]
    keys.append((5).to_bytes(16, "big"))
    many = tree.get_many(keys)
    assert all(many.get(key) == tree.get(key) for key in keys)
    return seen, packed(got), sorted(many.items())


@scenario
def cache_written_through_on_flush(M, seed):
    T = M.types
    attached, detached, durable = _mk_attached(M, seed, n_accounts=10,
                                               n_transfers=0)
    warm = attached.lookup_accounts([1])[0].pack()
    t = [T.Transfer(id=5_000_000, debit_account_id=1, credit_account_id=2,
                    amount=42 + seed, ledger=1, code=1)]
    for sm in (attached, detached):
        sm.create_transfers(t, 10**10)
    stale = attached.lookup_accounts([1])[0].pack()
    flushed = durable.flush(attached.state)
    attached.cache_upsert(*flushed)
    fresh = attached.lookup_accounts([1])[0]
    assert fresh == detached.lookup_accounts([1])[0]
    return warm, stale, flushed, fresh.pack()


# Last, so that every scenario above is registered.
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_matches_jax(name, seed):
    want = SCENARIOS[name](JAX, seed)
    got = SCENARIOS[name](PORT, seed)
    assert got == want
