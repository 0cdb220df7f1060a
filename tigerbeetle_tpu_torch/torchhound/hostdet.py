"""Host determinism pass: AST lint over the deterministic-replay plane.

The port's copy of the JAX package's `jaxhound/hostdet.py`: the same
four rules, the same visitor and the same pragma grammar, spelled
`# torchhound: allow(<rule>)`.

The replay envelope — the oracle, the serving supervisor's epoch
replay, the VSR state machine, the partitioned router's host side —
must recompute IDENTICAL bytes from identical logged inputs, on any
replica, at any later time. Four host-side habits silently break that:

  wall_clock       reading the wall clock (time.time/monotonic/...,
                   datetime.now) inside replay logic: replayed state
                   depends on WHEN it replayed. Injected clocks
                   (`self.time.monotonic()`, a `clock=` parameter) are
                   the sanctioned pattern and are not flagged — only
                   direct module-level reads are.
  unseeded_random  the process-global `random.*` / legacy
                   `np.random.*` generators: unseeded, shared, and
                   order-dependent across interleavings. Seeded
                   instances (`random.Random(seed)`,
                   `np.random.default_rng(seed)`) are fine.
  set_iteration    iterating a set expression directly (for /
                   comprehension over `set(...)`, a set literal, a set
                   comprehension, or a union/difference of those):
                   Python set order is hash-salt- and history-
                   dependent, so any committed ordering fed by it
                   diverges across replicas. `sorted(<set>)` is the
                   sanctioned pattern and is not flagged.
  env_read         os.environ / os.getenv inside replay modules:
                   environment is per-process state, not logged input.

Escape hatch: a flagged line carrying `# torchhound: allow(<rule>)`
suppresses that rule on that line, on a line whose value feeds no
committed state (tests/test_torch_hound.py checks that every pragma in
the port names a real rule, so stale pragmas cannot accumulate). The
scanned scope is SCOPE below — the port's modules whose output feeds
committed state.
"""

from __future__ import annotations

import ast
import os
import re

RULES = ("wall_clock", "unseeded_random", "set_iteration", "env_read")

# Replay-plane scope, relative to the package root's parent (the repo
# checkout): directories scan recursively.
SCOPE = (
    "tigerbeetle_tpu_torch/oracle",
    "tigerbeetle_tpu_torch/serving.py",
    "tigerbeetle_tpu_torch/state_machine.py",
    "tigerbeetle_tpu_torch/vsr",
    "tigerbeetle_tpu_torch/parallel/partitioned.py",
)

_PRAGMA_RE = re.compile(r"#\s*torchhound:\s*allow\(([\w,\s]+)\)")

_WALL_CLOCK_TIME_FNS = {
    "time", "time_ns", "monotonic", "monotonic_ns", "perf_counter",
    "perf_counter_ns", "process_time", "process_time_ns",
}
_WALL_CLOCK_DATETIME_FNS = {"now", "utcnow", "today"}
# Seeded-constructor names on the random module: instantiating is fine,
# calling the module-level functions is not.
_RANDOM_OK = {"Random", "SystemRandom", "seed"}
_NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "PCG64",
                 "Philox", "RandomState"}
_ENV_FNS = {"getenv"}


def file_pragmas(source: str) -> dict[int, set[str]]:
    """line number -> set of allowed rule names for every
    `# torchhound: allow(rule[, rule])` pragma in `source`."""
    out: dict[int, set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _PRAGMA_RE.search(line)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",")}
    return out


class _ModuleAliases(ast.NodeVisitor):
    """Top-level import resolution: alias name -> module path, plus
    `from M import f` leaves alias -> 'M.f'."""

    def __init__(self):
        self.aliases: dict[str, str] = {}

    def visit_Import(self, node):
        for a in node.names:
            self.aliases[a.asname or a.name.split(".")[0]] = a.name

    def visit_ImportFrom(self, node):
        if node.module:
            for a in node.names:
                self.aliases[a.asname or a.name] = \
                    f"{node.module}.{a.name}"


def _resolve(node, aliases) -> str | None:
    """Dotted path of a Name/Attribute chain rooted at an imported
    module, e.g. `_time.monotonic` -> 'time.monotonic'. Chains rooted
    at anything else (self.time.monotonic — an injected provider)
    resolve to None and are never flagged."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    root = aliases.get(node.id)
    if root is None:
        return None
    return ".".join([root] + list(reversed(parts)))


def _is_set_expr(node) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("set", "frozenset"):
        return True
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        return _is_set_expr(node.left) or _is_set_expr(node.right)
    return False


class _Checker(ast.NodeVisitor):
    def __init__(self, aliases, pragmas):
        self.aliases = aliases
        self.pragmas = pragmas
        self.findings: list[tuple[int, str, str]] = []

    def _flag(self, node, rule: str, detail: str) -> None:
        if rule in self.pragmas.get(node.lineno, ()):
            return
        self.findings.append((node.lineno, rule, detail))

    def visit_Call(self, node):
        path = _resolve(node.func, self.aliases)
        if path:
            mod, _, fn = path.rpartition(".")
            if mod == "time" and fn in _WALL_CLOCK_TIME_FNS:
                self._flag(node, "wall_clock", f"{path}() read")
            elif (mod in ("datetime.datetime", "datetime.date")
                  and fn in _WALL_CLOCK_DATETIME_FNS):
                self._flag(node, "wall_clock", f"{path}() read")
            elif mod == "random" and fn not in _RANDOM_OK:
                self._flag(node, "unseeded_random",
                           f"process-global {path}()")
            elif (mod in ("numpy.random", "np.random")
                  and fn not in _NP_RANDOM_OK):
                self._flag(node, "unseeded_random",
                           f"legacy global {path}()")
            elif mod == "os" and fn in _ENV_FNS:
                self._flag(node, "env_read", f"{path}() in replay scope")
            elif path in ("os.environ.get", "os.environ.setdefault"):
                self._flag(node, "env_read", f"{path}() in replay scope")
        self.generic_visit(node)

    def visit_Subscript(self, node):
        if _resolve(node.value, self.aliases) == "os.environ":
            self._flag(node, "env_read", "os.environ[...] in replay "
                       "scope")
        self.generic_visit(node)

    def _check_iter(self, node, it):
        if _is_set_expr(it):
            self._flag(node, "set_iteration",
                       "iterating a set expression feeds an "
                       "unspecified order — wrap in sorted(...)")

    def visit_For(self, node):
        self._check_iter(node, node.iter)
        self.generic_visit(node)

    def _visit_comp(self, node):
        for gen in node.generators:
            self._check_iter(node, gen.iter)
        self.generic_visit(node)

    visit_ListComp = visit_SetComp = visit_GeneratorExp = _visit_comp

    def visit_DictComp(self, node):
        self._visit_comp(node)


def scan_source(source: str, path: str = "<str>") -> list[str]:
    """Host-determinism findings for one module's source text, pragma
    allowlist applied. Each finding: 'path:line: rule: detail'."""
    tree = ast.parse(source, filename=path)
    aliases = _ModuleAliases()
    aliases.visit(tree)
    checker = _Checker(aliases.aliases, file_pragmas(source))
    checker.visit(tree)
    return [f"{path}:{line}: {rule}: {detail}"
            for line, rule, detail in sorted(checker.findings)]


def scope_files(repo_root: str | None = None) -> list[str]:
    """The replay-plane .py files SCOPE resolves to."""
    if repo_root is None:
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    files = []
    for rel in SCOPE:
        p = os.path.join(repo_root, rel)
        if os.path.isdir(p):
            for dirpath, _dirs, names in sorted(os.walk(p)):
                files.extend(os.path.join(dirpath, n)
                             for n in sorted(names) if n.endswith(".py"))
        elif os.path.isfile(p):
            files.append(p)
    return files


def run(repo_root: str | None = None) -> list[str]:
    """Run the host pass over the replay scope; returns RED strings
    (relative paths)."""
    fails = []
    root = repo_root or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for path in scope_files(root):
        with open(path) as f:
            src = f.read()
        rel = os.path.relpath(path, root)
        fails.extend(scan_source(src, rel))
    return fails
