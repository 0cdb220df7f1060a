"""Interactive REPL: parse statements, drive a cluster client.

reference: src/repl.zig + src/repl/parser.zig — statement syntax:

    create_accounts id=1 code=10 ledger=700 flags=linked|history,
                    id=2 code=10 ledger=700;
    create_transfers id=1 debit_account_id=1 credit_account_id=2 amount=10
                     ledger=700 code=10;
    lookup_accounts id=1, id=2;
    get_account_transfers account_id=1 flags=debits|credits limit=10;
    query_accounts ledger=700 limit=10;

Objects are comma-separated; a statement ends with ';'. Flag values are
'|'-separated flag names.

The port's copy of the JAX package's `repl.py`.
"""

from __future__ import annotations

import dataclasses
import shlex
from typing import Optional

from .types import (
    Account,
    AccountFilter,
    AccountFilterFlags,
    AccountFlags,
    ChangeEventsFilter,
    Operation,
    QueryFilter,
    QueryFilterFlags,
    Transfer,
    TransferFlags,
)

_OPERATIONS = {
    "create_accounts": Operation.create_accounts,
    "create_transfers": Operation.create_transfers,
    "lookup_accounts": Operation.lookup_accounts,
    "lookup_transfers": Operation.lookup_transfers,
    "get_account_transfers": Operation.get_account_transfers,
    "get_account_balances": Operation.get_account_balances,
    "query_accounts": Operation.query_accounts,
    "query_transfers": Operation.query_transfers,
    "get_change_events": Operation.get_change_events,
}

_FLAG_SETS = {
    "create_accounts": AccountFlags,
    "create_transfers": TransferFlags,
    "get_account_transfers": AccountFilterFlags,
    "get_account_balances": AccountFilterFlags,
    "query_accounts": QueryFilterFlags,
    "query_transfers": QueryFilterFlags,
}

_OBJECTS = {
    "create_accounts": Account,
    "create_transfers": Transfer,
    "get_account_transfers": AccountFilter,
    "get_account_balances": AccountFilter,
    "query_accounts": QueryFilter,
    "query_transfers": QueryFilter,
    "get_change_events": ChangeEventsFilter,
}


class ParseError(ValueError):
    pass


@dataclasses.dataclass
class Statement:
    operation: Operation
    objects: list  # dataclass instances, or ids for lookups


def parse_statement(text: str) -> Optional[Statement]:
    """Parse one ';'-terminated statement; None for blank input."""
    text = text.strip().rstrip(";").strip()
    if not text:
        return None
    try:
        tokens = shlex.split(text)
    except ValueError as e:
        raise ParseError(str(e))
    op_name = tokens[0]
    if op_name not in _OPERATIONS:
        raise ParseError(
            f"unknown operation {op_name!r} (expected one of "
            f"{', '.join(sorted(_OPERATIONS))})")
    operation = _OPERATIONS[op_name]

    # Split the remaining tokens into comma-separated objects.
    groups: list[list[str]] = [[]]
    for token in tokens[1:]:
        parts = token.split(",")
        for i, part in enumerate(parts):
            if i > 0:
                groups.append([])
            if part:
                groups[-1].append(part)
    groups = [g for g in groups if g]

    if op_name in ("lookup_accounts", "lookup_transfers"):
        ids = []
        for group in groups:
            for token in group:
                key, _, value = token.partition("=")
                if value == "":
                    value = key
                elif key != "id":
                    raise ParseError(f"lookups take ids, got {token!r}")
                ids.append(_parse_int(value))
        if not ids:
            raise ParseError("lookup needs at least one id")
        return Statement(operation, ids)

    cls = _OBJECTS[op_name]
    flag_set = _FLAG_SETS.get(op_name)
    fields = {f.name: f for f in dataclasses.fields(cls)}
    objects = []
    for group in groups:
        kwargs = {}
        for token in group:
            key, eq, value = token.partition("=")
            if not eq:
                raise ParseError(f"expected key=value, got {token!r}")
            if key not in fields:
                raise ParseError(
                    f"unknown field {key!r} for {op_name} "
                    f"(fields: {', '.join(sorted(fields))})")
            if key == "flags":
                if flag_set is None:
                    raise ParseError(f"{op_name} has no flags")
                kwargs[key] = _parse_flags(value, flag_set)
            else:
                kwargs[key] = _parse_int(value)
        objects.append(cls(**kwargs))
    if not objects:
        raise ParseError(f"{op_name} needs at least one object")
    return Statement(operation, objects)


def _parse_int(value: str) -> int:
    try:
        return int(value, 0)
    except ValueError:
        raise ParseError(f"not an integer: {value!r}")


def _parse_flags(value: str, flag_set) -> int:
    out = 0
    for name in value.split("|"):
        name = name.strip()
        if not name:
            continue
        try:
            out |= int(flag_set[name])
        except KeyError:
            raise ParseError(
                f"unknown flag {name!r} (expected "
                f"{', '.join(f.name for f in flag_set)})")
    return out


# ------------------------------------------------------------ completion

_COMMANDS = ("exit", "quit", "help")


def complete_candidates(buffer: str, word: str) -> list[str]:
    """Context-aware completions for the partial `word` at the end of
    `buffer` (reference: src/repl/completion.zig — operation names at
    statement start, then field names for that operation, then flag
    names inside a flags value). Pure function: the terminal layer below
    and the tests share it."""
    stmt = buffer[buffer.rfind(";") + 1:]
    prior = stmt[:len(stmt) - len(word)] if word else stmt
    tokens = prior.split()
    if not tokens:
        pool = sorted(_OPERATIONS) + list(_COMMANDS)
        return [c for c in pool if c.startswith(word)]
    op_name = tokens[0]
    if op_name not in _OPERATIONS:
        return []
    key, eq, value = word.partition("=")
    if eq:
        if key == "flags" and op_name in _FLAG_SETS:
            done, _, part = value.rpartition("|")
            prefix = f"{key}={done}|" if done else f"{key}="
            return [prefix + f.name for f in _FLAG_SETS[op_name]
                    if f.name.startswith(part)]
        return []
    if op_name in ("lookup_accounts", "lookup_transfers"):
        return ["id="] if "id".startswith(word) else []
    cls = _OBJECTS[op_name]
    names = [f.name for f in dataclasses.fields(cls)
             if f.name != "timestamp"]
    return [f"{n}=" for n in sorted(names) if n.startswith(word)]


def setup_terminal(history_path: Optional[str] = None):
    """Line editing + history + tab completion via GNU readline
    (reference: src/repl/terminal.zig's raw-mode editor — the runtime-
    native equivalent is the readline library). No-op where readline is
    unavailable; returns a save-history callback (or None)."""
    try:
        import readline
    except ImportError:
        return None

    state = {"matches": []}

    def completer(word, index):
        if index == 0:
            buffer = readline.get_line_buffer()[:readline.get_endidx()]
            state["matches"] = complete_candidates(buffer, word)
        if index < len(state["matches"]):
            return state["matches"][index]
        return None

    readline.set_completer(completer)
    readline.set_completer_delims(" \t\n,;")
    readline.parse_and_bind("tab: complete")
    if history_path:
        import contextlib

        with contextlib.suppress(OSError):
            readline.read_history_file(history_path)
        readline.set_history_length(1000)

        def save():
            with contextlib.suppress(OSError):
                readline.write_history_file(history_path)

        return save
    return None


def format_result(obj) -> str:
    """Render a result dataclass like the reference repl: non-zero fields."""
    pairs = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v not in (0, "", None) or f.name in ("id", "timestamp"):
            name = getattr(v, "name", None)
            pairs.append(f"{f.name}={name if name is not None else v}")
    return "{" + " ".join(pairs) + "}"


def run_repl(client, input_fn=input, print_fn=print) -> None:
    """Statement loop against a connected client. When driven by the
    builtin input() on a tty, the terminal layer (readline: editing,
    history, tab completion) engages automatically."""
    from . import multi_batch
    from .state_machine import OPERATION_SPECS
    from .types import (
        AccountBalance,
        ChangeEvent,
        CreateAccountResult,
        CreateTransferResult,
    )

    save_history = None
    if input_fn is input:
        import os
        import sys

        if sys.stdin.isatty():
            save_history = setup_terminal(
                os.path.expanduser("~/.tigerbeetle_tpu_history"))

    result_types = {
        Operation.create_accounts: CreateAccountResult,
        Operation.create_transfers: CreateTransferResult,
        Operation.lookup_accounts: Account,
        Operation.lookup_transfers: Transfer,
        Operation.get_account_transfers: Transfer,
        Operation.get_account_balances: AccountBalance,
        Operation.query_accounts: Account,
        Operation.query_transfers: Transfer,
        Operation.get_change_events: ChangeEvent,
    }
    buffer = ""
    while True:
        try:
            prompt = "> " if not buffer else ". "
            line = input_fn(prompt)
        except EOFError:
            if save_history:
                save_history()
            return
        if line.strip() in ("exit", "quit"):
            if save_history:
                save_history()
            return
        if line.strip() == "help":
            print_fn("operations: " + ", ".join(sorted(_OPERATIONS)))
            print_fn("syntax: <operation> key=value ... , key=value ...;")
            print_fn("tab completes operations, fields, and flag names")
            continue
        buffer += " " + line
        # Execute every complete statement on the line; a parse error drops
        # only its own statement, never the rest of the buffer.
        while ";" in buffer:
            statement_text, _, buffer = buffer.partition(";")
            try:
                stmt = parse_statement(statement_text)
            except ParseError as e:
                print_fn(f"error: {e}")
                continue
            if stmt is None:
                continue
            try:
                payload = _execute(client, stmt)
            except Exception as e:
                print_fn(f"error: {e}")
                continue
            rtype = result_types[stmt.operation]
            size = OPERATION_SPECS[stmt.operation].result_size
            for i in range(0, len(payload), size):
                print_fn(format_result(rtype.unpack(payload[i:i + size])))


def _execute(client, stmt: Statement) -> bytes:
    from . import multi_batch
    from .state_machine import OPERATION_SPECS

    op = stmt.operation
    spec = OPERATION_SPECS[op]
    if op in (Operation.lookup_accounts, Operation.lookup_transfers):
        body = b"".join(i.to_bytes(16, "little") for i in stmt.objects)
    else:
        body = b"".join(o.pack() for o in stmt.objects)
    if op.is_multi_batch():
        body = multi_batch.encode([body], spec.event_size)
    out = client.request(op, body)
    if op.is_multi_batch():
        (out,) = multi_batch.decode(out, spec.result_size)
    return out
