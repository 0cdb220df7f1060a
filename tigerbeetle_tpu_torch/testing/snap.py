"""Snapshot ("snaptest") assertions: inline expected values that update
themselves.

reference: src/stdx/stdx.zig:16 `Snap` (and src/testing/snaptest.zig) —
a test writes `snap(__file__, '''...''')` with the expected rendering
inline; on mismatch the failure shows a diff, and with rewriting on
(`set_update(True)`) a mismatch rewrites the expectation in place in the
test source. Keeps golden values next to the assertion instead of in
sidecar files.

Usage:

    from tigerbeetle_tpu_torch.testing.snap import snap

    def test_render():
        snap(got_text, expected='''\\
        line one
        line two
        ''')

The expected block is dedented before comparison.

A copy of the JAX package's `testing/snap.py`, whose rewriting is turned
on by the SNAP_UPDATE environment variable. The port reads no
environment, so its switch is the call `set_update(on)`, as
`constants.set_verify` replaced TB_VERIFY.
"""

from __future__ import annotations

import difflib
import inspect
import re
import textwrap

_UPDATE = False


def set_update(on: bool) -> None:
    """Turn rewriting of mismatched expectations on or off."""
    global _UPDATE
    _UPDATE = bool(on)


# Earlier rewrites shift line numbers within a file; later
# call frames still report COMPILE-TIME linenos, so track each rewrite's
# COMPILE-TIME position and line delta (path -> [(compile lineno, delta)])
# and shift a frame's lineno by the deltas of rewrites above it.
_REWRITE_DELTAS: dict[str, list[tuple[int, int]]] = {}


def snap(got: str, expected: str) -> None:
    """Assert `got` equals the dedented `expected` block; with
    rewriting on, rewrite the call site's literal instead of failing."""
    want = textwrap.dedent(expected)
    if got == want:
        return
    if _UPDATE:
        _rewrite_call_site(got)
        return
    diff = "\n".join(difflib.unified_diff(
        want.splitlines(), got.splitlines(),
        fromfile="expected", tofile="got", lineterm=""))
    raise AssertionError(
        f"snapshot mismatch (call set_update(True) to accept):\n{diff}")


def _rewrite_call_site(got: str) -> None:
    """Replace the triple-quoted `expected=` literal of the calling
    `snap()` with `got` (re-indented to the literal's indentation)."""
    frame = inspect.stack()[2]
    path, lineno = frame.filename, frame.lineno
    lineno += sum(d for at, d in _REWRITE_DELTAS.get(path, ())
                  if at < lineno)
    with open(path) as f:
        src = f.read()
    lines = src.splitlines(keepends=True)
    start = sum(len(ln) for ln in lines[:lineno - 1])
    m = re.compile(r"(?<![\w.])snap\(").search(src, start)
    assert m is not None, f"snap() call not found at {path}:{lineno}"
    # Anchor on the expected= keyword so a triple-quoted `got` argument
    # can never be mistaken for the expectation.
    kw = re.compile(r"expected\s*=").search(src, m.end())
    lit_from = kw.end() if kw is not None else m.end()
    lit = re.compile(
        r"(?P<q>'''|\"\"\")(?P<body>.*?)(?P=q)", re.S).search(src, lit_from)
    assert lit is not None, f"no triple-quoted literal after {path}:{lineno}"
    indent = _literal_indent(lit.group("body"))
    body = "\\\n" + textwrap.indent(got, indent)
    if got.endswith("\n"):
        body += indent  # align the closing quotes; dedent strips it
    new_src = src[:lit.start()] + lit.group("q") + body + lit.group("q") \
        + src[lit.end():]
    delta = new_src.count("\n") - src.count("\n")
    _REWRITE_DELTAS.setdefault(path, []).append((lineno, delta))
    with open(path, "w") as f:
        f.write(new_src)


def _literal_indent(body: str) -> str:
    for line in body.splitlines():
        # Skip the leading line-continuation backslash ('''\) — it is
        # part of the literal syntax, not indented content.
        if line.strip() and line.strip() != "\\":
            return line[:len(line) - len(line.lstrip())]
    return "        "
