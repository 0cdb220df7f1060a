"""Offline structural syntax checks for the generated client sources.

This image ships none of the six client toolchains (go, node, java,
dotnet, ruby, rust — reference runs per-language CI instead,
src/scripts/ci.zig:56), so the next-best gate runs here: strip each
language's comments and string literals, then require (a) balanced
() [] {} delimiters, (b) no unterminated string literal, and (c) the
expected top-level symbols (wire structs + the tbp_* ABI). This catches
the generator's characteristic failure class — template-escaping bugs
that emit an unbalanced or truncated source file — without compiling.

A copy of the JAX package's `clients/syntax_check.py`.
"""

from __future__ import annotations

PAIRS = {"(": ")", "[": "]", "{": "}"}
CLOSERS = {v: k for k, v in PAIRS.items()}


class SyntaxIssue(ValueError):
    pass


def _strip(source: str, language: str) -> str:
    """Remove comments and string/char literals, preserving everything
    else. Handles //, /* */, # (ruby), ', \", ` (node), rust lifetimes
    ('a is NOT a char literal), and escape sequences."""
    out = []
    i = 0
    n = len(source)
    line_comment = {"go": "//", "node": "//", "java": "//",
                    "dotnet": "//", "rust": "//", "ruby": "#"}[language]
    block_comments = language != "ruby"
    while i < n:
        ch = source[i]
        two = source[i:i + 2]
        if two == line_comment or (language == "ruby" and ch == "#"):
            j = source.find("\n", i)
            i = n if j < 0 else j  # keep the newline
            continue
        if block_comments and two == "/*":
            j = source.find("*/", i + 2)
            if j < 0:
                raise SyntaxIssue("unterminated block comment")
            i = j + 2
            continue
        if language == "dotnet" and two == '@"':
            # C# verbatim string: backslash is literal; "" escapes ".
            i = _skip_verbatim(source, i + 1)
            continue
        if ch == '"':
            i = _skip_string(source, i, '"')
            continue
        if ch == "`" and language == "node":
            i = _skip_string(source, i, "`")
            continue
        if ch == "`" and language == "go":
            # Go raw string: no escapes, runs to the next backtick.
            j = source.find("`", i + 1)
            if j < 0:
                raise SyntaxIssue(f"unterminated raw string at {i}")
            i = j + 1
            continue
        if ch == "/" and language == "node" and _regex_start(out):
            i = _skip_regex(source, i)
            continue
        if ch == "'":
            if language in ("node", "ruby"):
                i = _skip_string(source, i, "'")
                continue
            # go/java/dotnet/rust char literal — in rust an apostrophe
            # can also open a lifetime ('a, 'static): only treat it as
            # a literal when a closing quote appears within a short
            # escape-sized window.
            end = _char_literal_end(source, i)
            if end is not None:
                i = end
                continue
            if language != "rust":
                raise SyntaxIssue(f"unterminated char literal at {i}")
            i += 1  # lifetime: keep scanning
            continue
        out.append(ch)
        i += 1
    return "".join(out)


def _skip_verbatim(source: str, i: int) -> int:
    """C# @"..." body starting at the opening quote; "" is the only
    escape, backslash is literal."""
    j = i + 1
    n = len(source)
    while j < n:
        if source[j] == '"':
            if j + 1 < n and source[j + 1] == '"':
                j += 2
                continue
            return j + 1
        j += 1
    raise SyntaxIssue(f"unterminated verbatim string at {i}")


def _regex_start(out: list) -> bool:
    """Heuristic: a '/' begins a JS regex when the previous significant
    character cannot end an expression (so '/' can't be division)."""
    for ch in reversed(out):
        if ch in " \t\n\r":
            continue
        return ch in "=([{,;:!&|?+-*%<>~^"
    return True  # start of file


def _skip_regex(source: str, i: int) -> int:
    j = i + 1
    n = len(source)
    in_class = False
    while j < n:
        ch = source[j]
        if ch == "\\":
            j += 2
            continue
        if ch == "\n":
            break  # not actually a regex; treat the '/' as code
        if ch == "[":
            in_class = True
        elif ch == "]":
            in_class = False
        elif ch == "/" and not in_class:
            return j + 1
        j += 1
    # Unterminated on this line: fall back to treating '/' as division.
    return i + 1


def _skip_string(source: str, i: int, quote: str) -> int:
    j = i + 1
    n = len(source)
    while j < n:
        if source[j] == "\\":
            j += 2
            continue
        if source[j] == quote:
            return j + 1
        j += 1
    raise SyntaxIssue(f"unterminated string starting at {i}")


def _char_literal_end(source: str, i: int):
    """End index of a char literal 'x' or escape ('\\n', '\\'',
    '\\u{..}'), else None."""
    j = i + 1
    n = len(source)
    if j < n and source[j] == "\\":
        # The char after the backslash is consumed (covers '\\'');
        # search for the closer from j+2 so an escaped quote can't
        # masquerade as it.
        k = source.find("'", j + 2)
        if 0 < k <= j + 12:
            return k + 1
        return None
    if j + 1 < n and source[j + 1] == "'" and source[j] != "'":
        return j + 2
    return None


def check_source(source: str, language: str,
                 required_symbols: tuple = ()) -> None:
    """Raise SyntaxIssue on structural problems; None when clean."""
    stripped = _strip(source, language)
    stack = []
    for pos, ch in enumerate(stripped):
        if ch in PAIRS:
            stack.append((ch, pos))
        elif ch in CLOSERS:
            if not stack or stack[-1][0] != CLOSERS[ch]:
                raise SyntaxIssue(
                    f"unbalanced {ch!r} (depth {len(stack)})")
            stack.pop()
    if stack:
        raise SyntaxIssue(
            f"{len(stack)} unclosed delimiter(s), first "
            f"{stack[0][0]!r}")
    for symbol in required_symbols:
        if symbol not in source:
            raise SyntaxIssue(f"expected symbol missing: {symbol}")


LANGUAGE_OF = {
    ".go": "go", ".js": "node", ".c": "go",  # C files share // and /* */
    ".java": "java", ".cs": "dotnet", ".rb": "ruby", ".rs": "rust",
}


def check_generated(files: dict) -> list[str]:
    """Check every generated source by extension; returns the list of
    checked paths (raises SyntaxIssue naming the file on failure)."""
    import os

    checked = []
    for rel, content in sorted(files.items()):
        ext = os.path.splitext(rel)[1]
        language = LANGUAGE_OF.get(ext)
        if language is None:
            continue
        try:
            check_source(content, language)
        except SyntaxIssue as e:
            raise SyntaxIssue(f"{rel}: {e}") from None
        checked.append(rel)
    return checked
