"""Zig-zag intersection of sorted key streams.

reference: src/lsm/zig_zag_merge.zig — multi-index query AND: instead of
materializing each index's matches, the streams leapfrog each other (each
seeks to the maximum head key), touching only O(result + seeks) entries.
Streams must expose `peek() -> key | None` and `seek(key)` (advance to the
first key >= target).
"""

from __future__ import annotations

from typing import Iterator, Protocol


class SeekableStream(Protocol):
    def peek(self): ...
    def seek(self, key) -> None: ...
    def next(self) -> None: ...


def zig_zag_intersect(streams: list) -> Iterator:
    """Yield keys present in EVERY stream, ascending."""
    if not streams:
        return
    while True:
        heads = []
        for stream in streams:
            head = stream.peek()
            if head is None:
                return  # any exhausted stream ends the intersection
            heads.append(head)
        target = max(heads)
        if all(h == target for h in heads):
            yield target
            for stream in streams:
                stream.next()
        else:
            for stream, head in zip(streams, heads):
                if head < target:
                    stream.seek(target)
