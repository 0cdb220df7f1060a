"""Python binding over the native C tb_client (csrc/tb_client.cpp, a copy
of the JAX package's native/tb_client.cpp).

reference: src/clients/python over src/clients/c/tb_client.zig — the same
shape: a ctypes packet structure submitted to a thread-safe native client
whose internal IO thread speaks the cluster protocol. Typed helpers come
from clients/common.py, shared with vsr/client.py so the two client stacks
are interchangeable.

A copy of the JAX package's `clients/c_client.py`. The client is host
code: it speaks the cluster protocol over TCP and touches no device.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

from ..types import Operation
from .common import ClientHelpers

TBP_PACKET_PENDING = 0
TBP_PACKET_OK = 1
TBP_PACKET_CLIENT_SHUTDOWN = 2


class _Packet(ctypes.Structure):
    pass


_Packet._fields_ = [
    ("next", ctypes.POINTER(_Packet)),
    ("user_data", ctypes.c_void_p),
    ("operation", ctypes.c_uint16),
    ("status", ctypes.c_uint8),
    ("reserved", ctypes.c_uint8),
    ("data_size", ctypes.c_uint32),
    ("data", ctypes.POINTER(ctypes.c_uint8)),
    ("reply", ctypes.POINTER(ctypes.c_uint8)),
    ("reply_size", ctypes.c_uint32),
]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u64 = ctypes.c_uint64
    pp = ctypes.POINTER(ctypes.c_void_p)
    lib.tbp_client_init.argtypes = [
        pp, u64, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.tbp_client_init.restype = ctypes.c_int
    lib.tbp_client_init_echo.argtypes = [
        pp, u64, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.tbp_client_init_echo.restype = ctypes.c_int
    lib.tbp_client_submit.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(_Packet)]
    lib.tbp_client_wait.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Packet),
                                    ctypes.c_uint32]
    lib.tbp_client_wait.restype = ctypes.c_uint8
    lib.tbp_client_packet_free.argtypes = [ctypes.POINTER(_Packet)]
    lib.tbp_client_deinit.argtypes = [ctypes.c_void_p]
    return lib


def c_client_available() -> bool:
    from .. import native

    return native.load_client() is not None


class CClient(ClientHelpers):
    """Blocking convenience wrapper over the native async client."""

    def __init__(self, *, cluster: int,
                 replica_addresses: list[tuple[str, int]],
                 client_id: Optional[int] = None, echo: bool = False):
        from .. import native

        lib = native.load_client()
        assert lib is not None, "native tb_client unavailable (no g++?)"
        self.lib = _bind(lib)
        self.client_id = (client_id if client_id is not None
                          else int.from_bytes(os.urandom(15), "little") + 1)
        cid = self.client_id.to_bytes(16, "little")
        # Packets the native client still owns (timed-out requests): kept
        # alive here until they complete, or until deinit completes them
        # with CLIENT_SHUTDOWN — the native IO thread resends and finally
        # writes into these buffers, so dropping them early would be a
        # use-after-free.
        self._zombies: list = []
        handle = ctypes.c_void_p()
        if echo:
            rc = self.lib.tbp_client_init_echo(
                ctypes.byref(handle), cluster, cid, None, None)
        else:
            addresses = ",".join(f"{h}:{p}" for h, p in replica_addresses)
            rc = self.lib.tbp_client_init(
                ctypes.byref(handle), cluster, cid, addresses.encode(),
                None, None)
        assert rc == 0, f"tbp_client_init failed: {rc}"
        self.handle = handle

    def _reap_zombies(self) -> None:
        alive = []
        for packet, data in self._zombies:
            if packet.status == TBP_PACKET_PENDING:
                alive.append((packet, data))
            else:
                self.lib.tbp_client_packet_free(ctypes.byref(packet))
        self._zombies = alive

    def request(self, operation: Operation, body: bytes,
                timeout_s: float = 10.0) -> bytes:
        assert self.handle, "client closed"
        self._reap_zombies()
        packet = _Packet()
        data = (ctypes.c_uint8 * len(body)).from_buffer_copy(body or b"\x00")
        packet.operation = int(operation)
        packet.data_size = len(body)
        packet.data = ctypes.cast(data, ctypes.POINTER(ctypes.c_uint8))
        self.lib.tbp_client_submit(self.handle, ctypes.byref(packet))
        status = self.lib.tbp_client_wait(
            self.handle, ctypes.byref(packet), int(timeout_s * 1000))
        if status == TBP_PACKET_PENDING:
            # The native client still owns the packet (it will keep
            # resending); park it so its memory outlives this frame.
            self._zombies.append((packet, data))
            raise TimeoutError(f"request ({operation!r}) timed out")
        if status != TBP_PACKET_OK:
            raise RuntimeError(f"request failed: packet status {status}")
        reply = ctypes.string_at(packet.reply, packet.reply_size) \
            if packet.reply_size else b""
        self.lib.tbp_client_packet_free(ctypes.byref(packet))
        return reply

    def close(self) -> None:
        if self.handle:
            self.lib.tbp_client_deinit(self.handle)
            self.handle = None
            # deinit completed every parked packet (CLIENT_SHUTDOWN).
            self._reap_zombies()
            assert not self._zombies
