"""The constants the create_transfers path, the oracle and the wire need
(a copy of the JAX package's `constants.py` subset; reference:
src/config.zig, src/tigerbeetle.zig)."""

MESSAGE_SIZE_MAX = 1024 * 1024
HEADER_SIZE = 256
MESSAGE_BODY_SIZE_MAX = MESSAGE_SIZE_MAX - HEADER_SIZE
TRANSFER_SIZE = 128

# Events in one create_accounts/create_transfers batch:
# (1 MiB - 256 B header) / 128 B = 8190 (reference: src/state_machine.zig).
BATCH_MAX = MESSAGE_BODY_SIZE_MAX // TRANSFER_SIZE
assert BATCH_MAX == 8190

U128_MAX = (1 << 128) - 1
U63_MAX = (1 << 63) - 1
U32_MAX = (1 << 32) - 1

# Timestamps are u63 (reference: src/lsm/timestamp_range.zig:5-10).
TIMESTAMP_MIN = 1
TIMESTAMP_MAX = U63_MAX

NS_PER_S = 1_000_000_000


def timestamp_valid(timestamp: int) -> bool:
    """reference: src/lsm/timestamp_range.zig:36-39"""
    return TIMESTAMP_MIN <= timestamp <= TIMESTAMP_MAX


# Extra-check mode (reference: constants.verify, src/fuzz_tests.zig:11-16):
# expensive cross-structure invariant checks, off on the serving path and
# switched on by the chaos harness and the tests. Call sites read
# `constants.VERIFY` through the module (never `from ... import VERIFY`,
# which would freeze the value). Set only by `set_verify`: the port reads
# no environment variable.
VERIFY = False


def set_verify(on: bool) -> None:
    global VERIFY
    VERIFY = bool(on)
