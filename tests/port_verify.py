"""The port's process-global `constants.VERIFY` around tests.

The port's simulated `Cluster` turns VERIFY on and leaves it on, as the
JAX package's does (VOPR doctrine), and `tests/conftest.py` restores only
the JAX package's flag. A later test in the same worker would then run
VERIFY drain audits, each a probe and a row gather, that it never asked
for. So every `tests/test_torch_*.py` that builds a port `Cluster`
(directly, or through `testing/vopr.py`, `fuzz.py`, `trace_coverage.py`
or `chaos.py`) binds `port_verify_restored` at module level:

    from tests.port_verify import port_verify_restored  # noqa: F401

and every test that counts kernel calls runs with the flag off
(`port_verify_off`, or `verify_off()` in a module-scoped fixture), the
state the card's child processes run in.
"""

import contextlib

import pytest

from tigerbeetle_tpu_torch import constants


@pytest.fixture(autouse=True)
def port_verify_restored():
    """The port's VERIFY as it was before the test, after it."""
    was = constants.VERIFY
    yield
    constants.set_verify(was)


@contextlib.contextmanager
def verify_off():
    """The port's VERIFY off inside, restored after."""
    was = constants.VERIFY
    constants.set_verify(False)
    try:
        yield
    finally:
        constants.set_verify(was)


@pytest.fixture
def port_verify_off():
    """The port's VERIFY off for the test, restored after it."""
    with verify_off():
        yield
