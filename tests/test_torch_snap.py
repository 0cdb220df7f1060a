"""The port's snapshot assertions (reference: stdx.Snap,
src/stdx/stdx.zig:16): the JAX package's `tests/test_snap.py` cases on
the port's `testing/snap.py`, whose rewriting is switched on by the call
`snap.set_update(True)` where the JAX package reads SNAP_UPDATE."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from tigerbeetle_tpu_torch.testing import snap as snap_module
from tigerbeetle_tpu_torch.testing.snap import snap

REPO = Path(__file__).resolve().parent.parent


class TestSnapCore:
    def test_match_passes(self):
        snap("a\nb\n", expected="""\
        a
        b
        """)

    def test_mismatch_shows_diff(self):
        with pytest.raises(AssertionError) as e:
            snap("actual\n", expected="""\
            expected
            """)
        assert "-expected" in str(e.value) and "+actual" in str(e.value)
        assert "set_update(True)" in str(e.value)

    def test_update_is_off_until_switched_on(self):
        assert snap_module._UPDATE is False
        snap_module.set_update(True)
        try:
            assert snap_module._UPDATE is True
        finally:
            snap_module.set_update(False)

    def test_update_rewrites_source(self, tmp_path):
        test_src = textwrap.dedent('''\
            import sys

            from tigerbeetle_tpu_torch.testing import snap as snap_module
            from tigerbeetle_tpu_torch.testing.snap import snap

            snap_module.set_update(sys.argv[1:] == ["update"])

            def check():
                # Two stale snaps, the first shrinking: the rewriter must
                # track line deltas so the second still lands correctly.
                snap("one\\n", expected="""\\
                stale line a
                stale line b
                stale line c
                """)
                snap("x\\ny\\nz\\n", expected="""\\
                stale
                """)
                snap("no trailing newline", expected="""\\
                stale
                """)

            check()
            print("ok")
        ''')
        path = tmp_path / "snapped.py"
        path.write_text(test_src)
        env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)}
        # First run with rewriting on rewrites every literal in place.
        p = subprocess.run([sys.executable, str(path), "update"], env=env,
                           capture_output=True, text=True)
        assert p.returncode == 0, p.stderr
        text = path.read_text()
        assert "one" in text
        assert "stale line" not in text and '"""\\\nstale' not in text
        # Second run (rewriting off) passes against the rewritten
        # literals — including the no-trailing-newline value.
        p = subprocess.run([sys.executable, str(path)], env=env,
                           capture_output=True, text=True)
        assert p.returncode == 0, p.stderr


class TestSnapshots:
    """Snapshot assertions over stable user-facing renderings."""

    def test_account_repr_layout(self):
        from tigerbeetle_tpu_torch.types import Account, AccountFlags

        a = Account(id=7, debits_posted=250, credits_posted=50,
                    ledger=700, code=10,
                    flags=int(AccountFlags.history))
        got = "\n".join(
            f"{f}={getattr(a, f)}" for f in (
                "id", "debits_pending", "debits_posted", "credits_pending",
                "credits_posted", "ledger", "code", "flags"))
        snap(got + "\n", expected="""\
        id=7
        debits_pending=0
        debits_posted=250
        credits_pending=0
        credits_posted=50
        ledger=700
        code=10
        flags=8
        """)

    def test_operation_wire_codes(self):
        from tigerbeetle_tpu_torch.types import Operation

        live = [op for op in Operation if not op.name.startswith("deprec")]
        got = "\n".join(f"{int(op)} {op.name}" for op in live)
        snap(got + "\n", expected="""\
        128 pulse
        137 get_change_events
        140 lookup_accounts
        141 lookup_transfers
        142 get_account_transfers
        143 get_account_balances
        144 query_accounts
        145 query_transfers
        146 create_accounts
        147 create_transfers
        """)
