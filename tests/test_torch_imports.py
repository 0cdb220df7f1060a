"""Import hygiene of the PyTorch port: `tigerbeetle_tpu_torch` and
`chip_smoke.py` import neither JAX nor the JAX package nor the TPU probe
scripts of `onchip/`, the port's modules import nothing that needs a
card or a compiler at import time, and the port reads no environment
variable (VERIFY, the spot rate and the flight directory are set by
call)."""

import ast
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "tigerbeetle_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "tigerbeetle_tpu", "onchip")


def _sources():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    return files


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, tigerbeetle_tpu_torch, tigerbeetle_tpu_torch.ops."
        "ledger, tigerbeetle_tpu_torch.ops.state_epoch, "
        "tigerbeetle_tpu_torch.oracle, tigerbeetle_tpu_torch.ops.batch, "
        "tigerbeetle_tpu_torch.ops.create_kernels, "
        "tigerbeetle_tpu_torch.ops.create_seq, "
        "tigerbeetle_tpu_torch.ops.lazy_mirror, "
        "tigerbeetle_tpu_torch.multi_batch, "
        "tigerbeetle_tpu_torch.state_machine, "
        "tigerbeetle_tpu_torch.trace, tigerbeetle_tpu_torch.serving, "
        "tigerbeetle_tpu_torch.admission, "
        "tigerbeetle_tpu_torch.utils.zipfian, "
        "tigerbeetle_tpu_torch.testing.chaos\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_port_sources_name_no_jax_module(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
    text = path.read_text()
    assert "import jax" not in text and "from jax" not in text
    assert "tigerbeetle_tpu." not in text.replace("tigerbeetle_tpu_torch",
                                                  "")
    assert "import onchip" not in text and "from onchip" not in text


def test_the_serving_modules_are_the_ports_own():
    """The serving path's modules exist in the port and import nothing
    of the JAX package (the AST check above covers their sources): the
    StateMachine, the multi-batch codec, the lazy mirror, the supervisor,
    the admission plane, the trace core, the Zipfian generator and the
    chaos harness."""
    for name in ("state_machine.py", "multi_batch.py",
                 "ops/lazy_mirror.py", "serving.py", "admission.py",
                 "trace/__init__.py", "trace/context.py", "trace/event.py",
                 "trace/histogram.py", "trace/statsd.py", "trace/tracer.py",
                 "trace/flight_recorder.py", "utils/zipfian.py",
                 "testing/chaos.py"):
        assert (PORT / name) in _sources(), name


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_port_sources_read_no_environment(path):
    """No `os.environ` / `os.getenv` / `os.putenv` anywhere in the port or
    chip_smoke.py: the JAX package's TB_VERIFY, TB_VERIFY_SPOT_RATE and
    TB_TPU_FLIGHT_DIR become constants.set_verify,
    DeviceLedger.verify_spot_rate and FlightRecorder(dump_dir=...)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            assert node.attr not in ("environ", "getenv", "putenv",
                                     "environb"), (path, node.attr)
        if isinstance(node, ast.Name):
            assert node.id not in ("environ", "getenv"), (path, node.id)


def test_port_modules_import_no_triton_or_build_at_import():
    code = (
        "import sys, tigerbeetle_tpu_torch.ops.fused_probe as fp\n"
        "import tigerbeetle_tpu_torch.ops.row_gather\n"
        "import tigerbeetle_tpu_torch.ops.ledger\n"
        "import tigerbeetle_tpu_torch.ops.create_seq as cs\n"
        "import tigerbeetle_tpu_torch.ops.create_kernels\n"
        "import tigerbeetle_tpu_torch.oracle\n"
        "import tigerbeetle_tpu_torch.state_machine\n"
        "import tigerbeetle_tpu_torch.serving\n"
        "import tigerbeetle_tpu_torch.admission\n"
        "import tigerbeetle_tpu_torch.testing.chaos\n"
        "assert cs._launch == {}\n"
        "assert 'triton' not in sys.modules\n"
        "assert fp._build._libs == {}\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
