"""Import hygiene of the PyTorch port: `tigerbeetle_tpu_torch` and
`chip_smoke.py` import neither JAX nor the JAX package nor the TPU probe
scripts of `onchip/`, and the port's modules import nothing that needs a
card or a compiler at import time."""

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
        "ledger, tigerbeetle_tpu_torch.ops.state_epoch\n"
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


def test_port_modules_import_no_triton_or_build_at_import():
    code = (
        "import sys, tigerbeetle_tpu_torch.ops.fused_probe as fp\n"
        "import tigerbeetle_tpu_torch.ops.row_gather\n"
        "import tigerbeetle_tpu_torch.ops.ledger\n"
        "assert 'triton' not in sys.modules\n"
        "assert fp._build._libs == {}\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
