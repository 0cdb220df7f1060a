"""The port's client generators (`tigerbeetle_tpu_torch/clients/codegen*.py`,
`syntax_check.py`) against the JAX package's, on the CPU.

- Each language's files, and the conformance contract, equal the JAX
  generator's byte for byte; `write_out` and `python -m
  tigerbeetle_tpu_torch clients --out DIR` write the committed clients/
  tree, file for file.
- The layout tables, struct sizes and field offsets equal the JAX
  package's and agree with the port's own `types.py` `pack()`.
- The syntax check accepts every generated source and rejects a broken
  one.
- The C ABI the generated Go and Node glue names is exported by the
  port's csrc/tb_client.cpp, which exports the same `tbp_*` symbols as
  the JAX package's native/tb_client.cpp and is that file line for line
  (its own header note and its `vsr/header.py` paths aside).
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from tigerbeetle_tpu.clients import codegen as JCG
from tigerbeetle_tpu_torch import multi_batch
from tigerbeetle_tpu_torch import types as T
from tigerbeetle_tpu_torch.clients import codegen as CG
from tigerbeetle_tpu_torch.clients import syntax_check

REPO = Path(__file__).resolve().parent.parent

GENERATORS = ("go", "node", "java", "dotnet", "ruby", "rust")


def _generate(module, lang: str) -> dict:
    if lang in ("go", "node"):
        return getattr(module, f"generate_{lang}")()
    sub = __import__(f"{module.__package__}.codegen_{lang}",
                     fromlist=["x"])
    return getattr(sub, f"generate_{lang}")()


@pytest.fixture(scope="module")
def generated():
    return CG.generate_all()


def _committed() -> dict:
    root = REPO / "clients"
    return {str(p.relative_to(root)): p.read_text()
            for p in root.rglob("*") if p.is_file()}


@pytest.mark.parametrize("lang", GENERATORS + ("conformance",))
def test_a_generator_equals_the_jax_packages(lang):
    if lang == "conformance":
        got, want = CG.generate_conformance(), JCG.generate_conformance()
        assert got == want
        return
    got, want = _generate(CG, lang), _generate(JCG, lang)
    assert sorted(got) == sorted(want) and got
    for rel in want:
        assert got[rel] == want[rel], rel


def test_generate_all_equals_the_jax_package_and_the_committed_tree(
        generated):
    assert generated == JCG.generate_all()
    committed = _committed()
    for rel, content in generated.items():
        assert committed.get(rel) == content, rel


def test_write_out_writes_the_committed_tree(tmp_path, generated):
    written = CG.write_out(str(tmp_path))
    assert sorted(written) == sorted(str(tmp_path / r) for r in generated)
    committed = _committed()
    for rel in generated:
        assert (tmp_path / rel).read_text() == committed[rel], rel


def test_main_clients_writes_the_same_files(tmp_path, generated):
    out = subprocess.run(
        [sys.executable, "-m", "tigerbeetle_tpu_torch", "clients",
         f"--out={tmp_path}"], cwd=str(REPO), capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert f"clients: {len(generated)} files generated into {tmp_path}/" \
        in out.stdout
    files = sorted(str(p.relative_to(tmp_path))
                   for p in tmp_path.rglob("*") if p.is_file())
    assert files == sorted(generated)
    for rel, content in generated.items():
        assert (tmp_path / rel).read_text() == content, rel


def test_layouts_sizes_and_offsets_equal_the_jax_packages():
    assert CG.LAYOUTS == JCG.LAYOUTS
    assert CG.C_ABI_FUNCTIONS == JCG.C_ABI_FUNCTIONS
    assert {k: {m.name: int(m) for m in v} for k, v in CG.ENUMS.items()} \
        == {k: {m.name: int(m) for m in v} for k, v in JCG.ENUMS.items()}
    for name in CG.LAYOUTS:
        assert CG.struct_size(name) == JCG.struct_size(name)
        assert CG.offsets(name) == JCG.offsets(name)
    assert [CG.struct_size(n) for n in (
        "Account", "Transfer", "AccountBalance", "AccountFilter",
        "QueryFilter", "CreateAccountResult", "CreateTransferResult")] == \
        [128, 128, 128, 128, 64, 16, 16]
    assert all(CG.PY_CLASSES[n].__module__ == T.__name__
               for n in CG.LAYOUTS)


def test_layouts_agree_with_the_ports_pack():
    """Each field's slice at the generator's offset equals the field's own
    encoding in the port's types.py pack() (the JAX package's
    tests/test_clients_codegen.py check, on the port's types)."""
    for name, fields in CG.LAYOUTS.items():
        cls = CG.PY_CLASSES[name]
        sentinels = {}
        for i, (field, kind) in enumerate(fields):
            if kind.startswith("pad"):
                continue
            bits = 128 if kind == "u128" else int(kind[1:])
            sentinels[field] = (0x0101010101010101 * (i + 1)) % (1 << bits)
        kwargs = dict(sentinels)
        if name.endswith("Result"):
            enum_cls = (T.CreateAccountStatus if "Account" in name
                        else T.CreateTransferStatus)
            kwargs["status"] = enum_cls.linked_event_failed
            sentinels["status"] = int(enum_cls.linked_event_failed)
            kwargs.pop("reserved", None)
            sentinels["reserved"] = 0
        packed = cls(**{k: v for k, v in kwargs.items()
                        if k in cls.__dataclass_fields__}).pack()
        assert len(packed) == CG.struct_size(name), name
        for field, kind, off in CG.offsets(name):
            size = CG.field_size(kind)
            got = packed[off:off + size]
            if kind.startswith("pad"):
                assert got == b"\x00" * size, (name, field)
                continue
            want = (sentinels.get(field, 0)
                    if field in cls.__dataclass_fields__ else 0)
            assert got == want.to_bytes(size, "little"), (name, field)


def test_conformance_vectors_decode_with_the_ports_types():
    doc = json.loads(CG.generate_conformance())
    for vec in doc["struct_vectors"]:
        obj = CG.PY_CLASSES[vec["struct"]].unpack(
            bytes.fromhex(vec["encoded_hex"]))
        for field, want in vec["fields"].items():
            assert int(getattr(obj, field)) == int(want), \
                (vec["struct"], field)
    for vec in doc["multi_batch_vectors"]:
        payloads = [bytes.fromhex(p) for p in vec["payloads_hex"]]
        assert multi_batch.decode(bytes.fromhex(vec["encoded_hex"]),
                                  vec["element_size"]) == payloads


def test_the_syntax_check_accepts_every_generated_source(generated):
    checked = syntax_check.check_generated(generated)
    for ext in (".go", ".js", ".java", ".cs", ".rb", ".rs"):
        assert any(p.endswith(ext) for p in checked), ext
    assert len(checked) >= 20
    for rel, lang in (("go/tigerbeetle/client.go", "go"),
                      ("rust/src/client.rs", "rust"),
                      ("ruby/lib/tigerbeetle_tpu/client.rb", "ruby")):
        syntax_check.check_source(generated[rel], lang,
                                  required_symbols=CG.C_ABI_FUNCTIONS)


def test_the_syntax_check_rejects_a_broken_source(generated):
    bad = syntax_check.SyntaxIssue
    with pytest.raises(bad, match="unclosed"):
        syntax_check.check_source("fn main() { let x = (1;", "rust")
    with pytest.raises(bad, match="unterminated string"):
        syntax_check.check_source('let s = "oops;', "node")
    with pytest.raises(bad, match="missing"):
        syntax_check.check_source("package x", "go",
                                  required_symbols=("tbp_client_init",))
    broken = dict(generated)
    rel = "go/tigerbeetle/client.go"
    broken[rel] = broken[rel][:len(broken[rel]) // 2]
    with pytest.raises(bad, match=re.escape(rel)):
        syntax_check.check_generated(broken)
    syntax_check.check_source('// {{{ \nlet s = "}}}"; fn f() {}', "rust")
    syntax_check.check_source("s = '{{{' # }}}\n", "ruby")


def _exported(path: Path) -> set:
    """The `tbp_*` functions a tb_client source defines with C linkage."""
    text = path.read_text()
    return set(re.findall(r"^\s*(?:[\w\*]+\s+)+\**(tbp_\w+)\s*\(", text,
                          re.M))


def test_the_c_abi_is_the_jax_packages(generated):
    port = _exported(REPO / "tigerbeetle_tpu_torch" / "csrc" /
                     "tb_client.cpp")
    jax = _exported(REPO / "native" / "tb_client.cpp")
    assert port == jax and set(CG.C_ABI_FUNCTIONS) <= port
    go_client = generated["go/tigerbeetle/client.go"]
    addon = generated["node/addon/addon.c"]
    for fn in set(CG.C_ABI_FUNCTIONS) - {"tbp_client_packet_free"}:
        assert fn in go_client and fn in addon, fn


def test_the_c_runtime_is_the_jax_packages_line_for_line():
    """csrc/tb_client.cpp is native/tb_client.cpp with a note of four
    comment lines after the first two and the header module's path under
    the port's package."""
    port = (REPO / "tigerbeetle_tpu_torch" / "csrc" /
            "tb_client.cpp").read_text().splitlines()
    jax = (REPO / "native" / "tb_client.cpp").read_text().splitlines()
    note = port[2:6]
    assert note[0].startswith("// A copy of the JAX package's "
                              "native/tb_client.cpp") and note[-1] == "//"
    body = port[:2] + port[6:]
    assert len(body) == len(jax)
    moved = 0
    for k, (got, want) in enumerate(zip(body, jax)):
        if got != want:
            assert got == want.replace("tigerbeetle_tpu/vsr/header.py",
                                       "tigerbeetle_tpu_torch/vsr/header.py"
                                       ), k
            moved += 1
    assert moved == 2


def test_status_enums_complete(generated):
    go_types = generated["go/tigerbeetle/types.go"]
    node_types = generated["node/lib/types.js"]
    for status in T.CreateTransferStatus:
        go_name = "CreateTransferStatus" + "".join(
            p.capitalize() for p in status.name.split("_"))
        assert f"{go_name} CreateTransferStatus = {int(status)}" \
            in go_types, status.name
        assert f"{status.name}: {int(status)}," in node_types, status.name
    for op in T.Operation:
        assert f"{op.name}: {int(op)}," in node_types, op.name
