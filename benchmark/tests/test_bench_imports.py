"""Nothing under ``benchmark/`` imports JAX or the JAX package, and the
reference imports nothing of the program under test; module names are
compared whole by their top-level part (``emqx_tpu_torch`` is not
``emqx_tpu``)."""

import ast
import subprocess
import sys

from conftest import ROOT

BANNED = {"jax", "jaxlib", "flax", "emqx_tpu"}
REFERENCE_MAY = {"__future__", "typing", "math", "numpy", "benchmark"}


def imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_anywhere():
    files = sorted((ROOT / "benchmark").rglob("*.py"))
    assert files
    for f in files:
        for mod in imports(f):
            assert mod.split(".")[0] not in BANNED, (f, mod)


def test_reference_is_independent():
    for f in sorted((ROOT / "benchmark" / "reference").rglob("*.py")):
        for mod in imports(f):
            top = mod.split(".")[0]
            assert top in REFERENCE_MAY, (f, mod)
            if top == "benchmark":
                assert mod.startswith("benchmark.reference") or \
                    mod == "benchmark.yardstick", (f, mod)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.check, "
            "benchmark.reference.work; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out))  # noqa: S307 — a list of names printed above
    assert not loaded & (BANNED | {"emqx_tpu_torch", "torch"})


def test_banned_modules_compare_whole_names(monkeypatch):
    from benchmark import run
    monkeypatch.setitem(sys.modules, "emqx_tpu_torch_fake.x", object())
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "emqx_tpu.fake", object())
    assert run.banned_modules() == ["emqx_tpu.fake"]
