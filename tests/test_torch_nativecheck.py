"""``tools/nativecheck`` over the port's native plane.

The tool reads a repository's ``emqx_tpu/native/src/*``,
``emqx_tpu/native/__init__.py``, ``emqx_tpu/broker/native_server.py`` and
``tests/``, by those paths.  It is not edited: each case here runs on a
temporary tree whose ``emqx_tpu/native/src``, ``emqx_tpu/native/__init__.py``
and ``emqx_tpu/broker/native_server.py`` are links to the port's files
(``emqx_tpu_torch/...``), and whose ``tests`` and ``tools`` are links to
the repository's own.  Every case of ``tests/test_nativecheck.py`` reads
that tree: the reference's source of the module, executed with its
``REPO`` at the temporary tree.
"""

from __future__ import annotations

import inspect
import os
import sys
import types
from pathlib import Path

import pytest

from test_torch_harness import REPO

REF = REPO / "tests" / "test_nativecheck.py"


@pytest.fixture(scope="module")
def port_tree(tmp_path_factory) -> Path:
    """The temporary tree the tool reads: the reference's layout, the
    port's files."""
    tree = tmp_path_factory.mktemp("nativecheck") / "repo"
    port = REPO / "emqx_tpu_torch"
    (tree / "emqx_tpu" / "native").mkdir(parents=True)
    (tree / "emqx_tpu" / "broker").mkdir()
    links = {
        "emqx_tpu/native/src": port / "native" / "src",
        "emqx_tpu/native/__init__.py": port / "native" / "__init__.py",
        "emqx_tpu/broker/native_server.py":
            port / "broker" / "native_server.py",
        "tests": REPO / "tests",
        "tools": REPO / "tools",
    }
    for rel, target in links.items():
        os.symlink(target, tree / rel)
    return tree


_copies: dict = {}


def nativecheck_copy(tree: Path):
    """``tests/test_nativecheck.py`` executed as its own module, its
    ``__file__`` (so its ``REPO``, ``SRC`` and ``SERVER_PY``) in ``tree``.
    The line that puts its repository on ``sys.path`` is left out: the
    tree's ``emqx_tpu`` holds only the native plane's links, and must not
    shadow the package; the tool itself imports from this checkout."""
    if tree not in _copies:
        if str(REPO) not in sys.path:
            sys.path.insert(0, str(REPO))
        src = REF.read_text()
        line = 'sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))'
        assert src.count(line) == 1
        mod = types.ModuleType("_port_test_nativecheck")
        mod.__file__ = str(tree / "tests" / "test_nativecheck.py")
        exec(compile(src.replace(line, "pass"), str(REF), "exec"),
             mod.__dict__)
        assert mod.REPO == str(tree)
        assert os.path.realpath(mod.SRC) == str(
            REPO / "emqx_tpu_torch" / "native" / "src")
        assert os.path.realpath(mod.SERVER_PY) == str(
            REPO / "emqx_tpu_torch" / "broker" / "native_server.py")
        _copies[tree] = mod
    return _copies[tree]


# the module's cases (none is parametrised)
CASES = sorted(line[4:].split("(")[0] for line in REF.read_text().splitlines()
               if line.startswith("def test_"))


def test_reference_case_count():
    assert len(CASES) == 29


@pytest.mark.parametrize("case", CASES)
def test_nativecheck_case_over_the_port(case, port_tree, tmp_path):
    fn = getattr(nativecheck_copy(port_tree), case)
    assert not getattr(fn, "pytestmark", [])
    if "tmp_path" in inspect.signature(fn).parameters:
        fn(tmp_path=tmp_path)
    else:
        fn()
