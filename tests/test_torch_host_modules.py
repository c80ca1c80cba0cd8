"""The reference's own tests of the host modules the port copied, run over
the port: ``tests/test_topic.py`` (``core/topic.py``),
``tests/test_trie.py`` (``router/trie.py``, ``router/router.py``),
``tests/test_stats_lint.py`` (``native/__init__.py`` ``STAT_NAMES`` against
the port's copy of ``host.cc``, and the exposition) and
``tests/test_index_vectorized.py`` (``router/index.py``'s two builders).

Each case is the reference's, unedited, called on a private copy of its
module whose ``emqx_tpu`` names point at ``emqx_tpu_torch``
(``reference_tests``).  Two copies need more than that:

- ``test_stats_lint`` also names the reference's package as data: in the
  path of ``host.cc``, which its copy points at the port's copy, and in
  the exposition's default ``node="emqx_tpu"`` label, which the port keeps
  and so does the copy.
- ``test_index_vectorized`` matches through ``tm.device_trie`` and
  ``tm.match_batch`` with numpy arguments and no device.  The port's take
  tensors and need a card unless given a device, so its copy's ``tm`` is
  :class:`CpuTrieMatch`, which runs the port's ``ops/trie_match.py`` on
  CPU tensors (the walk's plain version).  Its cases are listed from the
  port's copy: the reference's copy does not import here (R1).
"""

from __future__ import annotations

import random
import types

import numpy as np
import pytest
import torch

from test_torch_harness import (_APP_IMPORT, _PKG_NAME, REPO,
                                _outside_strings, app_class,
                                call_reference, reference_calls,
                                reference_params, reference_tests,
                                slow_cases, torch_one_thread)  # noqa: F401

from emqx_tpu_torch.ops import trie_match as ptm

PLAIN = ("test_topic", "test_trie")


def _calls(name: str) -> list[tuple[str, int]]:
    return [(name, case, i)
            for case, i in reference_calls(name, skip=slow_cases(name))]


_stats_lint: dict = {}


def stats_lint_copy() -> types.ModuleType:
    """The port's copy of ``tests/test_stats_lint.py``, made as
    ``reference_tests`` makes one (every ``emqx_tpu`` name, the path of
    ``host.cc`` too, pointed at ``emqx_tpu_torch``; ``BrokerApp`` the
    port's), with the exposition's ``node="emqx_tpu"`` label kept."""
    if not _stats_lint:
        path = REPO / "tests" / "test_stats_lint.py"
        src = _outside_strings(_APP_IMPORT, r"\1pass", path.read_text())
        src = _PKG_NAME.sub("emqx_tpu_torch", src).replace(
            'node="emqx_tpu_torch"', 'node="emqx_tpu"')
        mod = types.ModuleType("_port_test_stats_lint")
        mod.__file__ = str(path)
        mod.BrokerApp = app_class("port")
        exec(compile(src, str(path), "exec"), mod.__dict__)
        assert "emqx_tpu_torch" in mod.HOST_CC
        _stats_lint["mod"] = mod
    return _stats_lint["mod"]


class CpuTrieMatch:
    """``device_trie`` and ``match_batch`` as the reference's
    ``ops/trie_match.py`` is called (numpy in, no device), over the port's
    on CPU tensors."""

    @staticmethod
    def device_trie(arrays):
        return ptm.device_trie(arrays, device="cpu")

    @staticmethod
    def match_batch(trie, tokens, lengths, sys_flags, *, K=32,
                    max_probes=8):
        return ptm.match_batch(
            trie, *(torch.from_numpy(np.ascontiguousarray(x))
                    for x in (tokens, lengths, sys_flags)),
            K=K, max_probes=max_probes)


def _port_calls(mod) -> list[tuple[str, int]]:
    """``reference_calls`` over a port copy: every call of its cases not
    marked ``slow``."""
    cases = sorted(n for n, v in vars(mod).items()
                   if n.startswith("test_") and callable(v)
                   and not any(m.name == "slow"
                               for m in getattr(v, "pytestmark", [])))
    return [(case, i) for case in cases
            for i in range(len(reference_params(getattr(mod, case))))]


VECTORIZED = _port_calls(reference_tests("test_index_vectorized", "port"))
STATS_LINT = reference_calls("test_stats_lint",
                             skip=slow_cases("test_stats_lint"))


HOST = [c for n in PLAIN for c in _calls(n)]


@pytest.mark.parametrize("name,case,i", HOST,
                         ids=[f"{n}::{c}[{i}]" for n, c, i in HOST])
def test_reference_host_case_over_the_port(name, case, i):
    call_reference(name, "port", case, i, rng=random.Random(0xE19))


@pytest.mark.parametrize("case,i", STATS_LINT,
                         ids=[f"{c}[{i}]" for c, i in STATS_LINT])
def test_reference_stats_lint_over_the_port(case, i):
    mod = stats_lint_copy()
    fn = getattr(mod, case)
    fn(**reference_params(fn)[i])


@pytest.mark.parametrize("case,i", VECTORIZED,
                         ids=[f"{c}[{i}]" for c, i in VECTORIZED])
def test_reference_index_vectorized_over_the_port(monkeypatch, case, i):
    mod = reference_tests("test_index_vectorized", "port")
    monkeypatch.setitem(vars(mod), "tm", CpuTrieMatch)
    call_reference("test_index_vectorized", "port", case, i)


def test_every_reference_host_case_runs():
    """The four modules' cases (no slow ones) all run here: 8, 11, 29 and
    the vectorized builder's 5 calls."""
    assert len(_calls("test_topic")) == 8
    assert len(_calls("test_trie")) == 11
    assert len(STATS_LINT) == 29
    assert len(VECTORIZED) == 5
