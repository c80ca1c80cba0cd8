"""The reference's own mesh cases over the port: every case of
``tests/test_multichip_scale.py`` (the 110k-filter parity matrix over the
three (dp, tp) splits of 8 devices and both trie layouts, the layout
invariance, the S=1 degeneracy, per-shard patches under churn, the full
serving stack over TCP on a mesh, and the device-loss failover) and
``tests/test_router_model.py::test_mesh_sharded_equals_single``, from the
reference's source with the package name pointed at the port
(``reference_tests``).

The port's mesh there is the CPU eight times (``cpu_meshes``) and its
models are on the CPU (``cpu_router_models``), where, as in the
reference, a failing step fails over to the host.  The reference's
module-scoped fixtures (the 110k-filter models) are built once for the
module, as pytest builds them for the reference's own run.
"""

from __future__ import annotations

import inspect
import random

import pytest

from test_torch_harness import call_reference, cpu_meshes, \
    cpu_router_models, reference_calls, reference_case_names, \
    reference_tests, slow_cases
from test_torch_harness import torch_one_thread  # noqa: F401 (autouse)

REFERENCE = {"test_multichip_scale": 21}
# the one mesh case of tests/test_router_model.py (the file's other cases
# are the single-device model's, held by tests/test_torch_router_model.py)
ROUTER_MODEL_CASE = "test_mesh_sharded_equals_single"
CASES = [(name, case, i) for name in REFERENCE
         for case, i in reference_calls(name)] + [
    ("test_router_model", ROUTER_MODEL_CASE, 0)]
FIXTURES = ("single_model", "sharded_models", "sharded_trie_models")


def test_reference_case_counts():
    for name, n in REFERENCE.items():
        assert len(reference_calls(name)) == n, name
        assert not slow_cases(name), name
    assert ROUTER_MODEL_CASE in reference_case_names("test_router_model")
    assert len(CASES) == 22


@pytest.fixture(scope="module")
def port_copies():
    """The port's copies of both reference modules, their RouterModel on
    the CPU and their make_mesh over the CPU eight times, for the
    module."""
    mods = {n: reference_tests(n, "port")
            for n in ("test_multichip_scale", "test_router_model")}
    with pytest.MonkeyPatch.context() as mp:
        cpu_router_models(mp, *mods.values())
        cpu_meshes(mp, *mods.values())
        yield mods


@pytest.fixture(scope="module")
def scale_fixtures(port_copies):
    """The reference module's module-scoped fixtures, each made once (the
    models' caches fill lazily, as in the reference's run)."""
    mod = port_copies["test_multichip_scale"]

    class Lazy(dict):
        def __missing__(self, name):
            self[name] = getattr(mod, name)._get_wrapped_function()()
            return self[name]

    return Lazy()


@pytest.mark.parametrize("name,case,i", CASES)
def test_reference_mesh_case(name, case, i, port_copies, scale_fixtures):
    mod = port_copies[name]
    fn = getattr(mod, case)
    wanted = set(inspect.signature(fn).parameters)
    fixtures = {f: scale_fixtures[f] for f in FIXTURES if f in wanted}
    call_reference(name, "port", case, i, rng=random.Random(0xE19),
                   **fixtures)
