"""The port's entry points (``emqx_tpu_torch/entry.py``) against the
reference's (``__graft_entry__.py``).

The reference runs in the harness's child process (``run_reference``,
eight virtual CPU devices for its mesh); the port runs here on the CPU
(``device="cpu"``, ``devices=[cpu] * n``).  Every comparison is exact:
the model's filters, index arrays and device tables, the example batch,
the step's five outputs, and the dry run's printed lines word for word.
"""

from __future__ import annotations

import io
import os
import re
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from test_torch_harness import (REPO, arrays_of, run_reference, tables_of,
                                torch_one_thread)  # noqa: F401

from emqx_tpu_torch import entry as E
from emqx_tpu_torch.models import router_model as rm
from emqx_tpu_torch.ops import trie_match as tm

CPU = torch.device("cpu")
DRY_FILTERS = 4000
# (n_devices, filters): the dry runs held to the reference's; n=3 (tp=1)
# does not split the 64-topic batch over its 3 dp rows, and both raise
DRY_CASES = [(8, DRY_FILTERS), (3, DRY_FILTERS), (2, DRY_FILTERS)]


@pytest.fixture(scope="module")
def ref():
    return run_reference({"ref_graft_entry": None,
                          "ref_graft_dryrun": DRY_CASES}, devices=8)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the step's kernels have no CPU "
                    "mode")
    return torch.device("cuda", 0)


def _outputs(out) -> list:
    """The step's five outputs as numpy (the fan-out's words as uint32,
    as the reference's), None kept."""
    res = []
    for i, o in enumerate(out):
        if o is None:
            res.append(None)
            continue
        a = o.cpu().numpy()
        res.append(a.view(np.uint32) if rm.STEP_OUTPUTS[i] == "fanout"
                   else a)
    return res


def _equal_outputs(got: list, want: list) -> None:
    assert len(got) == len(want) == 5
    for name, g, w in zip(rm.STEP_OUTPUTS, got, want):
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)


def _dryrun(n: int, devices=None) -> tuple[str, str | None]:
    """The port's dry run: what it printed and the exception's name."""
    buf, raised = io.StringIO(), None
    try:
        with redirect_stdout(buf):
            E.dryrun_multichip(n, devices=devices)
    except Exception as e:      # noqa: BLE001 — compared by type
        raised = type(e).__name__
    return buf.getvalue(), raised


def test_build_model_equals_the_reference(ref):
    model = E._build_model(device="cpu")
    want = ref["ref_graft_entry"]
    assert list(model.index.filters) == want["filters"]
    got = arrays_of(model.index.arrays)
    for name, a in want["arrays"].items():
        np.testing.assert_array_equal(got[name], a, err_msg=name)
    tables = tables_of(model)
    assert sorted(tables) == sorted(want["tables"])
    for name, a in want["tables"].items():
        np.testing.assert_array_equal(tables[name], a, err_msg=name)


def test_example_batch_equals_the_reference(ref):
    model = E._build_model(device="cpu")
    batch = E._example_batch(model)
    assert [x.dtype for x in batch] == [torch.int32, torch.int32,
                                        torch.bool]
    assert all(x.device == CPU for x in batch)
    for got, want in zip(batch, ref["ref_graft_entry"]["batch"]):
        np.testing.assert_array_equal(got.numpy(), want)


def test_entry_step_equals_the_reference(ref):
    """``fn(*args)`` equals the reference's ``jax.jit(fn)(*args)`` on all
    five outputs, with the counters off (None on both sides) and on."""
    fn, args = E.entry(device="cpu")
    assert fn.func is rm.router_step
    assert fn.keywords == {"K": 32, "M": 64, "max_probes": 8}
    assert len(args) == 6 and args[3].shape == (256, 8)
    want = ref["ref_graft_entry"]
    out = _outputs(fn(*args))
    assert out[4] is None
    _equal_outputs(out, list(want["out"]))
    _equal_outputs(_outputs(fn(*args, with_counters=True)),
                   list(want["out_counters"]))


@pytest.mark.parametrize("i", range(len(DRY_CASES)),
                         ids=[f"n{n}" for n, _ in DRY_CASES])
def test_dryrun_prints_the_reference_lines(ref, monkeypatch, i):
    """The port's dry run over n CPU devices prints the reference's lines
    over n virtual devices, word for word (n=3: both raise ValueError at
    the batch split, having printed nothing)."""
    n, filters = DRY_CASES[i]
    monkeypatch.setenv("GRAFT_DRYRUN_FILTERS", str(filters))
    printed, raised = _dryrun(n, devices=[CPU] * 8)
    want_printed, want_raised = ref["ref_graft_dryrun"][i]
    assert (printed, raised) == (want_printed, want_raised)
    if n % 2 == 0:
        lines = printed.splitlines()
        assert len(lines) == 2 and raised is None
        assert lines[0].startswith("dryrun_multichip OK: ")
        assert lines[1].startswith("dryrun_multichip sharded OK: S=4 ")
        assert all(line.endswith("oracle_parity=64/64") for line in lines)
    else:
        assert (printed, raised) == ("", "ValueError")


def test_dryrun_at_the_default_filters(monkeypatch):
    """At the default 200,000 filters the flat leg takes the reference's
    >=100k-distinct assert; both legs equal the host oracle on every
    topic."""
    monkeypatch.delenv("GRAFT_DRYRUN_FILTERS", raising=False)
    monkeypatch.delenv("GRAFT_DRYRUN_SHARDS", raising=False)
    printed, raised = _dryrun(8, devices=[CPU] * 8)
    assert raised is None
    flat, sharded = printed.splitlines()
    assert int(re.search(r" filters=(\d+) ", flat).group(1)) >= 100_000
    assert flat.startswith("dryrun_multichip OK: mesh={'dp': 4, 'tp': 2} ")
    assert sharded.startswith("dryrun_multichip sharded OK: S=4 ")
    for line in (flat, sharded):
        assert line.endswith(" fallback=0 oracle_parity=64/64")


def test_too_few_devices_raise():
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        E.dryrun_multichip(8, devices=[CPU] * 4)


def test_entry_points_raise_without_a_card(no_card):
    """With no card and no device, nothing falls back to the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E._build_model()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.dryrun_multichip(8)


def test_main_exits_non_zero_without_a_card(no_card):
    """``python -m emqx_tpu_torch.entry`` with no card exits 1, prints no
    result, and imports neither JAX nor the JAX package."""
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['emqx_tpu'] = None\n"
            "runpy.run_module('emqx_tpu_torch.entry', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr[-2000:]
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == ""


@pytest.mark.cuda
def test_entry_on_the_card_equals_its_plain_twin(cuda_device):
    """``entry()`` on the card: ``fn(*args)`` is one launch of the walk
    and one of the fan-out, and equals the plain step on CPU copies of
    the same arguments, with the counters off and on."""
    from emqx_tpu_torch.ops import _build
    fn, args = E.entry()
    assert args[3].device.type == "cuda"
    trie = tm.DeviceTrie(edges=args[0].edges.cpu(),
                         nodes=args[0].nodes.cpu())
    cpu_args = (trie, *(a.cpu() for a in args[1:]))
    for with_counters in (False, True):
        want = rm.router_step_plain(*cpu_args, **fn.keywords,
                                    with_counters=with_counters)
        before = _build.launch_counts()
        got = fn(*args, with_counters=with_counters)
        torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in _build.launch_counts().items()
                 if v != before[k]}
        assert delta == {"walk_compact": 1, "fanout_pool": 1}
        _equal_outputs(_outputs(got), _outputs(want))


@pytest.mark.cuda
def test_dryrun_on_the_card_four_times_equals_the_cpu_mesh(cuda_device,
                                                           monkeypatch):
    """The dry run on a (2, 2) mesh of the card four times prints what the
    CPU's (2, 2) mesh prints."""
    monkeypatch.setenv("GRAFT_DRYRUN_FILTERS", str(DRY_FILTERS))
    got = _dryrun(4, devices=[cuda_device] * 4)
    assert got == _dryrun(4, devices=[CPU] * 4)
    assert got[1] is None and len(got[0].splitlines()) == 2


def test_smoke_entry_phase_rehearses_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s entry paths at 4000 filters on the CPU:
    ``entry()`` equal to the plain step, ``dryrun_multichip(4)`` over the
    CPU four times equal to its single-device twins, and each leg's
    launches in its own window (the flat leg's walks on ``entry``, the
    sharded leg's on ``entry_s4``; here each mesh step counts as one launch
    of its walk, as the card's walk kernel would count per device)."""
    import chip_smoke as cs
    from emqx_tpu_torch.ops import _build
    read = {}

    def path_counts(name, counts=None):
        read[name] = dict(counts)
        return {}

    monkeypatch.setattr(cs, "path_counts", path_counts)
    plain = rm.mesh_step_plain

    def counted(trie, *a, **k):
        walk = ("walk_compact_sharded" if trie[0][0].edges.dim() == 3
                else "walk_compact")
        _build.KERNELS[walk].launches += 1
        return plain(trie, *a, **k)

    monkeypatch.setattr(rm, "mesh_step_plain", counted)
    counts, out = cs.entry_phase("cpu", device="cpu", filters=DRY_FILTERS)
    assert counts == {"entry": {}, "entry_s4": {}}
    assert out["entry_shapes"] == [[256, 64], [256, 128], [256], [], None]
    assert read["entry"]["walk_compact"] == 1
    assert read["entry"]["walk_compact_sharded"] == 0
    assert read["entry_s4"]["walk_compact_sharded"] == 1
    assert read["entry_s4"]["walk_compact"] == 0
    (run,) = out["dryruns"]
    assert run["mesh"] == [2, 2] and run["filters"] == 2040
    monkeypatch.setenv("GRAFT_DRYRUN_FILTERS", str(DRY_FILTERS))
    assert run["lines"] == _dryrun(4, devices=[CPU] * 4)[0].splitlines()


def test_smoke_spill_leg_rehearses_on_the_cpu():
    """``chip_smoke.py``'s rule-engine spill leg over a CPU model: three
    rows spill to the engine's host trie, three ride the aux column, 21
    firings, ``kernel_overflow`` 3, equal to the CPU twin's run."""
    import chip_smoke as cs
    out = cs.spill_leg("cpu", CPU)
    assert out["spilled"] == 3 and out["kernel_overflow"] == 3
    assert out["fired"] == 21 and out["steps"] == 1
    assert out["aux"] == {"s/x/y": None, "s/q/y": None, "s/x/z": None,
                          "t/q/z": ["#", "+/+/+"], "s/q": ["#", "s/#"],
                          "u": ["#"]}
