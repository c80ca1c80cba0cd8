"""The port's native plane over the reference's own tests: ASan and TSan
runs of the port's ``host.cc`` build, each driver in a child process
with the sanitizer runtime preloaded.

The cases of ``tests/test_native_sanitizers.py`` run over the port: the
reference's own source with every ``emqx_tpu`` name pointed at
``emqx_tpu_torch`` (``reference_tests``), so they drive the port's
``native`` bindings, its library (built from ``emqx_tpu_torch/native/src``
into ``emqx_tpu_torch/_build/native/``) and its ``NativeBrokerServer``. The
reference's own run of these modules holds the reference; the cases it
marks ``slow`` stay out here as they stay out of tier-1 there.

The 26 sanitized runs are marked ``slow`` here: on an 8-core x86 CPU they
took 345 s together, 241 s of it the two sanitized builds of ``host.cc``
(the reference's run reuses its own builds where they exist).
``tests/test_torch_native_plane.py`` holds the port's C++ to the
reference's byte for byte in tier-1, so these runs check the same source.
"""

from __future__ import annotations

import pytest

from test_torch_harness import call_reference, reference_calls, \
    reference_case_names, slow_cases

REFERENCE = {"test_native_sanitizers": 1}
CASES = [(name, case, i) for name in REFERENCE
         for case, i in reference_calls(name, slow_cases(name))]


def test_reference_case_counts():
    for name, n in REFERENCE.items():
        assert len(reference_case_names(name)) == n, name
    assert len(CASES) == sum(REFERENCE.values()) + 25


@pytest.mark.slow
@pytest.mark.parametrize("name,case,i", CASES)
def test_reference_native_case(name, case, i, tmp_path, monkeypatch,
                               caplog, capsys):
    monkeypatch.chdir(tmp_path)
    call_reference(name, "port", case, i, tmp_path=tmp_path,
                   monkeypatch=monkeypatch, caplog=caplog, capsys=capsys)
