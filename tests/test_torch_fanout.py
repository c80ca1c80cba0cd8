"""The port's fan-out kernels against the JAX reference, bit for bit.

``fanout_pool`` (the dense pool), ``fanout_bitmaps`` (a dense bitmap row
per filter) and ``bitmap_to_counts`` (popcount per topic).  The port
stores bitmap words as int32; its output viewed as uint32 must equal the
reference's uint32 words, and its int32 counts the reference's uint32 ones.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from emqx_tpu_torch.ops import fanout as fo

from test_torch_harness import torch_one_thread  # noqa: F401 (autouse)
from test_torch_harness import run_reference


def _case(rng: np.random.Generator, B: int, M: int, F: int, P: int,
          W: int) -> dict:
    rowmap = np.full(F, -1, np.int32)
    dense = rng.choice(F, size=min(P, F // 3), replace=False)
    rowmap[dense] = rng.permutation(P)[: len(dense)]
    pool = rng.integers(0, 2 ** 32, (P, W), dtype=np.uint64).astype(np.uint32)
    pool[rng.integers(0, P, P // 4)] = 0              # some empty rows
    fids = rng.integers(0, F, (B, M)).astype(np.int32)
    fids[rng.random((B, M)) < 0.6] = -1               # compact-style padding
    fids[: B // 8] = -1                               # rows with no match
    return dict(rowmap=rowmap, pool=pool, fids=fids)


CASES = [
    _case(np.random.default_rng(1), B=64, M=16, F=300, P=64, W=8),
    _case(np.random.default_rng(2), B=128, M=128, F=2000, P=128, W=33),
    _case(np.random.default_rng(3), B=64, M=4, F=64, P=64, W=1),
]


def _bitmap_case(rng: np.random.Generator, B: int, M: int, F: int,
                 W: int) -> dict:
    bitmaps = rng.integers(0, 2 ** 32, (F, W),
                           dtype=np.uint64).astype(np.uint32)
    bitmaps[rng.integers(0, F, F // 4)] = 0           # filters with no slot
    bitmaps[rng.integers(0, F, F // 8)] &= 0x80000001  # sparse rows
    fids = rng.integers(0, F, (B, M)).astype(np.int32)
    fids[rng.random((B, M)) < 0.6] = -1
    fids[: B // 8] = -1                               # rows with no match
    return dict(bitmaps=bitmaps, fids=fids)


BITMAP_CASES = [
    _bitmap_case(np.random.default_rng(4), B=64, M=16, F=300, W=8),
    _bitmap_case(np.random.default_rng(5), B=77, M=128, F=1500, W=33),
    _bitmap_case(np.random.default_rng(6), B=128, M=4, F=64, W=1),
]


@pytest.fixture(scope="module")
def refs():
    return run_reference({"ref_fanout": CASES,
                          "ref_fanout_bitmaps": BITMAP_CASES})


@pytest.fixture(scope="module")
def ref(refs):
    return refs["ref_fanout"]


@pytest.mark.parametrize("i", range(len(CASES)))
def test_fanout_pool_equals_reference(ref, i):
    c = CASES[i]
    out = fo.fanout_pool(torch.from_numpy(c["rowmap"]),
                         torch.from_numpy(c["pool"].view(np.int32)),
                         torch.from_numpy(c["fids"]))
    assert out.dtype == torch.int32
    got = out.numpy().view(np.uint32)
    np.testing.assert_array_equal(got, ref[i])
    assert (got >= 2 ** 31).any() and (got == 0).all(1).any()


@pytest.mark.parametrize("i", range(len(BITMAP_CASES)))
def test_fanout_bitmaps_equals_reference(refs, i):
    c = BITMAP_CASES[i]
    want_fan, want_counts = refs["ref_fanout_bitmaps"][i]
    fan = fo.fanout_bitmaps(torch.from_numpy(c["bitmaps"].view(np.int32)),
                            torch.from_numpy(c["fids"]))
    assert fan.dtype == torch.int32
    got = fan.numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want_fan)
    assert (got >= 2 ** 31).any() and (got == 0).all(1).any()


@pytest.mark.parametrize("i", range(len(BITMAP_CASES)))
def test_bitmap_to_counts_equals_reference(refs, i):
    want_fan, want_counts = refs["ref_fanout_bitmaps"][i]
    counts = fo.bitmap_to_counts(torch.from_numpy(want_fan.view(np.int32)))
    assert counts.dtype == torch.int32 and counts.shape == want_counts.shape
    np.testing.assert_array_equal(counts.numpy(),
                                  want_counts.astype(np.int64))
    assert (counts == 0).any()
    assert int(counts.max()) > 32 or want_fan.shape[1] == 1


def test_bitmap_wrappers_on_cpu_take_the_plain_version():
    from emqx_tpu_torch.ops import _build
    _build.reset_launch_counts()
    c = BITMAP_CASES[0]
    bm, fids = torch.from_numpy(c["bitmaps"].view(np.int32)), \
        torch.from_numpy(c["fids"])
    fan = fo.fanout_bitmaps(bm, fids)
    assert torch.equal(fan, fo.fanout_bitmaps_plain(bm, fids))
    assert torch.equal(fo.bitmap_to_counts(fan),
                       fo.bitmap_to_counts_plain(fan))
    # every bit pattern of a word, against Python's popcount
    words = torch.tensor([[0, -1, -2 ** 31, 1, 0x55555555, -0x55555556]],
                         dtype=torch.int32)
    assert fo.bitmap_to_counts(words).tolist() == [
        sum(bin(w & 0xFFFFFFFF).count("1") for w in words[0].tolist())]
    assert _build.launch_counts() == dict.fromkeys(_build.KERNELS, 0)
