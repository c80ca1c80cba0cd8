"""The port's fan-out kernels against the JAX reference, bit for bit.

``fanout_pool`` (the dense pool), ``fanout_bitmaps`` (a dense bitmap row
per filter) and ``bitmap_to_counts`` (popcount per topic).  The port
stores bitmap words as int32; its output viewed as uint32 must equal the
reference's uint32 words, and its int32 counts the reference's uint32 ones.

``bitmap_to_counts`` also runs on a grid of shapes around its kernel's
vector path (W % 4 == 0), one and two 256-word tiles, B = 1 and B not a
multiple of 8.  The cases reach both paths of the card's gather-OR kernel: W % 4 == 0 and
M % 4 == 0 (its 16-byte path; W = 256, M = 128 is the routing width) and
neither, M past one 128-fid chunk, B = 1 and B not a multiple of the 8
warps of a block, a topic whose every fid selects a row (one row many
times), a batch that selects no row, and fids >= F.

Out-of-range entries: the port skips a fid >= F (and a rowmap row >= P);
the reference's gathers clamp it to the last row (``ROADMAP.md`` §3 R3).
The cases with such entries make the clamped target select nothing, so the
two agree, and ``test_out_of_range_entries_select_nothing`` holds the
port's rule where the clamped row is not empty.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from emqx_tpu_torch.ops import fanout as fo

from test_torch_harness import torch_one_thread  # noqa: F401 (autouse)
from test_torch_harness import run_reference


def _words(rng: np.random.Generator, shape) -> np.ndarray:
    return rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _case(rng: np.random.Generator, B: int, M: int, F: int, P: int,
          W: int, kind: str = "mixed") -> dict:
    """``kind``: "mixed" (padding, empty pool rows, topics with no match),
    "full" (every fid selects a row, a few rows many times), "none" (no
    fid selects a row) or "beyond" (mixed, plus fids >= F and rowmap rows
    >= P, whose clamped targets in the reference select nothing)."""
    rowmap = np.full(F, -1, np.int32)
    dense = rng.choice(F, size=min(P, F // 3), replace=False)
    rowmap[dense] = rng.permutation(P)[: len(dense)]
    pool = _words(rng, (P, W))
    fids = rng.integers(0, F, (B, M)).astype(np.int32)
    if kind == "full":
        fids = dense[rng.integers(0, min(len(dense), 3), (B, M))].astype(
            np.int32)
        pool[pool.max(1) < 2 ** 31, 0] |= np.uint32(2 ** 31)  # none empty
        return dict(rowmap=rowmap, pool=pool, fids=fids, kind=kind)
    pool[rng.integers(0, P, P // 4)] = 0              # some empty rows
    fids[rng.random((B, M)) < 0.6] = -1               # compact-style padding
    fids[: B // 8] = -1                               # rows with no match
    if kind == "none":
        fids[rowmap[np.maximum(fids, 0)] >= 0] = -1
    elif kind == "beyond":
        rowmap[-1] = -1                               # the clamped fid
        pool[-1] = 0                                  # the clamped row
        rowmap[rng.choice(np.flatnonzero(rowmap < 0)[:-1], 5,
                          replace=False)] = P + rng.integers(0, 9, 5)
        far = rng.random((B, M)) < 0.1
        fids[far] = F + rng.integers(0, 3 * F, int(far.sum()))
        fids[0, 0] = 2 ** 31 - 1
    return dict(rowmap=rowmap, pool=pool, fids=fids, kind=kind)


CASES = [
    _case(np.random.default_rng(1), B=64, M=16, F=300, P=64, W=8),
    _case(np.random.default_rng(2), B=128, M=128, F=2000, P=128, W=33),
    _case(np.random.default_rng(3), B=64, M=4, F=64, P=64, W=1),
    # the routing width: the 16-byte path, one fid chunk and one tile
    _case(np.random.default_rng(7), B=136, M=128, F=2000, P=64, W=256),
    # W and M around the vector path: % 4 == 0 or not, past one chunk
    _case(np.random.default_rng(8), B=64, M=1, F=300, P=64, W=4),
    _case(np.random.default_rng(9), B=77, M=77, F=2000, P=64, W=5),
    _case(np.random.default_rng(10), B=40, M=130, F=2000, P=64, W=4),
    _case(np.random.default_rng(11), B=24, M=130, F=900, P=32, W=5),
    _case(np.random.default_rng(12), B=13, M=128, F=600, P=64, W=260,
          kind="full"),
    _case(np.random.default_rng(13), B=1, M=77, F=600, P=64, W=5,
          kind="full"),
    _case(np.random.default_rng(14), B=50, M=128, F=600, P=64, W=256,
          kind="none"),
    _case(np.random.default_rng(15), B=72, M=130, F=900, P=64, W=256,
          kind="beyond"),
]


def _bitmap_case(rng: np.random.Generator, B: int, M: int, F: int,
                 W: int, kind: str = "mixed") -> dict:
    """``kind`` as in :func:`_case`; "beyond" keeps the last bitmap row,
    the reference's clamped target, empty."""
    bitmaps = _words(rng, (F, W))
    if kind == "full":
        bitmaps[bitmaps.max(1) < 2 ** 31, 0] |= np.uint32(2 ** 31)
        fids = rng.integers(0, min(F, 3), (B, M)).astype(np.int32)
        return dict(bitmaps=bitmaps, fids=fids, kind=kind)
    bitmaps[rng.integers(0, F, F // 4)] = 0           # filters with no slot
    bitmaps[rng.integers(0, F, F // 8)] &= 0x80000001  # sparse rows
    fids = rng.integers(0, F, (B, M)).astype(np.int32)
    fids[rng.random((B, M)) < 0.6] = -1
    fids[: B // 8] = -1                               # rows with no match
    if kind == "none":
        fids[:] = -1
    elif kind == "beyond":
        bitmaps[-1] = 0
        far = rng.random((B, M)) < 0.1
        fids[far] = F + rng.integers(0, 3 * F, int(far.sum()))
        fids[0, 0] = 2 ** 31 - 1
    return dict(bitmaps=bitmaps, fids=fids, kind=kind)


BITMAP_CASES = [
    _bitmap_case(np.random.default_rng(4), B=64, M=16, F=300, W=8),
    _bitmap_case(np.random.default_rng(5), B=77, M=128, F=1500, W=33),
    _bitmap_case(np.random.default_rng(6), B=128, M=4, F=64, W=1),
    _bitmap_case(np.random.default_rng(16), B=136, M=128, F=3000, W=256),
    _bitmap_case(np.random.default_rng(17), B=64, M=1, F=300, W=4),
    _bitmap_case(np.random.default_rng(18), B=77, M=77, F=1500, W=5),
    _bitmap_case(np.random.default_rng(19), B=40, M=130, F=1500, W=4),
    _bitmap_case(np.random.default_rng(20), B=13, M=128, F=500, W=260,
                 kind="full"),
    _bitmap_case(np.random.default_rng(21), B=1, M=130, F=500, W=5,
                 kind="full"),
    _bitmap_case(np.random.default_rng(22), B=50, M=128, F=500, W=256,
                 kind="none"),
    _bitmap_case(np.random.default_rng(23), B=72, M=130, F=900, W=256,
                 kind="beyond"),
]


def _count_case(rng: np.random.Generator, B: int, W: int) -> np.ndarray:
    """``[B, W]`` uint32 words: random, with an empty row and a full row
    where B allows (the smallest and the largest count)."""
    fan = _words(rng, (B, W))
    fan[rng.random((B, W)) < 0.2] = 0
    if B > 1:
        fan[0] = 0
        fan[-1] = 0xFFFFFFFF
    return fan


# the popcount kernel's vector (W % 4 == 0) and scalar paths, one and
# more than one 256-word tile, B = 1 and B not a multiple of 8 warps
COUNT_GRID = [(B, W) for W in (1, 3, 4, 5, 127, 256, 257) for B in (1, 31, 77)]
COUNT_CASES = [_count_case(np.random.default_rng(100 + i), B, W)
               for i, (B, W) in enumerate(COUNT_GRID)]


def _check_reach(got: np.ndarray, kind: str) -> None:
    """The output reaches what its case was built for."""
    if kind == "none":
        assert not got.any()
    elif kind == "full":
        assert got.any(1).all() and (got >= 2 ** 31).any()
    else:
        assert (got >= 2 ** 31).any() and (got == 0).all(1).any()


@pytest.fixture(scope="module")
def refs():
    return run_reference({"ref_fanout": CASES,
                          "ref_fanout_bitmaps": BITMAP_CASES,
                          "ref_bitmap_counts": COUNT_CASES})


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
    _check_reach(got, c["kind"])


@pytest.mark.parametrize("i", range(len(BITMAP_CASES)))
def test_fanout_bitmaps_equals_reference(refs, i):
    c = BITMAP_CASES[i]
    want_fan, want_counts = refs["ref_fanout_bitmaps"][i]
    fan = fo.fanout_bitmaps(torch.from_numpy(c["bitmaps"].view(np.int32)),
                            torch.from_numpy(c["fids"]))
    assert fan.dtype == torch.int32
    got = fan.numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want_fan)
    _check_reach(got, c["kind"])


@pytest.mark.parametrize("i", range(len(BITMAP_CASES)))
def test_bitmap_to_counts_equals_reference(refs, i):
    want_fan, want_counts = refs["ref_fanout_bitmaps"][i]
    counts = fo.bitmap_to_counts(torch.from_numpy(want_fan.view(np.int32)))
    assert counts.dtype == torch.int32 and counts.shape == want_counts.shape
    np.testing.assert_array_equal(counts.numpy(),
                                  want_counts.astype(np.int64))
    kind = BITMAP_CASES[i]["kind"]
    if kind == "none":
        assert not counts.any()
        return
    assert (counts == 0).any() or kind == "full"
    assert int(counts.max()) > 32 or want_fan.shape[1] == 1


@pytest.mark.parametrize("i", range(len(COUNT_GRID)),
                         ids=[f"B{B}-W{W}" for B, W in COUNT_GRID])
def test_bitmap_to_counts_shapes_equal_reference(refs, i):
    fan, want = COUNT_CASES[i], refs["ref_bitmap_counts"][i]
    counts = fo.bitmap_to_counts(torch.from_numpy(fan.view(np.int32)))
    assert counts.dtype == torch.int32 and counts.shape == (fan.shape[0],)
    np.testing.assert_array_equal(counts.numpy(), want.astype(np.int64))
    if fan.shape[0] > 1:
        assert counts[0] == 0 and counts[-1] == 32 * fan.shape[1]


def test_out_of_range_entries_select_nothing():
    """A fid >= F selects no row in either fan-out, and a rowmap row >= P
    no pool row, even where the reference's clamped row is not empty:
    the port's plain versions against a numpy loop of that rule."""
    rng = np.random.default_rng(24)
    B, M, F, P, W = 40, 130, 200, 16, 5
    bitmaps = _words(rng, (F, W)).view(np.int32)
    pool = _words(rng, (P, W)).view(np.int32)
    rowmap = rng.integers(-1, P + 4, F).astype(np.int32)
    fids = rng.integers(-3, 2 * F, (B, M)).astype(np.int32)
    fids[0] = F + np.arange(M)                        # only fids >= F

    def numpy_or(table, rows_of):
        out = np.zeros((B, W), np.int32)
        for b in range(B):
            for f in fids[b]:
                r = rows_of(int(f))
                if 0 <= r < table.shape[0]:
                    out[b] |= table[r]
        return out

    want_bm = numpy_or(bitmaps, lambda f: f if f < F else -1)
    want_pool = numpy_or(pool, lambda f: rowmap[f] if 0 <= f < F else -1)
    got_bm = fo.fanout_bitmaps(torch.from_numpy(bitmaps),
                               torch.from_numpy(fids))
    got_pool = fo.fanout_pool(torch.from_numpy(rowmap), torch.from_numpy(pool),
                              torch.from_numpy(fids))
    np.testing.assert_array_equal(got_bm.numpy(), want_bm)
    np.testing.assert_array_equal(got_pool.numpy(), want_pool)
    assert not want_bm[0].any() and not want_pool[0].any()
    assert bitmaps[-1].any() and (rowmap >= P).any() and pool[-1].any()


def test_bitmap_wrappers_on_cpu_take_the_plain_version():
    from emqx_tpu_torch.ops import _build
    _build.reset_launch_counts()
    c = CASES[3]
    rowmap, pool, fids = (torch.from_numpy(c["rowmap"]),
                          torch.from_numpy(c["pool"].view(np.int32)),
                          torch.from_numpy(c["fids"]))
    assert torch.equal(fo.fanout_pool(rowmap, pool, fids),
                       fo.fanout_pool_plain(rowmap, pool, fids))
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
