"""The port's dense-pool fan-out against the JAX reference, bit for bit.

The port stores bitmap words as int32; its output viewed as uint32 must
equal the reference's uint32 words.
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


@pytest.fixture(scope="module")
def ref():
    return run_reference({"ref_fanout": CASES})["ref_fanout"]


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
