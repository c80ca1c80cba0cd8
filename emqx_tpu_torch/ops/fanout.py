"""Subscriber fan-out as a bitmap OR over the dense pool, on the card.

Port of the JAX package's ``ops/fanout.py`` ``fanout_pool``.  Each
high-degree filter owns a row of the dense pool ``[P, W]`` (W 32-bit words
⇒ 32·W subscriber slots); ``rowmap[fid]`` gives the row, -1 for low-degree
filters, whose slots decode on the host.  Fan-out for a topic batch is the
OR of the pool rows of its matched fids.

Bitmaps are stored as int32: OR is the same on the bits as the
reference's uint32, and torch has no uint32 shift or ``index_put_`` on the
CPU.
"""

from __future__ import annotations

import torch

from emqx_tpu_torch.ops import _build


def fanout_pool_plain(rowmap: torch.Tensor, pool: torch.Tensor,
                      fids: torch.Tensor) -> torch.Tensor:
    B, M = fids.shape
    F, P = rowmap.shape[0], pool.shape[0]
    known = (fids >= 0) & (fids < F)
    rows = torch.where(known, rowmap[torch.where(known, fids, 0).long()], -1)
    has = (rows >= 0) & (rows < P)
    out = torch.zeros((B, pool.shape[1]), dtype=torch.int32,
                      device=fids.device)
    for m in range(M):
        r = torch.where(has[:, m], rows[:, m], 0).long()
        out |= torch.where(has[:, m, None], pool[r], 0)
    return out


def fanout_pool(rowmap: torch.Tensor, pool: torch.Tensor,
                fids: torch.Tensor) -> torch.Tensor:
    """Hybrid fan-out: OR the dense-pool rows of matched filters.

    rowmap: [F] int32 — fid → pool row, -1 for low-degree filters.
    pool:   [P, W] int32 — subscriber-slot bitmaps (uint32 bits).
    fids:   [B, M] int32, -1 padding.
    returns: [B, W] int32 — slots contributed by dense filters.
    """
    if not fids.is_cuda:
        return fanout_pool_plain(rowmap, pool, fids)
    dev = fids.device
    _build.check_tensor(rowmap, "rowmap", torch.int32, 1, dev)
    _build.check_tensor(pool, "pool", torch.int32, 2, dev)
    _build.check_tensor(fids, "fids", torch.int32, 2, dev)
    B, M = fids.shape
    P, W = pool.shape
    if B < 1 or M > 12288 or W < 1:
        raise ValueError(f"fanout_pool takes B ≥ 1, M ≤ 12288 (shared "
                         f"memory), W ≥ 1; got B={B} M={M} W={W}")
    out = torch.empty((B, W), dtype=torch.int32, device=dev)
    _build.KERNELS["fanout_pool"](
        rowmap.data_ptr(), rowmap.shape[0], pool.data_ptr(), P, W,
        fids.data_ptr(), B, M, out.data_ptr(), device=dev)
    return out
