"""Subscriber fan-out as a bitmap OR on the card.

Port of the JAX package's ``ops/fanout.py``.  ``fanout_pool`` is the hybrid
fan-out of the routing step: each high-degree filter owns a row of the
dense pool ``[P, W]`` (W 32-bit words ⇒ 32·W subscriber slots);
``rowmap[fid]`` gives the row, -1 for low-degree filters, whose slots
decode on the host.  Fan-out for a topic batch is the OR of the pool rows
of its matched fids.  ``fanout_bitmaps`` is the heavy-fan-out form, with a
dense ``[F, W]`` bitmap row for every filter, and ``bitmap_to_counts`` the
popcount of its output rows.  On the card both fan-outs are one
gather-OR kernel (``row_or_kernel`` in ``csrc/router_kernels.cu``: a warp
per topic, 16-byte accesses where the shapes and pointers allow them), and
the popcount a persistent warp per row on the same terms
(``bitmap_counts_kernel``).

Bitmaps are stored as int32: OR is the same on the bits as the
reference's uint32, and torch has no uint32 shift or ``index_put_`` on the
CPU.
"""

from __future__ import annotations

import torch

from emqx_tpu_torch.ops import _build


def fanout_pool_plain(rowmap: torch.Tensor, pool: torch.Tensor,
                      fids: torch.Tensor) -> torch.Tensor:
    known = (fids >= 0) & (fids < rowmap.shape[0])
    rows = torch.where(known, rowmap[torch.where(known, fids, 0).long()], -1)
    return fanout_bitmaps_plain(pool, rows)      # the pool's rows, by row id


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
    if B < 1 or W < 1:
        raise ValueError(f"fanout_pool takes B ≥ 1, W ≥ 1; got B={B} W={W}")
    out = torch.empty((B, W), dtype=torch.int32, device=dev)
    _build.KERNELS["fanout_pool"](
        rowmap.data_ptr(), rowmap.shape[0], pool.data_ptr(), P, W,
        fids.data_ptr(), B, M, out.data_ptr(), device=dev)
    return out


def fanout_bitmaps_plain(bitmaps: torch.Tensor,
                         fids: torch.Tensor) -> torch.Tensor:
    B, M = fids.shape
    valid = (fids >= 0) & (fids < bitmaps.shape[0])
    safe = torch.where(valid, fids, 0).long()
    out = torch.zeros((B, bitmaps.shape[1]), dtype=torch.int32,
                      device=fids.device)
    for m in range(M):
        out |= torch.where(valid[:, m, None], bitmaps[safe[:, m]], 0)
    return out


def fanout_bitmaps(bitmaps: torch.Tensor, fids: torch.Tensor) -> torch.Tensor:
    """OR the subscriber bitmaps of matched filters.

    bitmaps: [F, W] int32 — one row of subscriber-slot bits per filter.
    fids:    [B, M] int32, -1 padding (a fid ≥ F matches no row).
    returns: [B, W] int32 — subscriber slots to deliver each topic to.
    """
    if not fids.is_cuda:
        return fanout_bitmaps_plain(bitmaps, fids)
    dev = fids.device
    _build.check_tensor(bitmaps, "bitmaps", torch.int32, 2, dev)
    _build.check_tensor(fids, "fids", torch.int32, 2, dev)
    B, M = fids.shape
    F, W = bitmaps.shape
    if B < 1 or W < 1:
        raise ValueError(f"fanout_bitmaps takes B ≥ 1, W ≥ 1; got B={B} "
                         f"W={W}")
    out = torch.empty((B, W), dtype=torch.int32, device=dev)
    _build.KERNELS["fanout_bitmaps"](
        bitmaps.data_ptr(), F, W, fids.data_ptr(), B, M, out.data_ptr(),
        device=dev)
    return out


def bitmap_to_counts_plain(fanout: torch.Tensor) -> torch.Tensor:
    x = fanout.long() & 0xFFFFFFFF       # the uint32 words, in int64
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = (x * 0x01010101 & 0xFFFFFFFF) >> 24
    return x.sum(1, dtype=torch.int32)


def bitmap_to_counts(fanout: torch.Tensor) -> torch.Tensor:
    """Population count per topic: ``[B, W]`` int32 bitmap words → ``[B]``
    int32, the number of subscriber slots each topic delivers to."""
    if not fanout.is_cuda:
        return bitmap_to_counts_plain(fanout)
    dev = fanout.device
    _build.check_tensor(fanout, "fanout", torch.int32, 2, dev)
    B, W = fanout.shape
    if B < 1 or W < 1:
        raise ValueError(f"bitmap_to_counts takes B, W ≥ 1; got {B}, {W}")
    counts = torch.empty(B, dtype=torch.int32, device=dev)
    _build.KERNELS["bitmap_counts"](fanout.data_ptr(), B, W,
                                    counts.data_ptr(), device=dev)
    return counts
