"""RouterModel — the publish routing step on the card: match+compact → fan-out.

Port of the JAX package's ``models/router_model.py`` for one device, on the
flat trie or the subscription-sharded one.  One step replaces the reference
broker's per-message read path (``emqx_router:match_routes/1`` →
``emqx_trie:match/1`` → subscriber lookups → pid fan-out loop) with a
batched run over device-resident tables:

    tokens [B, L] ──trie walk, compacted as it walks──► fids [B, M]
                    (epilogue: trimmed fids, overflow,      │
                     counters)                              │
          dense pool [P, W] + rowmap [F] ──OR──────────────►└─► fanout [B, W],
                                                                fan_any

On the card that is two kernel launches, which write all five outputs into
one packed block (``router_step_block``, ``step_layout``); the host copies
the block back in one copy.  As in the reference, the counters are packed
only when asked for (``with_counters``; ``RouterModel`` asks when its
``kernel_telemetry`` is on) and are None otherwise.

Fan-out is hybrid: subscriber slots are a fixed shard space, per-filter
slot sets live on the host in a refcounted dict, and only high-degree
filters (degree > dense_threshold) get a row in the device dense pool.

Subscribe and unsubscribe patch the host index in place; ``refresh``
scatters just the dirty elements into the live device tables with one
kernel launch (``apply_patches``), which reads the update block in place
from pinned host memory, and re-uploads only on structural growth.

On a ``ShardedTrieIndex`` the trie is S per-shard tries stacked into
``[S, ·, 4]`` records: every shard walks every topic, and the same walk
launch merges the shard-local matches into global fids
(``router_step_sharded``) before the same fan-out.

Sharding (see emqx_tpu_torch.parallel.mesh): ``RouterModel(mesh=...)``
places the tables over a ``[dp, tp]`` mesh of devices, driven from this
one process.  The flat trie's match runs with B over dp×tp; the compacted
fids then gather along tp (a copy of the small ``[B/(dp·tp), M]`` pieces
between devices) so the fan-out keeps W split over tp.  The sharded trie's
shard axis rides tp: each device walks its shards on its dp rows, and the
gather moves the merged compacted fids (``mesh_step_block``).
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
import threading
from typing import Optional, Sequence, Union

import numpy as np
import torch

from emqx_tpu_torch.observe import trace as _tracing
from emqx_tpu_torch.ops import _build
from emqx_tpu_torch.ops import fanout as fo
from emqx_tpu_torch.ops import trie_match as tm
from emqx_tpu_torch.parallel import mesh as pmesh
from emqx_tpu_torch.router.index import ShardedTrieIndex, TrieIndex
from emqx_tpu_torch.router.trie import Trie


# the routing step's five outputs, in the order both steps return them
STEP_OUTPUTS = ("fids", "fanout", "overflow", "fan_any", "counters")


def step_layout(B: int, R: int, W: int, S: Optional[int], C: int,
                fan_rows: Optional[int] = None
                ) -> tuple[dict[str, tuple[int, torch.dtype, tuple]], int]:
    """Where the routing step's outputs lie in its one packed block: name →
    ``(byte offset, dtype, shape)`` for each of :data:`STEP_OUTPUTS`, and
    the block's size in bytes.  ``fanout [B, W]`` and ``fids [B, R]`` are
    int32, then the counters ``[C]`` (flat, ``S`` None) or ``[S, C]``
    int32, each on a 16-byte boundary; ``fan_any`` is the first byte of the
    int32 word right after the counters, so one memset zeroes both before
    the kernels accumulate into them; ``overflow [B]`` is bytes.  The two
    flags are bool views of their bytes.  ``C = 0`` is a step with its
    counters off: the block has no counters region (``step_views`` gives
    None for it), and fan_any's word lies where the counters would.
    ``fan_rows`` (None: B) is the fanout's rows, where they differ from the
    fids' (a flat mesh device: fids for its B/(dp·tp) rows, the fan-out
    for its dp group's B/dp)."""
    def align(n: int) -> int:
        return -(-n // 16) * 16

    cshape = (C,) if S is None else (S, C)
    F = B if fan_rows is None else fan_rows
    regions = {"fanout": (0, torch.int32, (F, W))}
    off = align(F * W * 4)
    regions["fids"] = (off, torch.int32, (B, R))
    off = align(off + B * R * 4)
    if C:
        regions["counters"] = (off, torch.int32, cshape)
        off += math.prod(cshape) * 4
    regions["fan_any"] = (off, torch.bool, ())
    off = align(off + 4)
    regions["overflow"] = (off, torch.bool, (B,))
    return regions, align(off + B)


def step_views(block: torch.Tensor, regions: dict) -> tuple:
    """The five outputs as views of a packed uint8 ``block`` (on the card,
    or the pinned host copy of it), in :data:`STEP_OUTPUTS` order; None for
    an output the layout has no region for (the counters, when off)."""
    out = []
    for name in STEP_OUTPUTS:
        if name not in regions:
            out.append(None)
            continue
        off, dtype, shape = regions[name]
        n = math.prod(shape) * dtype.itemsize
        out.append(block[off:off + n].view(dtype).view(shape))
    return tuple(out)


def router_step_block(trie: tm.DeviceTrie, rowmap: torch.Tensor,
                      pool: torch.Tensor, tokens: torch.Tensor,
                      lengths: torch.Tensor, sys_flags: torch.Tensor, *,
                      n_shards: int = 1, K: int = 32, M: int = 128,
                      max_probes: int = 8, ret_cap: Optional[int] = None,
                      with_counters: bool = False,
                      out: Optional[torch.Tensor] = None,
                      shardings: Optional[dict] = None
                      ) -> tuple[torch.Tensor, dict]:
    """The routing step on CUDA tensors as two kernel launches: the
    compacting walk (flat, or over a stacked ``[S, ·, 4]`` trie), whose
    epilogue writes the trimmed fids, the overflow flags and, with
    ``with_counters``, the counters, after a memset of the counters and the
    fan_any word (of the fan_any word alone without them) in the same
    entry; then the dense-pool fan-out, which also sets fan_any.  Returns
    ``(block, regions)``: one uint8 block holding the outputs, laid out by
    :func:`step_layout` (``step_views`` gives the views; without counters
    the block has no counters region).  ``out`` is a block to write into,
    a contiguous 16-byte aligned uint8 tensor of the layout's size on the
    tokens' device, whatever it holds (None: a new one).  The walk's
    untrimmed fids, which the fan-out ORs over, are scratch.

    With ``shardings`` (``parallel.mesh.router_shardings``) every table
    and batch argument is a ``[dp][tp]`` grid of the pieces its mesh's
    devices hold, and the step is :func:`mesh_step_block`'s: a grid of
    blocks and one of their regions."""
    if shardings is not None:
        return mesh_step_block(trie, rowmap, pool, tokens, lengths,
                               sys_flags, shardings=shardings,
                               n_shards=n_shards, K=K, M=M,
                               max_probes=max_probes, ret_cap=ret_cap,
                               with_counters=with_counters)
    if not tokens.is_cuda:
        raise ValueError("router_step_block runs the kernels on CUDA "
                         "tensors; CPU tensors take router_step_plain")
    stacked = trie.edges.dim() == 3
    B, L = tokens.shape
    S = trie.edges.shape[0] if stacked else 1
    C = len(tm.KERNEL_COUNTER_FIELDS) if with_counters else 0
    cap = ret_cap if ret_cap is not None and ret_cap < M else M
    R = min(cap, tm.compact_width(L, K, M, S))
    regions, nbytes = step_layout(B, R, pool.shape[-1],
                                  S if stacked else None, C)
    if out is None:
        block = torch.empty(nbytes, dtype=torch.uint8, device=tokens.device)
    else:
        _build.check_tensor(out, "out", torch.uint8, 1, tokens.device)
        if out.numel() != nbytes or out.data_ptr() % 16:
            raise ValueError(f"out must be a 16-byte aligned block of "
                             f"{nbytes} bytes, got {out.numel()}")
        block = out
    fids, fanout, overflow, _, _ = step_views(block, regions)
    # the counters (if any) and the fan_any word: one memset zeroes them
    acc_at = regions["counters" if C else "fan_any"][0]
    acc = block[acc_at:acc_at + (S * C + 1) * 4].view(torch.int32)
    step = tm.StepOut(fids, overflow, acc, cap)
    kw = dict(K=K, M=M, max_probes=max_probes, step=step)
    if stacked:
        full = tm.launch_walk_compact_sharded(
            trie, tokens, lengths, sys_flags, n_shards=n_shards, **kw)[0]
    else:
        full = tm.launch_walk_compact(trie, tokens, lengths, sys_flags,
                                      **kw)[0]
    fo.launch_fanout_pool(rowmap, pool, full, fanout, fan_any=acc[-1:])
    return block, regions


def router_step_plain(
    trie: tm.DeviceTrie,
    rowmap: torch.Tensor,
    pool: torch.Tensor,
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    sys_flags: torch.Tensor,
    *,
    K: int = 32,
    M: int = 128,
    max_probes: int = 8,
    ret_cap: Optional[int] = None,
    with_counters: bool = False,
):
    """:func:`router_step` composed in torch around the walk and the
    fan-out (their plain versions on CPU tensors, their kernels on CUDA
    ones): the fused step's reference."""
    full, stats = tm.match_compact(trie, tokens, lengths, sys_flags, K=K,
                                   M=M, max_probes=max_probes)
    fids, overflow, counters = _flat_outputs(full, stats, M, ret_cap,
                                             with_counters)
    out = fo.fanout_pool(rowmap, pool, full)
    return fids, out, overflow, (out != 0).any(), counters


def router_step(
    trie: tm.DeviceTrie,
    rowmap: torch.Tensor,
    pool: torch.Tensor,
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    sys_flags: torch.Tensor,
    *,
    K: int = 32,
    M: int = 128,
    max_probes: int = 8,
    ret_cap: Optional[int] = None,
    with_counters: bool = False,
    shardings: Optional[dict] = None,
):
    """The full publish-batch routing step.

    Returns ``(fids [B, ret_cap or M], fanout [B, W], overflow [B],
    fan_any [], counters)``.  ``fanout`` covers the dense-pool filters;
    low-degree slots decode on the host.  ``ret_cap`` trims the returned
    fid columns: topics matching more than ret_cap filters are flagged
    overflow and take the host-oracle fallback upstream.  ``counters`` is
    None unless ``with_counters`` (the reference's default), else the int32
    ``[C]`` pack in tm.KERNEL_COUNTER_FIELDS order, computed on the device
    from the walk's per-topic stats (the untrimmed compacted block's
    counts: a topic keeps min(n, M) of its n candidates).  The other four
    outputs are the same either way.

    CUDA tensors take :func:`router_step_block`'s two launches, and the
    outputs are views of its block; CPU tensors :func:`router_step_plain`.

    With ``shardings`` the arguments are ``[dp][tp]`` grids of per-device
    pieces (:func:`mesh_step`): the batch over dp×tp, the trie and rowmap
    on every device, the pool's words over tp; the outputs are the same
    five, assembled.
    """
    if shardings is not None:
        return mesh_step(trie, rowmap, pool, tokens, lengths, sys_flags,
                         shardings=shardings, K=K, M=M,
                         max_probes=max_probes, ret_cap=ret_cap,
                         with_counters=with_counters)
    if not tokens.is_cuda:
        return router_step_plain(trie, rowmap, pool, tokens, lengths,
                                 sys_flags, K=K, M=M, max_probes=max_probes,
                                 ret_cap=ret_cap, with_counters=with_counters)
    if trie.edges.dim() != 2:
        raise ValueError("router_step takes a flat trie")
    return step_views(*router_step_block(
        trie, rowmap, pool, tokens, lengths, sys_flags, K=K, M=M,
        max_probes=max_probes, ret_cap=ret_cap, with_counters=with_counters))


def router_step_sharded_plain(
    trie: tm.DeviceTrie,
    rowmap: torch.Tensor,
    pool: torch.Tensor,
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    sys_flags: torch.Tensor,
    *,
    n_shards: int,
    K: int = 32,
    M: int = 128,
    max_probes: int = 8,
    ret_cap: Optional[int] = None,
    with_counters: bool = False,
):
    """:func:`router_step_sharded` composed in torch around the walk and
    the fan-out (their plain versions on CPU tensors, their kernels on CUDA
    ones): the fused step's reference."""
    fids, stats, truncated = tm.match_compact_sharded(
        trie, tokens, lengths, sys_flags, n_shards=n_shards, K=K, M=M,
        max_probes=max_probes)
    counters = _shard_counters(stats, M) if with_counters else None
    out = fo.fanout_pool(rowmap, pool, fids)
    fan_any = (out != 0).any()
    overflow = (stats[:, :, 3] != 0).any(0) | truncated
    if ret_cap is not None and ret_cap < M:
        overflow = overflow | ((fids >= 0).sum(1) > ret_cap)
        fids = fids[:, :ret_cap]
    return fids, out, overflow, fan_any, counters


def router_step_sharded(
    trie: tm.DeviceTrie,
    rowmap: torch.Tensor,
    pool: torch.Tensor,
    tokens: torch.Tensor,
    lengths: torch.Tensor,
    sys_flags: torch.Tensor,
    *,
    n_shards: int,
    K: int = 32,
    M: int = 128,
    max_probes: int = 8,
    ret_cap: Optional[int] = None,
    with_counters: bool = False,
    shardings: Optional[dict] = None,
):
    """The routing step over a stacked ``[S, H]`` / ``[S, N]`` trie.

    Every shard walks every topic against its own subscriptions; each
    shard's matches compact to M shard-local fids, translate to the global
    namespace (``local * S + shard``), merge shard-major and compact again
    to M — all inside the walk's launch.  After the merge the step is
    :func:`router_step`: the dense-pool fan-out over global fids, the
    ``ret_cap`` trim and ``overflow |= truncated``.  With one shard it
    equals :func:`router_step` bit for bit (its counters as ``[1, C]``).

    Returns ``(fids, fanout, overflow, fan_any, counters)``: counters is
    None unless ``with_counters``, else ``[S, C]``, the counters per shard,
    match fields from the shard's walk and cand_post, compact_peak and
    trunc_rows from the shard's own compact, before the merge.  The
    merge's spill rides ``overflow``, not the counters.

    CUDA tensors take :func:`router_step_block`'s two launches, and the
    outputs are views of its block; CPU tensors
    :func:`router_step_sharded_plain`.

    With ``shardings`` the arguments are ``[dp][tp]`` grids of per-device
    pieces (:func:`mesh_step`): the stacked trie's shard axis over tp, the
    batch over dp, the pool's words over tp; the outputs are the same
    five, assembled (the counters ``[S, C]`` in global shard order).
    """
    if shardings is not None:
        return mesh_step(trie, rowmap, pool, tokens, lengths, sys_flags,
                         shardings=shardings, n_shards=n_shards, K=K, M=M,
                         max_probes=max_probes, ret_cap=ret_cap,
                         with_counters=with_counters)
    if not tokens.is_cuda:
        return router_step_sharded_plain(
            trie, rowmap, pool, tokens, lengths, sys_flags,
            n_shards=n_shards, K=K, M=M, max_probes=max_probes,
            ret_cap=ret_cap, with_counters=with_counters)
    if trie.edges.dim() != 3:
        raise ValueError("router_step_sharded takes a stacked trie")
    return step_views(*router_step_block(
        trie, rowmap, pool, tokens, lengths, sys_flags, n_shards=n_shards,
        K=K, M=M, max_probes=max_probes, ret_cap=ret_cap,
        with_counters=with_counters))


# ---------------------------------------------------------------------------
# the step over a mesh of devices
# ---------------------------------------------------------------------------

# the counter fields that fold over devices by max; the others sum
PEAK_FIELDS = ("frontier_peak", "compact_peak")


def fold_counters(packs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Fold same-shaped ``[..., C]`` int32 counter packs of several devices
    into one, field by field as the reference's global reductions do:
    the peaks (:data:`PEAK_FIELDS`) by max, the other fields by sum."""
    x = torch.stack(list(packs))
    out = x.sum(0, dtype=torch.int32)
    for k, name in enumerate(tm.KERNEL_COUNTER_FIELDS):
        if name in PEAK_FIELDS:     # plain indexing: no host copy to wait on
            out[..., k] = x[..., k].amax(0)
    return out


def _on(device: torch.device):
    """``device`` made current for CUDA launches (nothing on the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def mesh_step_block(trie, rowmap, pool, tokens, lengths, sys_flags, *,
                    shardings: dict, n_shards: int = 1, K: int = 32,
                    M: int = 128, max_probes: int = 8,
                    ret_cap: Optional[int] = None,
                    with_counters: bool = False):
    """The routing step over the mesh of ``shardings`` (CUDA devices), on
    ``[dp][tp]`` grids of per-device pieces.  Returns ``(blocks, regions)``,
    grids of each device's packed block and its :func:`step_layout`.

    Flat trie (every piece of ``trie`` a replica; the batch over dp×tp):
    each device runs the flat walk with the step's epilogue on its
    ``B/(dp·tp)`` rows (trimmed fids, overflow, counters into its block);
    its untrimmed ``[B/(dp·tp), M]`` fids gather along tp into each device
    of its dp group, which ORs its ``[P, W/tp]`` pool slice over the
    group's ``B/dp`` rows into the block's ``[B/dp, W/tp]`` fanout.

    Sharded trie (tp rank j's pieces hold the global shards ``j·S/tp ..
    (j+1)·S/tp - 1`` of ``n_shards``; the batch over dp): each device walks
    its shards on its dp group's ``B/dp`` rows with a step of no fids and
    cap M (per-shard compact, translation to global fids, merge within
    the group; the group's K spill or truncation and ``[S/tp, C]``
    counters);
    the groups' rows gather along tp, shard-major, and each device
    compacts them again (the compact kernel), writes the final overflow
    (any group's K spill or truncation | the merge's | more than ret_cap
    kept) and the trimmed fids with a few tensor operations on its card,
    then the fan-out over its pool slice.

    Every launch and copy of device d runs under ``torch.cuda.device(d)``
    on d's current stream; a device's stream waits for an event of each
    producer before it copies that producer's fids."""
    mesh = shardings["replicated"].mesh
    dp, tp = mesh.devices.shape
    devs = mesh.devices
    sharded = trie[0][0].edges.dim() == 3
    C = len(tm.KERNEL_COUNTER_FIELDS) if with_counters else 0
    cap = ret_cap if ret_cap is not None and ret_cap < M else M
    B_l, L = tokens[0][0].shape
    S_l = trie[0][0].edges.shape[0] if sharded else 1
    if sharded and S_l * tp != n_shards:
        raise ValueError(f"{tp} tp ranks of {S_l} shards each hold no "
                         f"{n_shards} shards")
    W_l = pool[0][0].shape[1]
    Mout = tm.compact_width(L, K, M, n_shards if sharded else 1)
    R = min(cap, Mout)
    fan_rows = B_l if sharded else B_l * tp
    blocks, regions, views, accs = {}, {}, {}, {}
    pieces, flags, events = {}, {}, {}
    for i, j in mesh.positions():
        d = devs[i, j]
        with _on(d):
            reg, nbytes = step_layout(B_l, R, W_l, S_l if sharded else None,
                                      C, fan_rows=fan_rows)
            block = torch.empty(nbytes, dtype=torch.uint8, device=d)
            fids, _, overflow, _, _ = views[i, j] = step_views(block, reg)
            at = reg["counters" if C else "fan_any"][0]
            acc = accs[i, j] = block[at:at + (S_l * C + 1) * 4].view(
                torch.int32)
            args = (trie[i][j], tokens[i][j], lengths[i][j], sys_flags[i][j])
            kw = dict(K=K, M=M, max_probes=max_probes)
            if sharded:
                flags[i, j] = torch.empty(B_l, dtype=torch.bool, device=d)
                pieces[i, j] = tm.launch_walk_compact_sharded(
                    *args, n_shards=n_shards, shard_base=j * S_l,
                    step=tm.StepOut(None, flags[i, j], acc, M), **kw)[0]
            else:
                pieces[i, j] = tm.launch_walk_compact(
                    *args, step=tm.StepOut(fids, overflow, acc, cap), **kw)[0]
            events[i, j] = torch.cuda.Event()
            events[i, j].record(torch.cuda.current_stream(d))
            blocks[i, j], regions[i, j] = block, reg
    for i, j in mesh.positions():
        d = devs[i, j]
        with _on(d):
            stream = torch.cuda.current_stream(d)
            for k in range(tp):
                stream.wait_event(events[i, k])
            fids, fanout, overflow, _, _ = views[i, j]
            # the gather: the group's pieces on this device (a peer copy
            # from another card), joined along rows (flat) or shard-major
            # along columns (sharded)
            parts = [pieces[i, k].to(d, non_blocking=True)
                     for k in range(tp)]
            if sharded:
                full, trunc2 = tm.compact_fids(torch.cat(parts, 1), M=Mout)
                # overflow: any group's K spill or truncation, the merge's,
                # or a row keeping more than cap (its column cap is set)
                for k in range(tp):
                    torch.logical_or(
                        trunc2 if k == 0 else overflow,
                        flags[i, k].to(d, non_blocking=True), out=overflow)
                if cap < Mout:
                    overflow |= full[:, cap] >= 0
                fids.copy_(full[:, :R])
            else:
                full = parts[0] if tp == 1 else torch.cat(parts)
            fo.launch_fanout_pool(rowmap[i][j], pool[i][j], full, fanout,
                                  fan_any=accs[i, j][-1:])
    grid = [[blocks[i, j] for j in range(tp)] for i in range(dp)]
    return grid, [[regions[i, j] for j in range(tp)] for i in range(dp)]


def _flat_outputs(fids: torch.Tensor, stats: torch.Tensor, M: int,
                  ret_cap: Optional[int], with_counters: bool) -> tuple:
    """``(trimmed fids, overflow, counters or None)`` of the flat step from
    its walk's untrimmed fids and per-topic stats (:func:`router_step_plain`
    around them)."""
    n = stats[:, 2]
    occ = n.clamp(max=M)
    truncated = n > M
    counters = None
    if with_counters:
        counters = tm.pack_counters(
            frontier_peak=stats[:, 0].max(),
            probe_iters=stats[:, 1].sum(dtype=torch.int32),
            cand_pre=n.sum(dtype=torch.int32),
            cand_post=occ.sum(dtype=torch.int32),
            compact_peak=occ.max(),
            overflow_rows=stats[:, 3].sum(dtype=torch.int32),
            trunc_rows=truncated.sum(dtype=torch.int32),
        )
    overflow = (stats[:, 3] != 0) | truncated
    if ret_cap is not None and ret_cap < M:
        overflow = overflow | (occ > ret_cap)
        fids = fids[:, :ret_cap]
    return fids, overflow, counters


def _shard_counters(stats: torch.Tensor, M: int) -> torch.Tensor:
    """The ``[S, C]`` counters of a stacked walk's ``[S, B, 4]`` stats."""
    n = stats[:, :, 2]
    occ = n.clamp(max=M)
    return tm.pack_counters(
        frontier_peak=stats[:, :, 0].max(1).values,
        probe_iters=stats[:, :, 1].sum(1, dtype=torch.int32),
        cand_pre=n.sum(1, dtype=torch.int32),
        cand_post=occ.sum(1, dtype=torch.int32),
        compact_peak=occ.max(1).values,
        overflow_rows=stats[:, :, 3].sum(1, dtype=torch.int32),
        trunc_rows=(n > M).sum(1, dtype=torch.int32),
    )


def mesh_step_plain(trie, rowmap, pool, tokens, lengths, sys_flags, *,
                    shardings: dict, n_shards: int = 1, K: int = 32,
                    M: int = 128, max_probes: int = 8,
                    ret_cap: Optional[int] = None,
                    with_counters: bool = False) -> dict:
    """:func:`mesh_step_block`'s step on CPU pieces, in the kernels' plain
    versions, device by device and with the same gathers.  Returns
    position → the device's five outputs (the fanout its ``[B/dp,
    W/tp]`` tile; a flat device's fids, overflow and counters its own
    rows', a sharded device's its dp group's; the counters ``[C]`` flat,
    ``[S/tp, C]`` sharded)."""
    mesh = shardings["replicated"].mesh
    dp, tp = mesh.devices.shape
    sharded = trie[0][0].edges.dim() == 3
    cap = ret_cap if ret_cap is not None and ret_cap < M else M
    kw = dict(K=K, M=M, max_probes=max_probes)
    walked = {}
    for i, j in mesh.positions():
        args = (trie[i][j], tokens[i][j], lengths[i][j], sys_flags[i][j])
        if sharded:
            S_l = trie[i][j].edges.shape[0]
            g, stats, gtrunc = tm.match_compact_sharded_plain(
                *args, n_shards=n_shards, shard_base=j * S_l, **kw)
            walked[i, j] = (g, (stats[:, :, 3] != 0).any(0) | gtrunc,
                            _shard_counters(stats, M) if with_counters
                            else None)
        else:
            full, stats = tm.match_compact_plain(*args, **kw)
            walked[i, j] = (full, *_flat_outputs(full, stats, M, ret_cap,
                                                 with_counters))
    out = {}
    for i, j in mesh.positions():
        group = [walked[i, k] for k in range(tp)]
        if sharded:
            L = tokens[i][j].shape[1]
            merged = torch.cat([g[0] for g in group], 1)
            full, trunc2 = tm.compact_fids_plain(
                merged, M=tm.compact_width(L, K, M, n_shards))
            flag = torch.stack([g[1] for g in group]).any(0)
            overflow = flag | trunc2 | ((full >= 0).sum(1) > cap)
            fids, counters = full[:, :cap], walked[i, j][2]
        else:
            full = torch.cat([g[0] for g in group])
            _, fids, overflow, counters = walked[i, j]
        fanout = fo.fanout_pool_plain(rowmap[i][j], pool[i][j], full)
        out[i, j] = (fids, fanout, overflow, (fanout != 0).any(), counters)
    return out


def assemble(outs: dict, mesh: pmesh.Mesh, sharded: bool,
             device=None) -> tuple:
    """The five outputs of a mesh step from each position's (``outs``:
    position → ``(fids, fanout, overflow, fan_any, counters)``), on
    ``device`` (None: the mesh's first): the fids and overflow rows in
    batch order (a flat step's dp×tp pieces, a sharded step's dp groups
    from their tp rank 0), the fanout's tiles, fan_any's OR, and the
    counters folded (:func:`fold_counters`) over all devices (flat) or,
    ``[S, C]``, over dp row by row and concatenated over tp in shard
    order."""
    dp, tp = mesh.devices.shape
    dev = mesh.devices[0, 0] if device is None else torch.device(device)

    def at(x):
        return x.to(dev)

    rows = ([(i, 0) for i in range(dp)] if sharded
            else mesh.positions())
    fids = torch.cat([at(outs[p][0]) for p in rows])
    overflow = torch.cat([at(outs[p][2]) for p in rows])
    fanout = torch.cat([torch.cat([at(outs[i, j][1]) for j in range(tp)], 1)
                        for i in range(dp)])
    fan_any = torch.stack([at(o[3]).reshape(()) for o in outs.values()]).any()
    counters = None
    if outs[0, 0][4] is not None:
        if sharded:
            counters = torch.cat([fold_counters(
                [at(outs[i, j][4]) for i in range(dp)]) for j in range(tp)])
        else:
            counters = fold_counters([at(o[4]) for o in outs.values()])
    return fids, fanout, overflow, fan_any, counters


def mesh_step(trie, rowmap, pool, tokens, lengths, sys_flags, *,
              shardings: dict, n_shards: int = 1, K: int = 32, M: int = 128,
              max_probes: int = 8, ret_cap: Optional[int] = None,
              with_counters: bool = False) -> tuple:
    """The routing step over a mesh on ``[dp][tp]`` grids of pieces: the
    kernels (:func:`mesh_step_block`) on a mesh of cards, the plain
    versions (:func:`mesh_step_plain`) on a mesh of the CPU; returns the
    same five outputs as one device's step, assembled (:func:`assemble`)
    on the mesh's first device."""
    mesh = shardings["replicated"].mesh
    sharded = trie[0][0].edges.dim() == 3
    kw = dict(shardings=shardings, n_shards=n_shards, K=K, M=M,
              max_probes=max_probes, ret_cap=ret_cap,
              with_counters=with_counters)
    if mesh.device_type == "cuda":
        blocks, regions = mesh_step_block(trie, rowmap, pool, tokens,
                                          lengths, sys_flags, **kw)
        outs = {(i, j): step_views(blocks[i][j], regions[i][j])
                for i, j in mesh.positions()}
    else:
        outs = mesh_step_plain(trie, rowmap, pool, tokens, lengths,
                               sys_flags, **kw)
    return assemble(outs, mesh, sharded)


# rows of the [PATCH_ROWS, cap] update block: (index, value) per trie field
# in DeviceTrie order, then rowmap (index, value), then pool (row, col, val)
PATCH_ROWS = 2 * len(tm.TRIE_FIELDS) + 2 + 3


def apply_patches_plain(trie: tm.DeviceTrie, rowmap: torch.Tensor,
                        pool: torch.Tensor, upd: torch.Tensor) -> None:
    for t, field in enumerate(trie.flat_fields()):
        field.index_put_((upd[2 * t].long(),), upd[2 * t + 1])
    rowmap.index_put_((upd[12].long(),), upd[13])
    pool.index_put_((upd[14].long(), upd[15].long()), upd[16])


def apply_patches(trie: tm.DeviceTrie, rowmap: torch.Tensor,
                  pool: torch.Tensor, upd: torch.Tensor) -> None:
    """Write every padded element update into the live tables, in place,
    with one launch (the reference donates and rebuilds its buffers; the
    port writes where they lie).  ``upd`` is ``[PATCH_ROWS, cap]`` int32
    from :func:`patch_block`, whose indices are range-checked, with cap a
    multiple of 4; it must launch on the stream the step runs on.  Each
    trie field is a column of the edge or node records, patched through
    its element stride of 4; a stacked ``[S, ·, 4]`` trie through the
    offsets patch_block made.

    The tables' device decides: CPU tables take the plain version; CUDA
    tables take the kernel, which reads a block on the card or a pinned
    host block in place (how :class:`RouterModel` stages its blocks, so a
    refresh is one operation on the stream and no copy).  A pageable host
    block with CUDA tables raises: the card cannot read it."""
    if (upd.dtype != torch.int32 or upd.dim() != 2
            or upd.shape[0] != PATCH_ROWS or upd.shape[1] < 4
            or upd.shape[1] % 4):
        raise ValueError(f"upd must be a [{PATCH_ROWS}, cap] int32 block "
                         f"with cap a multiple of 4, got "
                         f"{tuple(upd.shape)} {upd.dtype}")
    dev = trie.edges.device
    if dev.type == "cpu":
        if upd.device.type != "cpu":
            raise ValueError(f"upd on {upd.device} for tables on the CPU")
        apply_patches_plain(trie, rowmap, pool, upd)
        return
    for n in ("edges", "nodes"):
        t = getattr(trie, n)
        _build.check_tensor(t, n, torch.int32, t.dim(), dev)
        if t.shape[-1] != 4:
            raise ValueError(f"{n} must be [·, 4] records")
    _build.check_tensor(rowmap, "rowmap", torch.int32, 1, dev)
    _build.check_tensor(pool, "pool", torch.int32, 2, dev)
    if upd.is_cuda:
        _build.check_tensor(upd, "upd", torch.int32, 2, dev)
    elif not upd.is_pinned():
        raise ValueError("upd is a pageable host block: the card reads "
                         "update blocks on the card or in pinned memory")
    elif not upd.is_contiguous():
        raise ValueError("upd must be contiguous")
    if upd.data_ptr() % 16:
        raise ValueError("upd must start on a 16-byte boundary")
    _build.KERNELS["patch"](
        *(f.data_ptr() for f in trie.flat_fields()), 4,
        rowmap.data_ptr(), pool.data_ptr(), pool.shape[1], upd.data_ptr(),
        upd.shape[1], device=dev)


def patch_block(cap: int, trie_upd: dict, rowmap_upd: tuple,
                pool_upd: tuple, sizes: dict) -> np.ndarray:
    """Pack padded updates into the ``[PATCH_ROWS, cap]`` int32 block.

    ``trie_upd`` maps each trie field to (idx, vals); ``rowmap_upd`` is
    (idx, vals) and ``pool_upd`` (rows, cols, vals), all already padded to
    ``cap``.  ``sizes`` gives each target's length (``pool`` as (P, W)).
    On a stacked trie a field's size is ``(S, stride)`` and its idx a
    ``(shard, element)`` pair, which becomes the flat offset
    ``shard * stride + element`` once each part is checked against S and
    the stride.  An index outside its target raises, so the kernel never
    writes out of bounds."""

    def in_range(name, idx, n):
        if idx.min() < 0 or idx.max() >= n:
            raise ValueError(f"patch index out of range for {name} "
                             f"(size {n}): [{idx.min()}, {idx.max()}]")

    upd = np.empty((PATCH_ROWS, cap), np.int32)
    for t, name in enumerate(tm.TRIE_FIELDS):
        idx, upd[2 * t + 1] = trie_upd[name]
        if isinstance(sizes[name], tuple):
            S, stride = sizes[name]
            if S * stride > 2 ** 31:
                raise ValueError(f"a stacked {name} of {S} x {stride} "
                                 f"elements has no int32 flat offsets")
            sidx, eidx = (np.asarray(x, np.int64) for x in idx)
            in_range(f"{name} shard", sidx, S)
            in_range(name, eidx, stride)
            idx = sidx * stride + eidx
        else:
            in_range(name, np.asarray(idx), sizes[name])
        upd[2 * t] = idx
    upd[12], upd[13] = rowmap_upd
    upd[14], upd[15], upd[16] = pool_upd
    P, W = sizes["pool"]
    in_range("rowmap", upd[12], sizes["rowmap"])
    in_range("pool row", upd[14], P)
    in_range("pool col", upd[15], W)
    return upd


def _patch_bucket(n: int) -> int:
    """Shared pad size for all update vectors of one apply_patches call:
    a 4×-stepped ladder, so the update block takes a handful of shapes."""
    cap = 64
    while cap < n:
        cap *= 4
    return cap


def _pad_to(cap: int, idx: np.ndarray, vals: np.ndarray):
    """Pad update vectors to cap by repeating the first element —
    a duplicate write of an identical value is a no-op."""
    pad = cap - len(idx)
    return (np.concatenate([idx, np.repeat(idx[:1], pad)]),
            np.concatenate([vals, np.repeat(vals[:1], pad)]))


class _HostMatcher:
    """Host serving path: an exact matcher keyed by fid.

    When active (``RouterModel._resolve_host_dispatch``), ``publish_batch``
    answers from this mirror instead of running the step: the CPU's
    plain-torch step is far slower than a host trie walk.

    Backend, as the reference picks it: the C++ ``NativeSubTable`` (owner =
    fid) when the port's native library builds, else the host oracle
    ``Trie``.  Entries are guarded by a fid→filter dict so refcount drift
    in either backend is impossible (adds/removes are idempotent per fid).
    """

    def __init__(self) -> None:
        self._fids: dict[int, str] = {}
        self._native = None
        self._trie = None
        self._by_filt: dict[str, int] = {}
        from emqx_tpu_torch import native
        if native.available():
            self._native = native.NativeSubTable()
        else:
            self._trie = Trie()
        self.backend = "native" if self._native is not None else "oracle"

    def add(self, fid: int, filt: str) -> None:
        if fid in self._fids:
            return
        self._fids[fid] = filt
        if self._native is not None:
            self._native.add(fid, filt)
        else:
            self._trie.insert(filt)
            self._by_filt[filt] = fid

    def remove(self, fid: int) -> None:
        filt = self._fids.pop(fid, None)
        if filt is None:
            return
        if self._native is not None:
            self._native.remove(fid, filt)
        else:
            self._trie.delete(filt)
            self._by_filt.pop(filt, None)

    def match(self, topic: str) -> list[int]:
        if self._native is not None:
            fids = list(self._native.match(topic))
        else:
            fids = [self._by_filt[f] for f in self._trie.match(topic)
                    if f in self._by_filt]
        if topic.startswith("$"):
            # MQTT-3.7.2-1: a root-level wildcard must not match a
            # $-topic.  The oracle Trie enforces this itself; the C++
            # SubTable does not, so filter uniformly here (the step's walk
            # kills the root wildcards' lanes of a '$' topic at level 0)
            fids = [f for f in fids
                    if self._fids[f].split("/", 1)[0] not in ("+", "#")]
        return fids

    def close(self) -> None:
        if self._native is not None:
            self._native.close()
            self._native = None


class RouterModel:
    """Host wrapper: TrieIndex + subscriber bitmaps + the routing step.

    The broker layer registers subscribers into per-filter slot sets
    (slot = subscriber shard from the connection manager);
    ``publish_batch`` tokenizes topics, runs the step on the device, and
    reports matches.  Device tables are patched incrementally by
    ``refresh``; a full upload happens only when the index signals
    structural growth (``needs_rebuild``) or the pool capacity changes.

    ``index`` is a flat ``TrieIndex`` or a ``ShardedTrieIndex``;
    ``trie_shards=S`` builds the latter when no index is given.

    ``device=None`` runs on the card and raises when there is none;
    ``device="cpu"`` runs the kernels' plain-torch versions.

    ``mesh`` (``parallel.mesh.make_mesh``) places the tables over a
    ``[dp, tp]`` mesh of devices, one process driving them all: the flat
    trie and the rowmap on every device, a sharded trie's shards over tp
    (``trie_shards`` a multiple of the tp extent), the pool's words over
    tp; each batch's rows over dp×tp (flat) or dp (sharded).  The model's
    device is the mesh's first; a ``device`` that disagrees raises.  A
    model on a mesh runs the step even on the CPU (the reference's
    dispatch), and on cards a failing step reaches the caller.

    ``kernel_telemetry`` (None: the ``EMQX_TPU_KERNEL_TELEMETRY`` env, on
    unless "0", "off" or "false") makes every step pack its counters, which
    ``publish_batch_collect`` hands to ``telemetry.on_batch``; off, the
    step packs none and ``on_batch`` gets None.

    ``EMQX_TPU_CPU_KERNEL`` picks where ``publish_batch`` is served:
    ``host`` from a host matcher (``_HostMatcher``, no step), ``xla`` from
    the step, anything else (auto) from the host matcher iff the model's
    device is the CPU.  On the card auto runs the step.
    """

    def __init__(
        self,
        index: Optional[Union[TrieIndex, ShardedTrieIndex]] = None,
        *,
        n_sub_slots: int = 8192,
        K: int = 32,
        M: int = 128,
        ret_cap: int = 16,
        dense_threshold: int = 64,
        mesh: Optional[pmesh.Mesh] = None,
        trie_shards: Optional[int] = None,
        kernel_telemetry: Optional[bool] = None,
        device=None,
    ) -> None:
        if mesh is not None:
            first = mesh.devices[0, 0]
            if device is not None:
                want = torch.device(device)
                if want.type != first.type or (
                        want.index is not None and want != first):
                    raise ValueError(f"device={want} disagrees with the "
                                     f"mesh's devices ({mesh})")
            self.device = first
        else:
            self.device = _build.resolve_device(device)
        if index is None:
            index = (ShardedTrieIndex(trie_shards) if trie_shards
                     else TrieIndex())
        elif trie_shards is not None and (
                getattr(index, "n_shards", 1) != trie_shards):
            raise ValueError(
                f"trie_shards={trie_shards} conflicts with the supplied "
                f"index ({getattr(index, 'n_shards', 1)} shard(s))")
        self.index = index
        self._sharded = isinstance(index, ShardedTrieIndex)
        self.n_shards = index.n_shards if self._sharded else 1
        self.mesh = mesh
        self.shardings = pmesh.router_shardings(mesh) if mesh else None
        if self._sharded and mesh is not None:
            tp_ext = mesh.shape[pmesh.TP]
            if self.n_shards % tp_ext:
                raise ValueError(
                    f"trie shard count {self.n_shards} must be a multiple "
                    f"of the tp mesh extent {tp_ext} — the stacked [S, ...]"
                    f" buffers partition their shard axis evenly over tp")
        if kernel_telemetry is None:
            kernel_telemetry = os.environ.get(
                "EMQX_TPU_KERNEL_TELEMETRY", "1"
            ).lower() not in ("0", "off", "false")
        self.n_sub_slots = n_sub_slots
        self.K, self.M = K, M
        self.ret_cap = min(ret_cap, M)
        self.dense_threshold = dense_threshold
        # fid → {slot: refcount} — slots are SHARDS, so a slot stays set
        # while any local subscriber of the filter lives in it
        self._subs: dict[int, dict[int, int]] = {}
        # fid → refcount for AUXILIARY filters (rule-engine FROM filters
        # co-batched with the router match): in the device trie, but with
        # no subscriber slots; the decode reports them separately
        self._aux_refs: dict[int, int] = {}
        # fid-indexed bool masks mirroring _subs/_aux_refs membership for
        # the vectorized batch decode
        self._sub_mask = np.zeros(64, bool)
        self._aux_mask = np.zeros(64, bool)
        # high-degree filters promoted into the device dense pool
        self._dense_row: dict[int, int] = {}      # fid → pool row
        self._row_free: list[int] = []
        self._next_row = 0
        # One lock over index mutation, the pending-update drain, the
        # device refresh AND the step launch: a drain racing a subscribe
        # could scatter a half-applied insert, and a patch must be ordered
        # on the stream with the steps around it.
        self._mlock = threading.RLock()
        self.set_kernel_telemetry(kernel_telemetry)
        self._trie_dev: Optional[tm.DeviceTrie] = None
        self._rowmap_dev: Optional[torch.Tensor] = None
        self._pool_dev: Optional[torch.Tensor] = None
        self._rowmap_host: Optional[np.ndarray] = None  # [F_cap] int32
        self._pool_host: Optional[np.ndarray] = None    # [P_cap, W] uint32
        self._rowmap_dirty: set[int] = set()
        self._pool_dirty: set[tuple[int, int]] = set()  # (row, word)
        self._dirty = True
        # pinned host blocks for the step's packed outputs, by size in
        # bytes, reused once collected
        self._pinned_free: dict[int, list[torch.Tensor]] = {}
        # a ring of two staging blocks for refresh's update blocks (on a
        # mesh, each slot holds every device's block), each grown to the
        # largest size it has held; pinned on the card, where the patch
        # kernel reads them in place, and guarded by the events recorded
        # after the launches that read the slot (one per device)
        self._patch_ring: list[Optional[torch.Tensor]] = [None, None]
        self._patch_done: list[Optional[list]] = [None, None]
        self._patch_slot = 0
        self.upload_count = 0      # full device uploads
        self.patch_count = 0       # incremental scatter flushes
        self.launch_count = 0      # publish_batch step launches
        self.host_match_count = 0  # batches served by the host matcher
        self.patch_upload_bytes = 0   # unpadded dirty bytes scattered
        self.patch_upload_ns = 0      # host time staging update blocks
        # the observe plane's fold attaches here (on_batch per collect;
        # counters None when kernel_telemetry is off; on_host_batch per
        # batch the host matcher serves)
        self.telemetry = None
        self._host_matcher = (_HostMatcher()
                              if self._resolve_host_dispatch() else None)

    def _resolve_host_dispatch(self) -> bool:
        """Should publish_batch serve from the host matcher?

        ``EMQX_TPU_CPU_KERNEL``: ``host`` forces the host matcher, ``xla``
        forces the step (how the CPU tests run the kernels' plain
        versions), anything else is auto: the host matcher iff the model
        runs on the CPU.
        """
        mode = os.environ.get("EMQX_TPU_CPU_KERNEL", "auto").lower()
        if mode == "host":
            return True
        if mode == "xla":
            return False
        return self.mesh is None and self.device.type == "cpu"

    # -- subscription surface (driven by the broker layer) -----------------

    def _mask_of(self, name: str, n: int) -> np.ndarray:
        """The named fid mask, grown to cover at least ``n`` fids."""
        mask = getattr(self, name)
        if mask.shape[0] < n:
            mask = np.pad(mask, (0, n - mask.shape[0]))
            setattr(self, name, mask)
        return mask

    def _mark(self, mask_name: str, fid: int, val: bool) -> None:
        mask = getattr(self, mask_name)
        if fid >= mask.shape[0]:
            grown = np.zeros(max(fid + 1, mask.shape[0] * 2), bool)
            grown[: mask.shape[0]] = mask
            mask = grown
            setattr(self, mask_name, mask)
        mask[fid] = val

    def subscribe(self, filt: str, slot: int) -> int:
        if not 0 <= slot < self.n_sub_slots:
            raise ValueError(
                f"subscriber slot {slot} out of range [0, {self.n_sub_slots})"
            )
        with self._mlock:
            fid = self.index.insert(filt)
            if self._host_matcher is not None:
                self._host_matcher.add(fid, filt)
            self._mark("_sub_mask", fid, True)
            slots = self._subs.setdefault(fid, {})
            n = slots.get(slot, 0)
            slots[slot] = n + 1
            if n == 0:                     # first subscriber in the shard
                self._slot_added(fid, slot)
                self._dirty = True
            return fid

    def unsubscribe(self, filt: str, slot: int) -> None:
        with self._mlock:
            fid = self.index.fid_of(filt)
            if fid is None:
                return
            slots = self._subs.get(fid)
            if not slots or slot not in slots:
                return
            slots[slot] -= 1
            if slots[slot] == 0:
                del slots[slot]
                self._slot_removed(fid, slot)
                if not slots:
                    self._subs.pop(fid, None)
                    self._mark("_sub_mask", fid, False)
                    # an aux registration keeps the trie entry alive past
                    # the last subscriber
                    if fid not in self._aux_refs:
                        self.index.delete(filt)
                        if self._host_matcher is not None:
                            self._host_matcher.remove(fid)
                self._dirty = True

    # -- auxiliary (rule-engine) filters ------------------------------------

    def aux_register(self, filt: str) -> int:
        """Co-batch a non-subscriber filter (rule FROM clause) into the
        device trie; refcounted across rules sharing a filter."""
        with self._mlock:
            fid = self.index.insert(filt)
            if self._host_matcher is not None:
                self._host_matcher.add(fid, filt)
            self._aux_refs[fid] = self._aux_refs.get(fid, 0) + 1
            self._mark("_aux_mask", fid, True)
            self._dirty = True
            return fid

    def aux_release(self, filt: str) -> None:
        with self._mlock:
            fid = self.index.fid_of(filt)
            if fid is None or fid not in self._aux_refs:
                return
            self._aux_refs[fid] -= 1
            if self._aux_refs[fid] > 0:
                return
            del self._aux_refs[fid]
            self._mark("_aux_mask", fid, False)
            if fid not in self._subs:      # no subscribers either
                self.index.delete(filt)
                if self._host_matcher is not None:
                    self._host_matcher.remove(fid)
            self._dirty = True

    # -- dense-pool promotion / demotion -----------------------------------

    def _slot_added(self, fid: int, slot: int) -> None:
        row = self._dense_row.get(fid)
        if row is not None:
            self._pool_bit(row, slot, on=True)
        elif len(self._subs[fid]) > self.dense_threshold:
            self._promote(fid)

    def _slot_removed(self, fid: int, slot: int) -> None:
        row = self._dense_row.get(fid)
        if row is not None:
            self._pool_bit(row, slot, on=False)
            # hysteresis: demote well below the promote threshold so a
            # filter oscillating around it doesn't thrash the pool
            if len(self._subs[fid]) < self.dense_threshold // 2:
                self._demote(fid)

    def _promote(self, fid: int) -> None:
        if self._row_free:
            row = self._row_free.pop()
        else:
            row = self._next_row
            self._next_row += 1
        self._dense_row[fid] = row
        if (self._pool_host is None or row >= self._pool_host.shape[0]):
            self._pool_host = None        # pool growth → full rebuild
        else:
            for slot in self._subs[fid]:
                self._pool_bit(row, slot, on=True)
        self._set_rowmap(fid, row)

    def _demote(self, fid: int) -> None:
        row = self._dense_row.pop(fid)
        if self._pool_host is not None and row < self._pool_host.shape[0]:
            for slot in self._subs.get(fid, ()):   # leave the row zeroed
                self._pool_bit(row, slot, on=False)
        self._row_free.append(row)
        self._set_rowmap(fid, -1)

    def _pool_bit(self, row: int, slot: int, *, on: bool) -> None:
        pool = self._pool_host
        if pool is None or row >= pool.shape[0] or slot // 32 >= pool.shape[1]:
            self._pool_host = None
            return
        if on:
            pool[row, slot // 32] |= np.uint32(1) << np.uint32(slot % 32)
        else:
            pool[row, slot // 32] &= ~(np.uint32(1) << np.uint32(slot % 32))
        self._pool_dirty.add((row, slot // 32))

    def _set_rowmap(self, fid: int, row: int) -> None:
        rm = self._rowmap_host
        if rm is None or fid >= rm.shape[0]:
            self._rowmap_host = None      # fid capacity growth → rebuild
            return
        rm[fid] = row
        self._rowmap_dirty.add(fid)

    # -- device refresh ----------------------------------------------------

    @property
    def bitmap_words(self) -> int:
        return max(1, (self.n_sub_slots + 31) // 32)

    def build_pool(self) -> tuple[np.ndarray, np.ndarray]:
        """Full (rowmap, pool) rebuild: compact rows, fresh headroom."""
        W = self.bitmap_words
        live = max(1, len(self.index.filters))
        F = 64
        while F < live + live // 2:
            F *= 2
        rowmap = np.full(F, -1, np.int32)
        # compact row ids (frees fragmentation from demotes)
        self._dense_row = {
            fid: i for i, fid in enumerate(sorted(self._dense_row))
        }
        self._row_free = []
        self._next_row = len(self._dense_row)
        P = 64
        while P < max(1, self._next_row * 2):
            P *= 2
        pool = np.zeros((P, W), np.uint32)
        for fid, row in self._dense_row.items():
            rowmap[fid] = row
            for slot in self._subs.get(fid, ()):
                pool[row, slot // 32] |= np.uint32(1) << np.uint32(slot % 32)
        return rowmap, pool

    def set_kernel_telemetry(self, on: bool) -> None:
        """Pack the step's counters into every batch's block (and hand them
        to ``telemetry.on_batch``), or not: the next step on either side of
        the call runs as a model built with ``kernel_telemetry=on``."""
        with self._mlock:
            self.kernel_telemetry = bool(on)
            # the device step over this index's layout: the 5-tuple, and on
            # the card the packed block publish_batch_submit copies back
            self._step = functools.partial(
                router_step_sharded if self._sharded else router_step,
                with_counters=self.kernel_telemetry,
                shardings=self.shardings,
                **({"n_shards": self.n_shards} if self._sharded else {}))
            self._step_block = functools.partial(
                router_step_block, n_shards=self.n_shards,
                with_counters=self.kernel_telemetry,
                shardings=self.shardings)

    def refresh(self) -> None:
        """Bring the device tables up to date: one patch launch when
        possible, a full upload on structural growth."""
        with self._mlock:
            self._refresh_locked()

    def _upload(self, arr: np.ndarray, sharding: str = "replicated"):
        """A host table on the model's device, a copy; on a mesh, the grid
        of its pieces under ``sharding``."""
        x = torch.from_numpy(np.ascontiguousarray(arr).view(np.int32))
        if self.mesh is not None:
            return self.shardings[sharding].split(x)
        return x.to(self.device, copy=True)

    def _place_trie(self, arrays) -> tm.DeviceTrie:
        """The index's trie arrays as device records: on the model's
        device, or on a mesh a grid of pieces (a replica of the flat trie
        on every device; each tp rank's slice of the stacked shards).  A
        mesh of cards must read pinned host blocks at their host address
        (unified addressing), which is checked here."""
        dev = "cpu" if self.mesh is not None else self.device
        host = (tm.stacked_device_trie(arrays, dev) if self._sharded
                else tm.device_trie(arrays, dev))
        if self.mesh is None:
            return host
        if self.mesh.device_type == "cuda":
            for d in set(self.mesh.devices.flat):
                if not _build.unified_addressing(d):
                    raise RuntimeError(f"{d} has no unified addressing: the "
                                       f"mesh's pinned blocks are unreadable")
        sh = self.shardings["trie_sub" if self._sharded else "replicated"]
        edges, nodes = sh.split(host.edges), sh.split(host.nodes)
        return [[tm.DeviceTrie(edges=e, nodes=n) for e, n in zip(er, nr)]
                for er, nr in zip(edges, nodes)]

    def _tables(self, i: int = 0, j: int = 0) -> tuple:
        """``(trie, rowmap, pool, device)`` of mesh position ``(i, j)``
        (the model's own tables without a mesh)."""
        if self.mesh is None:
            return (self._trie_dev, self._rowmap_dev, self._pool_dev,
                    self.device)
        return (self._trie_dev[i][j], self._rowmap_dev[i][j],
                self._pool_dev[i][j], self.mesh.devices[i, j])

    def _refresh_locked(self, trace=None) -> None:
        full_trie = (self.index.needs_rebuild or self._trie_dev is None
                     or (not self._sharded and self.index.arrays is None))
        if full_trie:
            # a sharded index's ensure() also equalizes the shards'
            # edge-table sizes, so the [S, H] stack shares one probe mask
            self._trie_dev = self._place_trie(self.index.ensure())
            self.index.drain_updates()    # superseded by the upload
            self.upload_count += 1

        # fid capacity must cover every live fid (rowmap gathers by fid)
        if (self._rowmap_host is not None
                and len(self.index.filters) > self._rowmap_host.shape[0]):
            self._rowmap_host = None
        full_pool = (self._pool_host is None or self._rowmap_host is None
                     or self._pool_dev is None
                     or self._pool_host.shape[1] != self.bitmap_words)
        if full_pool:
            self._rowmap_host, self._pool_host = self.build_pool()
            self._rowmap_dev = self._upload(self._rowmap_host)
            self._pool_dev = self._upload(self._pool_host, "bitmaps")
            self._rowmap_dirty.clear()
            self._pool_dirty.clear()

        updates = {} if full_trie else self.index.drain_updates()
        rm_dirty = [] if full_pool else sorted(self._rowmap_dirty)
        pool_dirty = [] if full_pool else sorted(self._pool_dirty)
        if updates or rm_dirty or pool_dirty:
            # patch-upload accounting (UNPADDED dirty counts — the pad
            # repeats a no-op write): each trie element scatters an
            # (index, value) int32 pair, +4 B for the shard index on the
            # stacked layout; pool writes carry (row, col, val)
            n_elems = sum(len(v) for v in updates.values())
            self.patch_upload_bytes += (
                n_elems * (12 if self._sharded else 8)
                + len(rm_dirty) * 8 + len(pool_dirty) * 12)
            if trace and self._sharded:
                # a traced batch's patch on the stacked layout: the
                # elements it writes (trie, rowmap, pool) and the shards
                # whose trie it touches
                trace.counters.update(
                    patch_elems=n_elems + len(rm_dirty) + len(pool_dirty),
                    patch_shards=len({s for v in updates.values()
                                      for s, _ in v}))
            if self.mesh is None:
                upds = [self._patch_for(updates, rm_dirty, pool_dirty)]
                where = [[(0, 0)]]
            else:
                # one block per tp rank that holds an updated element,
                # read in place by a launch on each of the rank's devices
                dp, tp = self.mesh.devices.shape
                upds, where = [], []
                for j in range(tp):
                    upd = self._patch_for(updates, rm_dirty, pool_dirty, j)
                    if upd is not None:
                        upds.append(upd)
                        where.append([(i, j) for i in range(dp)])
            t0 = _tracing.now_ns()
            blocks = self._stage_patch(upds)
            self.patch_upload_ns += _tracing.now_ns() - t0
            done = []
            for block, positions in zip(blocks, where):
                for i, j in positions:
                    trie, rowmap, pool, dev = self._tables(i, j)
                    with _on(dev):
                        apply_patches(trie, rowmap, pool, block)
                        if dev.type == "cuda":
                            done.append(torch.cuda.Event())
                            done[-1].record(torch.cuda.current_stream(dev))
            if done:
                self._patch_done[self._patch_slot] = done
            self._patch_slot ^= 1
            self._rowmap_dirty.clear()
            self._pool_dirty.clear()
            self.patch_count += 1
        self._dirty = False

    def _patch_for(self, updates: dict, rm_dirty: list, pool_dirty: list,
                   rank: Optional[int] = None) -> Optional[np.ndarray]:
        """The ``[PATCH_ROWS, cap]`` update block of the drained updates
        for the model's tables, or on a mesh for the devices of tp rank
        ``rank``: every flat-trie and rowmap element; the sharded elements
        of the rank's shards (at their local shard); the pool words of its
        columns (at their local column).  None when the rank holds none of
        the updated elements.  A target with no update gets a no-op
        self-write of its element 0."""
        trie, rowmap, pool, _ = self._tables(0, rank or 0)
        base = w0 = 0
        if rank is not None:
            w0 = rank * pool.shape[1]
            if self._sharded:
                S_l = trie.edges.shape[0]
                base = rank * S_l
                updates = {n: [(s - base, i) for s, i in v
                               if base <= s < base + S_l]
                           for n, v in updates.items()}
            pool_dirty = [(r, c - w0) for r, c in pool_dirty
                          if w0 <= c < w0 + pool.shape[1]]
        if not (any(updates.values()) or rm_dirty or pool_dirty):
            return None
        cap = _patch_bucket(max(
            max((len(v) for v in updates.values()), default=0),
            len(rm_dirty), len(pool_dirty)))
        tupd = {}
        for name in tm.TRIE_FIELDS:
            idxs = updates.get(name)
            if self._sharded:
                tupd[name] = self._shard_updates(name, idxs, cap, base)
                continue
            # no dirty entry: a no-op self-write of element 0
            idx = (np.asarray(idxs, np.int32) if idxs
                   else np.zeros(1, np.int32))
            tupd[name] = _pad_to(cap, idx,
                                 getattr(self.index.arrays, name)[idx])
        ridx = (np.asarray(rm_dirty, np.int32) if rm_dirty
                else np.zeros(1, np.int32))
        ridx, rvals = _pad_to(cap, ridx, self._rowmap_host[ridx])
        if pool_dirty:
            rows = np.asarray([r for r, _ in pool_dirty], np.int32)
            cols = np.asarray([c for _, c in pool_dirty], np.int32)
        else:
            rows = np.zeros(1, np.int32)
            cols = np.zeros(1, np.int32)
        vals = self._pool_host[rows, cols + w0].view(np.int32)
        # pad rows/cols/vals with the SAME (row0, col0, val0) triple
        rows, vals = _pad_to(cap, rows, vals)
        cols, _ = _pad_to(cap, cols, cols)
        sizes = {n: (tuple(getattr(trie, n).shape) if self._sharded
                     else getattr(trie, n).shape[0])
                 for n in tm.TRIE_FIELDS}
        sizes["rowmap"] = rowmap.shape[0]
        sizes["pool"] = tuple(pool.shape)
        return patch_block(cap, tupd, (ridx, rvals), (rows, cols, vals),
                           sizes)

    def _stage_patch(self, upds: list[np.ndarray]) -> list[torch.Tensor]:
        """Copy update blocks into the ring's next slot, one after another
        (each 16-byte aligned: 17·cap int32, cap a multiple of 4), and
        return them as the ``[PATCH_ROWS, cap]`` tensors the patch launches
        read, after waiting for the launches that last read that slot."""
        slot = self._patch_slot
        for done in self._patch_done[slot] or ():
            done.synchronize()
        total = sum(u.size for u in upds)
        buf = self._patch_ring[slot]
        if buf is None or buf.numel() < total:
            buf = torch.empty(total, dtype=torch.int32,
                              pin_memory=self.device.type == "cuda")
            self._patch_ring[slot] = buf
        out, off = [], 0
        for upd in upds:
            block = buf[off:off + upd.size].view(upd.shape)
            block.numpy()[:] = upd
            out.append(block)
            off += upd.size
        return out

    def _shard_updates(self, name: str, idxs, cap: int, base: int = 0):
        """One trie field's dirty (shard, element) pairs, padded to cap, as
        ``((shard, element), values)`` for :func:`patch_block`: a
        steady-state subscribe patches only the owning shard's row.  The
        shards are local to a tp rank whose first is global shard
        ``base`` (0 without a mesh)."""
        if idxs:
            sidx = np.asarray([s for s, _ in idxs], np.int32)
            eidx = np.asarray([i for _, i in idxs], np.int32)
        else:                                 # no-op self-write
            sidx = np.zeros(1, np.int32)
            eidx = np.zeros(1, np.int32)
        vals = np.empty(len(sidx), np.int32)
        for s in np.unique(sidx).tolist():
            at = sidx == s
            vals[at] = getattr(self.index.shards[base + s].arrays,
                               name)[eidx[at]]
        sidx, vals = _pad_to(cap, sidx, vals)
        eidx, _ = _pad_to(cap, eidx, eidx)
        return (sidx, eidx), vals

    # -- the hot path ------------------------------------------------------

    def publish_batch(self, topics: Sequence[str]):
        """Route a batch of publish topics.

        Returns ``(matched, aux, slots, fallback)``:
        - matched: per-topic subscriber filter strings
        - aux: per-topic auxiliary (rule FROM) filter strings matched by
          the same step
        - slots: per-topic subscriber shard slots
        - fallback: batch positions (overflow/too-long) that must take
          the host-oracle path upstream
        """
        return self.publish_batch_collect(self.publish_batch_submit(topics))

    def _host_block(self, nbytes: int) -> torch.Tensor:
        """A pinned uint8 block for one step's packed outputs, from the
        free list when one was collected."""
        free = self._pinned_free.get(nbytes)
        if free:
            return free.pop()
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def publish_batch_submit(self, topics: Sequence[str], trace=None):
        """Stage 1: tokenize and launch the step; returns an opaque pending
        handle without waiting for the device.  On the card, the step's
        packed result block starts its one copy into a pinned host block
        here and an event marks its end, so the caller can overlap the next
        batch's host work with this batch's device time.

        With the host matcher active the batch is served here, and the
        handle is ``("host", result)``: the finished result, which the
        broker recognizes by that shape.

        ``trace``: the batch's ``BatchTrace`` (or False / None, see
        ``observe.trace.BatchTrace``), kept in the handle.  A traced batch
        gets the spans ``model.refresh`` (when a dirty table is patched
        here), ``model.tokenize`` and ``model.launch`` (the upload, the
        step's launch and the start of its copy back), and at collect
        ``model.wait`` and ``model.decode``; the kernel fold records its
        points under the batch's trace id.  On a sharded trie it also gets
        the counters ``patch_elems`` and ``patch_shards`` (with
        ``model.refresh``) and ``trie_shards``, ``matched_fids`` and
        ``shard_fids_max`` (at collect, :meth:`_count_shards`)."""
        if self._host_matcher is not None:
            return ("host", self._publish_batch_host(topics))
        t0 = _tracing.now_ns()
        with self._mlock:
            if trace:
                t_tok = _tracing.now_ns()
            if self._dirty or self._trie_dev is None:
                self._refresh_locked(trace)
                if trace:
                    t_ref, t_tok = t_tok, _tracing.now_ns()
                    trace.span("model.refresh", t_ref, t_tok)
            self.launch_count += 1
            n = len(topics)
            # pad the batch to a pow2 bucket (≥64): few distinct shapes
            B = 64
            while B < n:
                B *= 2
            padded = list(topics) + [""] * (B - n)
            tokens, lengths, sys_flags, too_long = self.index.tokenize(
                padded)
            too_long = [b for b in too_long if b < n]
            # padding rows: length 0 + sys flag so even the root '#'/'+'
            # filters (which match an empty prefix) cannot emit for them
            lengths[n:] = 0
            sys_flags[n:] = True
            if trace:
                t_launch = _tracing.now_ns()
                trace.span("model.tokenize", t_tok, t_launch, n)
            dev = self.device
            batch = (tokens, lengths, sys_flags)
            if self.mesh is not None:
                # the rows over dp×tp (flat) or dp (sharded: every tp
                # rank's shards see its dp group's topics); a batch that
                # does not split evenly raises
                sh = self.shardings["batch_dp" if self._sharded
                                    else "batch_full"]
                batch = tuple(sh.split(torch.from_numpy(x)) for x in batch)
            else:
                batch = tuple(torch.from_numpy(x).to(dev) for x in batch)
            args = (self._trie_dev, self._rowmap_dev, self._pool_dev, *batch)
            kw = dict(K=self.K, M=self.M, ret_cap=self.ret_cap,
                      max_probes=self.index.max_probes)
            host, events = None, []
            if dev.type == "cuda":
                blocks, regions = self._step_block(*args, **kw)
                host, outs = self._copy_back(blocks, regions, events)
            else:
                outs = self._step(*args, **kw)
            # freed fids stay quarantined until this batch is decoded —
            # a reused fid would decode as the WRONG (new) filter
            self.index.begin_inflight()
            t1 = _tracing.now_ns()
            if trace:
                trace.span("model.launch", t_launch, t1, n)
            return (list(topics), too_long, outs, host, events, (t0, t1),
                    trace)

    def _copy_back(self, blocks, regions, events: list) -> tuple:
        """Start the copy of a step's packed block (on a mesh, of each
        device's, one after another) into one pinned host block, each copy
        followed by an event on its device's stream (appended to
        ``events``).  Returns the host block and the outputs: views of it,
        or on a mesh a callable that assembles them once the events have
        passed."""
        if self.mesh is None:
            host = self._host_block(blocks.numel())
            host.copy_(blocks, non_blocking=True)
            events.append(torch.cuda.Event())
            events[-1].record()
            return host, step_views(host, regions)
        pos = self.mesh.positions()
        host = self._host_block(sum(blocks[i][j].numel() for i, j in pos))
        views, off = {}, 0
        for i, j in pos:
            d, n = self.mesh.devices[i, j], blocks[i][j].numel()
            with _on(d):
                host[off:off + n].copy_(blocks[i][j], non_blocking=True)
                events.append(torch.cuda.Event())
                events[-1].record(torch.cuda.current_stream(d))
            views[i, j] = step_views(host[off:off + n], regions[i][j])
            off += n
        return host, functools.partial(assemble, views, self.mesh,
                                       self._sharded, "cpu")

    def publish_batch_collect(self, pending):
        """Stage 2: wait for a submitted batch's results and decode them."""
        if isinstance(pending, tuple) and len(pending) == 2 \
                and pending[0] == "host":
            return pending[1]
        topics, too_long, outs, host, events, (t0, t1), trace = pending
        try:
            t2 = _tracing.now_ns()
            for event in events:
                event.synchronize()
            t3 = _tracing.now_ns()
            if callable(outs):          # a mesh's pieces, assembled now
                outs = outs()
            fids, fan, overflow, fan_any, counters = (
                None if t is None else t.numpy() for t in outs)
            if fan_any:
                fan = fan.view(np.uint32)
            else:
                fan = np.zeros(fan.shape, np.uint32)
            with self._mlock:
                res = self._decode_locked(topics, too_long, fids, fan,
                                          overflow)
            tel = self.telemetry
            if tel is not None and counters is not None:
                counters = counters.copy()
            t4 = _tracing.now_ns()
            if trace:
                trace.span("model.wait", t2, t3, len(topics))
                trace.span("model.decode", t3, t4, len(topics))
                if self._sharded:
                    self._count_shards(trace, fids[:len(topics)])
            if tel is not None:
                # the trace goes to the hook only where a caller passed
                # one: a hook written for the model alone takes none
                kw = {} if trace is None else {"trace": trace}
                try:   # telemetry must never break the serving path
                    tel.on_batch(
                        counters, n_topics=len(topics),
                        submit_ns=t1 - t0, step_ns=t3 - t2,
                        decode_ns=t4 - t3, t_submit_ns=t0,
                        t_collect_ns=t3, **kw)
                except Exception:  # noqa: BLE001 — observe-plane bug
                    pass
            return res
        finally:
            with self._mlock:
                self.index.end_inflight()
                if host is not None:
                    self._pinned_free.setdefault(host.numel(),
                                                 []).append(host)

    def _publish_batch_host(self, topics):
        """Serve one batch from the host matcher.

        Same ``(matched, aux, slots, fallback)`` contract as the device
        decode.  The host walk is exact and depth-unbounded, so there is no
        overflow or too-long leg: fallback is always empty.  Slots come
        straight from the subscription dict for every matched filter; the
        dense pool is a device-bandwidth layout with no meaning here.
        """
        with self._mlock:
            self.host_match_count += 1
            tel = self.telemetry
            if tel is not None:
                try:
                    tel.on_host_batch(len(topics))
                except Exception:  # noqa: BLE001 — observe-plane bug
                    pass
            filters = self.index.filters
            any_aux = bool(self._aux_refs)
            matched: list[list[str]] = []
            aux: list[list[str]] = []
            slots_out: list[list[int]] = []
            for topic in topics:
                m: list[str] = []
                a: list[str] = []
                sl: set[int] = set()
                for fid in self._host_matcher.match(topic):
                    filt = filters[fid]
                    if filt is None:
                        continue
                    if fid in self._subs:
                        m.append(filt)
                        sl.update(self._subs[fid])
                    if any_aux and fid in self._aux_refs:
                        a.append(filt)
                matched.append(m)
                aux.append(a)
                slots_out.append(sorted(sl))
            return matched, aux, slots_out, []

    def _count_shards(self, trace, fids: np.ndarray) -> None:
        """A traced batch's matched fids by the shard that holds them (a
        global fid's ``fid % S``): ``trie_shards`` (S), ``matched_fids``
        and ``shard_fids_max``, the matched fids of the fullest shard."""
        per = np.bincount(fids[fids >= 0] % self.n_shards,
                          minlength=self.n_shards)
        trace.counters.update(trie_shards=self.n_shards,
                              matched_fids=int(per.sum()),
                              shard_fids_max=int(per.max()))

    def _decode_locked(self, topics, too_long, fids, fan, overflow):
        # vectorized batch decode: classify the whole [B, M] fid block with
        # two mask gathers, and expand ALL delivering bitmap words with one
        # shift table — O(nonzero words + actual matches)
        B_out = len(topics)
        F = max(1, len(self.index.filters))
        fb = fids[:B_out]
        valid = fb >= 0
        safe = np.where(valid, fb, 0)
        sub_hit = valid & self._mask_of("_sub_mask", F)[safe]
        any_aux = bool(self._aux_refs)
        if any_aux:
            aux_hit = valid & self._mask_of("_aux_mask", F)[safe]
        filters = self.index.filters
        matched: list[list[str]] = []
        aux: list[list[str]] = []
        slots_out: list[list[int]] = []

        # bitmap words → slot ids, all topics at once
        fan_b = fan[:B_out]
        rb, wb = np.nonzero(fan_b)
        if len(rb):
            vals = fan_b[rb, wb].astype(np.uint32)
            bits = (vals[:, None] >> np.arange(32, dtype=np.uint32)) & 1
            nz_r, nz_bit = np.nonzero(bits)
            rows_flat = rb[nz_r]                      # non-decreasing
            slots_flat = wb[nz_r] * 32 + nz_bit
            bounds = np.searchsorted(rows_flat, np.arange(B_out + 1))
        else:
            slots_flat = np.zeros(0, np.int64)
            bounds = np.zeros(B_out + 1, np.int64)

        for b in range(B_out):
            row = fb[b]
            sub_fids = row[sub_hit[b]]
            # a fid deleted while the batch was in flight decodes to
            # None — that unsubscribe raced the publish; drop the leg
            # (reuse is prevented by the index's in-flight quarantine)
            matched.append([filters[f] for f in sub_fids
                            if filters[f] is not None])
            aux.append([filters[f] for f in row[aux_hit[b]]
                        if filters[f] is not None]
                       if any_aux else [])
            # hybrid decode: dense (high-degree) filters' shard slots
            # come from the device OR (bitmap words above); low-degree
            # filters' slots from the host dict — O(deliveries) total
            out_slots = set(slots_flat[bounds[b]:bounds[b + 1]].tolist())
            for f in sub_fids:
                fi = int(f)
                if fi not in self._dense_row:
                    out_slots.update(self._subs.get(fi, ()))
            slots_out.append(sorted(out_slots))
        fallback = sorted(set(too_long) | set(np.nonzero(overflow)[0].tolist()))
        return matched, aux, slots_out, fallback
