"""RouterModel — the publish routing step on the card: match+compact → fan-out.

Port of the JAX package's ``models/router_model.py`` for one device, on the
flat trie or the subscription-sharded one.  One step replaces the reference
broker's per-message read path (``emqx_router:match_routes/1`` →
``emqx_trie:match/1`` → subscriber lookups → pid fan-out loop) with a
batched run over device-resident tables:

    tokens [B, L] ──trie walk, compacted as it walks──► fids [B, M]
                                                            │
          dense pool [P, W] + rowmap [F] ──OR──────────────►└─► fanout [B, W],
                                                                counters

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
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from emqx_tpu_torch.ops import _build
from emqx_tpu_torch.ops import fanout as fo
from emqx_tpu_torch.ops import trie_match as tm
from emqx_tpu_torch.router.index import ShardedTrieIndex, TrieIndex


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
):
    """The full publish-batch routing step.

    Returns ``(fids [B, ret_cap or M], fanout [B, W], overflow [B],
    fan_any [], counters [C])``.  ``fanout`` covers the dense-pool filters;
    low-degree slots decode on the host.  ``ret_cap`` trims the returned
    fid columns: topics matching more than ret_cap filters are flagged
    overflow and take the host-oracle fallback upstream.  ``counters`` is
    the int32 pack in tm.KERNEL_COUNTER_FIELDS order, computed on the
    device from the walk's per-topic stats (the untrimmed compacted block's
    counts: a topic keeps min(n, M) of its n candidates).
    """
    fids, stats = tm.match_compact(trie, tokens, lengths, sys_flags, K=K,
                                   M=M, max_probes=max_probes)
    n = stats[:, 2]
    occ = n.clamp(max=M)                                      # [B]
    truncated = n > M
    counters = tm.pack_counters(
        frontier_peak=stats[:, 0].max(),
        probe_iters=stats[:, 1].sum(dtype=torch.int32),
        cand_pre=n.sum(dtype=torch.int32),
        cand_post=occ.sum(dtype=torch.int32),
        compact_peak=occ.max(),
        overflow_rows=stats[:, 3].sum(dtype=torch.int32),
        trunc_rows=truncated.sum(dtype=torch.int32),
    )
    out = fo.fanout_pool(rowmap, pool, fids)
    fan_any = (out != 0).any()
    overflow = (stats[:, 3] != 0) | truncated
    if ret_cap is not None and ret_cap < M:
        overflow = overflow | (occ > ret_cap)
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
):
    """The routing step over a stacked ``[S, H]`` / ``[S, N]`` trie.

    Every shard walks every topic against its own subscriptions; each
    shard's matches compact to M shard-local fids, translate to the global
    namespace (``local * S + shard``), merge shard-major and compact again
    to M — all inside the walk's launch.  After the merge the step is
    :func:`router_step`: the dense-pool fan-out over global fids, the
    ``ret_cap`` trim and ``overflow |= truncated``.  With one shard it
    equals :func:`router_step` bit for bit (its counters as ``[1, C]``).

    Returns ``(fids, fanout, overflow, fan_any, counters [S, C])``: the
    counters per shard, match fields from the shard's walk and cand_post,
    compact_peak and trunc_rows from the shard's own compact, before the
    merge.  The merge's spill rides ``overflow``, not the counters.
    """
    fids, stats, truncated = tm.match_compact_sharded(
        trie, tokens, lengths, sys_flags, n_shards=n_shards, K=K, M=M,
        max_probes=max_probes)
    n = stats[:, :, 2]                                        # [S, B]
    occ = n.clamp(max=M)
    counters = tm.pack_counters(
        frontier_peak=stats[:, :, 0].max(1).values,
        probe_iters=stats[:, :, 1].sum(1, dtype=torch.int32),
        cand_pre=n.sum(1, dtype=torch.int32),
        cand_post=occ.sum(1, dtype=torch.int32),
        compact_peak=occ.max(1).values,
        overflow_rows=stats[:, :, 3].sum(1, dtype=torch.int32),
        trunc_rows=(n > M).sum(1, dtype=torch.int32),
    )
    out = fo.fanout_pool(rowmap, pool, fids)
    fan_any = (out != 0).any()
    overflow = (stats[:, :, 3] != 0).any(0) | truncated
    if ret_cap is not None and ret_cap < M:
        overflow = overflow | ((fids >= 0).sum(1) > ret_cap)
        fids = fids[:, :ret_cap]
    return fids, out, overflow, fan_any, counters


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
        trie_shards: Optional[int] = None,
        device=None,
    ) -> None:
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
        # the device step over this index's layout
        self._step = (functools.partial(router_step_sharded,
                                        n_shards=self.n_shards)
                      if self._sharded else router_step)
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
        self._trie_dev: Optional[tm.DeviceTrie] = None
        self._rowmap_dev: Optional[torch.Tensor] = None
        self._pool_dev: Optional[torch.Tensor] = None
        self._rowmap_host: Optional[np.ndarray] = None  # [F_cap] int32
        self._pool_host: Optional[np.ndarray] = None    # [P_cap, W] uint32
        self._rowmap_dirty: set[int] = set()
        self._pool_dirty: set[tuple[int, int]] = set()  # (row, word)
        self._dirty = True
        # pinned host buffers by batch size, reused once collected
        self._pinned_free: dict[int, list[tuple]] = {}
        # a ring of two staging blocks for refresh's update blocks, each
        # grown to the largest cap it has held; pinned on the card, where
        # the patch kernel reads them in place, and guarded by an event
        # recorded after the launch that reads the slot
        self._patch_ring: list[Optional[torch.Tensor]] = [None, None]
        self._patch_done: list[Optional[torch.cuda.Event]] = [None, None]
        self._patch_slot = 0
        self.upload_count = 0      # full device uploads
        self.patch_count = 0       # incremental scatter flushes
        self.launch_count = 0      # publish_batch step launches
        self.patch_upload_bytes = 0   # unpadded dirty bytes scattered
        self.patch_upload_ns = 0      # host time staging update blocks
        # the observe plane's fold attaches here (on_batch per collect)
        self.telemetry = None

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
                self._dirty = True

    # -- auxiliary (rule-engine) filters ------------------------------------

    def aux_register(self, filt: str) -> int:
        """Co-batch a non-subscriber filter (rule FROM clause) into the
        device trie; refcounted across rules sharing a filter."""
        with self._mlock:
            fid = self.index.insert(filt)
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

    def refresh(self) -> None:
        """Bring the device tables up to date: one patch launch when
        possible, a full upload on structural growth."""
        with self._mlock:
            self._refresh_locked()

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int32)
        ).to(self.device, copy=True)

    def _refresh_locked(self) -> None:
        full_trie = (self.index.needs_rebuild or self._trie_dev is None
                     or (not self._sharded and self.index.arrays is None))
        if full_trie:
            if self._sharded:
                # ensure() also equalizes the shards' edge-table sizes, so
                # the [S, H] stack shares one probe mask
                self._trie_dev = tm.stacked_device_trie(
                    self.index.ensure(), self.device)
            else:
                self._trie_dev = tm.device_trie(self.index.ensure(),
                                                self.device)
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
            self._pool_dev = self._upload(self._pool_host)
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
            cap = _patch_bucket(max(
                max((len(v) for v in updates.values()), default=0),
                len(rm_dirty), len(pool_dirty)))
            tupd = {}
            for name in tm.TRIE_FIELDS:
                idxs = updates.get(name)
                if self._sharded:
                    tupd[name] = self._shard_updates(name, idxs, cap)
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
            vals = self._pool_host[rows, cols].view(np.int32)
            # pad rows/cols/vals with the SAME (row0, col0, val0) triple
            rows, vals = _pad_to(cap, rows, vals)
            cols, _ = _pad_to(cap, cols, cols)
            sizes = {n: (tuple(getattr(self._trie_dev, n).shape)
                         if self._sharded
                         else getattr(self._trie_dev, n).shape[0])
                     for n in tm.TRIE_FIELDS}
            sizes["rowmap"] = self._rowmap_dev.shape[0]
            sizes["pool"] = tuple(self._pool_dev.shape)
            upd = patch_block(cap, tupd, (ridx, rvals), (rows, cols, vals),
                              sizes)
            t0 = time.monotonic_ns()
            block = self._stage_patch(upd)
            self.patch_upload_ns += time.monotonic_ns() - t0
            apply_patches(self._trie_dev, self._rowmap_dev, self._pool_dev,
                          block)
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
                self._patch_done[self._patch_slot] = done
            self._patch_slot ^= 1
            self._rowmap_dirty.clear()
            self._pool_dirty.clear()
            self.patch_count += 1
        self._dirty = False

    def _stage_patch(self, upd: np.ndarray) -> torch.Tensor:
        """Copy an update block into the ring's next slot and return it as
        the ``[PATCH_ROWS, cap]`` tensor the patch launch reads, after
        waiting for the launch that last read that slot."""
        slot = self._patch_slot
        done = self._patch_done[slot]
        if done is not None:
            done.synchronize()
        buf = self._patch_ring[slot]
        if buf is None or buf.numel() < upd.size:
            buf = torch.empty(upd.size, dtype=torch.int32,
                              pin_memory=self.device.type == "cuda")
            self._patch_ring[slot] = buf
        block = buf[:upd.size].view(upd.shape)
        block.numpy()[:] = upd
        return block

    def _shard_updates(self, name: str, idxs, cap: int):
        """One trie field's dirty (shard, element) pairs, padded to cap, as
        ``((shard, element), values)`` for :func:`patch_block`: a
        steady-state subscribe patches only the owning shard's row."""
        if idxs:
            sidx = np.asarray([s for s, _ in idxs], np.int32)
            eidx = np.asarray([i for _, i in idxs], np.int32)
        else:                                 # no-op self-write
            sidx = np.zeros(1, np.int32)
            eidx = np.zeros(1, np.int32)
        vals = np.empty(len(sidx), np.int32)
        for s, shard in enumerate(self.index.shards):
            at = sidx == s
            vals[at] = getattr(shard.arrays, name)[eidx[at]]
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

    def _host_buffers(self, B: int, fids_w: int) -> tuple:
        """Pinned (fids, fanout, overflow, fan_any, counters) buffers for
        a B-row batch, from the free list when one was collected."""
        free = self._pinned_free.get(B)
        if free:
            return free.pop()
        pin = dict(pin_memory=True)
        C = len(tm.KERNEL_COUNTER_FIELDS)       # counters per shard if sharded
        return (torch.empty((B, fids_w), dtype=torch.int32, **pin),
                torch.empty((B, self.bitmap_words), dtype=torch.int32, **pin),
                torch.empty(B, dtype=torch.bool, **pin),
                torch.empty((), dtype=torch.bool, **pin),
                torch.empty((self.n_shards, C) if self._sharded else (C,),
                            dtype=torch.int32, **pin))

    def publish_batch_submit(self, topics: Sequence[str]):
        """Stage 1: tokenize and launch the step; returns an opaque pending
        handle without waiting for the device.  On the card, the results'
        device-to-host copies into pinned buffers start here and an event
        marks their end, so the caller can overlap the next batch's host
        work with this batch's device time."""
        t0 = time.monotonic_ns()
        with self._mlock:
            if self._dirty or self._trie_dev is None:
                self._refresh_locked()
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
            dev = self.device
            outs = self._step(
                self._trie_dev, self._rowmap_dev, self._pool_dev,
                torch.from_numpy(tokens).to(dev),
                torch.from_numpy(lengths).to(dev),
                torch.from_numpy(sys_flags).to(dev),
                K=self.K, M=self.M, ret_cap=self.ret_cap,
                max_probes=self.index.max_probes)
            event = None
            if dev.type == "cuda":
                host = self._host_buffers(B, outs[0].shape[1])
                for dst, src in zip(host, outs):
                    dst.copy_(src, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
                outs = host
            # freed fids stay quarantined until this batch is decoded —
            # a reused fid would decode as the WRONG (new) filter
            self.index.begin_inflight()
            return (list(topics), too_long, outs, event,
                    (t0, time.monotonic_ns()))

    def publish_batch_collect(self, pending):
        """Stage 2: wait for a submitted batch's results and decode them."""
        topics, too_long, outs, event, (t0, t1) = pending
        try:
            t2 = time.monotonic_ns()
            if event is not None:
                event.synchronize()
            t3 = time.monotonic_ns()
            fids, fan, overflow, fan_any, counters = (
                t.numpy() for t in outs)
            if fan_any:
                fan = fan.view(np.uint32)
            else:
                fan = np.zeros(fan.shape, np.uint32)
            with self._mlock:
                res = self._decode_locked(topics, too_long, fids, fan,
                                          overflow)
            tel = self.telemetry
            if tel is not None:
                try:   # telemetry must never break the serving path
                    tel.on_batch(
                        counters.copy(), n_topics=len(topics),
                        submit_ns=t1 - t0, step_ns=t3 - t2,
                        decode_ns=time.monotonic_ns() - t3,
                        t_submit_ns=t0, t_collect_ns=t3)
                except Exception:  # noqa: BLE001 — observe-plane bug
                    pass
            return res
        finally:
            with self._mlock:
                self.index.end_inflight()
                if event is not None:
                    self._pinned_free.setdefault(
                        outs[0].shape[0], []).append(outs)

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
