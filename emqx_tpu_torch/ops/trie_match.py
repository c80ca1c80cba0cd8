"""Batched wildcard-trie match on the card: the K-capped frontier walk.

Port of the JAX package's ``ops/trie_match.py``.  A ``[B, L]`` batch of
tokenized topics walks the flat trie of ``router.index.TrieIndex`` level by
level; the frontier at level *i* holds the (≤K) trie nodes whose path
matches the first *i* words.  Each level emits ``hash_fid`` of every live
node (a ``prefix/#`` filter matches any remaining suffix), at end of topic
``node_fid``, then advances through the exact child (≤``max_probes``
double-hash probes of the edge table) and the ``+`` child, keeping the K
largest node ids.  Every matching filter id is emitted exactly once per
topic (the trie is a tree), so the output needs masking but no dedup.

On the card the trie is two tables of 16-byte int32 records (``DeviceTrie``:
edge-table slots and nodes), so the walk reads a probe round or a node with
one load.  The walk has three output modes: the reference's candidate block
(``match_batch``); compacted as it walks (``match_compact``: the first M
matches in the order ``compact_fids`` would keep them), which is what the
routing step runs; and counted only (``match_counts``), with no row.

The sharded trie (``router.index.ShardedTrieIndex``) stacks S per-shard
tries into ``[S, H, 4]`` / ``[S, N, 4]`` records: one walk launch covers
every shard; ``compact_sharded`` merges a candidate block's shard-local
results into global fids, and ``match_compact_sharded`` does the same
inside the walk's launch.

Each function has a hand-written CUDA kernel (``csrc/router_kernels.cu``)
and a plain-torch version beside it with the same integer semantics.  A
wrapper given CUDA tensors launches the kernel or raises; given CPU tensors
it runs the plain version.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from emqx_tpu_torch.ops import _build
from emqx_tpu_torch.router.index import PAD

# the per-batch counters vector's field order (same order as the JAX
# package's KERNEL_COUNTER_FIELDS, which its observe plane decodes)
KERNEL_COUNTER_FIELDS = (
    "frontier_peak",   # max per-topic frontier occupancy over all steps (≤K)
    "probe_iters",     # total live edge-hash probe-loop iterations
    "cand_pre",        # valid candidate fids before the M compact
    "cand_post",       # candidate fids surviving the M compact
    "compact_peak",    # max per-topic compact-slot occupancy (M utilization)
    "overflow_rows",   # topics whose K frontier spilled (incomplete match)
    "trunc_rows",      # topics truncated by the M compact
)

_M32 = 0xFFFFFFFF


def pack_counters(**fields_) -> torch.Tensor:
    """Stack the named counter values in KERNEL_COUNTER_FIELDS order into
    an int32 ``[C]`` (``[S, C]`` for per-shard ``[S]`` values).
    Keyword-only, so no caller can permute the layout."""
    if set(fields_) != set(KERNEL_COUNTER_FIELDS):
        missing = set(KERNEL_COUNTER_FIELDS) - set(fields_)
        extra = set(fields_) - set(KERNEL_COUNTER_FIELDS)
        raise TypeError(
            f"pack_counters field mismatch: missing={sorted(missing)} "
            f"extra={sorted(extra)}")
    vals = [torch.as_tensor(fields_[n]).to(torch.int32)
            for n in KERNEL_COUNTER_FIELDS]
    return torch.stack(torch.broadcast_tensors(*vals), dim=-1)


# the six TrieIndexArrays fields: (record tensor, column) of each
_COLUMNS = {
    "ht_parent": ("edges", 0),
    "ht_word": ("edges", 1),
    "ht_child": ("edges", 2),
    "plus_child": ("nodes", 0),
    "hash_fid": ("nodes", 1),
    "node_fid": ("nodes", 2),
}
TRIE_FIELDS = tuple(_COLUMNS)


def _column(name: str):
    rec, col = _COLUMNS[name]
    return property(lambda self: getattr(self, rec)[..., col],
                    doc=f"{name}: column {col} of {rec}, a view")


@dataclass(frozen=True)
class DeviceTrie:
    """The trie on one device as int32 records, one 16-byte load each in
    the walk: edge-table slot ``s`` is ``edges[s] = (parent, word, child,
    -1)`` (parent -1 = empty slot) and node ``n`` is ``nodes[n] =
    (plus_child, hash_fid, node_fid, -1)``; ``[S, H, 4]`` / ``[S, N, 4]``
    when stacked.  The six TrieIndexArrays fields are column views
    (``trie.ht_parent`` is ``edges[..., 0]``), so writing through one
    writes the record."""

    edges: torch.Tensor   # [H, 4] or [S, H, 4]
    nodes: torch.Tensor   # [N, 4] or [S, N, 4]

    ht_parent = _column("ht_parent")
    ht_word = _column("ht_word")
    ht_child = _column("ht_child")
    plus_child = _column("plus_child")
    hash_fid = _column("hash_fid")
    node_fid = _column("node_fid")

    def flat_fields(self) -> list[torch.Tensor]:
        """The six fields in TRIE_FIELDS order as 1-d views over every
        shard's rows (element stride 4): where patch offsets point."""
        return [getattr(self, rec).view(-1, 4)[:, col]
                for rec, col in _COLUMNS.values()]


def _records(arrays, names: tuple, rows: int) -> np.ndarray:
    """``[rows, 4]`` int32 records of three fields of ``arrays``, -1 in the
    fourth column and in the rows past the fields' own length."""
    out = np.full((rows, 4), -1, np.int32)
    for col, n in enumerate(names):
        x = np.asarray(getattr(arrays, n), np.int32)
        out[: x.shape[0], col] = x
    return out


_EDGE_FIELDS = TRIE_FIELDS[:3]
_NODE_FIELDS = TRIE_FIELDS[3:]


def device_trie(arrays, device=None) -> DeviceTrie:
    """Upload any object with the six numpy trie fields (this package's
    TrieIndexArrays or the JAX package's) as records — always a copy, so
    the host index can keep patching its arrays in place."""
    dev = _build.resolve_device(device)
    H = arrays.ht_parent.shape[0]
    N = arrays.plus_child.shape[0]
    return DeviceTrie(
        edges=torch.from_numpy(_records(arrays, _EDGE_FIELDS, H)).to(dev),
        nodes=torch.from_numpy(_records(arrays, _NODE_FIELDS, N)).to(dev))


def stacked_device_trie(shard_arrays, device=None) -> DeviceTrie:
    """Stack S per-shard trie arrays (this package's TrieIndexArrays or the
    JAX package's) into one DeviceTrie of contiguous ``[S, H, 4]`` /
    ``[S, N, 4]`` int32 records on the device — always a copy.

    The edge tables must already share one pow2 size H (the walk uses one
    probe mask for all shards; ``ShardedTrieIndex.ensure()`` equalizes
    them), else this raises.  Node records pad to the largest N with -1:
    the walk never reaches a node id at or past a shard's own N, and a -1
    child or fid reads as a miss, so the padding is invisible to it."""
    dev = _build.resolve_device(device)
    sizes = {a.ht_parent.shape[0] for a in shard_arrays}
    if len(sizes) != 1:
        raise ValueError(f"unequal edge-table sizes across shards: {sizes}")
    H = sizes.pop()
    N = max(a.plus_child.shape[0] for a in shard_arrays)
    edges = np.stack([_records(a, _EDGE_FIELDS, H) for a in shard_arrays])
    nodes = np.stack([_records(a, _NODE_FIELDS, N) for a in shard_arrays])
    return DeviceTrie(edges=torch.from_numpy(edges).to(dev),
                      nodes=torch.from_numpy(nodes).to(dev))


# ---------------------------------------------------------------------------
# plain-torch versions (CPU path; the card's reference for the kernels)
# ---------------------------------------------------------------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """uint32 wrap-around product of int64 x in [0, 2^32) and constant c,
    in 16-bit halves so no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def edge_hash(parent: torch.Tensor, word: torch.Tensor,
              mask: int) -> torch.Tensor:
    """Bit-identical to router.index.edge_hash, in int64 masked to 32 bits
    (torch has no uint32 shift on the CPU)."""
    h = _mul32(parent.long() & _M32, 0x9E3779B1) ^ _mul32(
        word.long() & _M32, 0x85EBCA77)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x2C1B3C6D)
    h = h ^ (h >> 12)
    return h & mask


def edge_step(parent: torch.Tensor, word: torch.Tensor,
              mask: int) -> torch.Tensor:
    """Bit-identical to router.index.edge_step (odd stride)."""
    h = _mul32(parent.long() & _M32, 0xC2B2AE3D) ^ _mul32(
        word.long() & _M32, 0x27D4EB2F)
    h = h ^ (h >> 13)
    h = _mul32(h, 0x165667B1)
    h = h ^ (h >> 16)
    return (h | 1) & mask


def _probe_exact(trie: DeviceTrie, parent: torch.Tensor, word: torch.Tensor,
                 max_probes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact-edge lookup for [B, K] (parent, word) pairs; -1 on miss.
    Returns (child, live probe rounds per lane)."""
    hmask = trie.ht_parent.shape[0] - 1
    h = edge_hash(parent, word, hmask)
    step = edge_step(parent, word, hmask)
    child = torch.full_like(parent, -1)
    iters = torch.zeros_like(parent)
    done = parent < 0
    for p in range(max_probes):
        iters += (~done).to(torch.int32)
        s = (h + p * step) & hmask
        slot_parent = trie.ht_parent[s]
        hit = (slot_parent == parent) & (trie.ht_word[s] == word) & ~done
        child = torch.where(hit, trie.ht_child[s], child)
        done = done | hit | (slot_parent == -1)
    return child, iters


def match_batch_plain(trie: DeviceTrie, tokens: torch.Tensor,
                      lengths: torch.Tensor, sys_flags: torch.Tensor, *,
                      K: int = 32, max_probes: int = 8
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch walk.  Returns ``(cand [B, (L+1)*2K], stats [B, 4])``,
    stats = (frontier peak, probe rounds, valid candidates, overflow) per
    topic — exactly what the kernel writes."""
    B, L = tokens.shape
    dev = tokens.device
    toks = torch.cat(
        [tokens, torch.full((B, 1), PAD, dtype=tokens.dtype, device=dev)], 1)
    frontier = torch.full((B, K), -1, dtype=torch.int32, device=dev)
    frontier[:, 0] = 0                                   # root
    overflow = torch.zeros(B, dtype=torch.bool, device=dev)
    peak = torch.zeros(B, dtype=torch.int32, device=dev)
    probes = torch.zeros(B, dtype=torch.int32, device=dev)
    hash_ems, end_ems = [], []
    for i in range(L + 1):
        valid = frontier >= 0
        peak = torch.maximum(peak, valid.sum(1, dtype=torch.int32))
        node = torch.where(valid, frontier, 0).long()
        active = (i <= lengths)[:, None]
        ended = (i == lengths)[:, None]
        advancing = (i < lengths)[:, None]
        sys_block = (sys_flags & (i == 0))[:, None]
        hash_ems.append(torch.where(valid & active & ~sys_block,
                                    trie.hash_fid[node], -1))
        end_ems.append(torch.where(valid & ended, trie.node_fid[node], -1))
        word = toks[:, i:i + 1].expand(B, K)
        exact, iters = _probe_exact(
            trie, torch.where(advancing, frontier, -1), word, max_probes)
        probes += iters.sum(1, dtype=torch.int32)
        plus = torch.where(valid & advancing & ~sys_block,
                           trie.plus_child[node], -1)
        nxt = torch.cat([exact, plus], 1)
        overflow |= (nxt >= 0).sum(1) > K
        frontier = torch.sort(nxt, dim=1, descending=True).values[:, :K]
    cand = torch.cat([torch.stack(hash_ems, 1).reshape(B, -1),
                      torch.stack(end_ems, 1).reshape(B, -1)], 1)
    stats = torch.stack([peak, probes, (cand >= 0).sum(1, dtype=torch.int32),
                         overflow.to(torch.int32)], 1)
    return cand, stats


def compact_fids_plain(cand: torch.Tensor, *, M: int = 128
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    order = torch.argsort((cand < 0).to(torch.int8), dim=1, stable=True)
    packed = torch.gather(cand, 1, order[:, :M])
    return packed, (cand >= 0).sum(1) > M


def shard_trie(trie: DeviceTrie, s: int) -> DeviceTrie:
    """Shard ``s`` of a stacked trie, as views of its ``[S, ·, 4]`` rows."""
    return DeviceTrie(edges=trie.edges[s], nodes=trie.nodes[s])


def match_batch_sharded_plain(trie: DeviceTrie, tokens: torch.Tensor,
                              lengths: torch.Tensor, sys_flags: torch.Tensor,
                              *, K: int = 32, max_probes: int = 8
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain-torch walk of every shard of a stacked trie.  Returns
    ``(cand [S, B, (L+1)*2K], stats [S, B, 4])`` — exactly what the
    sharded kernel writes."""
    outs = [match_batch_plain(shard_trie(trie, s), tokens, lengths,
                              sys_flags, K=K, max_probes=max_probes)
            for s in range(trie.edges.shape[0])]
    return (torch.stack([c for c, _ in outs]),
            torch.stack([st for _, st in outs]))


def compact_sharded_plain(cand: torch.Tensor, *, M: int = 128,
                          n_shards: int = 1, shard_base: int = 0
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's two-stage sharded compact, written out: each shard
    compacts to ``min(M, C)``, local fids become ``local * n_shards +
    shard``, the rows merge shard-major into ``[B, S * min(M, C)]`` and a
    second stable compact keeps the first M.  Returns ``(fids, truncated,
    n [S, B])``, n = each shard's valid candidates.  ``cand``'s S shards
    are the global shards ``shard_base .. shard_base + S - 1`` (a mesh
    device's group; 0 on one device)."""
    S, B, _ = cand.shape
    per, trunc = zip(*(compact_fids_plain(cand[s], M=M) for s in range(S)))
    per = torch.stack(per)
    shard_ids = shard_base + torch.arange(S, dtype=per.dtype,
                                          device=per.device)
    per = torch.where(per >= 0, per * n_shards + shard_ids[:, None, None],
                      -1)
    merged = per.permute(1, 0, 2).reshape(B, -1)
    fids, trunc2 = compact_fids_plain(merged, M=M)
    return (fids, torch.stack(trunc).any(0) | trunc2,
            (cand >= 0).sum(2, dtype=torch.int32))


def match_counts_plain(trie: DeviceTrie, tokens: torch.Tensor,
                       lengths: torch.Tensor, sys_flags: torch.Tensor, *,
                       K: int = 32, max_probes: int = 8
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain walk, then its candidate block reduced to a count per
    topic: ``(counts [B] int32, overflow [B] bool)``, as the reference's
    ``match_counts`` computes it."""
    cand, stats = match_batch_plain(trie, tokens, lengths, sys_flags, K=K,
                                    max_probes=max_probes)
    return (cand >= 0).sum(1, dtype=torch.int32), stats[:, 3] != 0


def match_compact_plain(trie: DeviceTrie, tokens: torch.Tensor,
                        lengths: torch.Tensor, sys_flags: torch.Tensor, *,
                        K: int = 32, M: int = 128, max_probes: int = 8
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain walk, then the plain compact: ``(fids [B, min(M, C)],
    stats [B, 4])`` — exactly what the walk's compacted mode writes (stats
    as the walk's, n uncapped, so truncated = n > M)."""
    cand, stats = match_batch_plain(trie, tokens, lengths, sys_flags, K=K,
                                    max_probes=max_probes)
    return compact_fids_plain(cand, M=M)[0], stats


def match_compact_sharded_plain(trie: DeviceTrie, tokens: torch.Tensor,
                                lengths: torch.Tensor,
                                sys_flags: torch.Tensor, *, n_shards: int,
                                K: int = 32, M: int = 128,
                                max_probes: int = 8, shard_base: int = 0
                                ) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """The plain sharded walk, then the plain two-stage sharded compact:
    ``(fids [B, min(M, S·min(M, C))], stats [S, B, 4], truncated [B])``;
    the trie's S shards are the global ``shard_base ..`` (a mesh
    device's group)."""
    cand, stats = match_batch_sharded_plain(trie, tokens, lengths, sys_flags,
                                            K=K, max_probes=max_probes)
    fids, truncated, _ = compact_sharded_plain(
        cand, M=M, n_shards=n_shards, shard_base=shard_base)
    return fids, stats, truncated


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def match_batch_stats(trie: DeviceTrie, tokens: torch.Tensor,
                      lengths: torch.Tensor, sys_flags: torch.Tensor, *,
                      K: int = 32, max_probes: int = 8
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(cand, stats)`` from the trie-walk kernel for CUDA tensors, from
    :func:`match_batch_plain` for CPU tensors."""
    if not tokens.is_cuda:
        return match_batch_plain(trie, tokens, lengths, sys_flags, K=K,
                                 max_probes=max_probes)
    dev, B, L, H, _, _ = _check_walk(trie, tokens, lengths, sys_flags, K,
                                     max_probes, stacked=False)
    cand = torch.empty((B, (L + 1) * 2 * K), dtype=torch.int32, device=dev)
    stats = torch.empty((B, 4), dtype=torch.int32, device=dev)
    _build.KERNELS["trie_walk"](
        trie.edges.data_ptr(), trie.nodes.data_ptr(), H - 1,
        tokens.data_ptr(), lengths.data_ptr(), sys_flags.data_ptr(),
        B, L, K, max_probes, cand.data_ptr(), stats.data_ptr(), device=dev)
    return cand, stats


def _check_walk(trie: DeviceTrie, tokens, lengths, sys_flags, K: int,
                max_probes: int, *, stacked: bool):
    """Raise unless the walk kernel takes these arguments; returns
    ``(device, B, L, H, N, S)`` (S = 1 unstacked).  A stacked trie has
    ``[S, H, 4]`` edge and ``[S, N, 4]`` node records with one S."""
    dev = tokens.device
    if tokens.dim() != 2:
        raise ValueError(f"tokens must be [B, L], got {tuple(tokens.shape)}")
    B, L = tokens.shape
    if not 1 <= K <= 32:
        raise ValueError(f"the trie-walk kernel holds K ≤ 32 frontier slots "
                         f"(one warp), got K={K}")
    if max_probes < 1 or B < 1:
        raise ValueError(f"need max_probes ≥ 1 and B ≥ 1 "
                         f"(got {max_probes}, {B})")
    for n in ("edges", "nodes"):
        t = getattr(trie, n)
        _build.check_tensor(t, n, torch.int32, 3 if stacked else 2, dev)
        if t.shape[-1] != 4 or t.data_ptr() % 16:
            raise ValueError(f"{n} must hold 16-byte aligned [·, 4] int32 "
                             f"records, got {tuple(t.shape)}")
    H, N = trie.edges.shape[-2], trie.nodes.shape[-2]
    if H & (H - 1) or H > 2 ** 31:
        raise ValueError(f"edge table size {H} must be a power of two")
    S = trie.edges.shape[0] if stacked else 1
    if stacked and (not 1 <= S <= 65535 or trie.nodes.shape[0] != S):
        raise ValueError("a stacked trie needs [S, H, 4] edge and "
                         "[S, N, 4] node records with one S in [1, 65535]")
    _build.check_tensor(tokens, "tokens", torch.int32, 2, dev)
    _build.check_tensor(lengths, "lengths", torch.int32, 1, dev)
    _build.check_tensor(sys_flags, "sys_flags", torch.bool, 1, dev)
    if lengths.shape[0] != B or sys_flags.shape[0] != B:
        raise ValueError("lengths / sys_flags must be [B]")
    return dev, B, L, H, N, S


def match_batch(trie: DeviceTrie, tokens: torch.Tensor,
                lengths: torch.Tensor, sys_flags: torch.Tensor, *,
                K: int = 32, max_probes: int = 8
                ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Match a topic batch against the trie.

    Returns ``(cand [B, (L+1)*2K] int32, overflow [B] bool, mstats)``.
    ``cand`` holds each matched filter id exactly once, -1 elsewhere;
    ``overflow[b]`` means topic *b*'s frontier exceeded K (the match may be
    incomplete — route it through the host oracle).  ``mstats`` is the
    match half of the counters: 0-d int32 tensors frontier_peak,
    probe_iters, cand_pre and overflow_rows.
    """
    cand, stats = match_batch_stats(trie, tokens, lengths, sys_flags, K=K,
                                    max_probes=max_probes)
    mstats = {
        "frontier_peak": stats[:, 0].max(),
        "probe_iters": stats[:, 1].sum(dtype=torch.int32),
        "cand_pre": stats[:, 2].sum(dtype=torch.int32),
        "overflow_rows": stats[:, 3].sum(dtype=torch.int32),
    }
    return cand, stats[:, 3] != 0, mstats


def match_counts(trie: DeviceTrie, tokens: torch.Tensor,
                 lengths: torch.Tensor, sys_flags: torch.Tensor, *,
                 K: int = 32, max_probes: int = 8
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Matched-filter count per topic (the LookupRps analogue): the full
    walk with only the reduction kept.  Returns ``(counts [B] int32,
    overflow [B] bool)``, overflow = the topic's K spill.

    CUDA tensors take one launch of the count-only walk (``walk_count``:
    no candidate block, no reduction pass); CPU tensors
    :func:`match_counts_plain`.  Flat trie only, as the reference's."""
    if not tokens.is_cuda:
        return match_counts_plain(trie, tokens, lengths, sys_flags, K=K,
                                  max_probes=max_probes)
    dev, B, L, H, _, _ = _check_walk(trie, tokens, lengths, sys_flags, K,
                                     max_probes, stacked=False)
    counts = torch.empty(B, dtype=torch.int32, device=dev)
    overflow = torch.empty(B, dtype=torch.bool, device=dev)
    _build.KERNELS["walk_count"](
        trie.edges.data_ptr(), trie.nodes.data_ptr(), H - 1,
        tokens.data_ptr(), lengths.data_ptr(), sys_flags.data_ptr(),
        B, L, K, max_probes, counts.data_ptr(), overflow.data_ptr(),
        device=dev)
    return counts, overflow


def compact_fids(cand: torch.Tensor, *, M: int = 128
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Compact sparse candidates [B, C] to the first M matches, stable.

    Returns (fids [B, min(M, C)] padded with -1, truncated [B] bool).
    """
    if not cand.is_cuda:
        return compact_fids_plain(cand, M=M)
    dev = cand.device
    _build.check_tensor(cand, "cand", torch.int32, 2, dev)
    B, C = cand.shape
    if B < 1 or M < 1:
        raise ValueError(f"need B ≥ 1 and M ≥ 1 (got {B}, {M})")
    width = min(M, C)
    fids = torch.empty((B, width), dtype=torch.int32, device=dev)
    truncated = torch.empty(B, dtype=torch.bool, device=dev)
    _build.KERNELS["compact"](cand.data_ptr(), B, C, width, fids.data_ptr(),
                              truncated.data_ptr(), device=dev)
    return fids, truncated


# ---------------------------------------------------------------------------
# the sharded trie: S per-shard tries stacked into [S, ...] tensors
# ---------------------------------------------------------------------------


def match_batch_sharded_stats(trie: DeviceTrie, tokens: torch.Tensor,
                              lengths: torch.Tensor, sys_flags: torch.Tensor,
                              *, K: int = 32, max_probes: int = 8
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(cand [S, B, C], stats [S, B, 4])`` from the sharded trie-walk
    kernel (one launch, the shard a grid dimension) for CUDA tensors, from
    :func:`match_batch_sharded_plain` for CPU tensors."""
    if not tokens.is_cuda:
        return match_batch_sharded_plain(trie, tokens, lengths, sys_flags,
                                         K=K, max_probes=max_probes)
    dev, B, L, H, N, S = _check_walk(trie, tokens, lengths, sys_flags, K,
                                     max_probes, stacked=True)
    cand = torch.empty((S, B, (L + 1) * 2 * K), dtype=torch.int32,
                       device=dev)
    stats = torch.empty((S, B, 4), dtype=torch.int32, device=dev)
    _build.KERNELS["trie_walk_sharded"](
        trie.edges.data_ptr(), trie.nodes.data_ptr(), H - 1, H, N,
        tokens.data_ptr(), lengths.data_ptr(), sys_flags.data_ptr(),
        B, L, K, max_probes, S, cand.data_ptr(), stats.data_ptr(),
        device=dev)
    return cand, stats


def match_batch_sharded(trie: DeviceTrie, tokens: torch.Tensor,
                        lengths: torch.Tensor, sys_flags: torch.Tensor, *,
                        K: int = 32, max_probes: int = 8
                        ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """:func:`match_batch` over every shard of a stacked trie.

    Each shard walks the same topic batch against its own subscriptions,
    so ``cand`` holds shard-LOCAL fids.  Overflow is per shard (a shard's
    K-frontier can spill where the flat trie's would not, and the other way
    round); the returned ``[B]`` flag is their OR, since any spilled shard
    leaves the merged match incomplete.

    Returns ``(cand [S, B, (L+1)*2K], overflow [B], mstats)``; every mstats
    leaf is a per-shard ``[S]`` int32 vector, overflow_rows counted before
    the OR."""
    cand, stats = match_batch_sharded_stats(trie, tokens, lengths,
                                            sys_flags, K=K,
                                            max_probes=max_probes)
    mstats = {
        "frontier_peak": stats[:, :, 0].max(1).values,
        "probe_iters": stats[:, :, 1].sum(1, dtype=torch.int32),
        "cand_pre": stats[:, :, 2].sum(1, dtype=torch.int32),
        "overflow_rows": stats[:, :, 3].sum(1, dtype=torch.int32),
    }
    return cand, (stats[:, :, 3] != 0).any(0), mstats


def compact_sharded(cand: torch.Tensor, *, M: int = 128, n_shards: int = 1
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-shard compact, ``local * n_shards + shard`` translation,
    shard-major merge and second compact in one kernel launch for a CUDA
    ``cand [S, B, C]``, :func:`compact_sharded_plain` for a CPU one.

    Returns ``(fids [B, min(M, S * min(M, C))], truncated [B], n [S, B])``:
    global fids padded with -1; truncated = any shard kept fewer than its
    valid candidates, or the merge held more than M; n = each shard's valid
    candidates, from which the step's counters take ``min(n, M)``."""
    if not cand.is_cuda:
        return compact_sharded_plain(cand, M=M, n_shards=n_shards)
    dev = cand.device
    _build.check_tensor(cand, "cand", torch.int32, 3, dev)
    S, B, C = cand.shape
    if S < 1 or B < 1 or C < 1 or M < 1 or n_shards < 1:
        raise ValueError(f"need S, B, C, M, n_shards ≥ 1 (got {S}, {B}, "
                         f"{C}, {M}, {n_shards})")
    width = min(M, S * min(M, C))
    fids = torch.empty((B, width), dtype=torch.int32, device=dev)
    truncated = torch.empty(B, dtype=torch.bool, device=dev)
    n = torch.empty((S, B), dtype=torch.int32, device=dev)
    _build.KERNELS["compact_sharded"](
        cand.data_ptr(), S, B, C, M, width, n_shards, fids.data_ptr(),
        truncated.data_ptr(), n.data_ptr(), device=dev)
    return fids, truncated, n


def compact_fids_sharded(cand: torch.Tensor, *, M: int = 128,
                         n_shards: int = 1
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-shard compact + local→global translation + merge: the
    reference's ``compact_fids_sharded``.  Returns ``(fids [B, M] global,
    truncated [B])``; for S=1 it equals :func:`compact_fids` bit for bit.
    Where C < M the widths follow the two stages (per shard min(M, C),
    merged S·min(M, C), out min(M, S·min(M, C)))."""
    fids, truncated, _ = compact_sharded(cand, M=M, n_shards=n_shards)
    return fids, truncated


# ---------------------------------------------------------------------------
# the routing step's walk: compacted as it walks, no candidate block
# ---------------------------------------------------------------------------


def compact_width(L: int, K: int, M: int, S: int = 1) -> int:
    """Columns of the compacting walk's fids: each shard keeps ``width =
    min(M, (L+1)·2K)``, and the merge of S shards ``min(M, S·width)`` (the
    flat walk's is S = 1's, ``width``)."""
    return min(M, S * min(M, (L + 1) * 2 * K))


class StepOut(NamedTuple):
    """What the routing step's walk writes beside its fids, in its
    epilogue: the returned ``fids [B, R]``, ``R = min(cap, the walk's
    width)``, or None for no trimmed fids (a mesh device's group walk,
    whose trim is the mesh step's); ``overflow [B]`` bool = the topic's K spill, its truncation,
    or more than ``cap`` fids kept; ``acc``, int32 ``[S·C + 1]``: the
    ``[S, C]`` counters (``[C]`` flat) in KERNEL_COUNTER_FIELDS order, then
    the fan-out's fan_any word, or ``[1]``, the fan_any word alone, for a
    step with its counters off.  The walk's entry zeroes ``acc`` before its
    launch, on the same stream.  ``cap`` is ``ret_cap`` where it trims, else
    M."""

    fids: Optional[torch.Tensor]
    overflow: torch.Tensor
    acc: torch.Tensor
    cap: int


def _step_args(step: Optional[StepOut], B: int, S: int, out_w: int,
               dev: torch.device) -> tuple:
    """The walk entry's ``(cap, R, fids, overflow, acc, counters_on)``
    arguments: zeros and null pointers without a step; raises unless the
    step's tensors are what its epilogue writes.  ``acc`` of ``S·C + 1``
    words packs the counters, of 1 word (the fan_any word alone) does
    not."""
    if step is None:
        return 0, 0, None, None, None, 0
    fids = step.fids
    if fids is not None:
        _build.check_tensor(fids, "step fids", torch.int32, 2, dev)
    _build.check_tensor(step.overflow, "step overflow", torch.bool, 1, dev)
    _build.check_tensor(step.acc, "step acc", torch.int32, 1, dev)
    R = 0 if fids is None else fids.shape[1]
    C = len(KERNEL_COUNTER_FIELDS)
    if ((fids is not None and (fids.shape[0] != B
                               or R != min(step.cap, out_w)))
            or step.overflow.shape[0] != B
            or step.acc.shape[0] not in (S * C + 1, 1) or step.cap < 0):
        raise ValueError(
            f"step outputs must be fids [{B}, min(cap, {out_w})] or None, "
            f"overflow [{B}] and acc [{S * C + 1}] (counters on) or [1] "
            f"(off) with cap >= 0; got "
            f"{None if fids is None else tuple(fids.shape)}, "
            f"{tuple(step.overflow.shape)}, {tuple(step.acc.shape)}, "
            f"cap={step.cap}")
    return (step.cap, R, None if fids is None else fids.data_ptr(),
            step.overflow.data_ptr(), step.acc.data_ptr(),
            int(step.acc.shape[0] == S * C + 1))


def launch_walk_compact(trie: DeviceTrie, tokens: torch.Tensor,
                        lengths: torch.Tensor, sys_flags: torch.Tensor, *,
                        K: int, M: int, max_probes: int,
                        step: Optional[StepOut] = None
                        ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch of the flat compacting walk on CUDA tensors: ``(fids [B,
    min(M, C)], stats [B, 4])``, or with a ``step`` the fids and None (the
    epilogue writes the step's outputs instead of the stats)."""
    dev, B, L, H, _, _ = _check_walk(trie, tokens, lengths, sys_flags, K,
                                     max_probes, stacked=False)
    if not tokens.is_cuda or M < 1:
        raise ValueError(f"the walk kernel takes CUDA tensors and M ≥ 1 "
                         f"(got {tokens.device}, M={M})")
    width = compact_width(L, K, M)
    fids = torch.empty((B, width), dtype=torch.int32, device=dev)
    stats = (None if step is not None
             else torch.empty((B, 4), dtype=torch.int32, device=dev))
    _build.KERNELS["walk_compact"](
        trie.edges.data_ptr(), trie.nodes.data_ptr(), H - 1,
        tokens.data_ptr(), lengths.data_ptr(), sys_flags.data_ptr(),
        B, L, K, max_probes, M, width, fids.data_ptr(),
        None if stats is None else stats.data_ptr(),
        *_step_args(step, B, 1, width, dev), device=dev)
    return fids, stats


def launch_walk_compact_sharded(
        trie: DeviceTrie, tokens: torch.Tensor, lengths: torch.Tensor,
        sys_flags: torch.Tensor, *, n_shards: int, K: int, M: int,
        max_probes: int, step: Optional[StepOut] = None,
        shard_base: int = 0
) -> tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One launch of the stacked compacting walk on CUDA tensors: ``(fids
    [B, min(M, S·min(M, C))], stats [S, B, 4], truncated [B])``, or with a
    ``step`` the fids and two Nones (the epilogue writes the step's
    outputs, its counters per shard).

    The trie's S shards are the global shards ``shard_base ..
    shard_base + S - 1`` of ``n_shards`` (the fid translation is ``local *
    n_shards + shard_base + s``).  A mesh device's share of the stacked
    trie launches with a step of no fids and ``cap = M``: its epilogue
    then writes the group's K spill or truncation and its counters, and
    the final trim and overflow are the mesh step's."""
    dev, B, L, H, N, S = _check_walk(trie, tokens, lengths, sys_flags, K,
                                     max_probes, stacked=True)
    if not tokens.is_cuda or 32 * S > 1024 or M < 1 or n_shards < 1:
        raise ValueError(f"the compacted sharded walk takes CUDA tensors and "
                         f"puts a topic's S warps in one block: need 32·S ≤ "
                         f"1024, M ≥ 1 and n_shards ≥ 1 (got {tokens.device}, "
                         f"S={S}, M={M}, n_shards={n_shards})")
    if not 0 <= shard_base <= n_shards - S:
        raise ValueError(f"shards {shard_base} .. {shard_base + S - 1} lie "
                         f"outside the {n_shards} shards")
    width = compact_width(L, K, M)
    out_w = compact_width(L, K, M, S)
    fids = torch.empty((B, out_w), dtype=torch.int32, device=dev)
    stats = truncated = None
    if step is None:
        stats = torch.empty((S, B, 4), dtype=torch.int32, device=dev)
        truncated = torch.empty(B, dtype=torch.bool, device=dev)
    _build.KERNELS["walk_compact_sharded"](
        trie.edges.data_ptr(), trie.nodes.data_ptr(), H - 1, H, N,
        tokens.data_ptr(), lengths.data_ptr(), sys_flags.data_ptr(),
        B, L, K, max_probes, S, M, width, out_w, n_shards, shard_base,
        fids.data_ptr(), None if stats is None else stats.data_ptr(),
        None if truncated is None else truncated.data_ptr(),
        *_step_args(step, B, S, out_w, dev), device=dev)
    return fids, stats, truncated


def match_compact(trie: DeviceTrie, tokens: torch.Tensor,
                  lengths: torch.Tensor, sys_flags: torch.Tensor, *,
                  K: int = 32, M: int = 128, max_probes: int = 8
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`match_batch` then :func:`compact_fids` as one walk kernel in
    its compacted mode for CUDA tensors (each warp appends its matches to
    its fids row as it walks), :func:`match_compact_plain` for CPU ones.

    Returns ``(fids [B, min(M, C)] padded with -1, stats [B, 4])``,
    ``C = (L+1)·2K``, stats = (frontier peak, probe rounds, valid
    candidates n, overflow) per topic; truncated = n > M."""
    if not tokens.is_cuda:
        return match_compact_plain(trie, tokens, lengths, sys_flags, K=K,
                                   M=M, max_probes=max_probes)
    return launch_walk_compact(trie, tokens, lengths, sys_flags, K=K, M=M,
                               max_probes=max_probes)


def match_compact_sharded(trie: DeviceTrie, tokens: torch.Tensor,
                          lengths: torch.Tensor, sys_flags: torch.Tensor, *,
                          n_shards: int, K: int = 32, M: int = 128,
                          max_probes: int = 8, shard_base: int = 0
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """:func:`match_batch_sharded` then :func:`compact_sharded` as one walk
    kernel in its compacted mode for CUDA tensors (the S warps of a topic
    share a block and merge their shard segments through shared memory),
    :func:`match_compact_sharded_plain` for CPU ones.

    Returns ``(fids [B, min(M, S·min(M, C))] global, stats [S, B, 4],
    truncated [B])``: truncated = some shard's n > M, or the merge held
    more than M.  The trie's shards are the global ``shard_base ..`` of
    ``n_shards`` (a mesh device's group)."""
    if not tokens.is_cuda:
        return match_compact_sharded_plain(
            trie, tokens, lengths, sys_flags, n_shards=n_shards, K=K, M=M,
            max_probes=max_probes, shard_base=shard_base)
    return launch_walk_compact_sharded(
        trie, tokens, lengths, sys_flags, n_shards=n_shards, K=K, M=M,
        max_probes=max_probes, shard_base=shard_base)
