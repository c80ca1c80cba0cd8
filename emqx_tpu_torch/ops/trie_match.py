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

Each function has a hand-written CUDA kernel (``csrc/router_kernels.cu``)
and a plain-torch version beside it with the same integer semantics.  A
wrapper given CUDA tensors launches the kernel or raises; given CPU tensors
it runs the plain version.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

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


@dataclass(frozen=True)
class DeviceTrie:
    """The six TrieIndexArrays fields as int32 tensors on one device."""

    ht_parent: torch.Tensor   # [H], -1 = empty slot
    ht_word: torch.Tensor     # [H]
    ht_child: torch.Tensor    # [H]
    plus_child: torch.Tensor  # [N]
    hash_fid: torch.Tensor    # [N]
    node_fid: torch.Tensor    # [N]


TRIE_FIELDS = tuple(f.name for f in fields(DeviceTrie))


def device_trie(arrays, device=None) -> DeviceTrie:
    """Upload any object with the six numpy trie fields (this package's
    TrieIndexArrays or the JAX package's) — always a copy, so the host
    index can keep patching its arrays in place."""
    dev = _build.resolve_device(device)
    return DeviceTrie(**{
        n: torch.from_numpy(
            np.ascontiguousarray(getattr(arrays, n), np.int32)
        ).to(dev, copy=True)
        for n in TRIE_FIELDS})


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
    for n in TRIE_FIELDS:
        _build.check_tensor(getattr(trie, n), n, torch.int32, 1, dev)
    H = trie.ht_parent.shape[0]
    if H & (H - 1) or H > 2 ** 31 or trie.ht_word.shape[0] != H \
            or trie.ht_child.shape[0] != H:
        raise ValueError(f"edge table size {H} must be one power of two")
    _build.check_tensor(tokens, "tokens", torch.int32, 2, dev)
    _build.check_tensor(lengths, "lengths", torch.int32, 1, dev)
    _build.check_tensor(sys_flags, "sys_flags", torch.bool, 1, dev)
    if lengths.shape[0] != B or sys_flags.shape[0] != B:
        raise ValueError("lengths / sys_flags must be [B]")
    cand = torch.empty((B, (L + 1) * 2 * K), dtype=torch.int32, device=dev)
    stats = torch.empty((B, 4), dtype=torch.int32, device=dev)
    _build.KERNELS["trie_walk"](
        *(getattr(trie, n).data_ptr() for n in TRIE_FIELDS), H - 1,
        tokens.data_ptr(), lengths.data_ptr(), sys_flags.data_ptr(),
        B, L, K, max_probes, cand.data_ptr(), stats.data_ptr(), device=dev)
    return cand, stats


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
    walk with only the reduction kept."""
    cand, stats = match_batch_stats(trie, tokens, lengths, sys_flags, K=K,
                                    max_probes=max_probes)
    return (cand >= 0).sum(1, dtype=torch.int32), stats[:, 3] != 0


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
