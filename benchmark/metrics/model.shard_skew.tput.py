"""The sharded trie's shard skew: S times the matched fids of each batch's
fullest shard over all matched fids (the ``trie_shards``, ``shard_fids_max``
and ``matched_fids`` counters of a sharded model's decode), over the
window's batches.  1.0 is an even split; S would be every match in one
shard.  Silent on a flat trie, whose batches carry none of them."""

from benchmark.program_spans import counter, in_window


def read(run):
    batches = [b for b in in_window(run) if "trie_shards" in b.counters]
    fids = counter(batches, "matched_fids")
    if not fids:
        return None
    shards = batches[0].counters["trie_shards"]
    return shards * counter(batches, "shard_fids_max") / fids
