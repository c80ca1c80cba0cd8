from emqx_tpu_torch.ops.fanout import bitmap_to_counts, fanout_bitmaps, \
    fanout_pool
from emqx_tpu_torch.ops.trie_match import (
    DeviceTrie,
    compact_fids,
    compact_fids_sharded,
    device_trie,
    match_batch,
    match_batch_sharded,
    match_counts,
    stacked_device_trie,
)

__all__ = [
    "DeviceTrie",
    "bitmap_to_counts",
    "compact_fids",
    "compact_fids_sharded",
    "device_trie",
    "fanout_bitmaps",
    "fanout_pool",
    "match_batch",
    "match_batch_sharded",
    "match_counts",
    "stacked_device_trie",
]
