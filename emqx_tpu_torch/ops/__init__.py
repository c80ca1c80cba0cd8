from emqx_tpu_torch.ops.fanout import fanout_pool
from emqx_tpu_torch.ops.trie_match import (
    DeviceTrie,
    compact_fids,
    device_trie,
    match_batch,
    match_counts,
)

__all__ = [
    "DeviceTrie",
    "compact_fids",
    "device_trie",
    "fanout_pool",
    "match_batch",
    "match_counts",
]
