from emqx_tpu_torch.router.index import ShardedTrieIndex, TrieIndex
from emqx_tpu_torch.router.trie import Trie
from emqx_tpu_torch.router.router import Router

__all__ = ["ShardedTrieIndex", "TrieIndex", "Trie", "Router"]
