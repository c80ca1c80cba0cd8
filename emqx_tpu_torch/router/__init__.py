from emqx_tpu_torch.router.index import ShardedTrieIndex, TrieIndex
from emqx_tpu_torch.router.trie import Trie

__all__ = ["ShardedTrieIndex", "TrieIndex", "Trie"]
