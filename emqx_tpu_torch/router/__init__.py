from emqx_tpu_torch.router.index import TrieIndex
from emqx_tpu_torch.router.trie import Trie

__all__ = ["TrieIndex", "Trie"]
