"""emqx_tpu_torch — the publish routing step of emqx_tpu on PyTorch and CUDA.

A port of the JAX package ``emqx_tpu`` (which stays as the reference) to
one NVIDIA H100: the host trie builder and tokenizer (flat and
subscription-sharded), the device step (trie walk → compact → dense-pool
fan-out → live patches, per shard on the stacked layout) as hand-written
CUDA kernels with plain-torch versions beside them, and the serving plane
around it (broker, publish pipeline, connection manager, kernel-telemetry
fold).  It imports neither JAX nor the JAX package.

Layout mirrors the reference: ``core`` (topic algebra, messages),
``router`` (host oracle trie, route table, device trie index), ``ops``
(kernels), ``models`` (the RouterModel step, its host wrapper and host
matcher), ``broker``, ``session``, ``mqtt`` (packet records) and
``observe`` (metrics, spans, the kernel fold).  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

from emqx_tpu_torch.models.router_model import RouterModel
from emqx_tpu_torch.ops.trie_match import device_trie, stacked_device_trie
from emqx_tpu_torch.router.index import ShardedTrieIndex, TrieIndex

__all__ = ["RouterModel", "ShardedTrieIndex", "TrieIndex", "device_trie",
           "stacked_device_trie"]
