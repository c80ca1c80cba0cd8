"""emqx_tpu_torch — the publish routing step of emqx_tpu on PyTorch and CUDA.

A port of the JAX package ``emqx_tpu`` (which stays as the reference) to
one NVIDIA H100: the host trie builder and tokenizer (flat and
subscription-sharded), the device step (trie walk → compact → dense-pool
fan-out → live patches, per shard on the stacked layout) as hand-written
CUDA kernels with plain-torch versions beside them, the serving plane
around it (broker, publish pipeline, connection manager, kernel-telemetry
fold), the network entry above that (MQTT codec, channel FSM,
limiter, TCP/WS/TLS server, client), the services beside the broker
(the rule engine co-batched on the step, shared subscriptions, the
retainer, delayed publish, alarms, stats, ``$SYS``, Prometheus), and the
app that assembles them from a HOCON config (``app.BrokerApp.from_config``:
config, access control, overload protection, the hook services,
listeners, bridges, the gateway context), with persistent sessions, the
management API, the connectors, the DB-backed access backends, the
exhook, the protocol gateways and the cluster plane on it, and the native
plane beside it (``native``: the C++ epoll host built with g++ into
``_build/native``; ``broker.native_server``: ``NativeBrokerServer``,
whose device lane batches publishes through the step).  It imports
neither JAX nor the JAX package.

Layout mirrors the reference: ``core`` (topic algebra, messages),
``router`` (host oracle trie, route table, device trie index), ``ops``
(kernels), ``models`` (the RouterModel step, its host wrapper and host
matcher), ``broker`` (also listeners and overload protection),
``session``, ``mqtt`` (packet records, codec, client), ``observe``
(metrics, spans, the kernel fold, alarms, stats, ``$SYS``, the exposition,
sysmon, statsd, the dashboard monitor, log formats), ``rules``,
``services``, ``utils`` (jq, replayq, snappy), ``config``, ``access``,
``resource``, ``bridge``, ``gateway``, ``mgmt``, ``connector``, ``exhook``,
``cluster``, ``native``, ``app`` and ``entry`` (the entry points:
``entry()``, ``dryrun_multichip``).  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""

import importlib

# the package's top-level names, imported on first use: a process that
# needs only a torch-free part (the native plane's bindings, the codec)
# does not import torch
_EXPORTS = {"RouterModel": "models.router_model",
            "device_trie": "ops.trie_match",
            "stacked_device_trie": "ops.trie_match",
            "ShardedTrieIndex": "router.index", "TrieIndex": "router.index"}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(
        f"{__name__}.{_EXPORTS[name]}"), name)
    globals()[name] = value
    return value
