"""The system under test, built from a configuration file: the port's app
booted as a deployment boots it (``BrokerApp.from_config`` on the
configuration's HOCON, no listeners), so every configuration runs the same
``Broker``, ``CM``, hooks and ``PublishPipeline``.

The app's ``router.device`` block builds a flat trie on the card.  A
configuration with ``trie_shards`` gets a ``RouterModel`` over a
``ShardedTrieIndex`` of that many tries, built from the same block and
handed to the app (its ``router_model`` override).  On the CPU every
model is built here and handed over the same way, since the block builds
its model on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass
class System:
    broker: Any
    cm: Any
    pipe: Any
    model: Any
    fold: Any                  # the model's telemetry hook, or None
    app: Any = None


def hocon(conf: dict, data_dir: str) -> str:
    """The configuration as the app reads it: the node and the configuration
    file's ``router_device`` block."""
    block = ", ".join(f"{k} = {str(v).lower() if isinstance(v, bool) else v}"
                      for k, v in conf["router_device"].items())
    return (f'node {{ name = "n1@127.0.0.1", data_dir = "{data_dir}" }}\n'
            f"router.device {{ {block} }}\n")


def _device_conf(conf: dict, data_dir: str):
    from emqx_tpu_torch.config.config import Config
    c = Config()
    c.init_load(hocon(conf, data_dir))
    return c


def _model(c, index, device):
    from emqx_tpu_torch.models.router_model import RouterModel
    return RouterModel(index,
                       n_sub_slots=int(c.get("router.device.n_sub_slots")),
                       K=int(c.get("router.device.frontier_k")),
                       M=int(c.get("router.device.match_cap")),
                       ret_cap=int(c.get("router.device.return_cap")),
                       device=device)


def build(conf: dict, device: str, data_dir: str) -> System:
    """``device`` is ``"cuda"`` for a measured run; the CPU tests pass
    ``"cpu"``, which runs the kernels' plain versions."""
    import torch

    from emqx_tpu_torch.app import BrokerApp
    from emqx_tpu_torch.router.index import ShardedTrieIndex, TrieIndex
    c = _device_conf(conf, data_dir)
    levels = int(c.get("router.device.max_levels"))
    shards = int(conf.get("trie_shards", 0))
    overrides = {}
    if shards or torch.device(device).type != "cuda":
        index = (ShardedTrieIndex(shards, max_levels=levels) if shards
                 else TrieIndex(max_levels=levels))
        model = _model(c, index, device)
        model.refresh()
        overrides["router_model"] = model
    app = BrokerApp.from_config(c, **overrides)
    return System(app.broker, app.cm, app.pipeline, app.broker.model,
                  app.device_metrics, app)
