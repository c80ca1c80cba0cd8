"""Data bridges — the ``emqx_bridge`` app."""

from emqx_tpu_torch.bridge.bridge import Bridge, BridgeManager   # noqa: F401
