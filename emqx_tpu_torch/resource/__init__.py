"""Managed external-resource runtime — the ``emqx_resource`` app."""

from emqx_tpu_torch.resource.resource import Resource, ResourceManager   # noqa: F401
from emqx_tpu_torch.resource.worker import BufferWorker                  # noqa: F401
