from emqx_tpu_torch.core import topic
from emqx_tpu_torch.core.message import Message

__all__ = ["topic", "Message"]
