from emqx_tpu_torch.broker.hooks import Hooks
from emqx_tpu_torch.broker.broker import Broker

__all__ = ["Hooks", "Broker"]
