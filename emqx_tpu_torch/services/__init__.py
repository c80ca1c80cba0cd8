from emqx_tpu_torch.services.retainer import Retainer
from emqx_tpu_torch.services.delayed import Delayed

__all__ = ["Retainer", "Delayed"]
