from emqx_tpu_torch.session.inflight import Inflight
from emqx_tpu_torch.session.mqueue import MQueue
from emqx_tpu_torch.session.session import Session

__all__ = ["Inflight", "MQueue", "Session"]
