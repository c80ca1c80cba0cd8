from emqx_tpu_torch.mqtt import packet
from emqx_tpu_torch.mqtt.frame import ParseState, Parser, serialize

__all__ = ["packet", "ParseState", "Parser", "serialize"]
