from emqx_tpu_torch.mqtt import packet

__all__ = ["packet"]
