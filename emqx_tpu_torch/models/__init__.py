from emqx_tpu_torch.models.router_model import RouterModel

__all__ = ["RouterModel"]
