from emqx_tpu_torch.parallel.mesh import (
    DP,
    TP,
    make_mesh,
    router_shardings,
)

__all__ = ["DP", "TP", "make_mesh", "router_shardings"]
