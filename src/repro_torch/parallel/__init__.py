"""Distribution layer of the port: mesh-aware sharding rules and collective
helpers on ``torch.distributed``."""
from .sharding import (batch_axes, constrain_act, current_mesh, mesh_context,
                       param_pspec, shard_params, shard_params_pspecs)

__all__ = ["batch_axes", "constrain_act", "current_mesh", "mesh_context",
           "param_pspec", "shard_params", "shard_params_pspecs"]
