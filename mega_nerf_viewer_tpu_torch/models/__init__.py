from .meganerf import (MegaNeRFModel, MLPParams, cluster_ids_from_yz,
                       mlp_forward, mlp_forward_all, model_from_numpy,
                       params_from_numpy, query_grouped)

__all__ = ["MegaNeRFModel", "MLPParams", "mlp_forward"]
