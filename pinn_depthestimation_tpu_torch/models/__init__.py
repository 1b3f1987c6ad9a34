from pinn_depthestimation_tpu_torch.models.mlp import (  # noqa: F401
    PARAM_KEYS,
    MLPSpec,
    init_mlp_params,
    mlp_apply,
    mlp_apply_with_tangents,
    num_params,
    params_from_numpy,
    params_to_numpy,
)
from pinn_depthestimation_tpu_torch.models.torch_mlp import PinnMLP  # noqa: F401
