from pinn_depthestimation_tpu_torch.ops.normalize import (  # noqa: F401
    denormalize,
    get_min_max,
    normalize,
)
