from pinn_depthestimation_tpu_torch.optim.lbfgs import (  # noqa: F401
    LBFGSOptions,
    LBFGSRunner,
    lbfgs_minimize,
)
