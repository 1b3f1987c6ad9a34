from pinn_depthestimation_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    pad_to_multiple,
    replicate,
    shard_batch,
)
