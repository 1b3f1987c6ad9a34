"""pinn_depthestimation_tpu_torch — the PyTorch/CUDA port of the PINN
bathymetry-inversion framework, for an NVIDIA H100.

The JAX package ``pinn_depthestimation_tpu`` stays the reference; this
package imports nothing of it (it keeps its own copies of what it needs) and
never imports ``jax``, ``flax`` or ``pandas``. Module names follow the JAX
package's, so each module's counterpart is found by name.

So far the port covers the serving path — ``Predictor`` (full-grid
prediction from a reference ``.pth`` or an ``.npz`` of the parameter
exchange dict) and the residual-evaluation bench, through the hand-written
CUDA kernel K2 (``ops/kernels.py``) — and the flagship training path —
``training.driver.Trainer`` and CLI ``train`` (Adam, then L-BFGS), every
loss evaluation through the one-kernel training step K1
(``ops/kernels_step.py``). The kernels' sources are in ``csrc/``. Entry
points run on ``device="cuda"`` unless the caller asks for the CPU.

The JAX package pins ``Precision.HIGHEST`` for every matmul; the port pins
true float32 here, at import, for matmuls and convolutions alike.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from pinn_depthestimation_tpu_torch.config import Config, load_config  # noqa: E402,F401
