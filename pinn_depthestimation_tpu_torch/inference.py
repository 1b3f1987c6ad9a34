"""Full-grid prediction (reference ``test.py`` parity).

Port of the JAX package's ``inference.py::Predictor`` for the serving path:

* restore a trained model from a reference ``.pth`` (whole pickled module
  or ``state_dict``) or an ``.npz`` of the parameter exchange dict
  (``training.checkpoint``);
* predict the full test grid, reshaped ``(ny, nx)``, with the inputs
  denormalized for plotting (reference ``test.py:60-89``).

On a CUDA device prediction runs through the K2 kernel
(``ops.kernels.mlp_fwd_tangents`` with no tangents) at the config's
``kernel_precision`` tier (``f32``, ``bf16`` or ``f32x3``) unless
the caller asks for the plain ``models.mlp.mlp_apply`` with
``use_kernel=False``, the counterpart of the JAX package's
``use_fused_kernel``. An architecture K2
was not compiled for raises instead of serving quietly through the plain
path (:func:`resolve_use_kernel`).

Test-time adaptation (``adapt``, ``perform_optimization``) needs L-BFGS and
parameter gradients, which come with the training slice (``ROADMAP.md``
Queue 1, M6); here it raises ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from pinn_depthestimation_tpu_torch import data as data_mod
from pinn_depthestimation_tpu_torch import ops
from pinn_depthestimation_tpu_torch.config import Config
from pinn_depthestimation_tpu_torch.device import resolve_device
from pinn_depthestimation_tpu_torch.models import MLPSpec, init_mlp_params, mlp_apply
from pinn_depthestimation_tpu_torch.ops import kernels
from pinn_depthestimation_tpu_torch.ops.cuda_build import K2_WIDTHS
from pinn_depthestimation_tpu_torch.training.checkpoint import restore_params_any

_ADAPT_TODO = (
    "test-time adaptation (Predictor.adapt, perform_optimization) needs "
    "L-BFGS and gradients and is not ported yet (ROADMAP.md Queue 1, M6)"
)


def resolve_use_kernel(spec: MLPSpec, device_type: str, use_kernel: bool | None) -> bool:
    """Whether prediction goes through K2.

    ``None`` means K2 on a CUDA device and the plain path on the CPU. On a
    CUDA device an architecture K2 does not take raises, naming
    ``K2_WIDTHS`` and ``use_kernel=False``, the explicit request for the
    plain path. On the CPU the K2 wrapper takes its plain version anyway."""
    if device_type != "cuda":
        return bool(use_kernel)
    if use_kernel is False:
        return False
    if not kernels.kernel_supports(spec):
        raise ValueError(
            f"K2 does not take sizes {spec.sizes} (it needs >= 1 hidden layer, "
            f"a width in K2_WIDTHS={K2_WIDTHS}, d_in <= {kernels.MAX_D_IN} and "
            f"d_out <= {kernels.MAX_D_OUT}); pass use_kernel=False (in a "
            "Trainer: fused_kernel='off') to predict through the plain mlp_apply"
        )
    return True


@dataclass
class InferenceResult:
    """Grids keyed by variable name, shaped ``(ny, nx)`` where configured."""

    pred: dict[str, np.ndarray] = field(default_factory=dict)
    true: dict[str, np.ndarray] = field(default_factory=dict)
    inputs: dict[str, np.ndarray] = field(default_factory=dict)  # denormalized
    adapted: bool = False


class Predictor:
    def __init__(
        self,
        config: Config,
        checkpoint_path: str | None = None,
        *,
        device: str | torch.device = "cuda",
        use_kernel: bool | None = None,
    ):
        """Weights come from ``checkpoint_path`` (else ``data_test.model``);
        with neither, from :func:`init_mlp_params` with a CPU
        ``torch.Generator`` seeded by ``config.seed`` — other numbers than
        the JAX package's ``jax.random`` init for the same seed, which is
        why tests hand both packages one weights file. ``use_kernel``: see
        :func:`resolve_use_kernel`."""
        self.config = config
        self.device = resolve_device(device)
        self.spec = MLPSpec.from_layers(config.layers)
        td = config.data_test
        if td is None:
            raise ValueError("config needs a data_test section for inference")
        self.test_cfg = td

        path = checkpoint_path or td.model
        if path:
            self.params = restore_params_any(path, spec=self.spec, device=self.device)
        else:
            gen = torch.Generator().manual_seed(config.seed)
            self.params = init_mlp_params(gen, self.spec, device=self.device)

        self.use_kernel = resolve_use_kernel(self.spec, self.device.type, use_kernel)
        self.precision = config.resolved_kernel_precision()
        if self.use_kernel:
            kernels.check_precision(self.precision)

    # ------------------------------------------------------------- predict

    @torch.no_grad()
    def predict(self, inputs: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(inputs, np.float32)).to(self.device)
        if self.use_kernel:
            y, _ = kernels.mlp_fwd_tangents(self.params, x, self.spec, 0,
                                            precision=self.precision)
        else:
            y = mlp_apply(self.params, x, self.spec)
        return y.cpu().numpy()

    def _grid(self, column: np.ndarray) -> np.ndarray:
        ny, nx = self.test_cfg.ny, self.test_cfg.nx
        if ny and nx and column.size == ny * nx:
            return column.reshape(ny, nx)  # reference test.py:69,84
        return column

    def run(self, test_data: data_mod.TestData | None = None) -> InferenceResult:
        """Full test pass: predict the grid and collect the true fields."""
        if self.config.perform_optimization:
            raise NotImplementedError(_ADAPT_TODO)
        if test_data is None:
            test_data = data_mod.load_test_data(self.config)

        result = InferenceResult()
        for i, key in enumerate(self.test_cfg.inputs):
            lo, hi = test_data.input_min_max[key]
            col = np.asarray(test_data.inputs[:, i], np.float64)
            result.inputs[key] = self._grid(ops.denormalize(col, lo, hi))

        pred = self.predict(test_data.inputs)
        for i, key in enumerate(self.test_cfg.outputs):
            if i < pred.shape[1]:
                result.pred[key] = self._grid(pred[:, i])
        for key, arr in test_data.trues.items():
            result.true[key] = np.asarray(arr)
        return result

    def adapt(self, inputs: np.ndarray, **kwargs) -> int:
        """Physics-only L-BFGS fine-tune: not ported yet."""
        raise NotImplementedError(_ADAPT_TODO)
