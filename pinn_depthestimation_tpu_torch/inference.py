"""Inference + test-time physics adaptation (reference ``test.py`` parity).

Port of the JAX package's ``inference.py::Predictor``:

* restore a trained model from a reference ``.pth`` (whole pickled module
  or ``state_dict``) or an ``.npz`` of the parameter exchange dict
  (``training.checkpoint``);
* predict the full test grid, reshaped ``(ny, nx)``, with the inputs
  denormalized for plotting (reference ``test.py:60-89``);
* optional **test-time adaptation**: when ``perform_optimization`` is set, a
  1-iteration L-BFGS (max_eval=2, history=10 — reference ``test.py:44-54``)
  fine-tunes the parameters against the pure physics residual on the test
  grid, then re-predicts (reference ``test.py:92-104``; :meth:`Predictor.adapt`).

On a CUDA device prediction runs through the K2 kernel
(``ops.kernels.mlp_fwd_tangents`` with no tangents) at the config's
``kernel_precision`` tier (``f32``, ``bf16`` or ``f32x3``) unless
the caller asks for the plain ``models.mlp.mlp_apply`` with
``use_kernel=False``, the counterpart of the JAX package's
``use_fused_kernel``. K2, K3 and K4 take every net the Pallas kernels
take (any width, ``d_in`` and ``d_out`` up to 128); any other raises
instead of serving quietly through the plain path
(:func:`resolve_use_kernel`). The adaptation's physics loss then runs
through ``ops.kernels_vjp.fused_apply_with_tangents`` at the same tier: K2
forward with a tangent per differentiated coordinate, and K3 (``f32``,
``f32x3``) or K4 (``bf16``) backward.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from pinn_depthestimation_tpu_torch import data as data_mod
from pinn_depthestimation_tpu_torch import ops, physics
from pinn_depthestimation_tpu_torch.config import Config
from pinn_depthestimation_tpu_torch.device import resolve_device
from pinn_depthestimation_tpu_torch.models import (
    MLPSpec,
    init_mlp_params,
    mlp_apply,
    mlp_apply_with_tangents,
)
from pinn_depthestimation_tpu_torch.ops import kernels, kernels_vjp, widths
from pinn_depthestimation_tpu_torch.optim.lbfgs import LBFGSOptions, LBFGSRunner
from pinn_depthestimation_tpu_torch.training.checkpoint import restore_params_any


def resolve_use_kernel(spec: MLPSpec, device_type: str, use_kernel: bool | None) -> bool:
    """Whether prediction goes through K2.

    ``None`` means K2 on a CUDA device and the plain path on the CPU. On a
    CUDA device K2 takes what the JAX package's Pallas kernel takes (the JAX
    ``inference.py:81-86`` gate: >= 1 hidden layer and ``max(width, d_in,
    d_out) <= 128``); any other net raises, naming that gate and
    ``use_kernel=False``, the explicit request for the plain path. On the
    CPU the K2 wrapper takes its plain version anyway."""
    if device_type != "cuda":
        return bool(use_kernel)
    if use_kernel is False:
        return False
    if not kernels.kernel_supports(spec):
        raise ValueError(
            f"K2 does not take sizes {spec.sizes}: like the JAX package's Pallas "
            "kernel it needs >= 1 hidden layer and max(width, d_in, d_out) <= "
            f"{widths.MAX_DIM}; pass use_kernel=False (in a Trainer: "
            "fused_kernel='off') to predict through the plain mlp_apply"
        )
    return True


@dataclass
class InferenceResult:
    """Grids keyed by variable name, shaped ``(ny, nx)`` where configured."""

    pred: dict[str, np.ndarray] = field(default_factory=dict)
    true: dict[str, np.ndarray] = field(default_factory=dict)
    inputs: dict[str, np.ndarray] = field(default_factory=dict)  # denormalized
    adapted: bool = False
    adapt_evaluations: int = 0  # loss evaluations of the adaptation, if any


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
        # per-evaluation physics losses of the last adaptation
        self.adapt_losses = np.zeros(0, np.float32)

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
        """Full test pass: predict, optional physics adaptation, re-predict."""
        if test_data is None:
            test_data = data_mod.load_test_data(self.config)

        result = InferenceResult()
        for i, key in enumerate(self.test_cfg.inputs):
            lo, hi = test_data.input_min_max[key]
            col = np.asarray(test_data.inputs[:, i], np.float64)
            result.inputs[key] = self._grid(ops.denormalize(col, lo, hi))

        if self.config.perform_optimization:
            result.adapt_evaluations = self.adapt(test_data.inputs)

        pred = self.predict(test_data.inputs)
        for i, key in enumerate(self.test_cfg.outputs):
            if i < pred.shape[1]:
                result.pred[key] = self._grid(pred[:, i])
        for key, arr in test_data.trues.items():
            result.true[key] = np.asarray(arr)
        result.adapted = self.config.perform_optimization
        return result

    # -------------------------------------------------- test-time adaptation

    def adapt(
        self,
        inputs: np.ndarray,
        *,
        equation: str | None = None,
        max_iter: int = 1,
        max_eval: int = 2,
        history_size: int = 10,
    ) -> int:
        """Physics-only L-BFGS fine-tune on the given (normalized) inputs.

        Mirrors the reference's fixed TTA optimizer settings (``test.py:45-54``:
        max_iter=1, max_eval=2, history_size=10, the learning rate, line
        search and tolerances from the config's ``lbfgs`` section) while
        generalizing the iteration budget. Returns the evaluation count;
        the per-evaluation losses are left in ``adapt_losses``.

        The equation defaults to ``config.physics`` (the equation the model
        was trained against), as in the JAX package; the reference
        hardcodes ``Navier_Stokes`` (``test.py:6,96``), which its CMB test
        inputs cannot feed; ``equation='navier_stokes'`` needs ``(t, x, y)``
        among the test inputs.

        Rows with a non-finite coordinate (the grid's masked cells) are left
        out of the loss. The JAX ``adapt`` averages over them, and then its
        loss, gradients and parameters are all NaN.

        Where prediction runs through K2 (:func:`resolve_use_kernel`), the
        loss runs through ``ops.kernels_vjp.fused_apply_with_tangents`` at
        the config's tier, which needs the differentiated coordinates to
        lead the test inputs, in order, and on the card K3/K4 compiled for
        the width; otherwise it raises. Elsewhere the loss is autograd of
        the plain ``mlp_apply_with_tangents``."""
        eq_name = equation or self.config.physics
        equation_fn = physics.residual_loss(eq_name)
        grad_coords = list(physics.required_grad_coords(eq_name))
        input_names = list(self.test_cfg.inputs)
        missing = [c for c in grad_coords if c not in input_names]
        if missing:
            raise ValueError(
                f"physics equation {eq_name!r} needs input coordinates "
                f"{grad_coords}, but data_test.inputs are "
                f"{input_names} (missing {missing})"
            )
        output_names = list(self.test_cfg.outputs)
        x = np.asarray(inputs, np.float32)
        coords = torch.as_tensor(x[np.isfinite(x).all(axis=1)]).to(self.device)
        spec, parity = self.spec, self.config.parity
        if self.use_kernel:
            columns = [input_names.index(c) for c in grad_coords]
            if columns != list(range(len(columns))):
                raise ValueError(
                    "the kernels produce tangents for the leading input columns: "
                    f"{grad_coords} must lead data_test.inputs {input_names}, in order; "
                    "pass use_kernel=False to adapt through the plain path"
                )
            precision = self.precision

            def apply_with_tangents(params):
                return lambda c, t: kernels_vjp.fused_apply_with_tangents(
                    params, c, spec, t.shape[0], precision)
        else:
            def apply_with_tangents(params):
                return lambda c, t: mlp_apply_with_tangents(params, c, t, spec)

        def loss_fn(params, batch):
            del batch
            c, f, g = physics.model_fields_and_grads(
                apply_with_tangents(params), coords, input_names, grad_coords, output_names
            )
            loss = equation_fn(c, f, g, parity=parity)
            return loss, (torch.zeros_like(loss), loss)

        lcfg = self.config.lbfgs
        runner = LBFGSRunner(
            loss_fn,
            self.params,
            LBFGSOptions(
                lr=lcfg.learning_rate,
                max_iter=max_iter,
                max_eval=max_eval,
                history_size=history_size,
                tolerance_grad=lcfg.tolerance_grad,
                tolerance_change=lcfg.tolerance_change,
                line_search=lcfg.line_search_fn,
            ),
        )
        state = runner.init(self.params, None)
        rows = []
        while not runner.finished(state):
            state, records = runner.run_chunk(state, None)
            rows.append(records)
        state, records = runner.drain_records(state)
        rows.append(records)
        self.adapt_losses = np.concatenate(rows)[:, 2]
        self.params = {k: v.detach().clone() for k, v in runner.get_params(state).items()}
        return int(state.func_evals)
