"""Plain reference of the ``continuity_only`` physics: the newmethod loss,
its gradients by autograd, Adam written out, and the per-point residual.

It follows the published newmethod pipeline (``train_newmethod.py``,
``physics.py`` of rezasalatin/PINN_depthEstimation) and nothing of the
program under test: it imports neither the port nor JAX, and takes only the
inputs the benchmark made (the weights, the survey columns, the points). It
works out the normalization, the NaN mask, the network with its coordinate
derivatives, the loss terms, the gradients and the updates again.

* Network: ``x @ W + b`` layers with tanh between them (weights stored
  ``(in, out)``), the coordinate derivatives carried forward beside the
  primal (forward-mode, the chain rule written out).
* Residual: ``fc = d(hU)/dx + d(hV)/dy`` on the heads ``(U, V, h)``,
  derivatives with respect to the normalized coordinates, as the pipeline
  feeds them.
* Loss: ``mean(fc^2) + mean((h - depth)^2 over x < threshold)`` plus the
  weighted fidelity MSE of ``U`` and ``V``. With ``parity`` the threshold
  is compared against the normalized ``x``, as the published code does, so
  every point is selected.
* Adam: torch's defaults, the bias-corrected update written out.

``precision`` is ``"f32"`` (true float32: TF32 is switched off around
every product) or ``"tf32"``, the control: every product's operands rounded
to TF32's 10-bit mantissa, the sums in float32, in the forward and in the
backward alike.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PARAM_KEYS = ("w_in", "b_in", "w_hidden", "b_hidden", "w_out", "b_out")
PRECISIONS = ("f32", "tf32")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to nearest-even at TF32's 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """``a @ b`` with both operands rounded to TF32, as the tensor cores take
    them, in the forward and in both products of the backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        ga = g @ round_tf32(b).transpose(-1, -2)
        gb = round_tf32(a).transpose(-1, -2) @ g
        if gb.dim() > b.dim():  # a batch of tangent streams against one weight
            gb = gb.sum(dim=tuple(range(gb.dim() - b.dim())))
        return ga, gb


def _matmul(a, b, precision: str):
    if precision == "f32":
        return a @ b
    if precision == "tf32":
        return _TF32MatMul.apply(a, b)
    raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


class _TrueF32:
    """Switches TF32 off for the products inside, and back as it was."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def forward_with_tangents(params, coords: torch.Tensor, precision: str = "f32"):
    """``(y (N, 3), dy (2, N, 3))``: the heads and their derivatives with
    respect to the two input coordinates."""
    n = coords.shape[0]
    basis = torch.eye(2, dtype=coords.dtype, device=coords.device)
    t = basis[:, None, :].expand(2, n, 2)
    z = _matmul(coords, params["w_in"], precision) + params["b_in"]
    a = torch.tanh(z)
    t = _matmul(t, params["w_in"], precision) * (1 - a * a)
    for layer in range(params["w_hidden"].shape[0]):
        w = params["w_hidden"][layer]
        a_next = torch.tanh(_matmul(a, w, precision) + params["b_hidden"][layer])
        t = _matmul(t, w, precision) * (1 - a_next * a_next)
        a = a_next
    y = _matmul(a, params["w_out"], precision) + params["b_out"]
    dy = _matmul(t, params["w_out"], precision)
    return y, dy


def continuity(y: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Per point ``d(hU)/dx + d(hV)/dy``, heads ``(U, V, h)``."""
    U, V, h = y[:, 0], y[:, 1], y[:, 2]
    return (dy[0][:, 2] * U + h * dy[0][:, 0]) + (dy[1][:, 2] * V + h * dy[1][:, 1])


@torch.no_grad()
def residual(params, coords: torch.Tensor, precision: str = "f32",
             block: int = 1 << 18) -> torch.Tensor:
    """The per-point continuity residual of ``coords`` (normalized), in
    blocks of ``block`` points."""
    with _TrueF32():
        out = [continuity(*forward_with_tangents(params, coords[i:i + block], precision))
               for i in range(0, coords.shape[0], block)]
    return torch.cat(out)


def normalize(values: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """The affine map of ``[lo, hi]`` onto ``[-1, 1]``, in float64."""
    return 2.0 * (np.asarray(values, np.float64) - lo) / (hi - lo) - 1.0


def survey_batch(columns: dict, grid: dict, device) -> dict:
    """The training rows of a survey: rows with a NaN in ``U`` or ``V``
    dropped, ``x``/``y`` normalized with the grid's bounds (float64, then
    float32), ``U``/``V`` raw (float32)."""
    keep = ~(np.isnan(columns["U"]) | np.isnan(columns["V"]))
    xn = normalize(columns["x"], grid["x_min"], grid["x_max"])[keep]
    yn = normalize(columns["y"], grid["y_min"], grid["y_max"])[keep]
    coords = np.stack([xn, yn], axis=1).astype(np.float32)
    trues = np.stack([columns["U"][keep], columns["V"][keep]], axis=1).astype(np.float32)
    return {"coords": torch.as_tensor(coords).to(device),
            "trues": torch.as_tensor(trues).to(device)}


def loss_terms(params, batch: dict, loss: dict, precision: str = "f32"):
    """``(fidelity, residual, total)`` of the newmethod loss on ``batch``."""
    coords, trues = batch["coords"], batch["trues"]
    y, dy = forward_with_tangents(params, coords, precision)
    fc = continuity(y, dy)
    x_seen = coords[:, 0]  # the published code compares the normalized x
    if not loss["parity"]:
        raise ValueError("the reference follows the published (parity) anchor only")
    sel = x_seen < loss["anchor_threshold"]
    residual_term = torch.mean(fc * fc) + torch.mean((y[sel, 2] - loss["anchor_depth"]) ** 2)
    fidelity = (loss["weight_U_loss"] * torch.mean((y[:, 0] - trues[:, 0]) ** 2)
                + loss["weight_V_loss"] * torch.mean((y[:, 1] - trues[:, 1]) ** 2))
    total = loss["weight_fid_loss"] * fidelity + loss["weight_res_loss"] * residual_term
    return fidelity, residual_term, total


def adam_steps(params0, batch: dict, loss: dict, adam: dict, n_steps: int,
               precision: str = "f32") -> dict:
    """``n_steps`` Adam steps from ``params0`` (not changed). Returns the
    loss terms of each step (``losses``: ``n_steps`` rows of ``(fidelity,
    residual, total)``), the first step's gradient (``grad1``) and the
    change of every parameter after the last step (``change``), each a dict
    of tensors by parameter name."""
    lr, (b1, b2), eps = adam["learning_rate"], adam["betas"], adam["eps"]
    if n_steps > adam["scheduler_step_size"]:
        raise ValueError("the reference's steps stay inside the first learning-rate stage")
    p = {k: params0[k].detach().clone() for k in PARAM_KEYS}
    m = {k: torch.zeros_like(p[k]) for k in PARAM_KEYS}
    v = {k: torch.zeros_like(p[k]) for k in PARAM_KEYS}
    losses, grad1 = [], None
    with _TrueF32():
        for step in range(1, n_steps + 1):
            leaves = {k: p[k].requires_grad_() for k in PARAM_KEYS}
            with torch.enable_grad():
                fid, res, total = loss_terms(leaves, batch, loss, precision)
                grads = torch.autograd.grad(total, [leaves[k] for k in PARAM_KEYS])
            losses.append((float(fid.detach()), float(res.detach()), float(total.detach())))
            g = dict(zip(PARAM_KEYS, grads))
            if grad1 is None:
                grad1 = {k: g[k].detach().clone() for k in PARAM_KEYS}
            with torch.no_grad():
                bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
                for k in PARAM_KEYS:
                    m[k] = b1 * m[k] + (1 - b1) * g[k]
                    v[k] = b2 * v[k] + (1 - b2) * g[k] * g[k]
                    denom = v[k].sqrt() / math.sqrt(bc2) + eps
                    p[k] = p[k].detach() - (lr / bc1) * m[k] / denom
    change = {k: (p[k].detach() - params0[k]) for k in PARAM_KEYS}
    return {"losses": losses, "grad1": grad1, "change": change}
