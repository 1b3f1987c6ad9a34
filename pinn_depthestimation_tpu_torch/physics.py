"""PDE residuals over field values and their coordinate derivatives.

Port of the forward subset of the JAX package's ``physics.py``: the two
continuity equations of the flagship newmethod pipeline,

* ``continuity_only``  — depth-anchored continuity (reference ``physics.py:18-33``);
* ``continuity_ftemp`` — anchor-free continuity (reference ``physics.py:37-47``);

and the model -> physics bridge :func:`model_fields_and_grads`. Callers
supply ``grads[coord][field]``, forward-mode derivatives of every network
output from one fused pass (``models.mlp.mlp_apply_with_tangents`` or the
K2 kernel in ``ops.kernels``).

``navier_stokes`` and ``wave_averaged`` belong to the legacy and CMB
pipelines and are queued in ``ROADMAP.md`` (M8, M9).

Parity quirk 2 (SURVEY.md §5), kept: ``continuity_only``'s depth anchor
compares the x coordinate exactly as stored (normalized, in the shipped
pipeline) against 25.5, and an empty selection gives NaN, as
``torch.mean`` of an empty tensor does in the reference.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch


def masked_mean(values: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """Mean over valid entries; ``mask=None`` means all valid."""
    if mask is None:
        return torch.mean(values)
    mask = mask.to(values.dtype)
    return torch.sum(values * mask) / torch.sum(mask)


def continuity_only_residuals(fields: Mapping, grads: Mapping) -> torch.Tensor:
    """Pointwise continuity residual ``d(hU)/dx + d(hV)/dy``."""
    h, U, V = fields["h"], fields["U"], fields["V"]
    dx, dy = grads["x"], grads["y"]
    hU_x = dx["h"] * U + h * dx["U"]
    hV_y = dy["h"] * V + h * dy["V"]
    return hU_x + hV_y


def continuity_only(
    coords,
    fields,
    grads,
    *,
    mask=None,
    parity: bool = True,
    anchor_threshold: float = 25.5,
    anchor_depth: float = 0.75,
):
    """Continuity loss plus depth anchor ``mean((h[x < 25.5] - 0.75)^2)``.

    ``coords['x']`` is compared against the threshold exactly as stored
    (module docstring, quirk 2). ``parity`` is accepted for interface
    uniformity; this equation has no parity-dependent term.
    """
    del parity
    fc = continuity_only_residuals(fields, grads)
    loss_continuity = masked_mean(fc**2, mask)

    sel = coords["x"] < anchor_threshold
    if mask is not None:
        sel = torch.logical_and(sel, mask.to(torch.bool))
    sel = sel.to(fc.dtype)
    # Mean over the selected subset; empty selection yields nan exactly like
    # torch.mean of an empty tensor (reference physics.py:28).
    loss_condition = torch.sum(sel * (fields["h"] - anchor_depth) ** 2) / torch.sum(sel)
    return loss_continuity + loss_condition


def continuity_ftemp(coords, fields, grads, *, mask=None, parity: bool = True):
    del coords, parity
    fc = continuity_only_residuals(fields, grads)
    return masked_mean(fc**2, mask)


def model_fields_and_grads(
    apply_with_tangents: Callable,
    coords: torch.Tensor,
    input_names,
    grad_coords,
    output_names,
):
    """Evaluate a model and package (coords, fields, grads) for residual fns.

    ``apply_with_tangents(x, tangents) -> (y, dy)`` is typically a partial of
    ``models.mlp.mlp_apply_with_tangents``. ``grad_coords`` names the inputs
    to differentiate against; one fused forward pass produces all of them.

    Returns ``(coord_dict, fields, grads)`` with 1-D ``(N,)`` leaves:
    ``coord_dict[name]``, ``fields[output]``, ``grads[coord][output]``.
    """
    input_names = list(input_names)
    output_names = list(output_names)
    grad_coords = list(grad_coords)
    columns = [input_names.index(c) for c in grad_coords]
    tangents = torch.zeros((len(columns),) + tuple(coords.shape), dtype=coords.dtype,
                           device=coords.device)
    for k, c in enumerate(columns):
        tangents[k, ..., c] = 1.0
    y, dy = apply_with_tangents(coords, tangents)
    coord_dict = {name: coords[..., i] for i, name in enumerate(input_names)}
    fields = {name: y[..., i] for i, name in enumerate(output_names)}
    grads = {
        c: {name: dy[k][..., i] for i, name in enumerate(output_names)}
        for k, c in enumerate(grad_coords)
    }
    return coord_dict, fields, grads


# Registry: config name -> (loss_fn, required coordinate-derivative names).
EQUATIONS: dict[str, tuple[Callable, tuple[str, ...]]] = {
    "continuity_only": (continuity_only, ("x", "y")),
    "continuity_ftemp": (continuity_ftemp, ("x", "y")),
}

# Equations of the JAX package that the port has not reached yet.
_QUEUED = {"navier_stokes": "M9", "wave_averaged": "M8"}


def _lookup(name: str):
    if name in _QUEUED:
        raise NotImplementedError(
            f"physics equation {name!r} is not ported yet "
            f"(ROADMAP.md Queue 1, {_QUEUED[name]})"
        )
    try:
        return EQUATIONS[name]
    except KeyError:
        raise KeyError(
            f"unknown physics equation {name!r}; available: {sorted(EQUATIONS)}"
        ) from None


def required_grad_coords(name: str) -> tuple[str, ...]:
    return _lookup(name)[1]


def residual_loss(name: str):
    """Look up a residual loss by its config name."""
    return _lookup(name)[0]
