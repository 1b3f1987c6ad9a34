"""PDE residuals over field values and their coordinate derivatives.

Port of the JAX package's ``physics.py`` for the newmethod and CMB
pipelines:

* ``continuity_only``  — depth-anchored continuity (reference ``physics.py:18-33``);
* ``continuity_ftemp`` — anchor-free continuity (reference ``physics.py:37-47``);
* ``navier_stokes``    — time-dependent continuity + momentum with wave
  breaking (reference ``physics.py:50-88``), the legacy pipeline's equation;
* ``wave_averaged``    — wave-averaged momentum with bottom friction and
  radiation stresses (reference ``physics.py:91-120``);

and the model -> physics bridge :func:`model_fields_and_grads`. Callers
supply ``grads[coord][field]``, forward-mode derivatives of every network
output from one fused pass (``models.mlp.mlp_apply_with_tangents`` or the
K2 kernel in ``ops.kernels``). The coordinate derivatives of the radiation
stresses, which the JAX package takes with ``jax.jvp`` of a pointwise
function of ``(h, Hrms, k)``, are the chain rule written out, so plain
autograd differentiates them.

Each loss also has a sufficient-statistics form (``residual_stats`` and
``residual_from_stats``): the sums the loss is a ratio of, so a chunked
evaluation that adds the chunks' statistics reproduces the full-batch loss.

Parity quirks (SURVEY.md §5), kept:

1. the reference's radiation-stress prefactor ``E = 1/8**rho*g*Hrms**2``
   parses as ``(1/8**1025)*...``, exactly 0.0: ``parity=True`` keeps
   ``E = 0`` (and its zero products, so ``0*inf`` stays NaN), ``parity=False``
   computes the intended ``rho*g*Hrms**2/8``;
2. ``continuity_only``'s depth anchor compares the x coordinate exactly as
   stored (normalized, in the shipped pipeline) against 25.5, and an empty
   selection gives NaN, as ``torch.mean`` of an empty tensor does in the
   reference.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

G = 9.81          # m/s^2 (reference physics.py:75,97)
RHO = 1025.0      # kg/m^3 (reference physics.py:98)
CD = 0.002        # drag coefficient (reference physics.py:71,99)
GAMMA_B = 0.78    # breaking index (reference physics.py:76)


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


# ---------------------------------------------------------------------------
# navier_stokes — reference physics.py:50-88
# ---------------------------------------------------------------------------

def navier_stokes_residuals(fields, grads):
    """Pointwise (continuity, x-momentum, y-momentum) residuals; every
    derivative comes from the tangents (``d(h+z)/dx = h_x + z_x``, and the
    product rule for ``(h+z)*u``)."""
    h, z, u, v = fields["h"], fields["z"], fields["u"], fields["v"]
    dt, dx, dy = grads["t"], grads["x"], grads["y"]

    u_t, u_x, u_y = dt["u"], dx["u"], dy["u"]
    v_t, v_x, v_y = dt["v"], dx["v"], dy["v"]
    z_t, z_x, z_y = dt["z"], dx["z"], dy["z"]

    depth = h + z
    h_x = dx["h"] + dx["z"]           # compute_gradient(h+z, x), physics.py:64
    h_y = dy["h"] + dy["z"]
    hu_x = h_x * u + depth * u_x      # compute_gradient((h+z)*u, x), physics.py:67
    hv_y = h_y * v + depth * v_y

    # Friction disabled in the reference (physics.py:72-73).
    fbr_x = 3.0 / 16.0 * G * GAMMA_B**2 * h_x * depth
    fbr_y = 3.0 / 16.0 * G * GAMMA_B**2 * h_y * depth

    fc = z_t + hu_x + hv_y
    fm_x = u_t + u * u_x + v * u_y + G * z_x + fbr_x
    fm_y = v_t + u * v_x + v * v_y + G * z_y + fbr_y
    return fc, fm_x, fm_y


def navier_stokes(coords, fields, grads, *, mask=None, parity: bool = True):
    del coords, parity
    fc, fm_x, fm_y = navier_stokes_residuals(fields, grads)
    return masked_mean(fc**2, mask) + masked_mean(fm_x**2, mask) + masked_mean(fm_y**2, mask)


# ---------------------------------------------------------------------------
# wave_averaged — reference physics.py:91-120 (``physics_equation``)
# ---------------------------------------------------------------------------

def _radiation_prefactor(hrms, d_hrms, parity: bool):
    """``(E, dE/dc)`` for the coordinate derivative ``d_hrms`` of Hrms."""
    if parity:
        # Reference: E = 1/8**rho*g*Hrms**2 -> (1/8**1025)*... == 0.0 exactly
        # (operator precedence). Kept in the graph, so downstream hazards
        # (inf * 0) match.
        return torch.zeros_like(hrms), torch.zeros_like(d_hrms)
    return RHO * G * hrms**2 / 8.0, RHO * G * (2.0 * hrms * d_hrms) / 8.0


def _t_over_sinh(t):
    """``(r, dr/dt)`` of ``r = t / sinh(t)``, numerically stable under AD.

    The even Taylor series serves ``|t| < 0.5``: the quotient rule's
    numerator ``sinh t - t cosh t`` cancels catastrophically at small ``t``
    (the JAX package's ``_t_over_sinh`` docstring has the measurement). The
    direct branch serves ``|t| >= 0.5``, its argument set to 1 where unused
    so ``sinh`` is never 0 (``where``-guarded, as in JAX)."""
    small = torch.abs(t) < 0.5
    ts = torch.where(small, t, torch.zeros_like(t))   # series arg (0 where unused)
    tb = torch.where(small, torch.ones_like(t), t)    # direct arg (never 0)
    t2 = ts * ts
    series = 1.0 + t2 * (
        -1.0 / 6.0 + t2 * (7.0 / 360.0 + t2 * (
            -31.0 / 15120.0 + t2 * (127.0 / 604800.0)))
    )
    # d(series)/dt = 2 t P'(t^2)
    d_series = 2.0 * ts * (
        -1.0 / 6.0 + t2 * (2.0 * 7.0 / 360.0 + t2 * (
            3.0 * -31.0 / 15120.0 + t2 * (4.0 * 127.0 / 604800.0)))
    )
    sinh_b = torch.sinh(tb)
    d_direct = 1.0 / sinh_b - tb * torch.cosh(tb) / sinh_b**2
    return (torch.where(small, series, tb / sinh_b),
            torch.where(small, d_series, d_direct))


def _stress_derivatives(fields, dfields, parity: bool):
    """``(d Sxx/dc, d Syy/dc)`` for one coordinate c, with
    ``Sxx = E*(r + 1/2)`` and ``Syy = E*r/2``, ``r = t/sinh(t)``,
    ``t = 2*k*h``: the chain rule ``E_c*(r + 1/2) + E*r'(t)*t_c`` with
    ``t_c = 2*(k_c*h + k*h_c)``, written out where the JAX package takes
    ``jax.jvp`` (``derived_and_grad``)."""
    h, k = fields["h"], fields["k"]
    e, e_c = _radiation_prefactor(fields["Hrms"], dfields["Hrms"], parity)
    r, dr = _t_over_sinh(2.0 * k * h)
    t_c = 2.0 * (dfields["k"] * h + k * dfields["h"])
    r_c = dr * t_c
    return e_c * (r + 0.5) + e * r_c, e_c * (0.5 * r) + e * (0.5 * r_c)


def wave_averaged_residuals(fields, grads, *, parity: bool = True):
    """Pointwise (continuity, x-momentum, y-momentum) residuals."""
    h, U, V = fields["h"], fields["U"], fields["V"]
    eta = fields["eta_mean"]
    dx, dy = grads["x"], grads["y"]

    u_x, u_y = dx["U"], dy["U"]
    v_x, v_y = dx["V"], dy["V"]
    z_x, z_y = dx["eta_mean"], dy["eta_mean"]

    tau_bx = RHO * CD * U * torch.abs(U)
    tau_by = RHO * CD * V * torch.abs(V)

    sxx_x, _ = _stress_derivatives(fields, dx, parity)
    _, syy_y = _stress_derivatives(fields, dy, parity)

    inv_rho_d = 1.0 / (RHO * (eta + h))
    fc = u_x + v_y
    fx = U * u_x + V * u_y + G * z_x + inv_rho_d * sxx_x + inv_rho_d * tau_bx
    fy = U * v_x + V * v_y + G * z_y + inv_rho_d * syy_y + inv_rho_d * tau_by
    return fc, fx, fy


def wave_averaged(coords, fields, grads, *, mask=None, parity: bool = True):
    del coords
    fc, fx, fy = wave_averaged_residuals(fields, grads, parity=parity)
    return masked_mean(fc**2, mask) + masked_mean(fx**2, mask) + masked_mean(fy**2, mask)


# ---------------------------------------------------------------------------
# Sufficient-statistics forms (chunked evaluation)
# ---------------------------------------------------------------------------
# Every residual loss is a ratio of sums (masked means, possibly over a
# data-dependent subset such as the depth anchor). The ``*_stats`` form
# returns those sums, so summing them over chunks of the points and combining
# at the end gives the full-batch loss (same numerators and denominators).

def _mask_of(values, mask):
    return torch.ones_like(values) if mask is None else mask.to(values.dtype)


def continuity_only_stats(
    coords, fields, grads, *, mask=None, parity=True,
    anchor_threshold=25.5, anchor_depth=0.75,
):
    del parity
    fc = continuity_only_residuals(fields, grads)
    m = _mask_of(fc, mask)
    sel = (coords["x"] < anchor_threshold).to(fc.dtype) * m
    return {
        "sum_fc2": torch.sum(fc**2 * m),
        "n": torch.sum(m),
        "sum_anchor": torch.sum(sel * (fields["h"] - anchor_depth) ** 2),
        "n_anchor": torch.sum(sel),
    }


def continuity_only_from_stats(s):
    return s["sum_fc2"] / s["n"] + s["sum_anchor"] / s["n_anchor"]


def continuity_ftemp_stats(coords, fields, grads, *, mask=None, parity=True):
    del coords, parity
    fc = continuity_only_residuals(fields, grads)
    m = _mask_of(fc, mask)
    return {"sum_fc2": torch.sum(fc**2 * m), "n": torch.sum(m)}


def continuity_ftemp_from_stats(s):
    return s["sum_fc2"] / s["n"]


def _three_term_stats(fc, fx, fy, mask):
    m = _mask_of(fc, mask)
    return {
        "sum_fc2": torch.sum(fc**2 * m),
        "sum_fx2": torch.sum(fx**2 * m),
        "sum_fy2": torch.sum(fy**2 * m),
        "n": torch.sum(m),
    }


def navier_stokes_stats(coords, fields, grads, *, mask=None, parity=True):
    del coords, parity
    return _three_term_stats(*navier_stokes_residuals(fields, grads), mask)


def wave_averaged_stats(coords, fields, grads, *, mask=None, parity: bool = True):
    del coords
    return _three_term_stats(*wave_averaged_residuals(fields, grads, parity=parity), mask)


def _three_term_from_stats(s):
    return (s["sum_fc2"] + s["sum_fx2"] + s["sum_fy2"]) / s["n"]


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


# Registry: config name -> (loss_fn, required coordinate-derivative names,
# stats_fn, combiner).
EQUATIONS: dict[str, tuple[Callable, tuple[str, ...], Callable, Callable]] = {
    "continuity_only": (
        continuity_only, ("x", "y"), continuity_only_stats, continuity_only_from_stats,
    ),
    "continuity_ftemp": (
        continuity_ftemp, ("x", "y"), continuity_ftemp_stats, continuity_ftemp_from_stats,
    ),
    "navier_stokes": (
        navier_stokes, ("t", "x", "y"), navier_stokes_stats, _three_term_from_stats,
    ),
    "wave_averaged": (
        wave_averaged, ("x", "y"), wave_averaged_stats, _three_term_from_stats,
    ),
}


def _lookup(name: str):
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


def residual_stats(name: str):
    """Sufficient-statistics form: ``stats_fn(coords, fields, grads, ...)``."""
    return _lookup(name)[2]


def residual_from_stats(name: str):
    """Combiner: ``loss = combine(summed stats)``."""
    return _lookup(name)[3]
