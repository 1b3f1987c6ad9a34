"""Inputs of the CMB configuration made from the seed: the fidelity survey
rows and the FUNWAVE-grid ``.mat`` of the residual points.

The reference's FUNWAVE products are not public, so the fields are the
port's synthetic wave-averaged stand-ins (a copy of ``utils/synthetic.py``
``beach_fields``: a planar beach under a longshore current, a set-up, a
wave height and a wavenumber), in numpy, drawn by
``numpy.random.default_rng`` so that seeds of any size are taken. Every seed
gives the same sizes: ``fidelity.rows`` survey rows uniform over the domain,
and the ``residual.ny x residual.nx`` grid of which the loader keeps every
``interval``-th cell in each direction with exactly ``residual.masked`` of
those kept cells masked (``x`` NaN, as the land cells of a FUNWAVE grid are),
so ``residual.points`` remain.
"""

from __future__ import annotations

import numpy as np

from portbench.gen import numpy_rng

FIELDS = ("h", "U", "V", "eta_mean", "Hrms", "k")


def beach_fields(x, y, h0=0.75, slope=0.02, x0=25.0) -> dict:
    """The port's ``beach_fields``: every head of the CMB net."""
    h = h0 - slope * (x - x0)
    U = -(-0.3 * 0.05 * np.sin(0.5 * (x - x0)) * np.sin(0.3 * y))
    V = 0.5 * 0.05 * np.cos(0.5 * (x - x0)) * np.cos(0.3 * y)
    eta_mean = 0.01 * np.cos(0.4 * (x - x0))
    hrms = 0.2 + 0.05 * np.tanh(0.3 * (x - x0))
    k = 1.5 + 0.2 * np.sin(0.2 * y)
    return {"h": h, "U": U, "V": V, "eta_mean": eta_mean, "Hrms": hrms, "k": k}


def survey_rows(cfg: dict, seed: int) -> dict:
    """``fidelity.rows`` rows ``x, y`` and every head (float64), the
    positions uniform over the grid's domain."""
    g, n = cfg["grid"], cfg["fidelity"]["rows"]
    u = numpy_rng(seed, 101).random((n, 2))
    x = g["x_min"] + u[:, 0] * (g["x_max"] - g["x_min"])
    y = g["y_min"] + u[:, 1] * (g["y_max"] - g["y_min"])
    return {"x": x, "y": y, **beach_fields(x, y)}


def residual_grid(cfg: dict, seed: int) -> dict:
    """The ``(ny, nx)`` grids ``x``, ``y`` and every head, ``x`` NaN at
    ``residual.masked`` of the cells the loader's stride keeps."""
    g, r = cfg["grid"], cfg["residual"]
    X, Y = np.meshgrid(np.linspace(g["x_min"], g["x_max"], r["nx"]),
                       np.linspace(g["y_min"], g["y_max"], r["ny"]))
    out = {"x": X.copy(), "y": Y, **beach_fields(X, Y)}
    step = r["interval"]
    kept = out["x"][::step, ::step]
    rows = numpy_rng(seed, 102).choice(kept.size, r["masked"], replace=False)
    iy, ix = np.unravel_index(rows, kept.shape)
    out["x"][iy * step, ix * step] = np.nan
    return out
