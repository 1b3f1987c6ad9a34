"""Synthetic nearshore datasets in the reference's file schema.

Port of the newmethod and CMB parts of the JAX package's
``utils/synthetic.py`` (numpy, the ``csv`` module and ``scipy.io.savemat``
only). The reference consumes private FUNWAVE-TVD products that are not
shipped; these generators write physically plausible stand-ins with the
same layout, so the pipelines run end to end:

* newmethod ``.mat``: columns ``x, y, U, V, h`` of shape ``(N, 1)`` on an
  ``ny x nx`` grid with optional NaN rows in the observed fields (reference
  ``train_newmethod.py:226-250``);
* CMB fidelity CSV with columns ``x, y, h, U, V, eta_mean, Hrms, k``
  (reference ``train.py:217``) and residual ``.mat`` with 2-D grid
  variables (reference ``train.py:258-260``);
* the legacy FUNWAVE snapshot directory: ``dep.out`` and
  ``eta_/u_/v_NNNNN`` grids plus the prep-script fidelity CSV (reference
  ``config.json:38-69``).

Each generator makes the same draws as the JAX package's for the same
arguments, and the text files it writes are byte for byte the JAX ones.
"""

from __future__ import annotations

import csv
import os

import numpy as np
from scipy.io import savemat


def beach_fields_structured(x: np.ndarray, y: np.ndarray, *, q0=-0.7, x0=25.0):
    """Analytic fields where continuity genuinely constrains a structured
    bathymetry: a sloped ``h(x)`` with a sand bar around the 0.75 m anchor
    depth, and a cross-shore flux ``h*U = q(y)`` conserved exactly with
    ``V = 0``, so the true continuity residual is 0 in any coordinates."""
    h = 0.75 - 0.14 * np.tanh((x - 29.0) / 2.0) - 0.10 * np.exp(-((x - 27.5) / 0.7) ** 2)
    q = q0 * (1.0 + 0.15 * np.sin(0.24 * y))
    U = q / h
    V = np.zeros_like(U)
    eta_mean = 0.01 * np.cos(0.4 * (x - x0))
    hrms = 0.2 + 0.05 * np.tanh(0.3 * (x - x0))
    k = 1.5 + 0.2 * np.sin(0.2 * y)
    return {"h": h, "U": U, "V": V, "eta_mean": eta_mean, "Hrms": hrms, "k": k}


def beach_fields(x: np.ndarray, y: np.ndarray, *, h0=0.75, slope=0.02, x0=25.0):
    """Analytic depth + velocity + wave fields on arbitrary coordinates: a
    planar beach under a longshore current from a streamfunction, so the
    continuity residual is small but nonzero."""
    h = h0 - slope * (x - x0)
    U = -(-0.3 * 0.05 * np.sin(0.5 * (x - x0)) * np.sin(0.3 * y))  # -dpsi/dy
    V = 0.5 * 0.05 * np.cos(0.5 * (x - x0)) * np.cos(0.3 * y)      # dpsi/dx
    eta_mean = 0.01 * np.cos(0.4 * (x - x0))
    hrms = 0.2 + 0.05 * np.tanh(0.3 * (x - x0))
    k = 1.5 + 0.2 * np.sin(0.2 * y)
    return {"h": h, "U": U, "V": V, "eta_mean": eta_mean, "Hrms": hrms, "k": k}


FIELD_PROFILES = {"plane": beach_fields, "structured": beach_fields_structured}


def grid(nx=81, ny=261, x_min=25.0, x_max=33.0, y_min=-13.0, y_max=13.0):
    """Meshgrid in the reference test geometry (reference config_CMB.json:66-73)."""
    xs = np.linspace(x_min, x_max, nx)
    ys = np.linspace(y_min, y_max, ny)
    return np.meshgrid(xs, ys)  # shapes (ny, nx)


def make_newmethod_mat(
    path: str,
    *,
    nx=81,
    ny=261,
    nan_fraction=0.05,
    seed=0,
    x_min=25.0,
    x_max=33.0,
    y_min=-13.0,
    y_max=13.0,
    fields="plane",
) -> dict[str, np.ndarray]:
    """Write a ``data_60percent.mat``-style file: ``x, y, U, V, h`` columns.

    ``fields`` picks the analytic field family (:data:`FIELD_PROFILES`).
    Same draws as the JAX package's generator for the same arguments, so
    both packages read one file's worth of identical data."""
    rng = np.random.RandomState(seed)
    X, Y = grid(nx, ny, x_min, x_max, y_min, y_max)
    f = FIELD_PROFILES[fields](X, Y)
    cols = {
        "x": X.reshape(-1, 1),
        "y": Y.reshape(-1, 1),
        "U": f["U"].reshape(-1, 1),
        "V": f["V"].reshape(-1, 1),
        "h": f["h"].reshape(-1, 1),
    }
    n = cols["x"].shape[0]
    n_nan = int(nan_fraction * n)
    if n_nan:
        nan_rows = rng.choice(n, n_nan, replace=False)
        for key in ("U", "V"):  # NaNs live in the observed fields
            cols[key] = cols[key].copy()
            cols[key][nan_rows] = np.nan
    savemat(path, cols)
    return cols


def make_cmb_dataset(
    csv_path: str,
    mat_path: str,
    *,
    nx=81,
    ny=261,
    n_csv=400,
    seed=0,
    x_min=25.0,
    x_max=33.0,
    y_min=-13.0,
    y_max=13.0,
    nan_fraction=0.02,
    fields="plane",
):
    """Write an ``input_fid.csv`` + ``input_res.mat`` pair; returns the CSV
    columns and the ``.mat`` variables. The CSV holds ``n_csv`` uniformly
    drawn gauges, each value in its shortest round-trip decimal form (as
    pandas writes a float64 column); the ``.mat`` holds the ``ny x nx``
    grids, with ``nan_fraction`` of the x cells set to NaN."""
    rng = np.random.RandomState(seed)

    xs = rng.uniform(x_min, x_max, n_csv)
    ys = rng.uniform(y_min, y_max, n_csv)
    columns = {"x": xs, "y": ys, **FIELD_PROFILES[fields](xs, ys)}
    with open(csv_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(list(columns))
        for row in zip(*columns.values()):
            writer.writerow([repr(float(v)) for v in row])

    X, Y = grid(nx, ny, x_min, x_max, y_min, y_max)
    mat = {"x": X, "y": Y, **FIELD_PROFILES[fields](X, Y)}
    n_nan = int(nan_fraction * X.size)
    if n_nan:
        flat_rows = rng.choice(X.size, n_nan, replace=False)
        xg = mat["x"].copy().reshape(-1)
        xg[flat_rows] = np.nan
        mat["x"] = xg.reshape(X.shape)
    savemat(mat_path, mat)
    return columns, mat


def wave_fields(t, x, y, *, h0=2.0, slope=0.004, a=0.15):
    """Time-dependent long-wave fields for the legacy FUNWAVE-snapshot
    pipeline: depth ``h`` (static), surface ``z`` and velocities ``u``/``v``
    as a shoaling wave train — smooth, bounded, physically plausible."""
    h = h0 + slope * np.asarray(x)
    kx, ky, om = 0.02, 0.008, 0.12
    z = a * np.cos(kx * x + ky * y - om * t)
    c = np.sqrt(9.81 / np.maximum(h, 1e-6))
    u = z * c * np.cos(0.01 * y)
    v = 0.3 * z * c * np.sin(0.01 * x)
    return {"h": h, "z": z, "u": u, "v": v}


def make_funwave_snapshot_dir(
    dirpath: str,
    *,
    nx=25,
    ny=21,
    dx=2.0,
    dy=2.0,
    x_min=0.0,
    y_min=0.0,
    snapshots=(200, 201, 202),
    dt=1.0,
    n_fidelity=300,
    nan_fraction=0.0,
    seed=0,
):
    """Write a legacy FUNWAVE snapshot directory and its fidelity CSV
    (reference ``config.json:38-69`` schema): whitespace-ASCII ``dep.out``
    plus ``eta_NNNNN`` / ``u_NNNNN`` / ``v_NNNNN`` grids per snapshot
    (FUNWAVE-TVD naming), and ``fidelity.csv`` in the prep script's format
    (space-separated, headerless, columns ``t x y h z u v``;
    ``input_prep_B2d.py:59``). Returns ``(snapshot_dir, csv_path)``."""
    os.makedirs(dirpath, exist_ok=True)
    rng = np.random.RandomState(seed)
    xs = x_min + dx * np.arange(nx)
    ys = y_min + dy * np.arange(ny)
    X, Y = np.meshgrid(xs, ys)  # (ny, nx)

    np.savetxt(os.path.join(dirpath, "dep.out"), wave_fields(0.0, X, Y)["h"], fmt="%.6f")
    for s in snapshots:
        f = wave_fields(dt * s, X, Y)
        for stem, key in (("eta", "z"), ("u", "u"), ("v", "v")):
            g = f[key]
            if nan_fraction:
                g = g.copy().reshape(-1)
                bad = rng.choice(g.size, int(nan_fraction * g.size), replace=False)
                g[bad] = np.nan
                g = g.reshape(X.shape)
            np.savetxt(os.path.join(dirpath, f"{stem}_{s:05d}"), g, fmt="%.6f")

    # fidelity CSV: random space-time samples of the same fields
    tq = dt * rng.choice(list(snapshots), n_fidelity)
    xq = rng.uniform(xs[0], xs[-1], n_fidelity)
    yq = rng.uniform(ys[0], ys[-1], n_fidelity)
    fq = wave_fields(tq, xq, yq)
    rows = np.column_stack([tq, xq, yq, fq["h"], fq["z"], fq["u"], fq["v"]])
    csv_path = os.path.join(dirpath, "fidelity.csv")
    np.savetxt(csv_path, rows, fmt="%.6f")
    return dirpath, csv_path
