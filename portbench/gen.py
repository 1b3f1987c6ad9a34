"""Inputs made from the seed: survey columns, collocation points, weights.

One seed gives the same inputs on one kind of device, and every seed the
same amount of work: the sizes come from the configuration, only which
rows are masked, where the points fall inside their cells and the weights'
values change with it.

* :func:`survey_columns`: a copy of the port's ``utils/synthetic.py``
  ``make_newmethod_mat`` (the analytic planar beach under a longshore
  current on the ``ny x nx`` survey grid, a fixed share of rows with NaN in
  the observed ``U``, ``V``), in numpy, its masked rows drawn by
  ``numpy.random.default_rng`` so that seeds of any size are taken.
* :func:`collocation_points`: a grid of cells over the survey's domain, one
  point drawn uniformly inside each cell, normalized to ``[-1, 1]^2``.
* :func:`init_params`: Xavier-uniform weights (tanh nets), zero hidden
  biases and a uniform output bias in ``+-1/sqrt(W)``, as the reference's
  ``dnn.py`` initializes, drawn on the device by one ``torch.Generator``
  call.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def numpy_rng(seed: int, stream: int = 0) -> np.random.Generator:
    return np.random.default_rng([seed % 2**64, stream])


def plane_fields(x: np.ndarray, y: np.ndarray, h0=0.75, slope=0.02, x0=25.0) -> dict:
    """The port's ``beach_fields``: a planar beach and a longshore current
    from a streamfunction."""
    h = h0 - slope * (x - x0)
    U = -(-0.3 * 0.05 * np.sin(0.5 * (x - x0)) * np.sin(0.3 * y))
    V = 0.5 * 0.05 * np.cos(0.5 * (x - x0)) * np.cos(0.3 * y)
    return {"h": h, "U": U, "V": V}


def survey_columns(grid: dict, seed: int) -> dict:
    """Columns ``x, y, U, V, h`` (float64, row-major over the ``(ny, nx)``
    grid) with ``int(nan_fraction * nx * ny)`` rows of NaN in ``U``, ``V``."""
    xs = np.linspace(grid["x_min"], grid["x_max"], grid["nx"])
    ys = np.linspace(grid["y_min"], grid["y_max"], grid["ny"])
    X, Y = np.meshgrid(xs, ys)
    f = plane_fields(X, Y)
    cols = {"x": X.reshape(-1), "y": Y.reshape(-1),
            "U": f["U"].reshape(-1).copy(), "V": f["V"].reshape(-1).copy(),
            "h": f["h"].reshape(-1)}
    n = cols["x"].shape[0]
    n_nan = int(grid["nan_fraction"] * n)
    if n_nan:
        rows = numpy_rng(seed).choice(n, n_nan, replace=False)
        cols["U"][rows] = np.nan
        cols["V"][rows] = np.nan
    return cols


def collocation_points(cells: dict, seed: int, n_sets: int) -> list[np.ndarray]:
    """``n_sets`` sets of ``nx * ny`` points (float32, ``(N, 2)``), one
    uniform point in each cell of the ``nx x ny`` grid over the domain,
    normalized to ``[-1, 1]`` with the domain's bounds."""
    nx, ny = cells["nx"], cells["ny"]
    ix, iy = np.meshgrid(np.arange(nx), np.arange(ny))
    ix, iy = ix.reshape(-1), iy.reshape(-1)
    out = []
    for k in range(n_sets):
        jitter = numpy_rng(seed, 1 + k).random((ix.shape[0], 2))
        x = cells["x_min"] + (ix + jitter[:, 0]) * (cells["x_max"] - cells["x_min"]) / nx
        y = cells["y_min"] + (iy + jitter[:, 1]) * (cells["y_max"] - cells["y_min"]) / ny
        xn = 2.0 * (x - cells["x_min"]) / (cells["x_max"] - cells["x_min"]) - 1.0
        yn = 2.0 * (y - cells["y_min"]) / (cells["y_max"] - cells["y_min"]) - 1.0
        out.append(np.stack([xn, yn], axis=1).astype(np.float32))
    return out


def init_params(layers: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The six parameter arrays of ``d_in -> [W] x L -> d_out`` (tanh,
    Xavier) from one uniform draw on ``device``."""
    if layers["init_type"] != "xavier":
        raise ValueError("the benchmark's nets are tanh nets with Xavier weights")
    d_in, W, L, d_out = (layers["input_features"], layers["hidden_width"],
                         layers["hidden_layers"], layers["output_features"])
    shapes = {"w_in": (d_in, W), "w_hidden": (L - 1, W, W), "w_out": (W, d_out),
              "b_out": (d_out,)}
    bounds = {"w_in": math.sqrt(6.0 / (d_in + W)), "w_hidden": math.sqrt(6.0 / (2 * W)),
              "w_out": math.sqrt(6.0 / (W + d_out)), "b_out": 1.0 / math.sqrt(W)}
    sizes = [math.prod(s) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    draw = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    params, off = {}, 0
    for (name, shape), size in zip(shapes.items(), sizes):
        params[name] = ((draw[off:off + size] * 2 - 1) * bounds[name]).reshape(shape)
        off += size
    params["b_in"] = torch.zeros(W, device=device)
    params["b_hidden"] = torch.zeros(L - 1, W, device=device)
    return {k: params[k].contiguous() for k in ("w_in", "b_in", "w_hidden", "b_hidden",
                                                 "w_out", "b_out")}
