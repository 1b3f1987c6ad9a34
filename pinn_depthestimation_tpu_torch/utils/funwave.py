"""FUNWAVE-TVD gauge-output ETL (capability of reference
``utilities/input_prep_B1d.py`` / ``input_prep_B2d.py``).

Port of the JAX package's ``utils/funwave.py``, with numpy in place of
pandas. It builds the training CSV the legacy pipeline reads from
raw FUNWAVE-TVD products: per-station time series ``sta_%04d`` with columns
``t, z, u, v``, a ``gauges.txt`` of 1-based (x, y) grid indices, and a
``dep.out`` depth grid. Output rows are ``t x y h z u v`` space-separated
with no header, byte for byte what the JAX module's
``DataFrame.to_csv(sep=" ", header=False, index=False)`` writes: each float
as its shortest repr, a NaN (a dry gauge's ``nan``) as an empty field.

The two reference scripts differ only in parameters: B1d uses 20 stations,
rows ``5092:10190``, ``dx = dy = 1``; B2d uses 12 stations, rows
``201:1001``, ``dx = dy = 2`` (reference ``input_prep_B1d.py:15-58``,
``input_prep_B2d.py:9-10,17-59``). One parameterized function covers both;
the presets reproduce each script.
"""

from __future__ import annotations

import math
import os

import numpy as np

from pinn_depthestimation_tpu_torch.data import read_whitespace_table

COLUMNS = ("t", "x", "y", "h", "z", "u", "v")


def _field(value) -> str:
    """One value as ``to_csv`` writes it: ints as ints, floats by their
    shortest repr, NaN as an empty field."""
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    value = float(value)
    return "" if math.isnan(value) else repr(value)


def prepare_station_csv(
    directory: str,
    output_csv: str,
    *,
    n_stations: int,
    row_start: int,
    row_stop: int,
    dx: float = 1.0,
    dy: float = 1.0,
    gauges_file: str = "gauges.txt",
    depth_file: str = "dep.out",
    station_pattern: str = "sta_%04d",
) -> dict[str, np.ndarray]:
    """Assemble the ``t x y h z u v`` training CSV from FUNWAVE outputs;
    returns its columns by name."""
    gauges = read_whitespace_table(os.path.join(directory, gauges_file))
    depth = read_whitespace_table(os.path.join(directory, depth_file))

    rows: list[list] = []
    for i in range(1, n_stations + 1):
        data = read_whitespace_table(os.path.join(directory, station_pattern % i), 4)
        # rounding exactly as the reference: t to 0.01, fields to 0.001
        data = np.column_stack([np.round(data[:, 0], 2), np.round(data[:, 1:], 3)])
        data = data[row_start:row_stop]

        idx_x, idx_y = (int(v) for v in gauges[i - 1, :2])
        h = round(float(depth[idx_y - 1, idx_x - 1]), 2)
        x, y = (idx_x - 1) * dx, (idx_y - 1) * dy
        rows += [[t, x, y, h, z, u, v] for t, z, u, v in data.tolist()]

    with open(output_csv, "w") as f:
        for row in rows:
            f.write(" ".join(_field(v) for v in row) + "\n")
    table = np.asarray(rows, dtype=np.float64).reshape(-1, len(COLUMNS))
    return {name: table[:, j] for j, name in enumerate(COLUMNS)}


def prepare_beach1d(directory: str, output_csv: str | None = None) -> dict[str, np.ndarray]:
    """The B1d preset: 20 stations, rows 5092:10190, unit grid spacing."""
    output_csv = output_csv or os.path.join(directory, "beach1d_2.csv")
    return prepare_station_csv(
        directory, output_csv, n_stations=20, row_start=5092, row_stop=10190,
        dx=1.0, dy=1.0,
    )


def prepare_beach2d_irr(directory: str, output_csv: str | None = None) -> dict[str, np.ndarray]:
    """The B2d preset: 12 stations, rows 201:1001, 2 m grid spacing."""
    output_csv = output_csv or os.path.join(directory, "beach2d_irr.csv")
    return prepare_station_csv(
        directory, output_csv, n_stations=12, row_start=201, row_stop=1001,
        dx=2.0, dy=2.0,
    )
