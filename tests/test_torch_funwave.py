"""The port's FUNWAVE gauge ETL (``pinn_depthestimation_tpu_torch.utils.
funwave``) against the JAX package's pandas module: the CSV byte for byte
and the returned columns bit for bit, on the JAX test's fixture
(``tests/test_funwave.py``), both presets, and a station with ``nan``
rows (a dry gauge: pandas writes an empty field)."""

import os

import numpy as np
import pytest

from pinn_depthestimation_tpu.utils import funwave as jfunwave
from pinn_depthestimation_tpu_torch.utils import funwave


def funwave_dir(path, *, n_stations=4, n_rows=50, nan_station=None, fmt="%.6f", seed=0):
    """The JAX test's FUNWAVE-TVD output directory: stations, gauges, depth;
    ``nan_station`` gets rows 3-5 of its z, u, v as ``nan``."""
    rs = np.random.RandomState(seed)
    nx, ny = 10, 8
    for i in range(1, n_stations + 1):
        arr = np.column_stack([np.arange(n_rows) * 0.05, rs.randn(n_rows) * 0.123456,
                               rs.randn(n_rows) * 0.654321, rs.randn(n_rows) * 0.2])
        if i == nan_station:
            arr[3:6, 1:] = np.nan
        np.savetxt(path / f"sta_{i:04d}", arr, fmt=fmt)
    gauges = np.column_stack([rs.randint(1, nx + 1, n_stations),
                              rs.randint(1, ny + 1, n_stations)])
    np.savetxt(path / "gauges.txt", gauges, fmt="%d")
    np.savetxt(path / "dep.out", rs.uniform(0.5, 2.0, (ny, nx)), fmt="%.4f")
    return str(path)


def assert_same(got_cols, frame, got_csv, want_csv):
    with open(got_csv, "rb") as f, open(want_csv, "rb") as g:
        assert f.read() == g.read()
    assert list(got_cols) == list(frame.columns) == list(funwave.COLUMNS)
    for k in got_cols:
        np.testing.assert_array_equal(got_cols[k], frame[k].to_numpy(np.float64), err_msg=k)


@pytest.mark.parametrize("nan_station", [None, 2])
@pytest.mark.parametrize("window, spacing", [((10, 30), (2.0, 2.0)), ((1, 60), (1.0, 1.0)),
                                             ((5, 9), (0.5, 2.0))])
def test_station_csv_matches_jax(tmp_path, nan_station, window, spacing):
    directory = funwave_dir(tmp_path, nan_station=nan_station)
    kw = dict(n_stations=4, row_start=window[0], row_stop=window[1], dx=spacing[0],
              dy=spacing[1])
    got_csv, want_csv = os.path.join(directory, "p.csv"), os.path.join(directory, "j.csv")
    cols = funwave.prepare_station_csv(directory, got_csv, **kw)
    frame = jfunwave.prepare_station_csv(directory, want_csv, **kw)
    assert_same(cols, frame, got_csv, want_csv)
    if nan_station and window[0] < 6:
        # a dry row: empty fields where pandas writes NaN
        with open(got_csv) as f:
            assert any(line.endswith("   \n") for line in f)


def test_presets_match_jax(tmp_path):
    """Both presets on the JAX test's 20-station, 10,200-row fixture: the
    station counts, row windows, spacings and default file names."""
    rs = np.random.RandomState(1)
    n_rows = 10_200
    for i in range(1, 21):
        arr = np.column_stack([np.arange(n_rows) * 0.05, rs.randn(n_rows), rs.randn(n_rows),
                               rs.randn(n_rows)])
        np.savetxt(tmp_path / f"sta_{i:04d}", arr, fmt="%.4f")
    np.savetxt(tmp_path / "gauges.txt",
               np.column_stack([rs.randint(1, 11, 20), rs.randint(1, 9, 20)]), fmt="%d")
    np.savetxt(tmp_path / "dep.out", rs.uniform(0.5, 2.0, (8, 10)), fmt="%.4f")
    for port, ref, name, rows in ((funwave.prepare_beach1d, jfunwave.prepare_beach1d,
                                   "beach1d_2.csv", 20 * (10_190 - 5_092)),
                                  (funwave.prepare_beach2d_irr, jfunwave.prepare_beach2d_irr,
                                   "beach2d_irr.csv", 12 * (1_001 - 201))):
        frame = ref(str(tmp_path))
        os.rename(tmp_path / name, tmp_path / ("jax_" + name))
        cols = port(str(tmp_path))
        assert len(cols["t"]) == rows
        assert_same(cols, frame, str(tmp_path / name), str(tmp_path / ("jax_" + name)))
