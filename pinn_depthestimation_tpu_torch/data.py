"""Host-side data loading with the reference's exact layout.

Port of the JAX package's ``data.py`` for the newmethod and CMB pipelines:

* :func:`load_cmb_training_data` — CSV fidelity set (round(3), normalize
  with dict-wide min/max, random subsample of ``training_points`` rows;
  reference ``train.py:216-240``) plus ``.mat`` residual grid
  (``[::interval_x, ::interval_y]`` stride, normalized with the *fidelity*
  bounds, Fortran-order flatten, NaN-row drop; reference
  ``train.py:246-277``). The CSV is read with the ``csv`` module, not
  pandas, and ``np.round(., 3)`` stands for ``frame.round(3)``;
* :func:`load_newmethod_training_data` — one ``.mat`` supplying inputs
  (normalized per key, with the config's x/y bounds) and raw true fields,
  with the NaN mask of the trues applied to both (reference
  ``train_newmethod.py:226-255``);
* :func:`load_legacy_training_data` — the legacy ``numerical_model``
  pipeline: the FUNWAVE-extracted fidelity CSV (read with ``csv`` in the
  cases ``pandas.read_csv`` takes, :func:`read_legacy_fidelity_csv`) and a
  directory of time-indexed snapshot grids for the ``(t, x, y, ...)``
  collocation set;
* :func:`load_test_data` — full-grid inputs normalized with dict-wide
  min/max and flattened in C order (reference ``test.py:156-183``).
"""

from __future__ import annotations

import csv
import io
import os
from dataclasses import dataclass, field

import numpy as np
from scipy.io import loadmat

from pinn_depthestimation_tpu_torch import ops
from pinn_depthestimation_tpu_torch.config import Config


def _fortran_column(arr: np.ndarray) -> np.ndarray:
    """reshape(-1, shape[1]) -> transpose -> reshape(-1, 1), exactly as the
    reference flattens residual grids (reference ``train.py:265-267``)."""
    tmp = arr.reshape(-1, arr.shape[1])
    tmp = np.transpose(tmp)
    return tmp.reshape(-1, 1)


def load_mat_var(path: str, key: str) -> np.ndarray:
    data = loadmat(path, variable_names=key)
    if key not in data:
        raise KeyError(f"{path!r} has no variable {key!r}")
    return data[key]


@dataclass
class TrainingData:
    """Assembled full-batch training arrays (host NumPy, float32)."""

    fidelity_input: np.ndarray          # (Nf, d_in) normalized
    fidelity_true: np.ndarray           # (Nf, n_true_outputs)
    residual_input: np.ndarray          # (Nr, d_in) normalized
    input_min_max: dict[str, tuple[float, float]] = field(default_factory=dict)
    # Loader-asserted contract: the fidelity rows ARE the residual rows (the
    # newmethod pipeline slices one forward for both, reference
    # train_newmethod.py:126-156); never inferred from shapes.
    fidelity_is_residual: bool = False


def read_csv_columns(path: str) -> dict[str, np.ndarray]:
    """A CSV with a header row as float64 columns keyed by name (what
    ``pandas.read_csv`` gives for an all-numeric file; empty cells are NaN).
    Python's ``float`` rounds each decimal correctly, pandas' fast parser
    not always: single values may differ in their last bit, which the CMB
    loader's ``round(3)`` removes (the tests hold the two loaders equal,
    array for array)."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        raise ValueError(f"{path!r} is empty")
    header, body = rows[0], [r for r in rows[1:] if r]
    values = np.array([[float(v) if v.strip() else np.nan for v in r] for r in body],
                      dtype=np.float64).reshape(len(body), len(header))
    return {name: values[:, i] for i, name in enumerate(header)}


def load_cmb_training_data(config: Config,
                           rng: np.random.RandomState | None = None) -> TrainingData:
    fd, rd = config.data_fidelity, config.data_residual
    if fd is None or rd is None:
        raise ValueError("the CMB loader needs data_fidelity and data_residual sections")
    if rng is None:
        rng = np.random.RandomState(config.seed)

    # fidelity: CSV -> round(3) -> column dicts (reference train.py:216-225)
    frame = {k: np.round(v, 3) for k, v in read_csv_columns(fd.file).items()}
    fidelity_input = {k: frame[k] for k in frame if k in fd.inputs}
    fidelity_true = {k: frame[k] for k in frame if k in fd.outputs}

    # dict-wide min/max with the x/y config override (reference train.py:228)
    input_min_max = ops.get_min_max(fidelity_input, config.raw)
    for key in fidelity_input:
        lo, hi = input_min_max[key]
        fidelity_input[key] = ops.normalize(fidelity_input[key], lo, hi)

    fid_in = np.column_stack([fidelity_input[k] for k in fd.inputs])
    fid_true = np.column_stack([fidelity_true[k] for k in fd.outputs])

    # random subsample of training_points rows (reference train.py:237-240);
    # 0/absent keeps all rows, and so does a request >= the row count
    if fd.training_points and fd.training_points < fid_in.shape[0]:
        idx = rng.choice(fid_in.shape[0], fd.training_points, replace=False)
        fid_in, fid_true = fid_in[idx, :], fid_true[idx, :]

    # residual: per-variable .mat -> stride -> normalize with the fidelity
    # bounds -> Fortran-order column -> hstack (reference train.py:257-273)
    columns = []
    for key in rd.inputs:
        arr = load_mat_var(rd.file, key)[:: rd.interval_x, :: rd.interval_y]
        lo, hi = input_min_max[key]
        columns.append(_fortran_column(ops.normalize(arr, lo, hi)))
    residual_input = columns[0] if len(columns) == 1 else np.hstack(columns)

    # NaN-row drop (reference train.py:276-277)
    residual_input = residual_input[~np.isnan(residual_input).any(axis=1)]

    return TrainingData(
        fidelity_input=np.asarray(fid_in, dtype=np.float32),
        fidelity_true=np.asarray(fid_true, dtype=np.float32),
        residual_input=np.asarray(residual_input, dtype=np.float32),
        input_min_max=dict(input_min_max),
    )


def load_newmethod_training_data(config: Config) -> TrainingData:
    dc = config.data
    if dc is None:
        raise ValueError("the newmethod loader needs a 'data' section")

    input_min_max: dict[str, tuple[float, float]] = {}
    input_cols = []
    for key in dc.inputs:
        arr = load_mat_var(dc.file, key)
        # per-key 3-arg min/max with the config x/y override
        # (reference train_newmethod.py:231-232)
        lo, hi = ops.get_min_max({key: arr}, key, config.raw)[key]
        input_min_max[key] = (lo, hi)
        input_cols.append(ops.normalize(arr, lo, hi))
    data_input = input_cols[0] if len(input_cols) == 1 else np.hstack(input_cols)

    # trues are used raw, never normalized (reference train_newmethod.py:241-250)
    true_cols = [load_mat_var(dc.file, key) for key in dc.trues]
    data_true = true_cols[0] if len(true_cols) == 1 else np.hstack(true_cols)

    # NaN mask from the trues, applied to both (reference train_newmethod.py:252-255)
    mask = np.isnan(data_true).any(axis=1)
    data_input = data_input[~mask]
    data_true = data_true[~mask]

    # no separate collocation set: the residual runs on the same (masked)
    # inputs (reference train_newmethod.py:156)
    return TrainingData(
        fidelity_input=np.asarray(data_input, dtype=np.float32),
        fidelity_true=np.asarray(data_true, dtype=np.float32),
        residual_input=np.asarray(data_input, dtype=np.float32),
        input_min_max=input_min_max,
        fidelity_is_residual=True,
    )


# the tokens pandas.read_csv reads as NaN by default
_NA_TOKENS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
LEGACY_COLUMNS = ("t", "x", "y", "h", "z", "u", "v")


def _is_number(tok: str) -> bool:
    try:
        float(tok)  # accepts 1.5e-3, nan, inf (dry-gauge rows print 'nan')
        return True
    except ValueError:
        return False


def _float_rows(path: str, rows: list[list[str]], width: int, first_line: int) -> np.ndarray:
    """Rows of fields as a ``(len(rows), width)`` float64 array, as pandas
    builds a numeric frame: a NA token is NaN, a short row is padded with
    NaN, a long row is an error."""
    out = np.full((len(rows), width), np.nan)
    for i, row in enumerate(rows):
        if len(row) > width:
            raise ValueError(f"{path!r}: expected {width} fields in line {first_line + i}, "
                             f"saw {len(row)}")
        for j, tok in enumerate(row):
            if tok.strip() not in _NA_TOKENS:
                out[i, j] = float(tok)
    return out


def read_whitespace_table(path: str, width: int | None = None) -> np.ndarray:
    """A headerless table split on runs of whitespace, as float64 (what
    ``pandas.read_csv(sep=r"\\s+", header=None)`` reads): blank lines
    skipped, NA tokens NaN, ``width`` columns (default: the first row's)."""
    with open(path) as f:
        rows = [line.split() for line in f if line.split()]
    if not rows:
        raise ValueError(f"{path!r} is empty")
    return _float_rows(path, rows, width or len(rows[0]), 1)


def _sniffed_rows(text: str) -> list[list[str]]:
    """``pandas.read_csv(sep=None, engine="python")``'s split: the delimiter
    sniffed (``csv.Sniffer``) from the first line alone, then the excel
    dialect with that delimiter; blank lines skipped."""
    first = text.splitlines(keepends=True)[0]
    delimiter = csv.Sniffer().sniff(first).delimiter
    return [r for r in csv.reader(io.StringIO(text), delimiter=delimiter, strict=True) if r]


def read_legacy_fidelity_csv(path: str) -> dict[str, np.ndarray]:
    """The legacy FUNWAVE-extracted fidelity CSV as float64 columns by name.

    The reference's prep script writes it space-separated with no header in
    the column order ``t x y h z u v`` (reference
    ``utilities/input_prep_B2d.py:4,59``), while ``train.py:217`` reads it
    as if it had one (SURVEY.md §5 quirk 5). As the JAX package's reader
    does: a first line that is not all numbers (``nan`` counts as a number)
    is a header, and the delimiter is sniffed from it; a headerless file
    with a comma on its first line is sniffed too; any other headerless
    file splits on runs of whitespace (hand- or Fortran-aligned columns).
    A headerless file must have the seven prep-script columns."""
    with open(path, newline="") as f:
        text = f.read()
    lines = text.splitlines()
    if not lines or not text.strip():
        raise ValueError(f"{path!r} is empty")
    first = lines[0]
    if not all(_is_number(t) for t in first.replace(",", " ").split()):
        header, *body = _sniffed_rows(text)
        values = _float_rows(path, body, len(header), 2)
        return {name: values[:, i] for i, name in enumerate(header)}
    if "," in first:
        rows = _sniffed_rows(text)
        values = _float_rows(path, rows, len(rows[0]), 1)
    else:
        values = read_whitespace_table(path)
    if values.shape[1] != len(LEGACY_COLUMNS):
        raise ValueError(
            f"{path!r}: headerless legacy fidelity CSV must have the "
            f"{len(LEGACY_COLUMNS)} columns {list(LEGACY_COLUMNS)} "
            f"(input_prep_B2d.py order), got {values.shape[1]}"
        )
    return {name: values[:, i] for i, name in enumerate(LEGACY_COLUMNS)}


def _read_funwave_grid(path: str, nx: int, ny: int) -> np.ndarray:
    """One whitespace-ASCII FUNWAVE grid file -> (ny, nx) float array
    (the ``dep.out`` layout read by reference ``input_prep_B2d.py:41-44``)."""
    arr = np.atleast_2d(np.loadtxt(path, dtype=np.float64))
    if arr.shape != (ny, nx):
        raise ValueError(f"{path!r}: expected a ({ny}, {nx}) grid, got {arr.shape}")
    return arr


def load_legacy_training_data(
    config: Config, rng: np.random.RandomState | None = None
) -> TrainingData:
    """The legacy ``numerical_model`` pipeline (reference ``config.json:38-69``):
    fidelity from the FUNWAVE-extracted CSV, residual collocation points from
    a directory of time-indexed snapshot grids. The reference's own
    ``train.py`` cannot run this schema (SURVEY.md §5 quirk 5); this is the
    JAX package's reconstruction, value for value:

    * the fidelity CSV is rounded to 3 decimals (reference ``train.py:218``)
      and its rows with a non-finite used value (FUNWAVE's dry gauges) are
      dropped before the min/max; ``training_points`` rows are drawn with
      ``rng.choice`` (default ``np.random.RandomState(config.seed)``);
    * the coordinate channels ``t``/``X``/``Y`` come from the
      ``numerical_model`` grid block (``t = dt * snapshot``);
    * a field channel (stem ``eta``, ``u``, ...) loads
      ``<dir>/<stem>_<snap:05d>`` (FUNWAVE-TVD naming); a stem that names an
      existing file (``dep.out``) loads once and is tiled over the snapshots;
    * grids are subsampled ``[::interval_y, ::interval_x]`` and flattened in
      Fortran order per snapshot (reference ``train.py:265-267``);
    * a residual input is normalized with the fidelity bounds where the key
      has them (reference ``train.py:263``), else its own range; rows with a
      NaN are dropped.
    """
    fd, rd, nm = config.data_fidelity, config.data_residual, config.numerical_model
    if fd is None or rd is None or nm is None:
        raise ValueError("the legacy loader needs data_fidelity, data_residual and "
                         "numerical_model sections")
    if not rd.snapshots:
        raise ValueError(
            "legacy numerical_model pipeline needs data_residual.numerical_model_snapshots"
        )
    if rng is None:
        rng = np.random.RandomState(config.seed)

    # fidelity: legacy CSV, round(3) (reference train.py:218), dry rows out
    frame = {k: np.round(v, 3) for k, v in read_legacy_fidelity_csv(fd.file).items()}
    missing = [k for k in (*fd.inputs, *fd.outputs) if k not in frame]
    if missing:
        raise KeyError(f"{fd.file!r} is missing fidelity columns {missing}")
    used_cols = list(dict.fromkeys((*fd.inputs, *fd.outputs)))
    finite = np.isfinite(np.column_stack([frame[k] for k in used_cols])).all(axis=1)
    if not finite.any():
        raise ValueError(
            f"{fd.file!r}: every fidelity row has a non-finite value in "
            f"{used_cols} — nothing to train on"
        )
    fidelity_input = {k: frame[k][finite] for k in fd.inputs}
    fidelity_true = {k: frame[k][finite] for k in fd.outputs}
    input_min_max = ops.get_min_max(fidelity_input, config.raw)
    for key in fidelity_input:
        lo, hi = input_min_max[key]
        fidelity_input[key] = ops.normalize(fidelity_input[key], lo, hi)
    fid_in = np.column_stack([fidelity_input[k] for k in fd.inputs])
    fid_true = np.column_stack([fidelity_true[k] for k in fd.outputs])
    if fd.training_points and fd.training_points < fid_in.shape[0]:
        idx = rng.choice(fid_in.shape[0], fd.training_points, replace=False)
        fid_in, fid_true = fid_in[idx, :], fid_true[idx, :]

    # residual: snapshot-grid channels
    ix, iy = nm.interval_x, nm.interval_y
    X, Y = np.meshgrid(nm.x_min + nm.dx * np.arange(nm.nx),
                       nm.y_min + nm.dy * np.arange(nm.ny))   # (ny, nx)
    X, Y = X[::iy, ::ix], Y[::iy, ::ix]
    snaps = list(rd.snapshots)
    if nm.number_of_files is not None:
        bad = [s for s in snaps if not 0 <= s < nm.number_of_files]
        if bad:
            raise ValueError(
                f"snapshots {bad} outside numerical_model.number_of_files={nm.number_of_files}"
            )

    def channel(stem: str) -> np.ndarray:
        """(n_snaps * points, 1) Fortran-flattened stacked channel."""
        low = stem.lower()
        if low == "t":
            t_vals = np.asarray([nm.dt * s for s in snaps], np.float64)
            return np.repeat(t_vals, X.size).reshape(-1, 1)
        if low in ("x", "y"):
            return np.concatenate([_fortran_column(X if low == "x" else Y)] * len(snaps))
        static_path = os.path.join(nm.dir, stem)
        if os.path.exists(static_path):
            g = _read_funwave_grid(static_path, nm.nx, nm.ny)[::iy, ::ix]
            return np.concatenate([_fortran_column(g)] * len(snaps))
        cols = []
        for s in snaps:
            snap_path = os.path.join(nm.dir, f"{stem}_{s:05d}")
            if not os.path.exists(snap_path):
                raise FileNotFoundError(
                    f"snapshot file {snap_path!r} not found (stem {stem!r}, snapshot {s}; "
                    f"expected FUNWAVE '<stem>_NNNNN' naming or a static file named {stem!r})"
                )
            cols.append(_fortran_column(_read_funwave_grid(snap_path, nm.nx, nm.ny)[::iy, ::ix]))
        return np.concatenate(cols)

    columns = []
    for key, stem in zip(rd.inputs, rd.input_files):
        col = channel(stem)
        if key in input_min_max:
            lo, hi = input_min_max[key]          # reference train.py:263
        else:
            lo, hi = ops.get_min_max({key: col}, config.raw)[key]
        columns.append(ops.normalize(col, lo, hi))
        input_min_max.setdefault(key, (lo, hi))
    residual_input = np.hstack(columns)
    residual_input = residual_input[~np.isnan(residual_input).any(axis=1)]

    return TrainingData(
        fidelity_input=np.asarray(fid_in, dtype=np.float32),
        fidelity_true=np.asarray(fid_true, dtype=np.float32),
        residual_input=np.asarray(residual_input, dtype=np.float32),
        input_min_max={k: (float(lo), float(hi)) for k, (lo, hi) in input_min_max.items()},
    )


def load_training_data(config: Config, rng: np.random.RandomState | None = None) -> TrainingData:
    if config.kind == "newmethod":
        return load_newmethod_training_data(config)
    rd = config.data_residual
    if config.numerical_model is not None and rd is not None and rd.snapshots and not rd.file:
        return load_legacy_training_data(config, rng)
    return load_cmb_training_data(config, rng)


@dataclass
class TestData:
    __test__ = False  # not a pytest test class

    inputs: np.ndarray                               # (N, d_in) normalized, C-order flatten
    trues: dict[str, np.ndarray]                     # raw grids by output name
    input_min_max: dict[str, tuple[float, float]]


def load_test_data(config: Config) -> TestData:
    td = config.data_test
    if td is None or not td.file:
        raise ValueError("config needs a data_test section with a file")

    raw_inputs = {key: load_mat_var(td.file, key) for key in td.inputs}
    # dict-wide min/max (reference test.py:161); the newmethod test script uses
    # the per-key form (test_newmethod.py:100) — identical bounds either way.
    input_min_max = ops.get_min_max(raw_inputs, config.raw)
    cols = []
    for key in td.inputs:
        lo, hi = input_min_max[key]
        normalized = ops.normalize(raw_inputs[key], lo, hi)
        cols.append(normalized.reshape(-1, 1))  # C-order (reference test.py:178)
    inputs = cols[0] if len(cols) == 1 else np.hstack(cols)

    trues = {key: load_mat_var(td.file, key) for key in td.outputs}
    return TestData(
        inputs=np.asarray(inputs, dtype=np.float32),
        trues=trues,
        input_min_max=dict(input_min_max),
    )
