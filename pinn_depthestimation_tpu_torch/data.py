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
* :func:`load_test_data` — full-grid inputs normalized with dict-wide
  min/max and flattened in C order (reference ``test.py:156-183``).

The legacy loader comes with its pipeline (``ROADMAP.md`` M9), and
:func:`load_training_data` raises for it.
"""

from __future__ import annotations

import csv
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


def load_training_data(config: Config) -> TrainingData:
    if config.kind == "newmethod":
        return load_newmethod_training_data(config)
    rd = config.data_residual
    if config.numerical_model is not None and rd is not None and rd.snapshots and not rd.file:
        raise NotImplementedError(
            f"the {config.kind!r} training loader is not ported yet "
            "(ROADMAP.md Queue 1, M9, legacy pipeline)"
        )
    return load_cmb_training_data(config)


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
