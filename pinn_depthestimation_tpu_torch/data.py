"""Host-side test-grid loading with the reference's exact layout.

Port of the serving subset of the JAX package's ``data.py``: the ``.mat``
reader and :func:`load_test_data` — full-grid inputs normalized with
dict-wide min/max and flattened in C order (reference ``test.py:156-183``).
The train-time loaders (CSV via pandas, the residual grid's Fortran-order
flatten in use) come with the training slice; :func:`_fortran_column` is
kept here for them.
"""

from __future__ import annotations

from dataclasses import dataclass

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
