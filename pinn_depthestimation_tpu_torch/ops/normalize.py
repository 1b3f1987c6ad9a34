"""Normalization ops with the reference's exact semantics.

Port of the JAX package's ``ops/normalize.py``: affine map to/from
``[-1, 1]`` with a degenerate-range guard (reference ``operations.py:4-13``)
and min/max lookup that prefers config-supplied bounds for the spatial
coordinates ``x``/``y`` (reference ``operations.py:16-30``).

The functions are pure arithmetic, so they work on NumPy arrays and torch
tensors alike; the loaders call them on host NumPy arrays.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np


def normalize(data, data_min, data_max):
    """Map ``data`` affinely from ``[data_min, data_max]`` to ``[-1, 1]``.

    Degenerate ranges return zeros (reference ``operations.py:5-6``).
    """
    if float(data_max) == float(data_min):
        return data * 0
    return 2 * (data - data_min) / (data_max - data_min) - 1


def denormalize(data, data_min, data_max):
    """Inverse of :func:`normalize` (reference ``operations.py:10-13``).

    Degenerate ranges return zeros shaped like ``data``, as the JAX package
    does (the reference returns a scalar there; the branch is unreachable in
    every shipped pipeline).
    """
    if float(data_max) == float(data_min):
        return data * 0
    return (data + 1) / 2 * (data_max - data_min) + data_min


def _bounds_for_key(data: Mapping[str, Any], key: str, config: Mapping[str, Any]):
    """Config-supplied bounds for x/y, nan-aware data min/max otherwise
    (reference ``operations.py:19-28``)."""
    test_cfg = config.get("data_test", {}) if isinstance(config, Mapping) else {}
    if key == "x" and "x_min" in test_cfg and "x_max" in test_cfg:
        return float(test_cfg["x_min"]), float(test_cfg["x_max"])
    if key == "y" and "y_min" in test_cfg and "y_max" in test_cfg:
        return float(test_cfg["y_min"]), float(test_cfg["y_max"])
    arr = np.asarray(data[key], dtype=np.float64)
    return float(np.nanmin(arr)), float(np.nanmax(arr))


def get_min_max(data, key_or_config, config=None):
    """Min/max bounds for normalization, serving both reference call patterns.

    * ``get_min_max(data, key, config)`` — per-key form (reference
      ``operations.py:16``); returns ``{key: (min, max)}``.
    * ``get_min_max(data_dict, config)`` — dict-wide form (reference
      ``train.py:228``, ``test.py:161``): bounds for *every* key in the dict,
      with the x/y config override applied per key.
    """
    if config is None:
        config = key_or_config
        if not isinstance(config, Mapping):
            raise TypeError("get_min_max(data, config): config must be a mapping")
        return {key: _bounds_for_key(data, key, config) for key in data}
    key = key_or_config
    return {key: _bounds_for_key(data, key, config)}
