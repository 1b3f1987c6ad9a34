"""The CMB configuration recipe of the JAX package's ``parity.py``.

Only :func:`make_cmb_config` and its constants are ported (the CMB Adam-step
bench and ``chip_smoke.py`` use them); the parity harness itself is queued
(``ROADMAP.md`` Queue 1, M12).
"""

from __future__ import annotations

# Non-uniform per-output fidelity weights so a run exercises the
# reference's weighted fidelity sum (train.py:136-141): a weight-handling
# bug would shift the fidelity loss from iteration 1.
_CMB_OUTPUTS = ("h", "U", "V", "eta_mean", "Hrms", "k")
_CMB_WEIGHTS = (2.0, 1.0, 1.0, 1.0, 0.5, 0.5)


def make_cmb_config(csv_path: str, mat_path: str, adam_iters: int,
                    lbfgs_iters: int, tol_grad: float = 1e-5,
                    tol_change: float = 1e-7, hidden_layers: int = 10,
                    hidden_width: int = 10, nx: int = 81,
                    ny: int = 261, interval: int = 10,
                    training_points: int = 12) -> dict:
    """The reference's own config_CMB.json recipe (2->[10]x10->6 MLP,
    training_points=12, 10x10 residual stride — reference
    ``config_CMB.json:2-56``) with synthetic stand-ins for its private
    ``../data/G1a`` products and non-uniform per-output weights, as a raw
    config dict."""
    return {
        "layers": {"input_features": 2, "hidden_layers": hidden_layers,
                   "hidden_width": hidden_width, "output_features": 6,
                   "dropout_rate": 0.0, "init_type": "xavier"},
        "adam_optimizer": {"max_it": adam_iters, "learning_rate": 1e-4,
                           "scheduler_step_size": 10000, "scheduler_gamma": 0.8},
        "lbfgs_optimizer": {"max_it": lbfgs_iters, "learning_rate": 1,
                            "max_evaluation": round(lbfgs_iters * 1.25),
                            "history_size": 100, "tolerance_grad": tol_grad,
                            "tolerance_change": tol_change,
                            "line_search_fn": "strong_wolfe"},
        "loss": {**{f"weight_{k}_loss": w for k, w in
                    zip(_CMB_OUTPUTS, _CMB_WEIGHTS)},
                 "weight_fid_loss": 1, "weight_res_loss": 1},
        "data_fidelity": {"file": csv_path, "inputs": ["x", "y"],
                          "outputs": list(_CMB_OUTPUTS),
                          "training_points": training_points},
        "data_residual": {"file": mat_path,
                          "inputs": {"x": {"requires_grad": ["true"]},
                                     "y": {"requires_grad": ["true"]}},
                          "outputs": list(_CMB_OUTPUTS), "snapshots": [1],
                          "interval_x": interval, "interval_y": interval},
        "data_test": {"model": "unused", "file": mat_path,
                      "inputs": {"x": {"requires_grad": ["true"]},
                                 "y": {"requires_grad": ["true"]}},
                      "outputs": list(_CMB_OUTPUTS), "nx": nx, "ny": ny,
                      "dx": 0.1, "dy": 0.1, "x_min": 25.0, "x_max": 33.0,
                      "y_min": -13.0, "y_max": 13.0, "dt": 1.0},
        "plot": {"font_size": 14, "x_limits": [25, 33], "y_limits": [-13, 13],
                 "c_limits": [-1, 1], "eta_limits": [-1, 1], "dir": "plots"},
    }
