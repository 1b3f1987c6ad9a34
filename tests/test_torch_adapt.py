"""Test-time adaptation (``Predictor.adapt``, ``perform_optimization``) of the
port held against the JAX package on the CPU.

Both packages load the same weights (the port an ``.npz``, the JAX package
a reference-layout ``.pth`` of the same arrays) and adapt on the same
normalized inputs: a ``continuity_only`` newmethod net and a
``wave_averaged`` CMB net. Tolerances: equal evaluation counts; each
evaluation's loss within 1e-5 relative (f32 against f32
``Precision.HIGHEST``, summed in other orders, as
``tests/test_torch_loss.py`` holds the loss); the parameters after
adaptation within 1e-6 + 1e-4 x the largest parameter change (the step is
the L-BFGS line search's, so its rounding scales with the change); the
predictions after it within 1e-5 relative and 1e-6 absolute.
"""

import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from pinn_depthestimation_tpu import data as jdata
from pinn_depthestimation_tpu import inference as jinference
from pinn_depthestimation_tpu.config import parse_config as jparse
from pinn_depthestimation_tpu.utils import synthetic as jsynthetic
from pinn_depthestimation_tpu.utils import torch_interop as jinterop
from pinn_depthestimation_tpu_torch import cli, data
from pinn_depthestimation_tpu_torch.config import parse_config
from pinn_depthestimation_tpu_torch.inference import Predictor
from pinn_depthestimation_tpu_torch.models import PARAM_KEYS
from pinn_depthestimation_tpu_torch.parity import make_cmb_config

REPO = pathlib.Path(__file__).resolve().parent.parent


def numpy_params(sizes, seed, eta_head=None):
    rng = np.random.RandomState(seed)
    d_in, W, d_out, n_stack = sizes[0], sizes[1], sizes[-1], len(sizes) - 3
    scale = np.sqrt(3.0 / W)
    b_out = rng.uniform(-0.2, 0.2, d_out)
    if eta_head is not None:
        # eta + h away from 0: the 1/(rho*(eta+h)) factor of wave_averaged
        b_out[eta_head] += 1.0
    return {
        "w_in": rng.uniform(-1, 1, (d_in, W)).astype(np.float32),
        "b_in": rng.uniform(-0.1, 0.1, W).astype(np.float32),
        "w_hidden": (rng.uniform(-1, 1, (n_stack, W, W)) * scale).astype(np.float32),
        "b_hidden": rng.uniform(-0.1, 0.1, (n_stack, W)).astype(np.float32),
        "w_out": (rng.uniform(-1, 1, (W, d_out)) * scale).astype(np.float32),
        "b_out": b_out.astype(np.float32),
    }


def newmethod_case(tmp_path, **extra):
    mat = str(tmp_path / "grid.mat")
    jsynthetic.make_newmethod_mat(mat, nx=12, ny=10, nan_fraction=0.1, seed=3)
    with open(REPO / "examples" / "newmethod.json") as f:
        raw = json.load(f)
    raw["layers"].update(hidden_layers=3, hidden_width=12)
    raw["data"]["file"] = mat
    raw["data_test"].update(file=mat, nx=12, ny=10)
    raw.update(extra)
    return raw, numpy_params((2, 12, 12, 12, 3), seed=4)


def cmb_case(tmp_path, **extra):
    csv, mat = str(tmp_path / "input_fid.csv"), str(tmp_path / "input_res.mat")
    jsynthetic.make_cmb_dataset(csv, mat, nx=21, ny=31, n_csv=60, seed=6, nan_fraction=0.03)
    raw = make_cmb_config(csv, mat, 5, 0, hidden_layers=3, hidden_width=10, nx=21, ny=31,
                          interval=2, training_points=40)
    raw["data_test"].pop("model")
    raw.update(extra)
    return raw, numpy_params((2, 10, 10, 10, 6), seed=5, eta_head=3)


CASES = {"newmethod": newmethod_case, "cmb": cmb_case}


def weights_files(tmp_path, arrays):
    npz, pth = str(tmp_path / "w.npz"), str(tmp_path / "w.pth")
    np.savez(npz, **arrays)
    torch.save(jinterop.torch_state_dict_from_params(arrays), pth)
    return npz, pth


class RecordingRunner(jinference.LBFGSRunner):
    """The JAX runner with each chunk's per-evaluation rows kept."""

    rows: list = []

    def run_chunk(self, state, batch):
        state, records = super().run_chunk(state, batch)
        RecordingRunner.rows.append(np.asarray(records))
        return state, records


def jax_adapt(monkeypatch, raw, pth, inputs, **kw):
    monkeypatch.setattr(jinference, "LBFGSRunner", RecordingRunner)
    RecordingRunner.rows = []
    pred = jinference.Predictor(jparse(raw), checkpoint_path=pth)
    evals = pred.adapt(inputs, **kw)
    losses = np.concatenate(RecordingRunner.rows)[:, 2]
    return pred, evals, losses


def finite_rows(inputs):
    return inputs[np.isfinite(inputs).all(axis=1)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_adapt_matches_jax(tmp_path, monkeypatch, case):
    raw, arrays = CASES[case](tmp_path)
    npz, pth = weights_files(tmp_path, arrays)
    cfg = parse_config(raw)
    inputs = finite_rows(data.load_test_data(cfg).inputs)
    np.testing.assert_array_equal(inputs, finite_rows(jdata.load_test_data(jparse(raw)).inputs))

    port = Predictor(cfg, npz, device="cpu")
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(port.params[k].numpy(), arrays[k])
    evals = port.adapt(inputs)
    jpred, jevals, jlosses = jax_adapt(monkeypatch, raw, pth, inputs)

    assert evals == jevals == len(port.adapt_losses) == len(jlosses)
    assert 2 <= evals <= 2 + 26
    np.testing.assert_allclose(port.adapt_losses, jlosses, rtol=1e-5)
    moved = max(float(np.abs(port.params[k].numpy() - arrays[k]).max()) for k in PARAM_KEYS)
    assert moved > 0, "the adaptation must move the parameters"
    for k in PARAM_KEYS:
        np.testing.assert_allclose(port.params[k].numpy(), np.asarray(jpred.params[k]),
                                   rtol=0, atol=1e-6 + 1e-4 * moved, err_msg=k)
    np.testing.assert_allclose(port.predict(inputs), jpred.predict(inputs), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_adapt_through_the_kernel_route_matches_the_plain_route(tmp_path, case):
    """``use_kernel=True`` on the CPU takes ``fused_apply_with_tangents``'s
    plain versions (K2's, then K3's or K4's): the card's route, on the same
    inputs, gives the plain route's evaluations, losses and parameters."""
    raw, arrays = CASES[case](tmp_path)
    npz, _ = weights_files(tmp_path, arrays)
    cfg = parse_config(raw)
    inputs = finite_rows(data.load_test_data(cfg).inputs)
    plain, fused = (Predictor(cfg, npz, device="cpu", use_kernel=u) for u in (False, True))
    assert plain.adapt(inputs) == fused.adapt(inputs)
    np.testing.assert_allclose(fused.adapt_losses, plain.adapt_losses, rtol=1e-6)
    for k in PARAM_KEYS:
        np.testing.assert_allclose(fused.params[k].numpy(), plain.params[k].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_adapt_leaves_out_masked_rows(tmp_path, monkeypatch):
    """The CMB test grid carries NaN x at its masked cells. The port's loss
    leaves those rows out, so adapting on the whole grid equals adapting on
    its finite rows; the JAX ``adapt`` averages over them and ends with NaN
    parameters (a divergence, ``ROADMAP.md`` Queue 3)."""
    raw, arrays = cmb_case(tmp_path)
    npz, pth = weights_files(tmp_path, arrays)
    cfg = parse_config(raw)
    grid = data.load_test_data(cfg).inputs
    assert not np.isfinite(grid).all()
    whole, finite = (Predictor(cfg, npz, device="cpu") for _ in range(2))
    assert whole.adapt(grid) == finite.adapt(finite_rows(grid))
    np.testing.assert_array_equal(whole.adapt_losses, finite.adapt_losses)
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(whole.params[k].numpy(), finite.params[k].numpy())
        assert np.isfinite(whole.params[k].numpy()).all()
    jpred, _, jlosses = jax_adapt(monkeypatch, raw, pth, grid)
    assert np.isnan(jlosses[0])
    assert not all(np.isfinite(np.asarray(v)).all() for v in jpred.params.values())


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_with_perform_optimization_sets_adapted(tmp_path, case):
    """As JAX ``tests/test_inference.py:71-93``: ``run()`` adapts, says so,
    moves the parameters and keeps the evaluation budget."""
    raw, arrays = CASES[case](tmp_path, perform_optimization=True)
    npz, _ = weights_files(tmp_path, arrays)
    pred = Predictor(parse_config(raw), npz, device="cpu")
    result = pred.run()
    assert result.adapted
    assert 2 <= result.adapt_evaluations <= 2 + 26
    assert result.adapt_evaluations == len(pred.adapt_losses)
    assert any(not np.array_equal(arrays[k], pred.params[k].numpy()) for k in PARAM_KEYS)
    # the served grid comes from the adapted weights
    td = data.load_test_data(parse_config(raw))
    first = pred.test_cfg.outputs[0]
    np.testing.assert_array_equal(result.pred[first].reshape(-1), pred.predict(td.inputs)[:, 0])

    without = Predictor(parse_config(dict(raw, perform_optimization=False)), npz, device="cpu")
    result = without.run()
    assert not result.adapted and result.adapt_evaluations == 0
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(without.params[k].numpy(), arrays[k])


def test_adapt_refuses_what_it_cannot_take(tmp_path):
    raw, arrays = newmethod_case(tmp_path)
    npz, _ = weights_files(tmp_path, arrays)
    pred = Predictor(parse_config(raw), npz, device="cpu")
    x = np.zeros((5, 2), np.float32)
    with pytest.raises(ValueError, match=r"needs input coordinates \['t', 'x', 'y'\]"):
        pred.adapt(x, equation="navier_stokes")  # ported; these inputs lack t
    with pytest.raises(KeyError, match="unknown physics"):
        pred.adapt(x, equation="heat")

    renamed = json.loads(json.dumps(raw))
    renamed["data_test"]["inputs"] = {"x": {"requires_grad": ["true"]},
                                      "z": {"requires_grad": ["true"]}}
    for use_kernel in (False, True):
        pred = Predictor(parse_config(renamed), npz, device="cpu", use_kernel=use_kernel)
        with pytest.raises(ValueError, match="missing"):
            pred.adapt(x)
    # the kernels differentiate the leading columns: (y, x) is refused on
    # their route and taken on the plain one
    swapped = json.loads(json.dumps(raw))
    swapped["data_test"]["inputs"] = {"y": {"requires_grad": ["true"]},
                                      "x": {"requires_grad": ["true"]}}
    with pytest.raises(ValueError, match="lead"):
        Predictor(parse_config(swapped), npz, device="cpu", use_kernel=True).adapt(x + 0.1)
    assert Predictor(parse_config(swapped), npz, device="cpu").adapt(x + 0.1) >= 1


def test_cli_test_adapts_and_prints_the_evaluations(tmp_path, capsys):
    raw, arrays = newmethod_case(tmp_path, perform_optimization=True)
    npz, _ = weights_files(tmp_path, arrays)
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(raw, f)
    before = sorted(p.name for p in tmp_path.iterdir())
    assert cli.main(["test", "--config", cfg_path, "--model", npz, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Test-time adaptation: " in out and " loss evaluations, physics loss " in out
    evals = int(out.split("Test-time adaptation: ")[1].split()[0])
    assert 2 <= evals <= 2 + 26
    assert "Training" not in out and "Prediction done!" in out
    # nothing trained: no run directory, log or checkpoint appeared
    assert sorted(p.name for p in tmp_path.iterdir()) == before


def test_jax_and_port_load_the_same_weights(tmp_path):
    raw, arrays = cmb_case(tmp_path)
    npz, pth = weights_files(tmp_path, arrays)
    port = Predictor(parse_config(raw), npz, device="cpu")
    jpred = jinference.Predictor(jparse(raw), checkpoint_path=pth)
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(port.params[k].numpy(),
                                      np.asarray(jax.device_get(jpred.params[k])))
