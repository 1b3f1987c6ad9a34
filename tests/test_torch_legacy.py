"""The legacy FUNWAVE-snapshot pipeline of the port (the ``numerical_model``
loader, ``navier_stokes``, ``synth --legacy``, ``adapt(equation=
'navier_stokes')``) held against the JAX package on the CPU.

Inputs come from the JAX package's own fixture (``tests/
test_legacy_numerical_model.py``: a 25x21 grid, snapshots 200-202, interval
2, seed 3) and from seeded numpy weights. Tolerances: the loader's arrays
and bounds bit for bit; a loss rel 1e-5 and each gradient within 1e-4 x
max|g| + 1e-7 (f32 against f32 ``Precision.HIGHEST``, summed in other
orders; measured: 1.3e-7 and 5.0e-7 of max|g|); the CSV reader's columns
bit for bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import savemat

from pinn_depthestimation_tpu import cli as jcli
from pinn_depthestimation_tpu import data as jdata
from pinn_depthestimation_tpu import inference as jinference
from pinn_depthestimation_tpu import physics as jphysics
from pinn_depthestimation_tpu.config import parse_config as jparse
from pinn_depthestimation_tpu.models import MLPSpec as JSpec
from pinn_depthestimation_tpu.training import Trainer as JTrainer
from pinn_depthestimation_tpu.training import loss as jloss
from pinn_depthestimation_tpu.training.logging_utils import read_log as jread_log
from pinn_depthestimation_tpu.utils import synthetic as jsynthetic
from pinn_depthestimation_tpu.utils import torch_interop as jinterop
from pinn_depthestimation_tpu_torch import cli, data, physics
from pinn_depthestimation_tpu_torch.config import parse_config
from pinn_depthestimation_tpu_torch.inference import Predictor
from pinn_depthestimation_tpu_torch.models import PARAM_KEYS, MLPSpec, params_from_numpy
from pinn_depthestimation_tpu_torch.ops import kernels_vjp
from pinn_depthestimation_tpu_torch.training import loss
from pinn_depthestimation_tpu_torch.training.driver import Trainer, decide_kernels
from pinn_depthestimation_tpu_torch.training.logging_utils import read_log
from pinn_depthestimation_tpu_torch.utils import synthetic

NX, NY, DX, DY = 25, 21, 2.0, 2.0
SNAPS = (200, 201, 202)
KEYS = ("fidelity_input", "fidelity_true", "residual_input")


def legacy_raw(snap_dir, csv_path, *, interval=2, adam_it=8, lbfgs_it=3, **extra):
    """The JAX fixture's ``config.json``-shaped dict: inputs t, x, y, u, v;
    outputs h, z, u, v; ``navier_stokes``."""
    raw = {
        "layers": {"input_features": 5, "hidden_layers": 3, "hidden_width": 16,
                   "output_features": 4, "dropout_rate": 0.0, "init_type": "xavier"},
        "adam_optimizer": {"max_it": adam_it, "learning_rate": 1e-3,
                           "scheduler_step_size": 100, "scheduler_gamma": 0.8},
        "lbfgs_optimizer": {"max_it": lbfgs_it, "learning_rate": 1,
                            "max_evaluation": 4 * max(lbfgs_it, 1), "history_size": 10,
                            "tolerance_grad": 1e-9, "tolerance_change": 1e-12,
                            "line_search_fn": "strong_wolfe"},
        "loss": {"weight_fid_loss": 1, "weight_res_loss": 1},
        "data_fidelity": {"dir": csv_path, "inputs": ["t", "x", "y", "u", "v"],
                          "outputs": ["h", "z", "u", "v"], "training_points": 200},
        "data_residual": {
            "inputs": {"t": {"file": "t", "requires_grad": ["true"]},
                       "x": {"file": "X", "requires_grad": ["true"]},
                       "y": {"file": "Y", "requires_grad": ["true"]},
                       "u": {"file": "u", "requires_grad": ["false"]},
                       "v": {"file": "v", "requires_grad": ["false"]}},
            "outputs": {"h": {"file": "dep.out"}, "z": {"file": "eta"},
                        "u": {"file": "u"}, "v": {"file": "v"}},
            "numerical_model_snapshots": list(SNAPS),
        },
        "numerical_model": {"dir": snap_dir, "nx": NX, "ny": NY, "dx": DX, "dy": DY,
                            "x_min": 0.0, "x_max": DX * (NX - 1), "y_min": 0.0,
                            "y_max": DY * (NY - 1), "interval_x": interval,
                            "interval_y": interval, "dt": 1.0, "number_of_files": 501},
        "physics": "navier_stokes",
    }
    raw.update(extra)
    return raw


@pytest.fixture
def snapshots(tmp_path):
    return jsynthetic.make_funwave_snapshot_dir(
        str(tmp_path / "beach2d"), nx=NX, ny=NY, dx=DX, dy=DY, snapshots=SNAPS, seed=3)


def numpy_params(sizes, seed):
    rng = np.random.RandomState(seed)
    d_in, W, d_out, n_stack = sizes[0], sizes[1], sizes[-1], len(sizes) - 3
    scale = np.sqrt(3.0 / W)
    return {
        "w_in": rng.uniform(-1, 1, (d_in, W)).astype(np.float32),
        "b_in": rng.uniform(-0.1, 0.1, W).astype(np.float32),
        "w_hidden": (rng.uniform(-1, 1, (n_stack, W, W)) * scale).astype(np.float32),
        "b_hidden": rng.uniform(-0.1, 0.1, (n_stack, W)).astype(np.float32),
        "w_out": (rng.uniform(-1, 1, (W, d_out)) * scale).astype(np.float32),
        "b_out": rng.uniform(-0.2, 0.2, d_out).astype(np.float32),
    }


def assert_loaded_equal(raw):
    td = data.load_training_data(parse_config(raw))
    jtd = jdata.load_training_data(jparse(raw))
    for k in KEYS:
        got, want = getattr(td, k), getattr(jtd, k)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert td.input_min_max == jtd.input_min_max
    assert not td.fidelity_is_residual and not jtd.fidelity_is_residual
    return td


def assert_close(port_out, jax_out):
    """Loss terms rel 1e-5; each gradient within 1e-4 x max|g| + 1e-7."""
    (t2, (f2, r2)), g2 = port_out
    (t1, (f1, r1)), g1 = jax_out
    for a, b in ((t1, t2), (f1, f2), (r1, r2)):
        assert float(b) == pytest.approx(float(a), rel=1e-5)
    for k in PARAM_KEYS:
        want = np.asarray(g1[k])
        np.testing.assert_allclose(g2[k].numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max() + 1e-7, err_msg=k)


# ------------------------------------------------------------------ loader

@pytest.mark.parametrize("interval", [1, 2])
def test_legacy_loader_matches_jax(snapshots, interval):
    td = assert_loaded_equal(legacy_raw(*snapshots, interval=interval))
    per_snap = -(-NX // interval) * -(-NY // interval)
    assert td.residual_input.shape == (len(SNAPS) * per_snap, 5)
    assert td.fidelity_input.shape == (200, 5) and td.fidelity_true.shape == (200, 4)
    t_blocks = td.residual_input[:, 0].reshape(len(SNAPS), -1)
    assert (t_blocks == t_blocks[:, :1]).all() and (np.diff(t_blocks[:, 0]) > 0).all()


def test_legacy_loader_takes_every_row_below_training_points(snapshots):
    """``training_points`` at or above the row count keeps every row, in
    file order, with no draw (the smoke's 500 of 300 rows)."""
    td = assert_loaded_equal(legacy_raw(*snapshots, data_fidelity={
        "dir": snapshots[1], "inputs": ["t", "x", "y", "u", "v"],
        "outputs": ["h", "z", "u", "v"], "training_points": 500}))
    assert td.fidelity_input.shape == (300, 5)


def test_legacy_loader_static_file_and_missing_snapshot(snapshots):
    raw = legacy_raw(*snapshots)
    raw["data_residual"]["inputs"]["u"] = {"file": "dep.out", "requires_grad": ["false"]}
    td = assert_loaded_equal(raw)
    u = td.residual_input[:, 3].reshape(len(SNAPS), -1)
    np.testing.assert_array_equal(u[0], u[1])  # loaded once, tiled

    raw["data_residual"]["inputs"]["u"] = {"file": "nosuch", "requires_grad": ["false"]}
    for load, parse in ((data.load_training_data, parse_config),
                        (jdata.load_training_data, jparse)):
        with pytest.raises(FileNotFoundError, match="nosuch_00200"):
            load(parse(raw))


def test_legacy_loader_snapshot_out_of_range(snapshots):
    raw = legacy_raw(*snapshots)
    raw["data_residual"]["numerical_model_snapshots"] = [200, 999]
    for load, parse in ((data.load_training_data, parse_config),
                        (jdata.load_training_data, jparse)):
        with pytest.raises(ValueError, match=r"\[999\] outside numerical_model.number_of_files=501"):
            load(parse(raw))


def test_legacy_nan_masking(tmp_path):
    snap_dir, csv = jsynthetic.make_funwave_snapshot_dir(
        str(tmp_path / "nan"), nx=NX, ny=NY, snapshots=SNAPS, nan_fraction=0.05, seed=7)
    td = assert_loaded_equal(legacy_raw(snap_dir, csv))
    assert td.residual_input.shape[0] < len(SNAPS) * 13 * 11
    assert np.isfinite(td.residual_input).all()


def test_legacy_dry_gauge_rows(snapshots, tmp_path):
    """A dry gauge's ``nan`` row is dropped before the bounds, as in JAX; an
    all-dry file fails in both."""
    snap_dir, csv = snapshots
    with open(csv, "a") as f:
        f.write("0.00 25.00 -13.00 nan nan nan nan\n")
    td = assert_loaded_equal(legacy_raw(snap_dir, csv, data_fidelity={
        "dir": csv, "inputs": ["t", "x", "y", "u", "v"], "outputs": ["h", "z", "u", "v"],
        "training_points": 500}))
    assert td.fidelity_input.shape[0] == 300 and np.isfinite(td.fidelity_true).all()
    dry = str(tmp_path / "dry.csv")
    with open(dry, "w") as f:
        f.write("0.00 25.00 -13.00 nan nan nan nan\n")
    for load, parse in ((data.load_training_data, parse_config),
                        (jdata.load_training_data, jparse)):
        with pytest.raises(ValueError, match="non-finite"):
            load(parse(legacy_raw(snap_dir, dry)))


CSV_FORMS = {
    "headerless, nan first row": "0.00 25.00 -13.00 nan nan nan nan\n"
                                 "0.05 25.00 -13.00 0.75 0.01 0.02 0.03\n",
    "headerless, commas": "0.00,25.00,-13.00,0.75,0.01,0.02,0.03\n"
                          "0.05,25.00,-12.00,0.74,0.02,0.03,0.04\n",
    "headerless, runs of spaces": " 0.00  25.00  -13.00   0.75  0.01  0.02  0.03\n"
                                  " 0.05  25.00  -12.00   0.74  0.02  0.03  0.04\n\n",
    "headerless, CRLF and a trailing space": "0.00 25.00 -13.00 0.75 0.01 0.02 0.03 \r\n"
                                             "0.05 25.00 -12.00 0.74 0.02 0.03 0.04\r\n",
    "headerless, commas, a short row": "0.00,25.00,-13.00,0.75,0.01,0.02,0.03\n0.05,25.00\n",
    "header, commas, NA tokens": "t,x,y,h,z,u,v\n0.00,25.00,-13.00,0.75,0.01,0.02,0.03\n"
                                 "0.05,25.00,-12.00,,NA,0.03,0.04\n",
    "header, single spaces": "t x y h z u v\n0.00 25.00 -13.00 0.75 0.01 0.02 0.03\n"
                             "0.05 25.00 -12.00 nan 0.02 0.03 0.04\n",
    "header, tabs": "t\tx\ty\th\tz\tu\tv\n0.00\t25.00\t-13.00\t0.75\t0.01\t0.02\t0.03\n",
    "header, other column order, blank lines": "v,u,z,h,y,x,t\n\n"
                                               "0.03,0.02,0.01,0.75,-13.00,25.00,0.00\n\n",
    "header, short row": "t;x;y;h;z;u;v\n0.00;25.00;-13.00;0.75\n",
}


@pytest.mark.parametrize("form", sorted(CSV_FORMS))
def test_fidelity_csv_forms_match_jax(tmp_path, form):
    """The ``csv`` reader against the JAX package's pandas reader, column
    for column, bit for bit (NaN where pandas has NaN)."""
    path = str(tmp_path / "fid.csv")
    with open(path, "w", newline="") as f:
        f.write(CSV_FORMS[form])
    got = data.read_legacy_fidelity_csv(path)
    frame = jdata._read_legacy_fidelity_csv(path)
    assert list(got) == list(frame.columns)
    for k in got:
        np.testing.assert_array_equal(got[k], frame[k].to_numpy(np.float64), err_msg=k)


def test_fidelity_csv_refusals_and_divergence(tmp_path):
    """Six headerless columns: both refuse with the same message. A header
    row split on single spaces over rows aligned with runs of spaces: the
    rows hold more fields than the header, pandas takes the first field as
    an index and shifts every column (t becomes x's values); the port
    refuses, naming the line (``ROADMAP.md`` Queue 3)."""
    six = str(tmp_path / "six.csv")
    with open(six, "w") as f:
        f.write("0 1 2 3 4 5\n")
    for read in (data.read_legacy_fidelity_csv, jdata._read_legacy_fidelity_csv):
        with pytest.raises(ValueError, match=r"must have the 7 columns .* got 6"):
            read(six)
    runs = str(tmp_path / "runs.csv")
    with open(runs, "w") as f:
        f.write("t x y h z u v\n0.00  25.00 -13.00 0.75 0.01 0.02 0.03\n")
    frame = jdata._read_legacy_fidelity_csv(runs)
    assert np.isnan(frame["t"].iloc[0]) and frame["x"].iloc[0] == 25.0  # shifted
    with pytest.raises(ValueError, match="expected 7 fields in line 2, saw 8"):
        data.read_legacy_fidelity_csv(runs)


def test_synth_legacy_files_equal_jax(tmp_path):
    """``synth --legacy`` writes the JAX CLI's files byte for byte."""
    port, ref = tmp_path / "port", tmp_path / "jax"
    assert cli.main(["synth", "--out", str(port), "--nx", "12", "--ny", "10",
                     "--legacy", "--snapshots", "3", "--seed", "4"]) == 0
    assert jcli.main(["synth", "--out", str(ref), "--nx", "12", "--ny", "10",
                      "--legacy", "--snapshots", "3", "--seed", "4"]) == 0
    names = sorted(os.listdir(ref / "beach2d"))
    assert names == sorted(os.listdir(port / "beach2d"))
    assert {"dep.out", "fidelity.csv", "eta_00202", "u_00200", "v_00201"} <= set(names)
    for name in names:
        assert (port / "beach2d" / name).read_bytes() == (ref / "beach2d" / name).read_bytes(), name
    # the generator itself, with NaN cells, against the JAX one
    a, _ = synthetic.make_funwave_snapshot_dir(str(tmp_path / "a"), nx=9, ny=7,
                                               nan_fraction=0.1, seed=5)
    b, _ = jsynthetic.make_funwave_snapshot_dir(str(tmp_path / "b"), nx=9, ny=7,
                                                nan_fraction=0.1, seed=5)
    for name in sorted(os.listdir(b)):
        assert open(os.path.join(a, name), "rb").read() == open(os.path.join(b, name),
                                                                   "rb").read(), name


# ------------------------------------------------------------------ physics

def random_fields(n, seed):
    rng = np.random.RandomState(seed)
    names = ("h", "z", "u", "v")
    fields = {k: rng.uniform(-1, 1, n).astype(np.float32) for k in names}
    fields["h"] += 2.0
    grads = {c: {k: rng.randn(n).astype(np.float32) for k in names} for c in ("t", "x", "y")}
    return fields, grads


def test_navier_stokes_matches_jax():
    """Residuals, the loss with and without a mask, and the statistics form
    with its combiner, against the JAX package at rel 1e-5."""
    fields, grads = random_fields(257, seed=11)
    mask = (np.random.RandomState(12).rand(257) > 0.2).astype(np.float32)
    tf = {k: torch.from_numpy(v) for k, v in fields.items()}
    tg = {c: {k: torch.from_numpy(v) for k, v in g.items()} for c, g in grads.items()}
    jf = {k: jnp.asarray(v) for k, v in fields.items()}
    jg = {c: {k: jnp.asarray(v) for k, v in g.items()} for c, g in grads.items()}
    for got, want in zip(physics.navier_stokes_residuals(tf, tg),
                         jphysics.navier_stokes_residuals(jf, jg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    for m in (None, mask):
        tm = None if m is None else torch.from_numpy(m)
        jm = None if m is None else jnp.asarray(m)
        want = float(jphysics.navier_stokes(None, jf, jg, mask=jm))
        assert float(physics.navier_stokes(None, tf, tg, mask=tm)) == pytest.approx(want, rel=1e-5)
        stats = physics.residual_stats("navier_stokes")(None, tf, tg, mask=tm)
        jstats = jphysics.residual_stats("navier_stokes")(None, jf, jg, mask=jm)
        assert set(stats) == set(jstats)
        for k in stats:
            assert float(stats[k]) == pytest.approx(float(jstats[k]), rel=1e-5), k
        assert float(physics.residual_from_stats("navier_stokes")(stats)) == pytest.approx(
            want, rel=1e-5)
    assert physics.required_grad_coords("navier_stokes") == ("t", "x", "y")
    assert physics.GAMMA_B == jphysics.GAMMA_B == 0.78


# ---------------------------------------------------------------- the loss

@pytest.mark.parametrize("fused", [False, True])
def test_legacy_loss_and_grads_match_jax(snapshots, fused):
    """The legacy loss and its six gradients: the port's plain path against
    JAX's XLA path, and the port's kernel route (K2's and K3's plain
    versions on the CPU) against JAX's fused path (interpret mode) and its
    XLA path."""
    raw = legacy_raw(*snapshots)
    cfg, jcfg = parse_config(raw), jparse(raw)
    td, jtd = data.load_training_data(cfg), jdata.load_training_data(jcfg)
    spec = MLPSpec.from_layers(cfg.layers)
    arrays = numpy_params(spec.sizes, seed=2)
    batch = {k: torch.from_numpy(getattr(td, k)) for k in KEYS}
    jbatch = {k: jnp.asarray(getattr(jtd, k)) for k in KEYS}
    jparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    fn = loss.build_loss_fn(cfg, spec, fused_kernel=fused)
    got = loss.value_and_grad(fn)(params_from_numpy(arrays, "cpu"), batch)
    for jfused in {False, fused}:
        jfn = jloss.build_loss_fn(jcfg, JSpec.from_layers(jcfg.layers), fused_kernel=jfused,
                                  fused_interpret=jfused)
        assert_close(got, jax.value_and_grad(lambda p: jfn(p, jbatch), has_aux=True)(jparams))


@pytest.mark.parametrize("tier, backward", [("f32", "stream"), ("f32x3", "stream"),
                                            ("bf16", "rebuild")])
def test_legacy_kernel_decision(snapshots, tier, backward):
    """On the card the legacy net takes K2 + K3 (K4 at bf16), never K1:
    neither package has a one-kernel contract for ``navier_stokes``. On the
    CPU 'auto' is autograd and 'on' the kernels' plain versions."""
    raw = legacy_raw(*snapshots, kernel_precision=tier)
    cfg = parse_config(raw)
    spec = MLPSpec.from_layers(cfg.layers)
    assert not loss.one_kernel_step_applicable(cfg, spec, False)
    assert decide_kernels(cfg, spec, False, "cuda") == (False, True, True)
    assert decide_kernels(cfg, spec, False, "cpu") == (False, False, False)
    assert decide_kernels(parse_config(dict(raw, fused_kernel="on")), spec, False,
                          "cpu") == (False, True, False)
    assert kernels_vjp.resolve_impl("auto", cfg.resolved_kernel_precision()) == backward
    # the shipped example's width and depth too
    full = dict(raw, layers=dict(raw["layers"], hidden_layers=20, hidden_width=20))
    cfg = parse_config(full)
    assert decide_kernels(cfg, MLPSpec.from_layers(cfg.layers), False, "cuda").fused


@pytest.mark.parametrize("fused", ["auto", "on"])
def test_legacy_trainer_matches_jax_trainer(snapshots, tmp_path, fused):
    """From the same weights: the port's Trainer (autograd, or the kernel
    route's plain versions) against the JAX Trainer on XLA: iteration 1
    within rel 1e-5, the 5-step Adam prefix within rel 1e-4."""
    raw = legacy_raw(*snapshots, adam_it=5, lbfgs_it=0, fused_kernel=fused)
    spec = MLPSpec.from_layers(parse_config(raw).layers)
    init = numpy_params(spec.sizes, seed=7)
    os.makedirs(tmp_path / "port")
    port = Trainer(parse_config(raw), run_dir=str(tmp_path / "port"), echo_every=0,
                   initial_params=init, device="cpu")
    assert port.kernel_plan == (False, fused == "on", False)
    port.train_adam()
    os.makedirs(tmp_path / "jax")
    ref = JTrainer(jparse(dict(raw, fused_kernel="off")), run_dir=str(tmp_path / "jax"),
                   echo_every=0, initial_params={k: jnp.asarray(v) for k, v in init.items()})
    ref.train_adam()
    got, want = np.array(read_log(port.run_dir)[1:]).T, np.array(jread_log(ref.run_dir)[1:]).T
    assert got.shape == want.shape == (5, 3)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_legacy_cli_trains(tmp_path):
    """``synth --legacy`` then CLI ``train`` on a legacy config that names
    its files, on the CPU: every evaluation logged, finite, the loss down."""
    assert cli.main(["synth", "--out", str(tmp_path), "--nx", "13", "--ny", "11",
                     "--legacy", "--snapshots", "3"]) == 0
    snap_dir = str(tmp_path / "beach2d")
    raw = legacy_raw(snap_dir, os.path.join(snap_dir, "fidelity.csv"), interval=1)
    raw["numerical_model"].update(nx=13, ny=11, x_max=24.0, y_max=20.0)
    cfg_path = tmp_path / "legacy.json"
    cfg_path.write_text(json.dumps(raw))
    assert cli.main(["train", "--config", str(cfg_path), "--log-root", str(tmp_path),
                     "--run-name", "run", "--device", "cpu"]) == 0
    epochs, _, _, totals = read_log(str(tmp_path / "run"))
    assert epochs == list(range(1, len(epochs) + 1)) and len(epochs) >= 9
    assert all(np.isfinite(totals)) and totals[-1] < totals[0]
    assert (tmp_path / "run" / "model.npz").exists()


# ----------------------------------------------- the .mat (t, x, y) route

def txyz_raw(mat):
    """``tests/test_navier_stokes_pipeline.py``'s config: the newmethod
    schema over ``(t, x, y)`` with ``navier_stokes``."""
    return {
        "layers": {"input_features": 3, "hidden_layers": 3, "hidden_width": 20,
                   "output_features": 4, "dropout_rate": 0.0, "init_type": "xavier"},
        "adam_optimizer": {"max_it": 5, "learning_rate": 1e-3,
                           "scheduler_step_size": 10000, "scheduler_gamma": 0.8},
        "lbfgs_optimizer": {"max_it": 0, "learning_rate": 1, "max_evaluation": 0,
                            "history_size": 10, "tolerance_grad": 1e-9,
                            "tolerance_change": 1e-12, "line_search_fn": "strong_wolfe"},
        "loss": {"weight_fid_loss": 1, "weight_res_loss": 100000},
        "physics": "navier_stokes",
        "data": {"file": mat,
                 "inputs": {"t": {"requires_grad": ["true"]}, "x": {"requires_grad": ["true"]},
                            "y": {"requires_grad": ["true"]}},
                 "trues": ["h", "z", "u"], "unknowns": ["v"]},
        "data_test": {"x_min": 0, "x_max": 500, "y_min": 0, "y_max": 1000},
    }


def test_navier_stokes_mat_route_matches_jax(tmp_path):
    """The ``.mat`` ``(t, x, y)`` route of ``tests/test_navier_stokes_pipeline.py``
    (shared forward, weight 1e5 on the residual): the port's Trainer
    against the JAX one, iteration 1 within rel 1e-5 and the 5-step prefix
    within rel 1e-4; ``t`` marked requires_grad=false is refused by both."""
    rs = np.random.RandomState(9)
    n = 600
    t, x, y = rs.uniform(0, 10, (n, 1)), rs.uniform(0, 500, (n, 1)), rs.uniform(0, 1000, (n, 1))
    mat = str(tmp_path / "txyz.mat")
    savemat(mat, {"t": t, "x": x, "y": y, "z": 0.1 * np.sin(0.05 * x + 0.3 * t),
                  "u": 0.2 * np.cos(0.05 * x + 0.3 * t), "v": 0.05 * np.sin(0.01 * y),
                  "h": 2.0 - 0.002 * x})
    raw = txyz_raw(mat)
    init = numpy_params((3, 20, 20, 20, 4), seed=8)
    os.makedirs(tmp_path / "port")
    port = Trainer(parse_config(raw), run_dir=str(tmp_path / "port"), echo_every=0,
                   initial_params=init, device="cpu")
    port.train_adam()
    os.makedirs(tmp_path / "jax")
    ref = JTrainer(jparse(raw), run_dir=str(tmp_path / "jax"), echo_every=0,
                   initial_params={k: jnp.asarray(v) for k, v in init.items()})
    ref.train_adam()
    got, want = np.array(read_log(port.run_dir)[1:]).T, np.array(jread_log(ref.run_dir)[1:]).T
    assert got.shape == want.shape == (5, 3)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert all(np.isfinite(got.ravel())) and got[-1, 2] < got[0, 2]
    raw["data"]["inputs"]["t"] = {"requires_grad": ["false"]}
    with pytest.raises(ValueError, match="requires_grad=false"):
        loss.build_loss_fn(parse_config(raw), MLPSpec.from_layers(parse_config(raw).layers))


# --------------------------------------------------------------- adaptation

class RecordingRunner(jinference.LBFGSRunner):
    """The JAX runner with each chunk's per-evaluation rows kept."""

    rows: list = []

    def run_chunk(self, state, batch):
        state, records = super().run_chunk(state, batch)
        RecordingRunner.rows.append(np.asarray(records))
        return state, records


def test_adapt_navier_stokes_matches_jax(snapshots, tmp_path, monkeypatch):
    """``Predictor.adapt(equation='navier_stokes')`` on the legacy
    collocation set against the JAX package's (same evaluation count,
    losses rel 1e-5, parameters within 1e-6 + 1e-4 x the largest change, as
    ``tests/test_torch_adapt.py`` holds the other equations), and the kernel
    route's plain versions against the plain route. Inputs that do not lead
    with ``(t, x, y)`` are refused on the kernel route."""
    raw = legacy_raw(*snapshots, data_test={
        "inputs": {"t": {"requires_grad": ["true"]}, "x": {"requires_grad": ["true"]},
                   "y": {"requires_grad": ["true"]}, "u": {"requires_grad": ["false"]},
                   "v": {"requires_grad": ["false"]}},
        "outputs": ["h", "z", "u", "v"]})
    cfg = parse_config(raw)
    inputs = data.load_training_data(cfg).residual_input
    arrays = numpy_params((5, 16, 16, 16, 4), seed=9)
    npz, pth = str(tmp_path / "w.npz"), str(tmp_path / "w.pth")
    np.savez(npz, **arrays)
    torch.save(jinterop.torch_state_dict_from_params(arrays), pth)

    port = Predictor(cfg, npz, device="cpu")
    evals = port.adapt(inputs, equation="navier_stokes")
    monkeypatch.setattr(jinference, "LBFGSRunner", RecordingRunner)
    RecordingRunner.rows = []
    jpred = jinference.Predictor(jparse(raw), checkpoint_path=pth)
    jevals = jpred.adapt(inputs, equation="navier_stokes")
    jlosses = np.concatenate(RecordingRunner.rows)[:, 2]
    assert evals == jevals == len(port.adapt_losses) == len(jlosses) >= 2
    np.testing.assert_allclose(port.adapt_losses, jlosses, rtol=1e-5)
    moved = max(float(np.abs(port.params[k].numpy() - arrays[k]).max()) for k in PARAM_KEYS)
    assert moved > 0
    for k in PARAM_KEYS:
        np.testing.assert_allclose(port.params[k].numpy(), np.asarray(jpred.params[k]), rtol=0,
                                   atol=1e-6 + 1e-4 * moved, err_msg=k)

    fused = Predictor(cfg, npz, device="cpu", use_kernel=True)
    assert fused.adapt(inputs, equation="navier_stokes") == evals
    np.testing.assert_allclose(fused.adapt_losses, port.adapt_losses, rtol=1e-6)
    for k in PARAM_KEYS:
        np.testing.assert_allclose(fused.params[k].numpy(), port.params[k].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)

    swapped = json.loads(json.dumps(raw))
    swapped["data_test"]["inputs"] = {k: swapped["data_test"]["inputs"][k]
                                      for k in ("x", "t", "y", "u", "v")}
    with pytest.raises(ValueError, match="must lead"):
        Predictor(parse_config(swapped), npz, device="cpu",
                  use_kernel=True).adapt(inputs, equation="navier_stokes")


def test_legacy_step_bench_runs_the_shipped_example_on_the_cpu():
    """``benchmarks.legacy_config`` is ``examples/legacy.json`` (its files
    and iterations aside), and ``run_legacy_step_bench`` runs its workload:
    26,691 points of ``synth --legacy --nx 41 --ny 31`` and 300 rows."""
    from pinn_depthestimation_tpu_torch import benchmarks

    with open(os.path.join(os.path.dirname(__file__), "..", "examples", "legacy.json")) as f:
        shipped = json.load(f)
    shipped.pop("_comment")
    assert benchmarks.legacy_config("data/beach2d", "data/beach2d/fidelity.csv", 500,
                                    100) == shipped
    out = benchmarks.run_legacy_step_bench(n_iters=1, reps=1, device="cpu")
    assert (out["points"], out["fidelity_points"], out["path"], out["device"]) == (
        26_691, 300, "autograd", "cpu")
    assert out["ms_per_iter"] > 0
