"""The CMB pipeline of the port — ``wave_averaged`` physics, the CMB loader,
the CMB loss with its separate fidelity forward, the Trainer and the kernel
decision — held against the JAX package on the CPU from identical numpy
inputs and one synthetic CSV/``.mat`` pair.

Tolerances: loss values rel 1e-5 and each gradient 2e-5 of its largest
entry, as ``tests/test_torch_loss.py`` holds the continuity loss — f32
against f32 ``Precision.HIGHEST``, summed in other orders; the radiation
stresses' derivatives are the chain rule written out in the port and a
``jax.jvp`` in JAX, which round alike to ~1e-7. The loader is held to
exact equality, array for array. Trainers: iteration 1 rel 1e-5, a 5-step
Adam prefix rel 1e-4 (``tests/test_torch_trainer.py``).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_depthestimation_tpu import data as jdata
from pinn_depthestimation_tpu import physics as jphysics
from pinn_depthestimation_tpu.config import parse_config as jparse
from pinn_depthestimation_tpu.models import MLPSpec as JSpec
from pinn_depthestimation_tpu.training import Trainer as JTrainer
from pinn_depthestimation_tpu.training import loss as jloss
from pinn_depthestimation_tpu.utils import synthetic
from pinn_depthestimation_tpu_torch import benchmarks, cli, data, physics
from pinn_depthestimation_tpu_torch.config import parse_config
from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
from pinn_depthestimation_tpu_torch.models.mlp import PARAM_KEYS
from pinn_depthestimation_tpu_torch.parity import make_cmb_config
from pinn_depthestimation_tpu_torch.training import loss
from pinn_depthestimation_tpu_torch.training.driver import Trainer, decide_kernels
from pinn_depthestimation_tpu_torch.training.logging_utils import read_log

FIELDS = ("h", "U", "V", "eta_mean", "Hrms", "k")


@pytest.fixture
def cmb_pair(tmp_path):
    """The JAX package's generator writes the pair both packages read."""
    csv, mat = str(tmp_path / "input_fid.csv"), str(tmp_path / "input_res.mat")
    synthetic.make_cmb_dataset(csv, mat, nx=21, ny=31, n_csv=60, seed=6, nan_fraction=0.03)
    return csv, mat


def cmb_raw(cmb_pair, *, interval=2, training_points=40, hidden_layers=3, width=10,
            adam=5, **extra):
    raw = make_cmb_config(*cmb_pair, adam, 0, hidden_layers=hidden_layers,
                          hidden_width=width, nx=21, ny=31, interval=interval,
                          training_points=training_points)
    raw.update(extra)
    return raw


def numpy_params(sizes, seed=0):
    rng = np.random.RandomState(seed)
    d_in, W, d_out, n_stack = sizes[0], sizes[1], sizes[-1], len(sizes) - 3
    scale = np.sqrt(3.0 / W)
    return {
        "w_in": rng.uniform(-1, 1, (d_in, W)).astype(np.float32),
        "b_in": rng.uniform(-0.1, 0.1, W).astype(np.float32),
        "w_hidden": (rng.uniform(-1, 1, (n_stack, W, W)) * scale).astype(np.float32),
        "b_hidden": rng.uniform(-0.1, 0.1, (n_stack, W)).astype(np.float32),
        "w_out": (rng.uniform(-1, 1, (W, d_out)) * scale).astype(np.float32),
        # the eta head shifted by 1, so eta + h stays away from 0 (the
        # 1/(rho*(eta+h)) factor), as the ROADMAP's M8 check asks
        "b_out": (rng.uniform(-0.2, 0.2, d_out) + np.eye(d_out)[3]).astype(np.float32),
    }


def assert_tree_close(got: dict, want: dict, tol: float):
    for k, w in want.items():
        a, b = np.asarray(w), np.asarray(got[k])
        assert a.shape == b.shape, k
        scale = np.abs(a).max()
        if scale == 0:
            np.testing.assert_array_equal(b, a, err_msg=k)
            continue
        np.testing.assert_allclose(b / scale, a / scale, atol=tol, rtol=0, err_msg=k)


# ------------------------------------------------------------------ physics

def physics_inputs(seed, n=64):
    """Fields and coordinate derivatives with t = 2*k*h on both sides of
    the series/direct seam at |t| = 0.5."""
    rng = np.random.RandomState(seed)
    f = {
        "h": rng.uniform(0.2, 1.5, n), "U": rng.uniform(-0.5, 0.5, n),
        "V": rng.uniform(-0.5, 0.5, n), "eta_mean": rng.uniform(-0.05, 0.05, n),
        "Hrms": rng.uniform(0.1, 0.4, n), "k": rng.uniform(0.02, 1.5, n),
    }
    g = {c: {k: rng.randn(n) * 0.3 for k in FIELDS} for c in ("x", "y")}
    f = {k: v.astype(np.float32) for k, v in f.items()}
    g = {c: {k: v.astype(np.float32) for k, v in d.items()} for c, d in g.items()}
    t = 2 * f["k"] * f["h"]
    assert (t < 0.5).any() and (t >= 0.5).any()
    return f, g


@pytest.mark.parametrize("parity", [True, False])
def test_wave_averaged_value_and_gradients_match_jax(parity):
    f, g = physics_inputs(1 + parity)

    def jloss_fn(fields, grads):
        return jphysics.wave_averaged(None, fields, grads, parity=parity)

    jval, (jgf, jgg) = jax.value_and_grad(jloss_fn, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in f.items()},
        {c: {k: jnp.asarray(v) for k, v in d.items()} for c, d in g.items()})
    tf = {k: torch.from_numpy(v).requires_grad_() for k, v in f.items()}
    tg = {c: {k: torch.from_numpy(v).requires_grad_() for k, v in d.items()} for c, d in g.items()}
    val = physics.residual_loss("wave_averaged")(None, tf, tg, parity=parity)
    leaves = list(tf.values()) + [v for c in ("x", "y") for v in tg[c].values()]
    # parity=True: E = 0 leaves Hrms without a path, a zero gradient in JAX
    grads = iter(torch.autograd.grad(val, leaves, allow_unused=True, materialize_grads=True))
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-5)
    assert_tree_close({k: next(grads).numpy() for k in tf}, jgf, 2e-5)
    for c in ("x", "y"):
        assert_tree_close({k: next(grads).numpy() for k in tg[c]}, jgg[c], 2e-5)


@pytest.mark.parametrize("parity", [True, False])
def test_wave_averaged_stats_form_matches_jax(parity):
    f, g = physics_inputs(3)
    mask = (np.random.RandomState(4).rand(64) > 0.2).astype(np.float32)
    jstats = jphysics.wave_averaged_stats(
        None, {k: jnp.asarray(v) for k, v in f.items()},
        {c: {k: jnp.asarray(v) for k, v in d.items()} for c, d in g.items()},
        mask=jnp.asarray(mask), parity=parity)
    tf = {k: torch.from_numpy(v) for k, v in f.items()}
    tg = {c: {k: torch.from_numpy(v) for k, v in d.items()} for c, d in g.items()}
    stats = physics.wave_averaged_stats(None, tf, tg, mask=torch.from_numpy(mask), parity=parity)
    assert set(stats) == set(jstats)
    for k in stats:
        np.testing.assert_allclose(float(stats[k]), float(jstats[k]), rtol=1e-5)
    np.testing.assert_allclose(
        float(physics._three_term_from_stats(stats)),
        float(physics.wave_averaged(None, tf, tg, mask=torch.from_numpy(mask), parity=parity)),
        rtol=1e-6)


def test_t_over_sinh_branches_match_jax():
    """r = t/sinh(t) and dr/dt on both branches, at the seam and far out,
    against JAX's _t_over_sinh and its jvp."""
    t = np.array([-3.0, -0.7, -0.5, -0.4999, -0.1, -1e-4, 0.0, 1e-6, 0.01, 0.3,
                  0.49999, 0.5, 0.50001, 1.0, 4.0, 20.0], np.float32)
    jr, jdr = jax.jvp(jphysics._t_over_sinh, (jnp.asarray(t),), (jnp.ones_like(jnp.asarray(t)),))
    r, dr = physics._t_over_sinh(torch.from_numpy(t))
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=2e-6, atol=1e-7)
    np.testing.assert_allclose(dr.numpy(), np.asarray(jdr), rtol=2e-5, atol=1e-7)


def test_parity_keeps_the_zero_products():
    """parity=True: E = 0 deletes the radiation stresses, but 0*inf stays
    NaN, as in JAX (the zeros are kept in the graph)."""
    f, g = physics_inputs(5, n=4)
    f["h"][0] = np.inf  # t = inf: r' is NaN, and 0 * NaN is NaN
    tf = {k: torch.from_numpy(v) for k, v in f.items()}
    tg = {c: {k: torch.from_numpy(v) for k, v in d.items()} for c, d in g.items()}
    fc, fx, fy = physics.wave_averaged_residuals(tf, tg, parity=True)
    jfc, jfx, jfy = jphysics.wave_averaged_residuals(
        {k: jnp.asarray(v) for k, v in f.items()},
        {c: {k: jnp.asarray(v) for k, v in d.items()} for c, d in g.items()}, parity=True)
    for got, want in ((fc, jfc), (fx, jfx), (fy, jfy)):
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(np.asarray(want)))
        ok = ~np.isnan(np.asarray(want))
        np.testing.assert_allclose(got.numpy()[ok], np.asarray(want)[ok], rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------------- loader

@pytest.mark.parametrize("interval,training_points", [(1, 40), (2, 0), (3, 1000)])
def test_cmb_loader_matches_jax(cmb_pair, interval, training_points):
    raw = cmb_raw(cmb_pair, interval=interval, training_points=training_points)
    td = data.load_training_data(parse_config(raw))
    jtd = jdata.load_training_data(jparse(raw))
    for key in ("fidelity_input", "fidelity_true", "residual_input"):
        got, want = getattr(td, key), getattr(jtd, key)
        assert got.dtype == np.float32 and got.shape == want.shape, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    assert td.input_min_max == jtd.input_min_max
    assert not td.fidelity_is_residual
    rows = 60 if training_points in (0, 1000) else training_points
    assert td.fidelity_input.shape == (rows, 2) and td.fidelity_true.shape == (rows, 6)


def test_cmb_writer_matches_jax(tmp_path, cmb_pair):
    """The port's generator writes the same numbers as the JAX package's."""
    from scipy.io import loadmat

    from pinn_depthestimation_tpu_torch.utils import synthetic as psynth

    csv, mat = str(tmp_path / "p.csv"), str(tmp_path / "p.mat")
    cols, grids = psynth.make_cmb_dataset(csv, mat, nx=21, ny=31, n_csv=60, seed=6,
                                          nan_fraction=0.03)
    assert list(cols) == ["x", "y", *FIELDS]
    got, want = data.read_csv_columns(csv), data.read_csv_columns(cmb_pair[0])
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jm, pm = loadmat(cmb_pair[1]), loadmat(mat)
    for k in ("x", "y", *FIELDS):
        np.testing.assert_array_equal(pm[k], jm[k], err_msg=k)


# --------------------------------------------------------------------- loss

@pytest.mark.parametrize("parity", [True, False])
def test_cmb_loss_and_grad_match_jax(cmb_pair, parity):
    """The CMB loss value and its six gradients: the port's fused path (K2
    and K3's plain versions on the CPU) and its plain path, against the JAX
    fused path (Pallas kernels in interpret mode) and its XLA path."""
    raw = cmb_raw(cmb_pair, parity=parity)
    cfg, jcfg = parse_config(raw), jparse(raw)
    td, jtd = data.load_training_data(cfg), jdata.load_training_data(jcfg)
    spec = MLPSpec.from_layers(cfg.layers)
    arrays = numpy_params(spec.sizes, seed=2)
    keys = ("fidelity_input", "fidelity_true", "residual_input")
    batch = {k: torch.from_numpy(getattr(td, k)) for k in keys}
    jbatch = {k: jnp.asarray(getattr(jtd, k)) for k in keys}
    jparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    want = {}
    for fused in (True, False):
        jfn = jloss.build_loss_fn(jcfg, JSpec.from_layers(jcfg.layers),
                                  input_min_max=jtd.input_min_max, fused_kernel=fused,
                                  fused_interpret=fused)
        want[fused] = jax.value_and_grad(lambda p: jfn(p, jbatch), has_aux=True)(jparams)
    for fused in (True, False):
        fn = loss.build_loss_fn(cfg, spec, input_min_max=td.input_min_max, fused_kernel=fused)
        (total, (fid, res)), grads = loss.value_and_grad(fn)(params_from_numpy(arrays, "cpu"),
                                                             batch)
        for (jtotal, (jfid, jres)), jgrads in want.values():
            for a, b in ((total, jtotal), (fid, jfid), (res, jres)):
                np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
            assert_tree_close({k: v.numpy() for k, v in grads.items()}, jgrads, 2e-5)


def test_fused_loss_refuses_what_the_kernels_do_not_take(cmb_pair):
    raw = cmb_raw(cmb_pair)
    raw["data_residual"]["inputs"] = {"y": {"requires_grad": ["true"]},
                                      "x": {"requires_grad": ["true"]}}
    cfg = parse_config(raw)
    with pytest.raises(ValueError, match="leading residual inputs"):
        loss.build_loss_fn(cfg, MLPSpec.from_layers(cfg.layers), fused_kernel=True)
    raw = cmb_raw(cmb_pair)
    raw["layers"]["dropout_rate"] = 0.1
    cfg = parse_config(raw)
    with pytest.raises(ValueError, match="dropout"):
        loss.build_loss_fn(cfg, MLPSpec.from_layers(cfg.layers), fused_kernel=True)
    cfg = parse_config(cmb_raw(cmb_pair))
    with pytest.raises(ValueError, match="K3"):
        loss.build_loss_fn(cfg, MLPSpec.from_layers(cfg.layers), fused_kernel=True,
                           fused_precision="fp8")


# ------------------------------------------------------------------ Trainer

@pytest.mark.parametrize("fused", ["auto", "on"])
def test_cmb_trainer_matches_jax_trainer(cmb_pair, tmp_path, fused):
    """From the same weights: equal iteration-1 losses and a tracked 5-step
    Adam prefix. 'auto' on the CPU is autograd of the plain loss; 'on' runs
    the fused path with K2's and K3's plain versions."""
    raw = cmb_raw(cmb_pair, fused_kernel=fused)
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
    got = np.array(read_log(port.run_dir)[1:]).T
    want = np.array(read_log(ref.run_dir)[1:]).T
    assert got.shape == want.shape == (5, 3)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)  # iteration 1
    np.testing.assert_allclose(got, want, rtol=1e-4)        # the 5-step prefix


def test_cmb_adam_raises_the_loss_at_width_128_in_both_packages(tmp_path):
    """``examples/cmb.json`` (uniform weights, Adam at lr 1e-4) at
    ``hidden_width`` 128 on the synthetic CMB pair at 81x261, every 4th
    point: from the JAX package's own seeded weights its Adam raises the
    loss at step 2, and the port, from the same weights, tracks it over a
    5-step prefix. So the card's CMB runs at width 128 need not lower the
    loss under Adam, on either package."""
    csv, mat = str(tmp_path / "input_fid.csv"), str(tmp_path / "input_res.mat")
    synthetic.make_cmb_dataset(csv, mat, nx=81, ny=261, seed=0)
    with open(os.path.join(os.path.dirname(__file__), "..", "examples", "cmb.json")) as f:
        raw = json.load(f)
    for block in ("data_fidelity", "data_residual", "data_test"):
        raw[block]["file"] = mat if block != "data_fidelity" else csv
    raw["layers"]["hidden_width"] = 128
    raw["adam_optimizer"]["max_it"], raw["lbfgs_optimizer"]["max_it"] = 5, 0
    raw["data_residual"]["interval_x"] = raw["data_residual"]["interval_y"] = 4
    raw["fused_kernel"] = "off"
    os.makedirs(tmp_path / "jax")
    ref = JTrainer(jparse(raw), run_dir=str(tmp_path / "jax"), echo_every=0)
    init = {k: np.array(v) for k, v in ref.state.params.items()}
    ref.train_adam()
    os.makedirs(tmp_path / "port")
    port = Trainer(parse_config(raw), run_dir=str(tmp_path / "port"), echo_every=0,
                   initial_params=init, device="cpu")
    port.train_adam()
    got = np.array(read_log(port.run_dir)[1:]).T
    want = np.array(read_log(ref.run_dir)[1:]).T
    assert got.shape == want.shape == (5, 3)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)  # iteration 1
    np.testing.assert_allclose(got, want, rtol=1e-4)        # the 5-step prefix
    assert want[1, 2] > 1.2 * want[0, 2] and got[1, 2] > 1.2 * got[0, 2]


def test_cli_trains_and_tests_a_cmb_config(tmp_path, capsys):
    """synth writes the CMB pair; train and test run on a CMB config with
    those files, on the CPU."""
    out = str(tmp_path / "synth")
    assert cli.main(["synth", "--out", out, "--nx", "21", "--ny", "31"]) == 0
    for name in ("data_synth.mat", "input_fid.csv", "input_res.mat"):
        assert os.path.exists(os.path.join(out, name)), name
    raw = make_cmb_config(os.path.join(out, "input_fid.csv"), os.path.join(out, "input_res.mat"),
                          12, 4, tol_grad=1e-9, tol_change=1e-12, hidden_layers=3,
                          nx=21, ny=31, interval=2, training_points=30)
    raw["fused_kernel"] = "on"
    cfg = str(tmp_path / "cmb.json")
    with open(cfg, "w") as f:
        json.dump(raw, f)
    assert cli.main(["train", "--config", cfg, "--log-root", str(tmp_path), "--run-name", "r",
                     "--device", "cpu"]) == 0
    epochs, _, _, totals = read_log(str(tmp_path / "r"))
    assert epochs[:13] == list(range(1, 14)) and all(np.isfinite(totals))
    model = str(tmp_path / "r" / "model.npz")
    save = str(tmp_path / "pred.mat")
    assert cli.main(["test", "--config", cfg, "--model", model, "--save", save,
                     "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "K2 forward + K3 backward" in printed and "pred_eta_mean: shape (31, 21)" in printed
    from scipy.io import loadmat

    pred = loadmat(save)
    x = loadmat(os.path.join(out, "input_res.mat"))["x"]
    for key in FIELDS:
        arr = pred[f"pred_{key}"]
        assert arr.shape == (31, 21)
        # NaN exactly at the grid's masked cells
        np.testing.assert_array_equal(np.isnan(arr), np.isnan(x), err_msg=key)


def test_cmb_step_bench_runs_on_the_cpu():
    out = benchmarks.run_cmb_step_bench(n_iters=2, reps=1, device="cpu")
    assert out["path"] == "autograd" and out["device"] == "cpu"
    assert out["fidelity_points"] == 200 and 20_000 < out["points"] < 21_141
    assert out["ms_per_iter"] > 0


# ---------------------------------------------------------- kernel decision

@pytest.mark.parametrize("width,dropout,mode,device_type,want", [
    (10, 0.0, "auto", "cuda", (False, True, True)),   # K2 + K3 for both terms
    (10, 0.0, "on", "cuda", (False, True, True)),
    (10, 0.0, "off", "cuda", (False, False, False)),  # the explicit plain request
    (10, 0.0, "auto", "cpu", (False, False, False)),
    (10, 0.0, "on", "cpu", (False, True, False)),     # the kernels' plain versions
    (24, 0.0, "auto", "cuda", (False, True, True)),   # uncompiled width: padded
    (24, 0.0, "on", "cuda", (False, True, True)),
    (24, 0.0, "off", "cuda", (False, False, False)),
    (128, 0.0, "auto", "cuda", (False, True, True)),  # the wide body
    (130, 0.0, "auto", "cuda", "use_kernel=False"),   # beyond the Pallas gate: no K2
    (130, 0.0, "on", "cuda", "fused_kernel='on' needs"),
    (10, 0.1, "auto", "cuda", (False, False, True)),  # structurally unfit: autograd
    (10, 0.1, "on", "cuda", "K3"),
])
def test_cmb_kernel_decision(cmb_pair, width, dropout, mode, device_type, want):
    raw = cmb_raw(cmb_pair, width=width, fused_kernel=mode)
    raw["layers"]["dropout_rate"] = dropout
    cfg = parse_config(raw)
    spec = MLPSpec.from_layers(cfg.layers)
    if isinstance(want, tuple):
        assert decide_kernels(cfg, spec, False, device_type) == want
        return
    with pytest.raises(ValueError, match=want) as err:
        decide_kernels(cfg, spec, False, device_type)
    if want == "use_kernel=False":
        assert "fused_kernel='off'" in str(err.value)


def test_cmb_reference_net_takes_the_kernels_on_the_card(cmb_pair):
    """The reference CMB net (2->[10]x10->6, 10 hidden layers) at the
    bench's ~20,500 points: the JAX 'auto' keeps it on XLA on a TPU (depth
    gate); on the card 'auto' takes K2 + K3 (ROADMAP.md Queue 3)."""
    raw = cmb_raw(cmb_pair, hidden_layers=10)
    cfg = parse_config(raw)
    plan = decide_kernels(cfg, MLPSpec.from_layers(cfg.layers), False, "cuda")
    assert plan.fused and not plan.k1 and plan.predict
    assert set(PARAM_KEYS) == {"w_in", "b_in", "w_hidden", "b_hidden", "w_out", "b_out"}
