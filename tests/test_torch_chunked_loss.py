"""The chunked residual loss of the port's plain path (``residual_chunk_size``
without the kernels) and the sufficient-statistics forms it sums, on the CPU.

Chunked equals full-batch up to f32 summation order: the loss at rel 1e-6
and each gradient at rtol 1e-4, atol 1e-7, the JAX package's own tolerances
(``tests/test_chunked_loss.py``), for every equation at chunks 17, 64 and
143 (non-divisors of every point count, so the last chunk is a
remainder), with and without masks. Against the JAX package's chunked loss: the loss at rel 1e-5
and each gradient within 1e-4 x max|g| + 1e-7, as
``tests/test_torch_legacy.py`` holds the two packages' losses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_depthestimation_tpu import data as jdata
from pinn_depthestimation_tpu import physics as jphysics
from pinn_depthestimation_tpu.config import parse_config as jparse
from pinn_depthestimation_tpu.models import MLPSpec as JSpec
from pinn_depthestimation_tpu.training import loss as jloss
from pinn_depthestimation_tpu.utils import synthetic as jsynthetic
from pinn_depthestimation_tpu_torch import data, physics
from pinn_depthestimation_tpu_torch.config import parse_config
from pinn_depthestimation_tpu_torch.models import PARAM_KEYS, MLPSpec, params_from_numpy
from pinn_depthestimation_tpu_torch.parity import make_cmb_config
from pinn_depthestimation_tpu_torch.training import loss
from test_torch_legacy import legacy_raw, numpy_params

KEYS = ("fidelity_input", "fidelity_true", "residual_input")
EQUATIONS = ("continuity_only", "continuity_ftemp", "navier_stokes", "wave_averaged")
CHUNKS = (17, 64, 143)


def newmethod_raw(tmp_path, physics_name):
    mat = str(tmp_path / "d.mat")
    jsynthetic.make_newmethod_mat(mat, nx=20, ny=16, nan_fraction=0.1, seed=3)
    return {
        "layers": {"input_features": 2, "hidden_layers": 3, "hidden_width": 12,
                   "output_features": 3, "dropout_rate": 0.0, "init_type": "xavier"},
        "adam_optimizer": {"max_it": 5, "learning_rate": 1e-3,
                           "scheduler_step_size": 5, "scheduler_gamma": 0.8},
        "lbfgs_optimizer": {"max_it": 0, "learning_rate": 1, "max_evaluation": 0,
                            "history_size": 5, "tolerance_grad": 1e-9,
                            "tolerance_change": 1e-12, "line_search_fn": "strong_wolfe"},
        "loss": {"weight_fid_loss": 1, "weight_res_loss": 1},
        "physics": physics_name,
        "data": {"file": mat, "inputs": {"x": {"requires_grad": ["true"]},
                                         "y": {"requires_grad": ["true"]}},
                 "trues": ["U", "V"], "unknowns": ["h"]},
        "data_test": {"x_min": 25.0, "x_max": 33.0, "y_min": -13.0, "y_max": 13.0},
    }


def case(tmp_path, equation):
    """``(raw, arrays)``: continuity on a newmethod grid (fidelity shares the
    residual points, ~290 of them), ``navier_stokes`` on the legacy fixture
    at interval 1 (1,575 points, a separate fidelity set), ``wave_averaged`` on a CMB grid
    (~630 points), with seeded numpy weights."""
    if equation.startswith("continuity"):
        raw = newmethod_raw(tmp_path, equation)
    elif equation == "navier_stokes":
        snap_dir, csv = jsynthetic.make_funwave_snapshot_dir(
            str(tmp_path / "beach2d"), nx=25, ny=21, snapshots=(200, 201, 202), seed=3)
        raw = legacy_raw(snap_dir, csv, interval=1)
    else:
        csv, mat = str(tmp_path / "fid.csv"), str(tmp_path / "res.mat")
        jsynthetic.make_cmb_dataset(csv, mat, nx=21, ny=31, n_csv=60, seed=6,
                                    nan_fraction=0.03)
        raw = make_cmb_config(csv, mat, 5, 0, hidden_layers=3, hidden_width=10, nx=21,
                              ny=31, interval=1, training_points=40)
    cfg = parse_config(raw)
    arrays = numpy_params(MLPSpec.from_layers(cfg.layers).sizes, seed=5)
    if equation == "wave_averaged":
        arrays["b_out"][3] += 1.0  # eta + h away from 0
    return raw, arrays


def port_eval(raw, arrays, batch_extra=None, **kw):
    cfg = parse_config(raw)
    td = data.load_training_data(cfg)
    spec = MLPSpec.from_layers(cfg.layers)
    batch = {k: torch.from_numpy(getattr(td, k)) for k in KEYS}
    batch.update(batch_extra or {})
    fn = loss.build_loss_fn(cfg, spec, input_min_max=td.input_min_max,
                            fidelity_is_residual=td.fidelity_is_residual, **kw)
    return loss.value_and_grad(fn)(params_from_numpy(arrays, "cpu"), batch)


def assert_chunked_equals_full(chunked, full):
    (t_c, (f_c, r_c)), g_c = chunked
    (t_f, (f_f, r_f)), g_f = full
    for a, b in ((t_c, t_f), (f_c, f_f), (r_c, r_f)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    for k in PARAM_KEYS:
        np.testing.assert_allclose(g_c[k].numpy(), g_f[k].numpy(), rtol=1e-4, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("equation", EQUATIONS)
def test_chunked_equals_full(tmp_path, equation, chunk):
    raw, arrays = case(tmp_path, equation)
    n = data.load_training_data(parse_config(raw)).residual_input.shape[0]
    assert n > max(CHUNKS) and all(n % c for c in CHUNKS)
    assert_chunked_equals_full(port_eval(raw, arrays, residual_chunk_size=chunk),
                               port_eval(raw, arrays))


def jax_eval(raw, arrays, batch_extra=None, **kw):
    jcfg = jparse(raw)
    jtd = jdata.load_training_data(jcfg)
    jfn = jloss.build_loss_fn(jcfg, JSpec.from_layers(jcfg.layers),
                              input_min_max=jtd.input_min_max,
                              fidelity_is_residual=jtd.fidelity_is_residual, **kw)
    jbatch = {k: jnp.asarray(getattr(jtd, k)) for k in KEYS}
    jbatch.update({k: jnp.asarray(v.numpy()) for k, v in (batch_extra or {}).items()})
    jparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    return jax.value_and_grad(lambda p: jfn(p, jbatch), has_aux=True)(jparams)


def assert_matches_jax(port_out, jax_out):
    """Loss terms rel 1e-5; each gradient within 1e-4 x max|g| + 1e-7."""
    (t2, (f2, r2)), g2 = port_out
    (t1, (f1, r1)), g1 = jax_out
    for a, b in ((t1, t2), (f1, f2), (r1, r2)):
        assert float(b) == pytest.approx(float(a), rel=1e-5)
    for k in PARAM_KEYS:
        want = np.asarray(g1[k])
        np.testing.assert_allclose(g2[k].numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max() + 1e-7, err_msg=k)


@pytest.mark.parametrize("equation", EQUATIONS)
def test_chunked_with_masks(tmp_path, equation):
    """Masked rows (a third of the residual points) contribute nothing,
    chunked or not. On a shared point set the fidelity term reads its own
    ``fidelity_mask``: with a different one the chunked loss equals the JAX
    package's full-batch loss, which reads both masks; the port's unchunked
    shared loss inside the one-kernel gate is K1's plain form, which reads
    ``residual_mask`` for both terms, so it is held to the chunked one with
    one mask (``ROADMAP.md`` Queue 3)."""
    raw, arrays = case(tmp_path, equation)
    td = data.load_training_data(parse_config(raw))
    n = td.residual_input.shape[0]
    mask = torch.from_numpy((np.arange(n) % 3 != 0).astype(np.float32))
    one = {"residual_mask": mask}
    if td.fidelity_is_residual:
        one["fidelity_mask"] = mask
        two = dict(one, fidelity_mask=torch.from_numpy((np.arange(n) % 4 != 1).astype(np.float32)))
        assert_matches_jax(port_eval(raw, arrays, two, residual_chunk_size=17),
                           jax_eval(raw, arrays, two))
    for chunk in (17, 143):
        assert_chunked_equals_full(port_eval(raw, arrays, one, residual_chunk_size=chunk),
                                   port_eval(raw, arrays, one))


def test_shared_fidelity_rides_the_sweep(tmp_path, monkeypatch):
    """On a shared point set the fidelity term comes from the chunks'
    forwards: no separate fidelity forward, one forward per chunk, the last
    one the remainder. A set no larger than the chunk takes the unchunked
    path (one forward)."""
    raw, arrays = case(tmp_path, "continuity_ftemp")
    cfg = parse_config(raw)
    td = data.load_training_data(cfg)
    assert td.fidelity_is_residual
    n = td.residual_input.shape[0]
    spec = MLPSpec.from_layers(cfg.layers)
    batch = {k: torch.from_numpy(getattr(td, k)) for k in KEYS}
    params = params_from_numpy(arrays, "cpu")
    calls = []
    real = loss.mlp_apply_with_tangents
    monkeypatch.setattr(loss, "mlp_apply_with_tangents",
                        lambda p, x, t, s: calls.append(x.shape[0]) or real(p, x, t, s))
    monkeypatch.setattr(loss, "mlp_apply", None)  # the separate fidelity forward
    full = port_eval(raw, arrays)
    assert n % 64
    for chunk, want in ((64, [64] * (n // 64) + [n % 64]), (n, [n])):
        calls.clear()
        fn = loss.build_loss_fn(cfg, spec, residual_chunk_size=chunk, fidelity_is_residual=True)
        with torch.no_grad():
            total, (fid, res) = fn(params, batch)
        assert calls == want
        np.testing.assert_allclose(float(fid), float(full[0][1][0]), rtol=1e-6)
        np.testing.assert_allclose(float(total), float(full[0][0]), rtol=1e-6)


def random_bundle(n, equation, seed):
    """Seeded fields and coordinate derivatives for ``equation``, as numpy."""
    rng = np.random.RandomState(seed)
    names = {"navier_stokes": ("h", "z", "u", "v"),
             "wave_averaged": ("h", "U", "V", "eta_mean", "Hrms", "k")}.get(equation,
                                                                         ("U", "V", "h"))
    coords = {"x": rng.uniform(20.0, 30.0, n).astype(np.float32)}
    fields = {k: rng.uniform(-1, 1, n).astype(np.float32) for k in names}
    fields["h"] += 2.0
    gc = physics.required_grad_coords(equation)
    grads = {c: {k: rng.randn(n).astype(np.float32) for k in names} for c in gc}
    return coords, fields, grads


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("equation", EQUATIONS)
def test_stats_forms_match_their_losses(equation, masked):
    """``residual_from_stats(residual_stats(...))`` equals the loss (rel
    1e-6), and each statistic equals the JAX package's (rel 1e-5)."""
    c, f, g = random_bundle(301, equation, seed=4)
    mask = (np.random.RandomState(5).rand(301) > 0.3).astype(np.float32) if masked else None
    tt = lambda d: {k: (tt(v) if isinstance(v, dict) else torch.from_numpy(v))  # noqa: E731
                    for k, v in d.items()}
    jj = lambda d: {k: (jj(v) if isinstance(v, dict) else jnp.asarray(v))  # noqa: E731
                    for k, v in d.items()}
    tm = None if mask is None else torch.from_numpy(mask)
    jm = None if mask is None else jnp.asarray(mask)
    want = float(physics.residual_loss(equation)(tt(c), tt(f), tt(g), mask=tm))
    stats = physics.residual_stats(equation)(tt(c), tt(f), tt(g), mask=tm)
    assert float(physics.residual_from_stats(equation)(stats)) == pytest.approx(want, rel=1e-6)
    jstats = jphysics.residual_stats(equation)(jj(c), jj(f), jj(g), mask=jm)
    assert set(stats) == set(jstats)
    for k in stats:
        assert float(stats[k]) == pytest.approx(float(jstats[k]), rel=1e-5), k
    if equation == "continuity_only":
        assert 0 < float(stats["n_anchor"]) < float(stats["n"])  # the anchor selects some


@pytest.mark.parametrize("equation", EQUATIONS)
def test_chunked_matches_jax_chunked(tmp_path, equation):
    raw, arrays = case(tmp_path, equation)
    assert parse_config(raw).physics == equation
    assert_matches_jax(port_eval(raw, arrays, residual_chunk_size=64),
                       jax_eval(raw, arrays, residual_chunk_size=64))
