"""The port's loss assembly (``pinn_depthestimation_tpu_torch.training.loss``)
and training loader, held against the JAX package's on identical numpy
weights and one ``.mat`` file.

Tolerances: loss terms rel 1e-5 and each gradient 2e-5 of its largest
entry, as ``tests/test_kernels_step.py`` holds the JAX step to its loss
builder — f32 against f32 ``Precision.HIGHEST``, summed in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_depthestimation_tpu import data as jdata
from pinn_depthestimation_tpu.config import parse_config as jparse
from pinn_depthestimation_tpu.models import MLPSpec as JSpec
from pinn_depthestimation_tpu.training import loss as jloss
from pinn_depthestimation_tpu.utils import synthetic
from pinn_depthestimation_tpu_torch import data
from pinn_depthestimation_tpu_torch.config import parse_config
from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
from pinn_depthestimation_tpu_torch.training import loss


def raw_config(mat, **extra):
    raw = {
        "layers": {"input_features": 2, "hidden_layers": 4, "hidden_width": 16,
                   "output_features": 3, "dropout_rate": 0.0, "init_type": "xavier"},
        "adam_optimizer": {"max_it": 3, "learning_rate": 1e-3,
                           "scheduler_step_size": 5, "scheduler_gamma": 0.8},
        "lbfgs_optimizer": {"max_it": 0, "learning_rate": 1, "max_evaluation": 0,
                            "history_size": 5, "tolerance_grad": 1e-9,
                            "tolerance_change": 1e-12, "line_search_fn": "strong_wolfe"},
        "loss": {"weight_fid_loss": 1, "weight_res_loss": 1},
        "data": {"file": mat,
                 "inputs": {"x": {"requires_grad": ["true"]},
                            "y": {"requires_grad": ["true"]}},
                 "trues": ["U", "V"], "unknowns": ["h"]},
        "data_test": {"x_min": 25.0, "x_max": 33.0, "y_min": -13.0, "y_max": 13.0},
    }
    raw.update(extra)
    return raw


@pytest.fixture
def mat(tmp_path):
    path = str(tmp_path / "d.mat")
    synthetic.make_newmethod_mat(path, nx=12, ny=10, nan_fraction=0.15, seed=3)
    return path


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
        "b_out": rng.uniform(-0.2, 0.2, d_out).astype(np.float32),
    }


def both(raw):
    """(port config, JAX config, port data, JAX data, port batch, JAX batch)."""
    cfg, jcfg = parse_config(raw), jparse(raw)
    td, jtd = data.load_training_data(cfg), jdata.load_training_data(jcfg)
    keys = ("fidelity_input", "fidelity_true", "residual_input")
    batch = {k: torch.from_numpy(getattr(td, k)) for k in keys}
    jbatch = {k: jnp.asarray(getattr(jtd, k)) for k in keys}
    return cfg, jcfg, td, jtd, batch, jbatch


def assert_same(port_out, jax_out, grad_tol=2e-5):
    (t2, (f2, r2)), g2 = port_out
    (t1, (f1, r1)), g1 = jax_out
    for a, b in ((t1, t2), (f1, f2), (r1, r2)):
        assert float(b) == pytest.approx(float(a), rel=1e-5)
    for k in g1:
        x, y = np.asarray(g1[k]), g2[k].numpy()
        if x.size:
            scale = np.abs(x).max() + 1e-12
            np.testing.assert_allclose(y / scale, x / scale, atol=grad_tol, err_msg=k)


def test_newmethod_loader_matches_jax(mat):
    cfg, jcfg, td, jtd, _, _ = both(raw_config(mat))
    assert td.fidelity_is_residual and jtd.fidelity_is_residual
    for k in ("fidelity_input", "fidelity_true", "residual_input"):
        np.testing.assert_array_equal(getattr(td, k), getattr(jtd, k))
    assert td.input_min_max == jtd.input_min_max


def test_cmb_loader_is_queued(tmp_path):
    """The CMB loader (M8) is ported: a CMB config loads its CSV and grid;
    so is the legacy loader (snapshot directory, M9), which a config with a
    ``numerical_model`` block and snapshots reaches: here its coordinate
    channels come from the grid block alone, equal to the JAX loader's."""
    from pinn_depthestimation_tpu_torch.utils import synthetic as psynth

    csv, mat = str(tmp_path / "f.csv"), str(tmp_path / "r.mat")
    psynth.make_cmb_dataset(csv, mat, nx=4, ny=5, n_csv=12, seed=2)
    raw = raw_config(mat)
    del raw["data"]
    raw["data_fidelity"] = {"file": csv, "inputs": ["x", "y"], "outputs": ["U", "V"]}
    raw["data_residual"] = {"file": mat, "inputs": ["x", "y"], "outputs": ["U", "V", "h"]}
    td = data.load_training_data(parse_config(raw))
    assert td.fidelity_true.shape == (12, 2) and td.residual_input.shape[1] == 2
    assert not td.fidelity_is_residual
    raw["data_residual"] = {"inputs": ["x", "y"], "outputs": ["U", "V", "h"], "snapshots": [1]}
    raw["numerical_model"] = {"dir": str(tmp_path), "nx": 4, "ny": 5, "dx": 1.0,
                              "dy": 1.0, "x_min": 0.0, "y_min": 0.0, "number_of_files": 2}
    td, jtd = data.load_training_data(parse_config(raw)), jdata.load_training_data(jparse(raw))
    assert td.residual_input.shape == (20, 2) and td.fidelity_true.shape == (12, 2)
    for k in ("fidelity_input", "fidelity_true", "residual_input"):
        np.testing.assert_array_equal(getattr(td, k), getattr(jtd, k))


@pytest.mark.parametrize("physics", ["continuity_only", "continuity_ftemp"])
@pytest.mark.parametrize("parity", [True, False])
@pytest.mark.parametrize("shared", [True, False])
def test_loss_and_grad_match_jax(mat, physics, parity, shared):
    """build_loss_fn + autograd against build_loss_fn + jax.value_and_grad,
    through a real config and loader, over both physics, both parity modes
    and both fidelity paths (shared forward / separate forward)."""
    cfg, jcfg, td, jtd, batch, jbatch = both(raw_config(mat, physics=physics, parity=parity))
    spec = MLPSpec.from_layers(cfg.layers)
    arrays = numpy_params(spec.sizes, seed=1)
    kw = dict(input_min_max=td.input_min_max, fidelity_is_residual=shared)
    loss_fn = loss.build_loss_fn(cfg, spec, **kw)
    jloss_fn = jloss.build_loss_fn(jcfg, JSpec.from_layers(jcfg.layers), **kw)
    jparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    assert_same(loss.value_and_grad(loss_fn)(params_from_numpy(arrays, "cpu"), batch),
                jax.value_and_grad(jloss_fn, has_aux=True)(jparams, jbatch))


@pytest.mark.parametrize("trues", [["U", "V", "h"], ["V", "U"]])
def test_shared_forward_outside_the_gate_matches_jax(mat, trues):
    """Shared-forward configurations the one-kernel gate excludes (an
    anchored 3-head fidelity, heads out of order) take build_loss_fn's
    generic shared path; it too agrees with the JAX package."""
    base = raw_config(mat)
    unknowns = [k for k in ("U", "V", "h") if k not in trues]
    raw = {**base, "data": {**base["data"], "trues": trues, "unknowns": unknowns}}
    cfg, jcfg, td, jtd, batch, jbatch = both(raw)
    spec = MLPSpec.from_layers(cfg.layers)
    assert not loss.one_kernel_step_applicable(cfg, spec, True)
    arrays = numpy_params(spec.sizes, seed=3)
    kw = dict(input_min_max=td.input_min_max, fidelity_is_residual=True)
    loss_fn = loss.build_loss_fn(cfg, spec, **kw)
    jloss_fn = jloss.build_loss_fn(jcfg, JSpec.from_layers(jcfg.layers), **kw)
    jparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    assert_same(loss.value_and_grad(loss_fn)(params_from_numpy(arrays, "cpu"), batch),
                jax.value_and_grad(jloss_fn, has_aux=True)(jparams, jbatch))


@pytest.mark.parametrize("physics", ["continuity_only", "continuity_ftemp"])
@pytest.mark.parametrize("parity", [True, False])
def test_value_and_grad_fn_matches_jax(mat, physics, parity):
    """The port's build_value_and_grad_fn (K1's plain version on the CPU)
    against the JAX one-kernel step in interpret mode."""
    cfg, jcfg, td, jtd, batch, jbatch = both(raw_config(mat, physics=physics, parity=parity))
    spec = MLPSpec.from_layers(cfg.layers)
    arrays = numpy_params(spec.sizes, seed=2)
    kw = dict(input_min_max=td.input_min_max, fidelity_is_residual=True, fused_kernel=True)
    vg = loss.build_value_and_grad_fn(cfg, spec, **kw)
    jvg = jloss.build_value_and_grad_fn(jcfg, JSpec.from_layers(jcfg.layers),
                                        fused_interpret=True, **kw)
    assert vg is not None and jvg is not None
    jparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    out = vg(params_from_numpy(arrays, "cpu"), batch)
    assert_same(out, jvg(jparams, jbatch), grad_tol=3e-5)
    # the per-batch constants are built once: a second call reuses them
    (t2, _), _ = vg(params_from_numpy(arrays, "cpu"), batch)
    assert float(t2) == float(out[0][0])


def test_one_kernel_gate_matches_jax(mat):
    base = raw_config(mat)
    variants = [
        base,
        raw_config(mat, physics="continuity_ftemp"),
        raw_config(mat, physics="continuity_only", parity=False),
        {**base, "layers": {**base["layers"], "dropout_rate": 0.1}},
        {**base, "layers": {**base["layers"], "output_features": 4},
         "data": {**base["data"], "unknowns": ["h", "eta"]}},
        {**base, "data": {**base["data"], "trues": ["U", "V", "h"], "unknowns": []}},
        {**base, "physics": "continuity_ftemp",
         "data": {**base["data"], "trues": ["U", "V", "h"], "unknowns": []}},
        {**base, "data": {**base["data"], "trues": ["V", "U"]}},
    ]
    for raw in variants:
        cfg, jcfg = parse_config(raw), jparse(raw)
        spec, jspec = MLPSpec.from_layers(cfg.layers), JSpec.from_layers(jcfg.layers)
        for shared in (True, False):
            want = jloss.one_kernel_step_applicable(jcfg, jspec, shared)
            assert loss.one_kernel_step_applicable(cfg, spec, shared) == want, raw
            built = loss.build_value_and_grad_fn(cfg, spec, fused_kernel=True,
                                                 fidelity_is_residual=shared,
                                                 input_min_max={"x": (25.0, 33.0)})
            assert (built is not None) == want
    cfg = parse_config(base)
    spec = MLPSpec.from_layers(cfg.layers)
    assert loss.build_value_and_grad_fn(cfg, spec, fidelity_is_residual=True) is None


def test_loud_errors(mat):
    cfg = parse_config(raw_config(mat, parity=False))
    spec = MLPSpec.from_layers(cfg.layers)
    with pytest.raises(ValueError, match="input_min_max"):
        loss.build_loss_fn(cfg, spec)
    # the chunked plain loss (M3) is ported: it builds
    assert loss.build_loss_fn(parse_config(raw_config(mat)), spec, residual_chunk_size=64)
    cfg = parse_config(raw_config(mat, kernel_precision="f32x3"))  # ported: it builds
    assert loss.build_value_and_grad_fn(cfg, spec, fused_kernel=True, fidelity_is_residual=True,
                                        fused_precision=cfg.resolved_kernel_precision())
    with pytest.raises(ValueError, match="precision"):
        loss.build_value_and_grad_fn(cfg, spec, fused_kernel=True, fidelity_is_residual=True,
                                     fused_precision="fp8")
