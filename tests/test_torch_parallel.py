"""The port's data-parallel mesh (``parallel/mesh.py``, the sharded losses
and the Trainer's ``mesh=``) held against the JAX package's on the CPU.

Mirrors ``tests/test_parallel.py``: the JAX side runs on the 8 virtual CPU
devices of ``tests/conftest.py``, the port's on an 8-shard mesh of the one
CPU (``make_mesh(8, devices=["cpu"] * 8)``), which runs the same code a
mesh of cards does with the kernels' plain versions in their place.

Tolerances: the JAX test's own for the sharded loss against the unsharded
one (rtol 2e-5 on the loss terms; rtol 1e-3 and atol 1e-6 on gradients),
which only allow for f32 summation order; structural faults (a lost shard,
local counts, a padded row counted) are O(1). K1's sharded plain step is
held to its measured gap (each tolerance a few times that gap, as the JAX
dry run sets them from ``MULTICHIP_r05.json``'s). In float64 the same
sharding holds to 1e-13 relative, apart from f32 roundoff.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_depthestimation_tpu import parallel as jparallel
from pinn_depthestimation_tpu.config import parse_config as jparse
from pinn_depthestimation_tpu.training import Trainer as JTrainer
from pinn_depthestimation_tpu.training import build_loss_fn as jbuild_loss_fn
from pinn_depthestimation_tpu.utils import synthetic
from pinn_depthestimation_tpu_torch import cli, parallel
from pinn_depthestimation_tpu_torch.config import parse_config
from pinn_depthestimation_tpu_torch.data import load_training_data
from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
from pinn_depthestimation_tpu_torch.ops import kernels_step
from pinn_depthestimation_tpu_torch.training.driver import Trainer
from pinn_depthestimation_tpu_torch.training.logging_utils import read_log
from pinn_depthestimation_tpu_torch.training.loss import (
    _step_batch_fn,
    build_loss_fn,
    build_value_and_grad_fn,
    value_and_grad,
)

CPU8 = ["cpu"] * 8
BATCH_KEYS = ("fidelity_input", "fidelity_true", "residual_input")

# K1's sharded plain step against the unsharded one at the newmethod config
# below, on the CPU (tests/test_torch_parallel.py's own cases): measured
# gaps, relative on the loss terms and of each gradient leaf's largest
# entry, 1.75e-7 and 3.52e-7 at f32 (8 shards), 0 and 4.05e-7 at bf16,
# 1.15e-7 and 7.66e-7 at f32x3 (4 shards); the JAX f32 run's in
# MULTICHIP_r05.json: 7.23e-8 and 6.66e-7. Each tolerance is 3x the largest
# gap plus a 1e-6 floor, the JAX dry run's rule (__graft_entry__.py)
K1_SHARD_LOSS_RTOL, K1_SHARD_GRAD_TOL = 3 * 1.75e-7 + 1e-6, 3 * 7.66e-7 + 1e-6


def newmethod_raw(mat, adam_it=10, lbfgs_it=5, **extra):
    raw = {
        "layers": {"input_features": 2, "hidden_layers": 3, "hidden_width": 16,
                   "output_features": 3, "dropout_rate": 0.0, "init_type": "xavier"},
        "adam_optimizer": {"max_it": adam_it, "learning_rate": 1e-3,
                           "scheduler_step_size": 30, "scheduler_gamma": 0.8},
        "lbfgs_optimizer": {"max_it": lbfgs_it, "learning_rate": 1,
                            "max_evaluation": 4 * lbfgs_it if lbfgs_it else 0,
                            "history_size": 10, "tolerance_grad": 1e-9,
                            "tolerance_change": 1e-12, "line_search_fn": "strong_wolfe"},
        "loss": {"weight_fid_loss": 1, "weight_res_loss": 1},
        "data": {"file": mat,
                 "inputs": {"x": {"requires_grad": ["true"]},
                            "y": {"requires_grad": ["true"]}},
                 "trues": ["U", "V"], "unknowns": ["h"]},
    }
    raw.update(extra)
    return raw


def newmethod_mat(tmp_path, n_nan=0.07):
    mat = str(tmp_path / "data.mat")
    synthetic.make_newmethod_mat(mat, nx=13, ny=17, nan_fraction=n_nan, seed=4)
    return mat


def cmb_raw(tmp_path, adam_it=6, lbfgs_it=0):
    """The JAX test's CMB config (``tests/test_parallel.py::_cmb_config``)."""
    csv, mat = str(tmp_path / "fid.csv"), str(tmp_path / "res.mat")
    synthetic.make_cmb_dataset(csv, mat, nx=15, ny=13, n_csv=77, seed=6, nan_fraction=0.03)
    return {
        "layers": {"input_features": 2, "hidden_layers": 3, "hidden_width": 16,
                   "output_features": 6, "dropout_rate": 0.0, "init_type": "xavier"},
        "adam_optimizer": {"max_it": adam_it, "learning_rate": 1e-4,
                           "scheduler_step_size": 100, "scheduler_gamma": 0.8},
        "lbfgs_optimizer": {"max_it": lbfgs_it, "learning_rate": 1,
                            "max_evaluation": 4 * lbfgs_it, "history_size": 10,
                            "tolerance_grad": 1e-9, "tolerance_change": 1e-12,
                            "line_search_fn": "strong_wolfe"},
        "loss": {"weight_fid_loss": 1, "weight_res_loss": 1,
                 "weight_h_loss": 2, "weight_U_loss": 1, "weight_V_loss": 1,
                 "weight_eta_mean_loss": 1, "weight_Hrms_loss": 0.5, "weight_k_loss": 0.5},
        "data_fidelity": {"file": csv, "inputs": ["x", "y"],
                          "outputs": ["h", "U", "V", "eta_mean", "Hrms", "k"],
                          "training_points": 60},
        "data_residual": {"file": mat,
                          "inputs": {"x": {"requires_grad": ["true"]},
                                     "y": {"requires_grad": ["true"]}},
                          "outputs": ["h", "U", "V", "eta_mean", "Hrms", "k"],
                          "interval_x": 1, "interval_y": 1},
        "data_test": {"x_min": 25.0, "x_max": 33.0, "y_min": -13.0, "y_max": 13.0},
        "physics": "wave_averaged",
        "parity": False,
    }


def navier_stokes_raw(tmp_path):
    """The JAX test's legacy config (``test_sharded_navier_stokes_matches_plain``)."""
    snap_dir, csv = synthetic.make_funwave_snapshot_dir(
        str(tmp_path / "beach2d"), nx=13, ny=11, dx=2.0, dy=2.0, snapshots=(200, 201), seed=3)
    return {
        "layers": {"input_features": 5, "hidden_layers": 3, "hidden_width": 16,
                   "output_features": 4, "dropout_rate": 0.0, "init_type": "xavier"},
        "adam_optimizer": {"max_it": 2, "learning_rate": 1e-3,
                           "scheduler_step_size": 100, "scheduler_gamma": 0.8},
        "lbfgs_optimizer": {"max_it": 0, "learning_rate": 1, "max_evaluation": 0,
                            "history_size": 10, "tolerance_grad": 1e-9,
                            "tolerance_change": 1e-12, "line_search_fn": "strong_wolfe"},
        "loss": {"weight_fid_loss": 1, "weight_res_loss": 1},
        "data_fidelity": {"dir": csv, "inputs": ["t", "x", "y", "u", "v"],
                          "outputs": ["h", "z", "u", "v"], "training_points": 64},
        "data_residual": {
            "inputs": {"t": {"file": "t", "requires_grad": ["true"]},
                       "x": {"file": "X", "requires_grad": ["true"]},
                       "y": {"file": "Y", "requires_grad": ["true"]},
                       "u": {"file": "u", "requires_grad": ["false"]},
                       "v": {"file": "v", "requires_grad": ["false"]}},
            "outputs": {"h": {"file": "dep.out"}, "z": {"file": "eta"},
                        "u": {"file": "u"}, "v": {"file": "v"}},
            "numerical_model_snapshots": [200, 201],
        },
        "numerical_model": {"dir": snap_dir, "nx": 13, "ny": 11, "dx": 2.0, "dy": 2.0,
                            "x_min": 0.0, "x_max": 24.0, "y_min": 0.0, "y_max": 20.0,
                            "interval_x": 2, "interval_y": 2, "dt": 1.0,
                            "number_of_files": 501},
        "physics": "navier_stokes",
    }


def numpy_params(sizes, seed=0, eta_col=None):
    """Seeded weights (``tests/test_torch_cmb.py``'s scales); with
    ``eta_col`` the eta_mean head is shifted by 1 so eta + h stays O(1)
    positive, away from the ``1/(rho*(eta+h))`` pole that amplifies f32
    summation order (the JAX test's ``_eta_shifted_params``)."""
    rng = np.random.RandomState(seed)
    d_in, W, d_out, n_stack = sizes[0], sizes[1], sizes[-1], len(sizes) - 3
    scale = np.sqrt(3.0 / W)
    p = {
        "w_in": rng.uniform(-1, 1, (d_in, W)).astype(np.float32),
        "b_in": rng.uniform(-0.1, 0.1, W).astype(np.float32),
        "w_hidden": (rng.uniform(-1, 1, (n_stack, W, W)) * scale).astype(np.float32),
        "b_hidden": rng.uniform(-0.1, 0.1, (n_stack, W)).astype(np.float32),
        "w_out": (rng.uniform(-1, 1, (W, d_out)) * scale).astype(np.float32),
        "b_out": rng.uniform(-0.2, 0.2, d_out).astype(np.float32),
    }
    if eta_col is not None:
        p["b_out"][eta_col] += 1.0
    return p


def host_batch(td, dtype=np.float32):
    return {k: np.asarray(getattr(td, k), dtype) for k in BATCH_KEYS}


def torch_batch(td, dtype=torch.float32):
    return {k: torch.as_tensor(np.asarray(getattr(td, k))).to(dtype) for k in BATCH_KEYS}


def jax_sharded(raw, params, td, **kw):
    """The JAX package's loss and gradient on its 8-device mesh."""
    cfg, spec_j = jparse(raw), None
    from pinn_depthestimation_tpu.models import MLPSpec as JSpec

    spec_j = JSpec.from_layers(cfg.layers)
    mesh = jparallel.make_mesh(8)
    batch = jparallel.shard_batch(host_batch(td), mesh)
    loss = jbuild_loss_fn(cfg, spec_j, mesh=mesh, **kw)
    p = jparallel.replicate({k: jnp.asarray(v) for k, v in params.items()}, mesh)
    (t, (f, r)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(p, batch)
    return np.asarray([f, r, t], np.float64), {k: np.asarray(v) for k, v in g.items()}


def port_value_and_grad(loss_fn, params, batch):
    (t, (f, r)), g = value_and_grad(loss_fn)(params, batch)
    return np.asarray([float(f), float(r), float(t)]), {k: v.numpy() for k, v in g.items()}


def assert_loss_grads_close(got, want, rtol=2e-5, g_rtol=1e-3, g_atol=1e-6):
    np.testing.assert_allclose(got[0], want[0], rtol=rtol)
    for k in want[1]:
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=g_rtol, atol=g_atol, err_msg=k)


def assert_scaled_grads_close(got, want, atol):
    """Gradients relative to each leaf's largest entry (the JAX test's rule
    for the wave_averaged and navier_stokes gradients)."""
    for k in want:
        scale = np.abs(want[k]).max() + 1e-12
        np.testing.assert_allclose(got[k] / scale, want[k] / scale, atol=atol, err_msg=k)


# --------------------------------------------------------------------- mesh


def test_make_mesh_shapes():
    assert parallel.make_mesh(devices=CPU8).shape == {"data": 8, "model": 1}
    assert parallel.make_mesh(4, devices=CPU8).shape == {"data": 4, "model": 1}
    mesh = parallel.make_mesh(4, devices=CPU8)
    assert mesh.data_devices == (torch.device("cpu"),) * 4
    assert mesh.first_device == torch.device("cpu")
    with pytest.raises(ValueError, match="mesh 16x1 needs 16 devices, have 8"):
        parallel.make_mesh(16, devices=CPU8)
    # no model parallelism: a model axis would leave all but one card of
    # each row idle, so it is refused
    with pytest.raises(ValueError, match="model=2: the port has no model parallelism"):
        parallel.make_mesh(4, 2, devices=CPU8)
    with pytest.raises(ValueError, match="CUDA devices or the CPU"):
        parallel.make_mesh(1, devices=["meta"])
    # the default is every visible CUDA device, never the CPU
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"needs {have + 1} devices, have {have}"):
        parallel.make_mesh(have + 1)


def test_replicate_copies_are_differentiable():
    mesh = parallel.make_mesh(3, devices=["cpu"] * 3)
    w = torch.ones(4, requires_grad=True)
    copies = parallel.replicate({"w": w}, mesh)
    assert len(copies) == 3
    sum(torch.sum(c["w"] * (i + 1)) for i, c in enumerate(copies)).backward()
    assert torch.equal(w.grad, torch.full((4,), 6.0))


@pytest.mark.parametrize("n,multiple,width", [(5, 8, 2), (8, 8, 3), (17, 4, 1), (1, 3, 5)])
def test_pad_to_multiple_matches_jax(n, multiple, width):
    arr = np.random.RandomState(n).randn(n, width).astype(np.float32)
    got, got_mask = parallel.pad_to_multiple(arr, multiple)
    want, want_mask = jparallel.pad_to_multiple(arr, multiple)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_mask, want_mask)
    assert got.dtype == want.dtype and got_mask.dtype == want_mask.dtype
    assert got.shape[0] % multiple == 0
    np.testing.assert_array_equal(got[n:], np.broadcast_to(arr[:1], (got.shape[0] - n, width)))
    with pytest.raises(ValueError, match="empty"):
        parallel.pad_to_multiple(np.zeros((0, 2), np.float32), 8)


@pytest.mark.parametrize("pipeline", ["newmethod", "cmb"])
def test_shard_batch_matches_jax(tmp_path, pipeline):
    raw = (newmethod_raw(newmethod_mat(tmp_path)) if pipeline == "newmethod"
           else cmb_raw(tmp_path))
    batch = host_batch(load_training_data(parse_config(raw)))
    shards = parallel.shard_batch(batch, parallel.make_mesh(8, devices=CPU8))
    want = jparallel.shard_batch(batch, jparallel.make_mesh(8))
    assert len(shards) == 8
    assert all(set(s) == set(want) for s in shards)
    assert set(want) == set(BATCH_KEYS) | {"fidelity_mask", "residual_mask"}
    for k, arr in want.items():
        rows = arr.shape[0] // 8
        assert all(s[k].shape[0] == rows for s in shards), k
        got = np.concatenate([s[k].numpy() for s in shards])
        np.testing.assert_array_equal(got, np.asarray(arr), err_msg=k)
        assert got.dtype == np.asarray(arr).dtype


def test_shared_point_set_gets_equal_masks_in_every_shard(tmp_path):
    """One point set (newmethod: fidelity rows == residual rows) gets two
    masks of equal value in every shard, so K1's plain form, which reads
    ``residual_mask`` for both terms, and the generic loss, which reads
    ``fidelity_mask`` for the fidelity, stay one function (ROADMAP.md
    Queue 3 item 3)."""
    td = load_training_data(parse_config(newmethod_raw(newmethod_mat(tmp_path, n_nan=0.11))))
    assert td.fidelity_is_residual
    for n in (3, 7, 8):
        for shard in parallel.shard_batch(host_batch(td), parallel.make_mesh(n, devices=["cpu"] * n)):
            assert torch.equal(shard["fidelity_mask"], shard["residual_mask"])
            assert torch.equal(shard["fidelity_input"], shard["residual_input"])


# ------------------------------------------------------------- sharded loss


def test_sharded_loss_equals_unsharded(tmp_path):
    """The load-bearing property (JAX ``test_sharded_loss_equals_unsharded``):
    shards and masked sums give the single-device full-batch loss and
    gradient; the port's 8 shards also against the JAX package's 8
    devices."""
    raw = newmethod_raw(newmethod_mat(tmp_path))  # odd row count: padding exercised
    cfg = parse_config(raw)
    td = load_training_data(cfg)
    spec = MLPSpec.from_layers(cfg.layers)
    arrays = numpy_params(spec.sizes, seed=0)
    params = params_from_numpy(arrays, "cpu")
    kw = dict(input_min_max=td.input_min_max, fidelity_is_residual=td.fidelity_is_residual)
    mesh = parallel.make_mesh(8, devices=CPU8)
    shards = parallel.shard_batch(host_batch(td), mesh)
    assert shards[0]["residual_input"].shape[0] * 8 > td.residual_input.shape[0]
    plain = port_value_and_grad(build_loss_fn(cfg, spec, **kw), params, torch_batch(td))
    sharded = port_value_and_grad(build_loss_fn(cfg, spec, mesh=mesh, **kw), params, shards)
    assert_loss_grads_close(sharded, plain)
    jax_sh = jax_sharded(raw, arrays, td, input_min_max=td.input_min_max,
                         fidelity_is_residual=td.fidelity_is_residual)
    assert_loss_grads_close(sharded, jax_sh)


def test_k1_sharded_step_equals_unsharded(tmp_path):
    """K1's data-parallel step (its plain statistics and gradients per shard
    on the CPU, the global scales, the flat sum) against the unsharded
    step. Measured gaps and tolerances: ``K1_SHARD_*`` above."""
    cfg = parse_config(newmethod_raw(newmethod_mat(tmp_path)))
    td = load_training_data(cfg)
    spec = MLPSpec.from_layers(cfg.layers)
    params = params_from_numpy(numpy_params(spec.sizes, seed=1), "cpu")
    kw = dict(input_min_max=td.input_min_max, fused_kernel=True,
              fidelity_is_residual=td.fidelity_is_residual)
    mesh = parallel.make_mesh(8, devices=CPU8)
    (t0, (f0, r0)), g0 = build_value_and_grad_fn(cfg, spec, **kw)(params, torch_batch(td))
    shards = parallel.shard_batch(host_batch(td), mesh)
    (t1, (f1, r1)), g1 = build_value_and_grad_fn(cfg, spec, **kw)(params, shards)
    for a, b in ((t1, t0), (f1, f0), (r1, r0)):
        assert abs(float(a) - float(b)) <= K1_SHARD_LOSS_RTOL * abs(float(b))
    gap = max(float((g1[k] - g0[k]).abs().max()) / float(g0[k].abs().max()) for k in g0
              if float(g0[k].abs().max()) > 0)
    assert gap <= K1_SHARD_GRAD_TOL
    # the one-shard mesh is the unsharded step, bit for bit
    one = parallel.make_mesh(1, devices=["cpu"])
    (t2, (f2, r2)), g2 = build_value_and_grad_fn(cfg, spec, **kw)(
        params, parallel.shard_batch(host_batch(td), one))
    assert (float(t2), float(f2), float(r2)) == (float(t0), float(f0), float(r0))
    assert all(torch.equal(g2[k], g0[k]) for k in g0)


@pytest.mark.parametrize("precision", ["bf16", "f32x3"])
def test_k1_sharded_step_at_the_cheap_tiers(tmp_path, precision):
    """At bf16 and f32x3 each shard's plain tier step takes the global
    scales too: the sum equals the unsharded tier step within f32
    summation order (the tier's own rounding is the same per point)."""
    cfg = parse_config(newmethod_raw(newmethod_mat(tmp_path), kernel_precision=precision))
    td = load_training_data(cfg)
    spec = MLPSpec.from_layers(cfg.layers)
    params = params_from_numpy(numpy_params(spec.sizes, seed=2), "cpu")
    kw = dict(input_min_max=td.input_min_max, fused_kernel=True, fused_precision=precision,
              fidelity_is_residual=td.fidelity_is_residual)
    mesh = parallel.make_mesh(4, devices=["cpu"] * 4)
    (t0, _), g0 = build_value_and_grad_fn(cfg, spec, **kw)(params, torch_batch(td))
    (t1, _), g1 = build_value_and_grad_fn(cfg, spec, **kw)(
        params, parallel.shard_batch(host_batch(td), mesh))
    assert abs(float(t1) - float(t0)) <= K1_SHARD_LOSS_RTOL * abs(float(t0))
    for k in g0:
        scale = float(g0[k].abs().max())
        assert float((g1[k] - g0[k]).abs().max()) <= K1_SHARD_GRAD_TOL * scale, k


@pytest.mark.parametrize("fused", [False, True])
def test_sharding_in_float64_is_exact_to_f64_roundoff(tmp_path, fused):
    """The same sharding in float64 against the unsharded float64 loss,
    within 1e-13 relative: apart from f32 roundoff, the sharding itself
    (global counts, padding masked, per-shard partial gradients) is the
    full-batch function (the JAX package's f64 gaps were 1e-16 to 1e-15)."""
    cfg = parse_config(newmethod_raw(newmethod_mat(tmp_path)))
    td = load_training_data(cfg)
    spec = MLPSpec.from_layers(cfg.layers)
    params = {k: v.double() for k, v in
              params_from_numpy(numpy_params(spec.sizes, seed=3), "cpu").items()}
    kw = dict(input_min_max=td.input_min_max, fidelity_is_residual=td.fidelity_is_residual)
    mesh = parallel.make_mesh(8, devices=CPU8)
    shards = parallel.shard_batch(host_batch(td, np.float64), mesh)
    batch = torch_batch(td, torch.float64)
    if fused:
        kw["fused_kernel"] = True
        (t0, (f0, r0)), g0 = build_value_and_grad_fn(cfg, spec, **kw)(params, batch)
        (t1, (f1, r1)), g1 = build_value_and_grad_fn(cfg, spec, **kw)(params, shards)
        want = (np.asarray([float(f0), float(r0), float(t0)]), {k: v.numpy() for k, v in g0.items()})
        got = (np.asarray([float(f1), float(r1), float(t1)]), {k: v.numpy() for k, v in g1.items()})
    else:
        want = port_value_and_grad(build_loss_fn(cfg, spec, **kw), params, batch)
        got = port_value_and_grad(build_loss_fn(cfg, spec, mesh=mesh, **kw), params, shards)
    assert got[1]["w_in"].dtype == np.float64
    np.testing.assert_allclose(got[0], want[0], rtol=1e-13)
    for k in want[1]:
        scale = np.abs(want[1][k]).max()
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=0, atol=1e-13 * scale, err_msg=k)


@pytest.mark.parametrize("fused", [False, True])
def test_sharded_cmb_matches_plain_and_jax(tmp_path, fused):
    """The CMB pipeline on the mesh (JAX
    ``test_sharded_cmb_separate_fidelity_matches_plain``): each shard's
    residual statistics and separate fidelity forward, summed, against the
    plain single-device loss; ``fused`` runs K2 + K3's plain versions per
    shard (the generic fused path as it runs on the card). Tolerances the
    JAX test's: 5e-4 relative on the loss terms and of each gradient's
    scale."""
    raw = cmb_raw(tmp_path)
    cfg = parse_config(raw)
    td = load_training_data(cfg)
    assert not td.fidelity_is_residual
    spec = MLPSpec.from_layers(cfg.layers)
    arrays = numpy_params(spec.sizes, seed=0, eta_col=3)
    params = params_from_numpy(arrays, "cpu")
    mesh = parallel.make_mesh(8, devices=CPU8)
    plain = port_value_and_grad(build_loss_fn(cfg, spec), params, torch_batch(td))
    sharded = port_value_and_grad(build_loss_fn(cfg, spec, mesh=mesh, fused_kernel=fused),
                                  params, parallel.shard_batch(host_batch(td), mesh))
    np.testing.assert_allclose(sharded[0], plain[0], rtol=5e-4)
    assert_scaled_grads_close(sharded[1], plain[1], 5e-4)
    jax_sh = jax_sharded(raw, arrays, td, fused_kernel=True, fused_interpret=True)
    np.testing.assert_allclose(sharded[0], jax_sh[0], rtol=5e-4)
    assert_scaled_grads_close(sharded[1], jax_sh[1], 5e-4)


@pytest.mark.parametrize("fused", [False, True])
def test_sharded_navier_stokes_matches_plain(tmp_path, fused):
    """Sharded ``navier_stokes`` (three differentiated coordinates t, x, y):
    the JAX test's tolerances, 2e-5 on the loss and 1e-4 of each gradient's
    scale on the plain path, 1e-4 and 2e-4 through the kernels' plain
    versions."""
    cfg = parse_config(navier_stokes_raw(tmp_path))
    td = load_training_data(cfg)
    spec = MLPSpec.from_layers(cfg.layers)
    params = params_from_numpy(numpy_params(spec.sizes, seed=0), "cpu")
    mesh = parallel.make_mesh(8, devices=CPU8)
    plain = port_value_and_grad(build_loss_fn(cfg, spec), params, torch_batch(td))
    sharded = port_value_and_grad(build_loss_fn(cfg, spec, mesh=mesh, fused_kernel=fused),
                                  params, parallel.shard_batch(host_batch(td), mesh))
    np.testing.assert_allclose(sharded[0][2], plain[0][2], rtol=1e-4 if fused else 2e-5)
    assert_scaled_grads_close(sharded[1], plain[1], 2e-4 if fused else 1e-4)


def test_sharded_plain_loss_chunks_each_shard(tmp_path):
    """On the plain path a shard larger than ``residual_chunk_size`` is
    evaluated in chunks (``_chunked_stats``); the sum is the unsharded
    loss (JAX tolerances)."""
    raw = newmethod_raw(newmethod_mat(tmp_path), residual_chunk_size=7)
    cfg = parse_config(raw)
    td = load_training_data(cfg)
    spec = MLPSpec.from_layers(cfg.layers)
    params = params_from_numpy(numpy_params(spec.sizes, seed=4), "cpu")
    kw = dict(residual_chunk_size=7, input_min_max=td.input_min_max,
              fidelity_is_residual=td.fidelity_is_residual)
    mesh = parallel.make_mesh(3, devices=["cpu"] * 3)
    shards = parallel.shard_batch(host_batch(td), mesh)
    assert shards[0]["residual_input"].shape[0] > 7
    plain = port_value_and_grad(build_loss_fn(cfg, spec, **kw), params, torch_batch(td))
    sharded = port_value_and_grad(build_loss_fn(cfg, spec, mesh=mesh, **kw), params, shards)
    assert_loss_grads_close(sharded, plain)


def test_step_batches_take_the_global_counts(tmp_path):
    """Every shard's K1 scales come from the global masked counts, built once
    per batch (a shard's local counts would give a wrong gradient)."""
    cfg = parse_config(newmethod_raw(newmethod_mat(tmp_path)))
    td = load_training_data(cfg)
    shards = parallel.shard_batch(host_batch(td), parallel.make_mesh(8, devices=CPU8))
    step_batch = _step_batch_fn(cfg, td.input_min_max)
    batches = step_batch(shards)
    assert step_batch(shards) is batches
    [whole] = step_batch(torch_batch(td))
    for b in batches:
        assert float(b.n_res) == float(whole.n_res) == td.residual_input.shape[0]
        assert float(b.n_sel) == float(whole.n_sel)
        assert torch.equal(b.scal, whole.scal)
    assert sum(int(b.mask.sum()) for b in batches) == td.residual_input.shape[0]


# ------------------------------------------------------------------ Trainer


def test_trainer_on_mesh_matches_single_device(tmp_path):
    """JAX ``test_trainer_on_mesh_matches_single_device``, with its
    tolerances: the same number of rows, totals within 2e-3, parameters
    within rtol 5e-2 and atol 5e-4 (f32 trajectories drift)."""
    raw = newmethod_raw(newmethod_mat(tmp_path, n_nan=0.05), adam_it=12, lbfgs_it=4)
    runs = {}
    for name, kw in (("single", dict(device="cpu")),
                     ("mesh", dict(mesh=parallel.make_mesh(8, devices=CPU8)))):
        run = str(tmp_path / name)
        os.makedirs(run)
        tr = Trainer(parse_config(raw), run_dir=run, echo_every=0, **kw)
        tr.train()
        runs[name] = (read_log(run)[3], tr.state.params)
    (ta, pa), (tb, pb) = runs["single"], runs["mesh"]
    assert len(ta) == len(tb)
    np.testing.assert_allclose(ta, tb, rtol=2e-3)
    for k in pa:
        np.testing.assert_allclose(pa[k].numpy(), pb[k].numpy(), rtol=5e-2, atol=5e-4)


def test_trainer_on_mesh_cmb_matches_single_device(tmp_path):
    """JAX ``test_trainer_on_mesh_cmb_matches_single_device``: separate
    fidelity and residual sets, different row counts, both padded."""
    cfg = parse_config(cmb_raw(tmp_path, adam_it=6, lbfgs_it=2))
    init = numpy_params((2, 16, 16, 16, 6), seed=5, eta_col=3)
    logs = {}
    for name, kw in (("single", dict(device="cpu")),
                     ("mesh", dict(mesh=parallel.make_mesh(8, devices=CPU8)))):
        run = str(tmp_path / name)
        os.makedirs(run)
        Trainer(cfg, run_dir=run, echo_every=0, initial_params=init, **kw).train()
        logs[name] = read_log(run)
    _, fa, _, ta = logs["single"]
    _, fb, _, tb = logs["mesh"]
    assert len(ta) == len(tb)
    np.testing.assert_allclose(ta, tb, rtol=2e-3)
    np.testing.assert_allclose(fa, fb, rtol=2e-3)


def test_mesh_trainer_tracks_the_jax_mesh_trainer(tmp_path):
    """The port's 8-shard Trainer and the JAX package's 8-device one from the
    same weights: iteration 1 within 1e-5 relative, the first 5 Adam losses
    within 1e-4 (as ``tests/test_torch_trainer.py`` holds the unsharded
    Trainers)."""
    raw = newmethod_raw(newmethod_mat(tmp_path), adam_it=5, lbfgs_it=0)
    init = numpy_params((2, 16, 16, 16, 3), seed=6)
    run_p, run_j = str(tmp_path / "p"), str(tmp_path / "j")
    os.makedirs(run_p)
    os.makedirs(run_j)
    Trainer(parse_config(raw), run_dir=run_p, echo_every=0, initial_params=init,
            mesh=parallel.make_mesh(8, devices=CPU8)).train()
    JTrainer(jparse(raw), run_dir=run_j, echo_every=0, initial_params=init,
             mesh=jparallel.make_mesh(8)).train()
    tp, tj = np.asarray(read_log(run_p)[3]), np.asarray(read_log(run_j)[3])
    assert len(tp) == len(tj) == 5
    assert abs(tp[0] - tj[0]) <= 1e-5 * abs(tj[0])
    np.testing.assert_allclose(tp, tj, rtol=1e-4)


def test_trainer_mesh_and_device_must_agree(tmp_path):
    raw = newmethod_raw(newmethod_mat(tmp_path), adam_it=1, lbfgs_it=0)
    mesh = parallel.make_mesh(2, devices=["cpu"] * 2)
    tr = Trainer(parse_config(raw), run_dir=str(tmp_path), mesh=mesh, device="cpu")
    assert tr.device == torch.device("cpu") and len(tr.batch) == 2
    with pytest.raises(ValueError, match="first device"):
        Trainer(parse_config(raw), run_dir=str(tmp_path), mesh=mesh, device="cuda")


def test_cli_mesh_and_parallel_data(tmp_path, capsys):
    """CLI ``train --mesh N`` and a config's ``parallel.data`` build the mesh
    (on the CPU with ``--device cpu``: N shards in the one process); more
    shards than visible CUDA devices exit 1 with the mesh error."""
    mat = newmethod_mat(tmp_path)
    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as f:
        json.dump(newmethod_raw(mat, adam_it=4, lbfgs_it=2), f)
    assert cli.main(["train", "--config", cfg, "--log-root", str(tmp_path), "--run-name", "m",
                     "--device", "cpu", "--mesh", "4"]) == 0
    assert "mesh 4x1 over ['cpu', 'cpu', 'cpu', 'cpu']" in capsys.readouterr().out
    scaled = str(tmp_path / "scaled.json")
    with open(scaled, "w") as f:
        json.dump(newmethod_raw(mat, adam_it=4, lbfgs_it=2, parallel={"data": 8},
                                residual_chunk_size=32768), f)
    assert cli.main(["train", "--config", scaled, "--log-root", str(tmp_path),
                     "--run-name", "s", "--device", "cpu"]) == 0
    assert "mesh 8x1" in capsys.readouterr().out
    epochs = read_log(str(tmp_path / "s"))[0]
    assert epochs == list(range(1, len(epochs) + 1)) and len(epochs) >= 5
    have = torch.cuda.device_count()
    assert cli.main(["train", "--config", scaled, "--log-root", str(tmp_path)]) == (
        1 if have < 8 else 0)
    if have < 8:
        assert (f"Error building device mesh: mesh 8x1 needs 8 devices, have {have}"
                in capsys.readouterr().out)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_cli_refuses_a_model_axis(tmp_path, capsys, device):
    """``parallel.model`` 2 exits 1 with the mesh error, on the CPU and on
    the default CUDA devices alike: the port shards data only, and a model
    axis would leave all but one card of each row idle."""
    mat = newmethod_mat(tmp_path)
    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as f:
        json.dump(newmethod_raw(mat, adam_it=2, lbfgs_it=0,
                                parallel={"data": 1, "model": 2}), f)
    assert cli.main(["train", "--config", cfg, "--log-root", str(tmp_path), "--run-name", "m",
                     "--device", device]) == 1
    assert ("Error building device mesh: model=2: the port has no model parallelism"
            in capsys.readouterr().out)
    assert not os.path.exists(tmp_path / "m")
