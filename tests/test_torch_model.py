"""The port's model layer (``pinn_depthestimation_tpu_torch.models``) held
against the JAX package on the CPU, at identical weights and inputs made
from a numpy seed.

Tolerance: both sides compute in true f32 (JAX pins ``Precision.HIGHEST``,
the port switches TF32 off) but sum in other orders and use other tanh
implementations, so they agree to f32 roundoff, about 1e-6 relative per
layer: 1e-5 for shallow nets, 1e-4 relative at the 100-layer flagship
depth, where the differences compound through the stack.
"""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_depthestimation_tpu import config as jconfig
from pinn_depthestimation_tpu.models import mlp as jmlp
from pinn_depthestimation_tpu_torch import config as tconfig
from pinn_depthestimation_tpu_torch.models import (
    PARAM_KEYS,
    MLPSpec,
    PinnMLP,
    init_mlp_params,
    mlp_apply,
    mlp_apply_with_tangents,
    num_params,
    params_from_numpy,
    params_to_numpy,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def numpy_params(sizes, init_type="xavier", seed=0):
    """Exchange-dict weights from a numpy seed, nonzero biases included."""
    rng = np.random.RandomState(seed)
    d_in, d_out = sizes[0], sizes[-1]
    if len(sizes) == 2:
        return {
            "w_in": np.zeros((d_in, 0), np.float32), "b_in": np.zeros((0,), np.float32),
            "w_hidden": np.zeros((0, 0, 0), np.float32),
            "b_hidden": np.zeros((0, 0), np.float32),
            "w_out": rng.uniform(-1, 1, (d_in, d_out)).astype(np.float32),
            "b_out": rng.uniform(-0.5, 0.5, d_out).astype(np.float32),
        }
    W, n_stack = sizes[1], len(sizes) - 3
    gain = 1.0 if init_type == "xavier" else 0.7
    return {
        "w_in": (rng.uniform(-1, 1, (d_in, W)) * gain).astype(np.float32),
        "b_in": rng.uniform(-0.1, 0.1, W).astype(np.float32),
        "w_hidden": (rng.uniform(-1, 1, (n_stack, W, W)) * gain * math.sqrt(3.0 / W)).astype(np.float32),
        "b_hidden": rng.uniform(-0.1, 0.1, (n_stack, W)).astype(np.float32),
        "w_out": (rng.uniform(-1, 1, (W, d_out)) * math.sqrt(3.0 / W)).astype(np.float32),
        "b_out": rng.uniform(-0.2, 0.2, d_out).astype(np.float32),
    }


def coord_tangents(n, d_in, k):
    t = np.zeros((k, n, d_in), np.float32)
    for c in range(k):
        t[c, :, c] = 1.0
    return t


CASES = [
    # (sizes, init_type, n_points, rtol)
    ((2, 3), "xavier", 17, 1e-5),                       # no hidden layer
    ((2, 12, 3), "xavier", 33, 1e-5),                   # one hidden layer
    ((2, 16, 16, 16, 3), "xavier", 64, 1e-5),
    ((3, 8, 8, 8, 8, 4), "kaiming", 64, 1e-5),
    ((2, 20, 20, 20, 3), "kaiming", 50, 1e-5),
    ((2,) + (20,) * 100 + (3,), "xavier", 64, 1e-4),    # flagship depth
]


@pytest.mark.parametrize("sizes,init_type,n,rtol", CASES)
def test_mlp_apply_matches_jax(sizes, init_type, n, rtol):
    arrays = numpy_params(sizes, init_type, seed=len(sizes))
    x = np.random.RandomState(1).uniform(-1, 1, (n, sizes[0])).astype(np.float32)
    y_jax = jmlp.mlp_apply(
        {k: jnp.asarray(v) for k, v in arrays.items()}, jnp.asarray(x),
        jmlp.MLPSpec(sizes=sizes, init_type=init_type),
    )
    y = mlp_apply(params_from_numpy(arrays, "cpu"), torch.from_numpy(x),
                  MLPSpec(sizes=sizes, init_type=init_type))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("sizes,init_type,n,rtol", CASES)
def test_mlp_apply_with_tangents_matches_jax(sizes, init_type, n, rtol):
    arrays = numpy_params(sizes, init_type, seed=len(sizes) + 1)
    rng = np.random.RandomState(2)
    x = rng.uniform(-1, 1, (n, sizes[0])).astype(np.float32)
    # coordinate directions plus one generic direction
    tang = np.concatenate([coord_tangents(n, sizes[0], 2),
                           rng.randn(1, n, sizes[0]).astype(np.float32)])
    y_jax, dy_jax = jmlp.mlp_apply_with_tangents(
        {k: jnp.asarray(v) for k, v in arrays.items()}, jnp.asarray(x), jnp.asarray(tang),
        jmlp.MLPSpec(sizes=sizes, init_type=init_type),
    )
    y, dy = mlp_apply_with_tangents(
        params_from_numpy(arrays, "cpu"), torch.from_numpy(x), torch.from_numpy(tang),
        MLPSpec(sizes=sizes, init_type=init_type),
    )
    assert dy.shape == (3, n, sizes[-1])
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jax), rtol=rtol, atol=1e-6)
    np.testing.assert_allclose(dy.numpy(), np.asarray(dy_jax), rtol=rtol, atol=1e-6)


def test_tangents_accept_a_sequence_and_match_autograd():
    spec = MLPSpec(sizes=(2, 10, 10, 3), init_type="xavier")
    params = params_from_numpy(numpy_params(spec.sizes), "cpu")
    x = torch.from_numpy(np.random.RandomState(3).uniform(-1, 1, (9, 2)).astype(np.float32))
    e = [torch.zeros_like(x).index_fill_(1, torch.tensor([c]), 1.0) for c in range(2)]
    _, dy = mlp_apply_with_tangents(params, x, e, spec)
    jac = torch.autograd.functional.jacobian(lambda z: mlp_apply(params, z, spec), x)
    # jac[i, o, i, c] = d y[i, o] / d x[i, c]
    idx = torch.arange(9)
    for c in range(2):
        np.testing.assert_allclose(dy[c].numpy(), jac[idx, :, idx, c].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("init_type", ["xavier", "kaiming"])
def test_init_bounds_zero_biases_and_layout(init_type):
    spec = MLPSpec(sizes=(2,) + (20,) * 6 + (3,), init_type=init_type)
    p = init_mlp_params(torch.Generator().manual_seed(0), spec, device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w_in": (2, 20), "b_in": (20,), "w_hidden": (5, 20, 20), "b_hidden": (5, 20),
        "w_out": (20, 3), "b_out": (3,),
    }
    # the JAX package's parameter count for the same spec
    jax_p = jmlp.init_mlp_params(jax.random.PRNGKey(0), jmlp.MLPSpec(sizes=spec.sizes))
    assert num_params(p) == sum(int(v.size) for v in jax_p.values())

    def bound(fan_in, fan_out):
        return math.sqrt(6 / (fan_in + fan_out)) if init_type == "xavier" else math.sqrt(6 / fan_in)

    # fans per stacked layer, not over the stack
    for key, b in (("w_in", bound(2, 20)), ("w_hidden", bound(20, 20)), ("w_out", bound(20, 3))):
        w = p[key]
        assert float(w.abs().max()) <= b
        assert float(w.abs().max()) > 0.8 * b  # fills the range
    assert not p["b_in"].any() and not p["b_hidden"].any()
    assert 0 < float(p["b_out"].abs().max()) <= 1 / math.sqrt(20)
    # one seed gives one set of weights
    q = init_mlp_params(torch.Generator().manual_seed(0), spec, device="cpu")
    assert all(torch.equal(p[k], q[k]) for k in PARAM_KEYS)


def test_params_numpy_round_trip_and_missing_key():
    arrays = numpy_params((2, 8, 8, 3))
    back = params_to_numpy(params_from_numpy(arrays, "cpu"))
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(back[k], arrays[k])
        assert back[k].dtype == np.float32
    with pytest.raises(KeyError, match="w_out"):
        params_from_numpy({k: v for k, v in arrays.items() if k != "w_out"}, "cpu")


def test_dropout_inverted_scaling_and_eval_mode():
    spec = MLPSpec(sizes=(2, 64, 64, 3), init_type="xavier", dropout_rate=0.5)
    arrays = numpy_params(spec.sizes)
    params = params_from_numpy(arrays, "cpu")
    x = torch.from_numpy(np.random.RandomState(4).uniform(-1, 1, (256, 2)).astype(np.float32))
    y_eval = mlp_apply(params, x, spec)
    y_a = mlp_apply(params, x, spec, dropout_generator=torch.Generator().manual_seed(1))
    y_b = mlp_apply(params, x, spec, dropout_generator=torch.Generator().manual_seed(1))
    y_c = mlp_apply(params, x, spec, dropout_generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(y_a, y_b)         # same generator state, same mask
    assert not torch.allclose(y_a, y_c)          # other draws, other mask
    assert not torch.allclose(y_a, y_eval)
    # inverted dropout: kept units scale by 1/keep, dropped ones are 0
    from pinn_depthestimation_tpu_torch.models.mlp import _dropout

    out = _dropout(torch.ones(20_000), 0.25, torch.Generator().manual_seed(0))
    assert set(out.unique().tolist()) <= {0.0, np.float32(1 / 0.75)}
    assert abs(float((out == 0).float().mean()) - 0.25) < 0.02
    # rate 0 with a generator is the eval forward
    spec0 = dataclasses.replace(spec, dropout_rate=0.0)
    torch.testing.assert_close(
        mlp_apply(params, x, spec0, dropout_generator=torch.Generator().manual_seed(1)),
        mlp_apply(params, x, spec0),
    )


def test_pinn_module_matches_functional():
    spec = MLPSpec(sizes=(2, 12, 12, 3), init_type="kaiming")
    arrays = numpy_params(spec.sizes, "kaiming")
    m = PinnMLP(spec, device="cpu", params=params_from_numpy(arrays, "cpu")).eval()
    x = torch.from_numpy(np.random.RandomState(5).uniform(-1, 1, (7, 2)).astype(np.float32))
    torch.testing.assert_close(m(x), mlp_apply(params_from_numpy(arrays, "cpu"), x, spec))
    assert sorted(n for n, _ in m.named_parameters()) == sorted(PARAM_KEYS)
    tang = torch.from_numpy(coord_tangents(7, 2, 2))
    torch.testing.assert_close(
        m.apply_with_tangents(x, tang)[1],
        mlp_apply_with_tangents(params_from_numpy(arrays, "cpu"), x, tang, spec)[1],
    )
    seeded = PinnMLP(spec, device="cpu", generator=torch.Generator().manual_seed(3))
    assert seeded.w_hidden.shape == (1, 12, 12)


def test_spec_validation_matches_jax():
    for bad in ((2,), (2, 10, 12, 3)):
        with pytest.raises(ValueError):
            MLPSpec(sizes=bad)
    with pytest.raises(ValueError, match="init_type"):
        MLPSpec(sizes=(2, 3), init_type="he")
    s = MLPSpec(sizes=(2, 20, 20, 3))
    j = jmlp.MLPSpec(sizes=(2, 20, 20, 3))
    assert (s.d_in, s.d_out, s.width, s.n_hidden) == (j.d_in, j.d_out, j.width, j.n_hidden)


@pytest.mark.parametrize(
    "name", sorted(n for n in os.listdir(os.path.join(REPO, "examples")) if n.endswith(".json"))
)
def test_config_copy_parses_like_jax(name):
    with open(os.path.join(REPO, "examples", name)) as f:
        raw = json.load(f)
    t, j = tconfig.parse_config(raw), jconfig.parse_config(raw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.resolved_kernel_precision() == j.resolved_kernel_precision() == "f32"
    assert MLPSpec.from_layers(t.layers).sizes == jmlp.MLPSpec.from_layers(j.layers).sizes
