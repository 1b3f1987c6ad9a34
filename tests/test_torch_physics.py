"""The port's continuity physics (``pinn_depthestimation_tpu_torch.physics``)
held against the JAX package on the CPU at identical fields and weights.

Tolerance 1e-5 relative: f32 against f32 with ``Precision.HIGHEST``, summed
in other orders.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_depthestimation_tpu import physics as jphysics
from pinn_depthestimation_tpu.models import MLPSpec as JSpec
from pinn_depthestimation_tpu.models import mlp_apply_with_tangents as j_awt
from pinn_depthestimation_tpu_torch import physics
from pinn_depthestimation_tpu_torch.models import MLPSpec, mlp_apply_with_tangents, params_from_numpy


def fields_and_grads(n, seed):
    rng = np.random.RandomState(seed)
    names = ("U", "V", "h")
    f = {k: rng.randn(n).astype(np.float32) for k in names}
    g = {c: {k: rng.randn(n).astype(np.float32) for k in names} for c in ("x", "y")}
    return f, g


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


def to_jax(tree):
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("name", ["continuity_only", "continuity_ftemp"])
def test_losses_match_jax(name, with_mask):
    n = 200
    f, g = fields_and_grads(n, seed=1)
    rng = np.random.RandomState(2)
    # x as stored: half of the points below the 25.5 anchor threshold
    coords = {"x": rng.uniform(0, 51, n).astype(np.float32),
              "y": rng.uniform(-1, 1, n).astype(np.float32)}
    mask = (rng.uniform(size=n) < 0.7) if with_mask else None
    got = physics.residual_loss(name)(
        to_torch(coords), to_torch(f), to_torch(g),
        mask=None if mask is None else torch.from_numpy(mask),
    )
    want = jphysics.residual_loss(name)(
        to_jax(coords), to_jax(f), to_jax(g), mask=None if mask is None else jnp.asarray(mask),
    )
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert physics.required_grad_coords(name) == jphysics.required_grad_coords(name)


def test_residuals_and_masked_mean_match_jax():
    f, g = fields_and_grads(64, seed=3)
    np.testing.assert_allclose(
        physics.continuity_only_residuals(to_torch(f), to_torch(g)).numpy(),
        np.asarray(jphysics.continuity_only_residuals(to_jax(f), to_jax(g))),
        rtol=1e-6, atol=1e-6,
    )
    v = np.random.RandomState(4).rand(64).astype(np.float32)
    m = np.arange(64) % 3 == 0
    np.testing.assert_allclose(
        float(physics.masked_mean(torch.from_numpy(v), torch.from_numpy(m))),
        float(jphysics.masked_mean(jnp.asarray(v), jnp.asarray(m))), rtol=1e-6,
    )


def test_anchor_quirk_empty_selection_is_nan():
    """Quirk 2: the anchor compares the stored x; no x below 25.5 means an
    empty selection, whose mean is NaN as in torch.mean of nothing."""
    f, g = fields_and_grads(10, seed=5)
    coords = {"x": torch.full((10,), 30.0), "y": torch.zeros(10)}
    assert torch.isnan(physics.continuity_only(coords, to_torch(f), to_torch(g)))
    # normalized x (the shipped pipeline) selects every point
    coords["x"] = torch.linspace(-1, 1, 10)
    assert torch.isfinite(physics.continuity_only(coords, to_torch(f), to_torch(g)))


def test_model_fields_and_grads_matches_jax():
    sizes = (2, 12, 12, 12, 3)
    rng = np.random.RandomState(6)
    arrays = {
        "w_in": rng.uniform(-1, 1, (2, 12)).astype(np.float32),
        "b_in": rng.uniform(-0.1, 0.1, 12).astype(np.float32),
        "w_hidden": (rng.uniform(-0.5, 0.5, (2, 12, 12))).astype(np.float32),
        "b_hidden": rng.uniform(-0.1, 0.1, (2, 12)).astype(np.float32),
        "w_out": rng.uniform(-0.5, 0.5, (12, 3)).astype(np.float32),
        "b_out": rng.uniform(-0.2, 0.2, 3).astype(np.float32),
    }
    x = rng.uniform(-1, 1, (50, 2)).astype(np.float32)
    names = (["x", "y"], ["y"], ["U", "V", "h"])
    params = params_from_numpy(arrays, "cpu")
    c, f, g = physics.model_fields_and_grads(
        lambda z, t: mlp_apply_with_tangents(params, z, t, MLPSpec(sizes=sizes)),
        torch.from_numpy(x), *names,
    )
    jc, jf, jg = jphysics.model_fields_and_grads(
        functools.partial(j_awt, {k: jnp.asarray(v) for k, v in arrays.items()},
                          spec=JSpec(sizes=sizes)),
        jnp.asarray(x), *names,
    )
    assert set(g) == {"y"} and set(g["y"]) == {"U", "V", "h"}
    for k in ("x", "y"):
        np.testing.assert_array_equal(c[k].numpy(), np.asarray(jc[k]))
    for k in ("U", "V", "h"):
        np.testing.assert_allclose(f[k].numpy(), np.asarray(jf[k]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(g["y"][k].numpy(), np.asarray(jg["y"][k]), rtol=1e-5, atol=1e-6)


def test_registry():
    with pytest.raises(KeyError, match="available"):
        physics.residual_loss("nope")
    # the legacy equation is ported: its loss, its coordinates, its statistics
    assert physics.residual_loss("navier_stokes") is physics.navier_stokes
    assert physics.required_grad_coords("navier_stokes") == ("t", "x", "y")
    assert physics.residual_stats("navier_stokes") is physics.navier_stokes_stats
    assert physics.residual_loss("wave_averaged") is physics.wave_averaged
    assert physics.required_grad_coords("wave_averaged") == ("x", "y")
