"""K1-K4 take every net the Pallas kernels take (``ops/widths.py``): the
gate against the JAX package's, the narrow bodies' exact padding, the wide
body's launch plan (``ops/wide_plan.py``), the wrappers' routing, and the
port held to the JAX package's Pallas kernels (interpret mode) at widths
17, 64 and 128 and at ``d_out = 16``.

Tolerances: padding changes nothing beyond f32 roundoff (1e-6 of each
output's or gradient's largest entry); against the JAX package,
``test_torch_loss.assert_same``'s (the loss to f32 roundoff, 1e-5 relative;
the gradients scaled by their largest entry within 2e-5).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pinn_depthestimation_tpu.models import MLPSpec as JSpec
from pinn_depthestimation_tpu.ops import kernels as jk
from pinn_depthestimation_tpu.ops import kernels_step as jstep
from pinn_depthestimation_tpu.ops import kernels_vjp as jvjp
from pinn_depthestimation_tpu.training.driver import Trainer as JTrainer
from pinn_depthestimation_tpu_torch.config import parse_config
from pinn_depthestimation_tpu_torch.inference import resolve_use_kernel
from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
from pinn_depthestimation_tpu_torch.models.mlp import PARAM_KEYS
from pinn_depthestimation_tpu_torch.ops import (
    cuda_build,
    kernels,
    kernels_step,
    kernels_vjp,
    wide_plan,
    widths,
)
from pinn_depthestimation_tpu_torch.training.driver import decide_kernels
from pinn_depthestimation_tpu_torch.utils import synthetic
from test_torch_bf16 import numpy_params
from test_torch_train_step import port_batch, step_inputs
from test_torch_trainer import newmethod_raw

TIERS = ("f32", "bf16", "f32x3")


# ----------------------------------------------------------------- the gate

def jax_gate(spec: MLPSpec) -> bool:
    """The JAX Trainer's ``structurally_ok`` (``training/driver.py:228-232``),
    asked through its own code: with ``fused_kernel='on'`` it returns True
    or raises."""
    fake = types.SimpleNamespace(config=types.SimpleNamespace(fused_kernel="on"), mesh=None,
                                 spec=JSpec(sizes=spec.sizes, dropout_rate=spec.dropout_rate))
    try:
        return JTrainer._decide_fused_kernel(fake)
    except ValueError:
        return False


@pytest.fixture(scope="module")
def gate_configs(tmp_path_factory):
    mat = str(tmp_path_factory.mktemp("gate") / "data.mat")
    synthetic.make_newmethod_mat(mat, nx=8, ny=6, nan_fraction=0.0, seed=1)
    return {mode: parse_config(newmethod_raw(mat, fused_kernel=mode)) for mode in ("on", "auto")}


@settings(max_examples=150, deadline=None)
@given(width=st.integers(1, 140), d_in=st.integers(1, 140), d_out=st.integers(1, 140),
       n_hidden=st.integers(0, 3), dropout=st.sampled_from([0.0, 0.1]),
       fidelity_is_residual=st.booleans())
def test_gates_say_yes_exactly_where_the_jax_gate_does(gate_configs, width, d_in, d_out,
                                                       n_hidden, dropout, fidelity_is_residual):
    spec = MLPSpec(sizes=(d_in,) + (width,) * n_hidden + (d_out,), dropout_rate=dropout)
    jax_ok = jax_gate(spec)
    shapes_ok = n_hidden >= 1 and max(width, d_in, d_out) <= 128  # JAX inference.py:81-86
    assert jax_ok == (shapes_ok and dropout == 0.0)
    assert kernels.kernel_supports(spec) == shapes_ok
    assert kernels_vjp.kernel_supports(spec) == shapes_ok
    assert kernels_step.kernel_supports(spec) == (shapes_ok and d_out == 3 and d_in >= 2)
    if shapes_ok:
        assert resolve_use_kernel(spec, "cuda", None) is True
    else:
        with pytest.raises(ValueError, match="use_kernel=False"):
            resolve_use_kernel(spec, "cuda", None)
    if d_in < 2:  # the continuity physics needs K = 2 <= min(3, d_in) tangents
        return
    for mode, cfg in gate_configs.items():
        if not shapes_ok:  # K2-predict refuses the net, as above
            with pytest.raises(ValueError):
                decide_kernels(cfg, spec, fidelity_is_residual, "cuda")
            continue
        if mode == "on" and not jax_ok:
            with pytest.raises(ValueError, match="fused_kernel='on' needs"):
                decide_kernels(cfg, spec, fidelity_is_residual, "cuda")
            continue
        plan = decide_kernels(cfg, spec, fidelity_is_residual, "cuda")
        assert (plan.k1 or plan.fused) == jax_ok and plan.predict
        assert plan.k1 == (jax_ok and fidelity_is_residual and d_out == 3)


def test_routes():
    route = lambda *sizes: widths.narrow_width(MLPSpec(sizes=sizes))  # noqa: E731
    assert route(2, 20, 20, 3) == 20 and route(2, 10, 6) == 10     # compiled: as they are
    assert route(2, 17, 17, 3) == 20 and route(3, 24, 24, 3) == 32  # padded
    assert route(2, 1, 1, 3) == 8 and route(2, 9, 4) == 10 and route(8, 11, 8) == 16
    assert route(2, 33, 3) is None and route(2, 128, 2) is None     # wide
    assert route(9, 20, 3) is None and route(3, 20, 16) is None     # d_in, d_out > 8: wide
    assert route(2, 129, 3) is None and route(2, 3) is None         # beyond the gate
    assert widths.body(MLPSpec(sizes=(2, 17, 3))) == "narrow"
    assert widths.body(MLPSpec(sizes=(2, 64, 3))) == "wide"


# ----------------------------------------------------------------- padding

PADDED = [((2, 17, 17, 17, 3), "xavier", 20), ((3, 24, 24, 24, 3), "kaiming", 32),
          ((2, 1, 1, 3), "xavier", 8), ((2, 9, 9, 4), "kaiming", 10)]


def rel_close(got, want, tol=1e-6):
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    assert got.shape == want.shape
    if want.numel():
        scale = float(want.abs().max()) + 1e-30
        assert float((got - want).abs().max()) <= tol * scale


@pytest.mark.parametrize("sizes,init,width", PADDED)
def test_padded_net_computes_the_same_function(sizes, init, width):
    spec = MLPSpec(sizes=sizes, init_type=init)
    pspec = widths.padded_spec(spec, width)
    params = params_from_numpy(numpy_params(sizes), "cpu")
    padded = widths.pad_params(params, spec, width)
    assert all(padded[k].shape == p.shape for k, p in zip(PARAM_KEYS, (
        torch.empty(spec.d_in, width), torch.empty(width), torch.empty(spec.n_hidden - 1, width, width),
        torch.empty(spec.n_hidden - 1, width), torch.empty(width, spec.d_out), torch.empty(spec.d_out))))
    rs = np.random.RandomState(4)
    x = torch.as_tensor(rs.uniform(-1, 1, (57, spec.d_in)).astype(np.float32))
    kt = min(3, spec.d_in)
    # at f32: the reduced tiers round the same values, and a flipped rounding is theirs
    y, dy = kernels.mlp_fwd_tangents_plain(params, x, spec, kt)
    py, pdy = kernels.mlp_fwd_tangents_plain(padded, x, pspec, kt)
    rel_close(py.detach(), y.detach())
    rel_close(pdy.detach(), dy.detach())
    ybar = torch.as_tensor(rs.randn(57, spec.d_out).astype(np.float32))
    dybar = torch.as_tensor(rs.randn(kt, 57, spec.d_out).astype(np.float32))
    g = kernels_vjp.packed_mlp_bwd_plain(params, x, ybar, dybar, spec, kt)
    pg = widths.slice_grads(
        kernels_vjp.packed_mlp_bwd_plain(padded, x, ybar, dybar, pspec, kt), spec)
    for k in PARAM_KEYS:
        rel_close(pg[k], g[k])
    if spec.d_out == 3:
        b = port_batch(*step_inputs(57, 2), 2, True)
        b = kernels_step.make_step_batch(x[:, :2] if spec.d_in == 2 else x, b.trues, b.sel, b.mask,
                                         [1.0, 0.5], 2, 0.7, 1.3, has_anchor=True)
        (t, (f, r)), g = kernels_step.fused_loss_and_grad_plain(params, b, spec)
        (pt, (pf, pr)), pg = kernels_step.fused_loss_and_grad_plain(padded, b, pspec)
        for a, c in ((pt, t), (pf, f), (pr, r)):
            rel_close(a.detach().reshape(1), c.detach().reshape(1))
        pg = widths.slice_grads(pg, spec)
        for k in PARAM_KEYS:
            rel_close(pg[k], g[k])


def test_padding_adds_plus_zero_and_drops_the_added_gradients():
    spec = MLPSpec(sizes=(2, 3, 3, 2))
    params = {k: -torch.ones_like(torch.as_tensor(v)) for k, v in numpy_params(spec.sizes).items()}
    padded = widths.pad_params(params, spec, 8)
    for k in ("w_in", "b_in", "w_hidden", "b_hidden", "w_out"):
        extra = padded[k][..., 3:] if k != "w_out" else padded[k][3:]
        assert bool((extra == 0).all()) and not bool(torch.signbit(extra).any())
    grads = {k: torch.arange(v.numel(), dtype=torch.float32).reshape(v.shape)
             for k, v in padded.items()}
    sliced = widths.slice_grads(grads, spec)
    for k in PARAM_KEYS:
        assert sliced[k].shape == params[k].shape
    assert torch.equal(sliced["w_hidden"], grads["w_hidden"][:, :3, :3])
    assert torch.equal(sliced["b_in"], grads["b_in"][:3])  # the padded rows dropped, not summed
    with pytest.raises(ValueError, match="pad width"):
        widths.pad_params(params, MLPSpec(sizes=(2, 12, 12, 2)), 8)


# ------------------------------------------------- the routing of the wrappers

class Recorder:
    """Stands in for a narrow or wide launch on the CPU: records what it was
    given and computes the kernel's function with the plain version."""

    def __init__(self):
        self.calls = []

    def k2(self, body):
        def launch(params, coords, spec, kt, precision, *, epilogue, y=None, dy=None, fc=None,
                   lib=None):
            self.calls.append((body, spec, {k: v.shape for k, v in params.items()}))
            if epilogue:
                fc.copy_(kernels.residual_continuity_plain(params, coords, spec, precision))
                return
            yy, dd = kernels.mlp_fwd_tangents_plain(params, coords, spec, kt, precision)
            y.copy_(yy.detach())
            if kt:
                dy.copy_(dd.detach())
        return launch

    def bwd(self, body):
        def launch(*args, **kw):
            if body == "wide":
                args = args[1:]  # the kernel's name
            params, coords, ybar, dybar, spec, kt, precision = args[:7]
            self.calls.append((body, spec, {k: v.shape for k, v in params.items()}))
            g = kernels_vjp.packed_mlp_bwd_plain(params, coords, ybar, dybar, spec, kt, precision)
            return torch.cat([g[k].reshape(-1) for k in kernels_step.FLAT_KEYS])
        return launch

    def k1(self, body):
        def launch(params, b, spec, lib=None, precision="f32"):
            if body == "wide":
                precision = lib
            self.calls.append((body, spec, {k: v.shape for k, v in params.items()}))
            _, _, _, stats, g = kernels_step._plain_stats_and_grads(params, b, spec, precision)
            return torch.cat([g[k].reshape(-1) for k in kernels_step.FLAT_KEYS] + [stats])
        return launch


@pytest.mark.parametrize("sizes,body,width", [
    ((2, 17, 17, 3), "narrow", 20), ((2, 24, 24, 24, 3), "narrow", 32),
    ((2, 20, 20, 3), "narrow", 20), ((2, 40, 40, 3), "wide", 40), ((3, 12, 12, 16), "wide", 12),
])
def test_wrappers_route_pad_and_slice(monkeypatch, sizes, body, width):
    """The launchers reached on the CPU with the kernels' launches recorded:
    a net goes to its body at the width the route says (padded for the
    narrow body), and what comes back has the net's own shapes and the
    unpadded net's values: no gradient entry of a padded neuron reaches a
    caller."""
    rec = Recorder()
    monkeypatch.setattr(kernels, "_launch_k2_narrow", rec.k2("narrow"))
    monkeypatch.setattr(kernels, "_launch_k2_wide", rec.k2("wide"))
    monkeypatch.setattr(kernels_vjp, "_launch_k3_narrow", rec.bwd("narrow"))
    monkeypatch.setattr(kernels_vjp, "_launch_k4_narrow", rec.bwd("narrow"))
    monkeypatch.setattr(kernels_vjp, "_launch_wide", rec.bwd("wide"))
    monkeypatch.setattr(kernels_step, "_launch_k1_narrow", rec.k1("narrow"))
    monkeypatch.setattr(kernels_step, "_launch_k1_wide", rec.k1("wide"))
    spec = MLPSpec(sizes=sizes)
    params = params_from_numpy(numpy_params(sizes), "cpu")
    rs = np.random.RandomState(5)
    n, kt = 41, min(2, spec.d_in)
    x = torch.as_tensor(rs.uniform(-1, 1, (n, spec.d_in)).astype(np.float32))
    y, dy = torch.empty(n, spec.d_out), torch.empty(kt, n, spec.d_out)
    kernels._launch_k2(params, x, spec, kt, "f32", epilogue=False, y=y, dy=dy)
    yr, dyr = kernels.mlp_fwd_tangents_plain(params, x, spec, kt)
    rel_close(y, yr.detach())
    rel_close(dy, dyr.detach())
    ybar = torch.as_tensor(rs.randn(n, spec.d_out).astype(np.float32))
    dybar = torch.as_tensor(rs.randn(kt, n, spec.d_out).astype(np.float32))
    want = kernels_vjp.packed_mlp_bwd_plain(params, x, ybar, dybar, spec, kt)
    for launch in (kernels_vjp._launch_k3, kernels_vjp._launch_k4):
        args = (params, x, ybar, dybar, spec, kt, "f32")
        got = kernels_step.unflatten(launch(*args), spec)
        for k in PARAM_KEYS:
            assert got[k].shape == params[k].shape
            rel_close(got[k], want[k])
    if spec.d_out == 3:
        b = port_batch(*step_inputs(n, 2), 2, True)
        flat = kernels_step._launch_k1(params, b, spec, precision="f32")
        _, _, _, stats, g = kernels_step._plain_stats_and_grads(params, b, spec, "f32")
        got = kernels_step.unflatten(flat[:kernels_step.n_flat(spec)], spec)
        for k in PARAM_KEYS:
            rel_close(got[k], g[k])
        rel_close(flat[kernels_step.n_flat(spec):], stats)
    for called, cspec, shapes in rec.calls:
        assert called == body and cspec.width == width
        assert shapes["w_hidden"] == (spec.n_hidden - 1, width, width)


# ---------------------------------------------------------- the launch plan

def test_every_gated_shape_fits_the_shared_memory():
    """W <= 128, d_in, d_out <= 128, K <= 3, every kernel and tier: a tile
    of at least 16 points fits 232,448 B (the worst case, d_in = d_out = 128
    and K = 3, at every width; the bytes grow with each size), and the
    largest tile is the last multiple of 16 that fits and takes one round
    of the block's products."""
    for kernel in wide_plan.KERNELS:
        for tier in TIERS:
            for W in range(1, 129):
                top = wide_plan.max_tile(kernel, W, 128, 128, 3, tier)
                assert top >= 16 and top % 16 == 0
                assert wide_plan.smem_bytes(kernel, W, 128, 128, 3, top, tier) <= 232_448
                assert (wide_plan.smem_bytes(kernel, W, 128, 128, 3, top + 16, tier) > 232_448
                        or not wide_plan.one_round(W, 128, 128, top + 16)
                        or top == wide_plan.MAX_TILE)
    assert wide_plan.max_tile("k1", 128, 2, 3, 2, "f32") == 32  # the flagship at W = 128


@settings(max_examples=200, deadline=None)
@given(kernel=st.sampled_from(wide_plan.KERNELS), tier=st.sampled_from(TIERS),
       width=st.integers(1, 128), d_in=st.integers(1, 128), d_out=st.integers(1, 128),
       k=st.integers(0, 3), n=st.integers(1, 300_000), sms=st.integers(1, 132),
       n_stack=st.integers(0, 120), ckpt=st.integers(0, 12))
def test_wide_plan_covers_the_points(kernel, tier, width, d_in, d_out, k, n, sms, n_stack, ckpt):
    k = min(k, d_in)
    p = wide_plan.wide_plan(kernel, n, width, d_in, d_out, n_stack, k, tier, sms, ckpt=ckpt)
    assert p.tile % 16 == 0 and 16 <= p.tile <= wide_plan.MAX_TILE
    assert p.tiles * p.tile >= n > (p.tiles - 1) * p.tile
    assert p.grid == min(p.tiles, sms) and p.smem <= wide_plan.SMEM_LIMIT
    assert p.rounds * p.grid >= p.tiles > (p.rounds - 1) * p.grid
    if kernel == "k4":
        c = p.ckpt_every
        assert 1 <= c <= max(1, n_stack) and (ckpt == 0 or c == min(ckpt, max(1, n_stack)))
        assert p.slots == -(-n_stack // c) + c
    else:
        assert p.slots == (0 if kernel == "k2" else n_stack + 1)
    assert p.state_numel() == p.grid * p.slots * (1 + k) * wide_plan.round16(width) * p.tile
    assert p.image == wide_plan.image_bytes(kernel, width, d_in, d_out, n_stack, tier)


def test_wide_wrappers_pass_what_the_plan_says(monkeypatch):
    """The wide launches reached on the CPU: a fake library records the C
    entry's arguments; they must be the plan's tile, grid, C, sizes and the
    buffers it sizes, the weight images' scratch among them."""
    seen, made = {}, []

    class FakeLib:
        def __getattr__(self, name):
            def entry(*args):
                seen[name] = args
                return 0
            return entry

    scratch = wide_plan.WidePlan.scratch

    def recorded(plan, n_ent, device):
        out = scratch(plan, n_ent, device)
        made.append((plan, out))
        return out

    monkeypatch.setattr(wide_plan.WidePlan, "scratch", recorded)
    monkeypatch.setattr(kernels, "wide_library", lambda k: FakeLib())
    monkeypatch.setattr(kernels_vjp, "wide_library", lambda k: FakeLib())
    monkeypatch.setattr(kernels_step, "wide_library", lambda k: FakeLib())
    props = types.SimpleNamespace(multi_processor_count=132, shared_memory_per_block_optin=232_448)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: props)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: __import__("contextlib").nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=7))
    wide_plan._card_plan.cache_clear()
    spec = MLPSpec(sizes=(2,) + (64,) * 5 + (3,))
    params = params_from_numpy(numpy_params(spec.sizes), "cpu")
    n = 12_516
    x = torch.zeros(n, 2)
    y, dy = torch.empty(n, 3), torch.empty(2, n, 3)
    kernels._launch_k2(params, x, spec, 2, "bf16", epilogue=False, y=y, dy=dy)
    plan = wide_plan.card_plan("k2", n, spec, 2, "bf16", x.device)
    args = seen["k2w_mlp_fwd_tangents_bf16"]
    assert args[11:] == (n, 2, 3, 4, 2, 0, 0, 64, plan.grid, plan.tile, 7)
    assert made[-1][0] == plan and args[7] == made[-1][1].data_ptr()
    assert made[-1][1].numel() == plan.image == wide_plan.image_bytes("k2", 64, 2, 3, 4, "bf16")
    ybar, dybar = torch.zeros(n, 3), torch.zeros(2, n, 3)
    kernels_vjp._launch_wide("k4", params, x, ybar, dybar, spec, 2, "f32", 3)
    plan = wide_plan.card_plan("k4", n, spec, 2, "f32", x.device, 3)
    args = seen["k4w_mlp_bwd"]
    assert args[13:] == (n, 2, 3, 4, 2, 0, 3, 64, plan.grid, plan.tile, 7)
    assert plan.ckpt_every == 3 and plan.slots == 2 + 3
    image, partial, states, _ = made[-1][1]
    assert args[9:12] == (image.data_ptr(), partial.data_ptr(), states.data_ptr())
    assert (image.numel(), states.numel()) == (plan.image, plan.state_numel())
    assert tuple(partial.shape) == (plan.grid, kernels_step.n_flat(spec))
    b = port_batch(*step_inputs(n, 2), 2, True)
    kernels_step._launch_k1_wide(params, b, spec, "f32x3")
    plan = wide_plan.card_plan("k1", n, spec, 2, "f32x3", x.device)
    assert seen["k1w_train_step_f32x3"][15:] == (n, 2, 4, 2, 1, 0, 64, plan.grid, plan.tile, 7)
    assert seen["k1w_train_step_f32x3"][11] == made[-1][1][0].data_ptr()
    assert made[-1][1][0].numel() == plan.image
    assert kernels_vjp.rebuild_ckpt_every(spec, 2, "f32", 0, n_points=n) == 4  # C cut to L
    wide_plan._card_plan.cache_clear()


def test_build_keeps_the_wide_body_lazy():
    """A narrow run never builds the wide libraries: they are a set of their
    own, one nvcc per kernel and tier, flagged into the right kernel."""
    assert set(cuda_build.NARROW) & set(cuda_build.WIDE) == set()
    variants = {n: cuda_build._SPECS[n][1]() for n in cuda_build.WIDE}
    assert all(len(v) == 3 for v in variants.values())
    assert variants["k3w"][(0, "f32")][0] == "-DWIDE_REBUILD=0"
    assert variants["k4w"][(0, "bf16")][0] == "-DWIDE_REBUILD=1"
    assert cuda_build._SPECS["k3w"][0] == cuda_build._SPECS["k4w"][0] == "mlp_bwd_wide.cu"


# ------------------------------------------- against the JAX Pallas kernels

@pytest.mark.parametrize("sizes", [
    (2, 17, 17, 17, 3), (2, 64, 64, 64, 3), (2, 128, 128, 3),
])
def test_loss_and_gradients_match_the_jax_kernels(sizes):
    """K1's function at widths 17, 64 and 128: the port (plain versions on
    the CPU, which the kernels are held to on the card) against the JAX
    package's one-kernel step through its Pallas kernel in interpret mode."""
    arrays = numpy_params(sizes)
    coords, trues, sel, mask, fidw = step_inputs(24, 2)
    (t1, (f1, r1)), g1 = jstep.fused_loss_and_grad(
        {k: jnp.asarray(v) for k, v in arrays.items()}, jnp.asarray(coords), jnp.asarray(trues),
        jnp.asarray(sel), jnp.asarray(mask), jnp.asarray(fidw), JSpec(sizes=sizes), 2, 0.7, 1.3,
        anchor_depth=0.6, has_anchor=True, interpret=True)
    (t2, (f2, r2)), g2 = kernels_step.fused_loss_and_grad(
        params_from_numpy(arrays, "cpu"), port_batch(coords, trues, sel, mask, fidw, 2, True),
        MLPSpec(sizes=sizes))
    for a, b in ((t1, t2), (f1, f2), (r1, r2)):
        assert float(b) == pytest.approx(float(a), rel=1e-5)
    for k in g1:
        x, y = np.asarray(g1[k]), g2[k].numpy()
        assert x.shape == y.shape
        scale = np.abs(x).max() + 1e-12
        np.testing.assert_allclose(y / scale, x / scale, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("sizes,kt", [
    ((2, 17, 17, 3), 2), ((2, 64, 64, 3), 2), ((2, 128, 128, 2), 2), ((3, 20, 20, 16), 3),
])
def test_forward_and_backward_match_the_jax_kernels(sizes, kt):
    """K2's outputs and tangents and K3's gradients at widths 17, 64, 128
    and at d_out = 16 against the JAX packed kernels in interpret mode."""
    arrays = numpy_params(sizes)
    rs = np.random.RandomState(9)
    x = rs.uniform(-1, 1, (24, sizes[0])).astype(np.float32)
    ybar = rs.randn(24, sizes[-1]).astype(np.float32)
    dybar = rs.randn(kt, 24, sizes[-1]).astype(np.float32)
    jp, js = {k: jnp.asarray(v) for k, v in arrays.items()}, JSpec(sizes=sizes)
    p, s = params_from_numpy(arrays, "cpu"), MLPSpec(sizes=sizes)
    jy, jdy = jk.packed_mlp_fwd_tangents(jp, jnp.asarray(x), js, kt, interpret=True)
    y, dy = kernels.mlp_fwd_tangents(p, torch.from_numpy(x), s, kt)
    for a, b in ((y, jy), (dy, jdy)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=1e-5, atol=1e-6 * np.abs(b).max())
    want = jvjp.packed_mlp_bwd(jp, jnp.asarray(x), jnp.asarray(ybar), jnp.asarray(dybar), js, kt,
                               interpret=True)
    got = kernels_vjp.packed_mlp_bwd(p, torch.from_numpy(x), torch.from_numpy(ybar),
                                     torch.from_numpy(dybar), s, kt)
    for k in PARAM_KEYS:
        w = np.asarray(want[k])
        scale = np.abs(w).max() + 1e-12
        np.testing.assert_allclose(got[k].numpy() / scale, w / scale, atol=2e-5, err_msg=k)


def test_jax_is_on_the_cpu():
    assert jax.devices()[0].platform == "cpu"
