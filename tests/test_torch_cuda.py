"""The port's CUDA kernels K2, K1, K3 and K4 on a card, at the f32, bf16 and
f32x3 tiers, against their plain PyTorch versions.

Every test here carries the ``cuda`` marker and skips without a CUDA device
(a CUDA kernel has no CPU mode). The file imports no JAX, so it runs on the
card's machine, which has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: max|kernel - plain| <= 1e-4 * max|plain| + 1e-7 per output —
f32 FMA chains in the kernel against f32 cuBLAS products in the plain
version, over up to 120 layers, agree to ~1e-5 of the output's scale
(``PERF.md``); the 1e-7 only covers outputs that are all near zero. K1's
loss terms and gradients are held to the same tolerance: on the card they
agree with the plain version to ~1e-6 of their scale (``PERF.md``), and so
are K3's gradients. The bf16 tier is held to its own error instead
(``assert_tier_close``): one f32 roundoff can flip a bf16 rounding, so f32's
1e-4 does not apply there, and in deep chains one flip moves a point as
far as the tier's roundings do (``PERF.md``). The f32x3 tier is held the
same way with a floor of 2e-6 of the output (``chip_smoke.X3_REL_FLOOR``):
its own error is ~1e-5 of the output, below f32's 1e-4.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
from pinn_depthestimation_tpu_torch.ops import kernels, kernels_step, kernels_vjp


def numpy_params(sizes, init_type="xavier", seed=0):
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


def assert_close_to_plain(got, want):
    assert got.shape == want.shape
    err = float((got - want).abs().max()) if got.numel() else 0.0
    tol = 1e-4 * (float(want.abs().max()) if want.numel() else 0.0) + 1e-7
    assert err <= tol, (err, tol)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the K2 CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,init_type", [
    ((2,) + (20,) * 100 + (3,), "xavier"),   # the flagship
    ((2,) + (10,) * 10 + (6,), "xavier"),    # the CMB net
    ((3,) + (16,) * 5 + (4,), "kaiming"),
    ((2, 8, 3), "kaiming"),                  # one hidden layer, no stack
    ((2,) + (32,) * 120 + (3,), "xavier"),   # deeper than one shared-memory chunk
])
def test_cuda_kernel_matches_plain_on_card(cuda_device, sizes, init_type):
    spec = MLPSpec(sizes=sizes, init_type=init_type)
    params = params_from_numpy(numpy_params(sizes, init_type, seed=5), cuda_device)
    x = torch.from_numpy(
        np.random.RandomState(6).uniform(-1, 1, (1_003, sizes[0])).astype(np.float32)
    ).to(cuda_device)
    for k in range(0, min(3, sizes[0]) + 1):
        before = kernels.mlp_fwd_tangents.launches
        y, dy = kernels.mlp_fwd_tangents(params, x, spec, k)
        assert kernels.mlp_fwd_tangents.launches == before + 1
        y_p, dy_p = kernels.mlp_fwd_tangents_plain(params, x, spec, k)
        assert_close_to_plain(y, y_p)
        assert_close_to_plain(dy, dy_p)
    if spec.d_out == 3:
        before = kernels.fused_residual_continuity.launches
        fc = kernels.fused_residual_continuity(params, x, spec)
        assert kernels.fused_residual_continuity.launches == before + 1
        assert_close_to_plain(fc, kernels.residual_continuity_plain(params, x, spec))


@pytest.mark.cuda
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    spec = MLPSpec(sizes=(2, 130, 130, 3))  # beyond the Pallas kernels' 128 lanes
    params = params_from_numpy(numpy_params(spec.sizes), cuda_device)
    x = torch.zeros(8, 2, device=cuda_device)
    with pytest.raises(ValueError, match="width"):
        kernels.mlp_fwd_tangents(params, x, spec, 0)
    spec = MLPSpec(sizes=(2, 20, 3))
    params = params_from_numpy(numpy_params(spec.sizes), "cpu")  # weights on the host
    with pytest.raises(ValueError, match="cpu"):
        kernels.mlp_fwd_tangents(params, x, spec, 0)
    empty = kernels.mlp_fwd_tangents(
        params_from_numpy(numpy_params(spec.sizes), cuda_device),
        torch.zeros(0, 2, device=cuda_device), spec, 2,
    )
    assert empty[0].shape == (0, 3) and empty[1].shape == (2, 0, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,init_type,n_true,has_anchor", [
    ((2,) + (20,) * 100 + (3,), "xavier", 2, True),    # the flagship
    ((2,) + (10,) * 10 + (3,), "xavier", 3, False),    # anchorless, three heads
    ((2,) + (16,) * 5 + (3,), "kaiming", 2, True),     # leaky-relu
    ((2, 8, 3), "xavier", 1, True),                    # one hidden layer, no stack
    ((2,) + (32,) * 120 + (3,), "xavier", 2, True),    # deeper than one smem chunk
])
def test_cuda_train_step_matches_plain_on_card(cuda_device, sizes, init_type, n_true, has_anchor):
    spec = MLPSpec(sizes=sizes, init_type=init_type)
    params = params_from_numpy(numpy_params(sizes, init_type, seed=3), cuda_device)
    rs = np.random.RandomState(4)
    n = 1_003
    x = torch.from_numpy(rs.uniform(-1, 1, (n, 2)).astype(np.float32)).to(cuda_device)
    trues = torch.from_numpy((rs.randn(n, n_true) * 0.1).astype(np.float32)).to(cuda_device)
    mask = torch.from_numpy((rs.rand(n) > 0.1).astype(np.float32)).to(cuda_device)
    b = kernels_step.make_step_batch(x, trues, (x[:, 0] < 0.3).float() * mask, mask,
                                     [1.0, 2.0, 0.5][:n_true], n_true, 0.7, 1.3,
                                     anchor_depth=0.6, has_anchor=has_anchor)
    before = kernels_step.fused_loss_and_grad.launches
    (t, (f, r)), g = kernels_step.fused_loss_and_grad(params, b, spec)
    assert kernels_step.fused_loss_and_grad.launches == before + 1
    (t_p, (f_p, r_p)), g_p = kernels_step.fused_loss_and_grad_plain(params, b, spec)
    for got, want in [(t, t_p), (f, f_p), (r, r_p)] + [(g[k], g_p[k]) for k in g]:
        assert_close_to_plain(got, want)
    (t2, _), g2 = kernels_step.fused_loss_and_grad(params, b, spec)
    assert torch.equal(t, t2) and all(torch.equal(g[k], g2[k]) for k in g)  # deterministic


def ragged_n(which: str, lib, kernel: str, precision: str) -> int:
    """A point count around the walk's tiles (ops/walk_plan.py): one point,
    one either side of the smallest tile, the flagship's 12,516, and one
    either side of a full wave of the width's largest tiles (the last block
    then walks a second tile of one point, or the last tile is one short)."""
    from pinn_depthestimation_tpu_torch.ops.kernels import entry
    from pinn_depthestimation_tpu_torch.ops.walk_plan import TILE_STEP

    wave = (torch.cuda.get_device_properties(0).multi_processor_count
            * entry(lib, f"{kernel}_max_tile", precision)())
    return {"1": 1, "tile-1": TILE_STEP - 1, "tile+1": TILE_STEP + 1, "12516": 12_516,
            "wave-1": wave - 1, "wave+1": wave + 1}[which]


RAGGED = ("1", "tile-1", "tile+1", "12516", "wave-1", "wave+1")


@pytest.mark.cuda
@pytest.mark.parametrize("width", [20, 10])
@pytest.mark.parametrize("which", RAGGED)
def test_cuda_train_step_ragged_tiles(cuda_device, width, which):
    """K1 against its plain version at point counts around the tiles, at
    the flagship's width and at width 10 (five neurons per lane)."""
    sizes = (2,) + (width,) * 6 + (3,)
    spec = MLPSpec(sizes=sizes)
    params = params_from_numpy(numpy_params(sizes, seed=13), cuda_device)
    n = ragged_n(which, kernels_step.k1_library().libs[width], "k1", "f32")
    rs = np.random.RandomState(14)
    x = torch.from_numpy(rs.uniform(-1, 1, (n, 2)).astype(np.float32)).to(cuda_device)
    x[0, 0] = -0.5  # at least one anchored point
    trues = torch.from_numpy((rs.randn(n, 2) * 0.1).astype(np.float32)).to(cuda_device)
    mask = torch.ones(n, device=cuda_device)
    b = kernels_step.make_step_batch(x, trues, (x[:, 0] < 0.3).float(), mask, [1.0, 1.0], 2,
                                     1.0, 1.0, anchor_depth=0.6, has_anchor=True)
    (t, (f, r)), g = kernels_step.fused_loss_and_grad(params, b, spec)
    (t_p, (f_p, r_p)), g_p = kernels_step.fused_loss_and_grad_plain(params, b, spec)
    for got, want in [(t, t_p), (f, f_p), (r, r_p)] + [(g[k], g_p[k]) for k in g]:
        assert_close_to_plain(got, want)
    (t2, _), g2 = kernels_step.fused_loss_and_grad(params, b, spec)
    assert torch.equal(t, t2) and all(torch.equal(g[k], g2[k]) for k in g)  # deterministic


@pytest.mark.cuda
@pytest.mark.parametrize("which", RAGGED)
def test_cuda_k3_ragged_tiles(cuda_device, which):
    """K3 on the CMB net at K=2 at point counts around the tiles."""
    sizes = (2,) + (10,) * 10 + (6,)
    spec = MLPSpec(sizes=sizes)
    params = params_from_numpy(numpy_params(sizes, seed=15), cuda_device)
    n = ragged_n(which, kernels_vjp.k3_library().libs[10], "k3", "f32")
    rs = np.random.RandomState(16)
    x = torch.from_numpy(rs.uniform(-1, 1, (n, 2)).astype(np.float32)).to(cuda_device)
    ybar = torch.from_numpy(rs.randn(n, 6).astype(np.float32)).to(cuda_device)
    dybar = torch.from_numpy(rs.randn(2, n, 6).astype(np.float32)).to(cuda_device)
    g = kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, spec, 2)
    g_p = kernels_vjp.packed_mlp_bwd_plain(params, x, ybar, dybar, spec, 2)
    for k in g:
        assert_close_to_plain(g[k], g_p[k])
    g2 = kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, spec, 2)
    assert all(torch.equal(g[k], g2[k]) for k in g)  # deterministic


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k1", "k3", "k4"])
def test_cuda_libraries_report_the_walk_layout(cuda_device, kernel):
    """Every width's library answers, at each tier, the lane count and the
    largest tile that the CPU tests of the launch plan
    (tests/test_torch_walk_plan.py) take for ``mlp_bwd::kLanes`` and
    ``mlp_bwd::max_tile``: 160 points for widths <= 10 at f32 and bf16,
    else 128."""
    from pinn_depthestimation_tpu_torch.ops.cuda_build import TIERS
    from pinn_depthestimation_tpu_torch.ops.kernels import entry

    library = {"k1": kernels_step.k1_library, "k3": kernels_vjp.k3_library,
               "k4": kernels_vjp.k4_library}[kernel]()
    for width, lib in library.libs.items():
        assert getattr(lib, f"{kernel}_lanes")() == 2
        for precision in TIERS:
            want = 160 if width <= 10 and precision != "f32x3" else 128
            assert entry(lib, f"{kernel}_max_tile", precision)() == want, (width, precision)
    # the bf16 and f32x3 tiers' tensor-core walk answers the plan of
    # ops/walk_mma_plan.py (its chunk, regions, bytes and K4's segment length)
    from pinn_depthestimation_tpu_torch.ops import walk_mma_plan as mp

    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    kts = (2,) if kernel == "k1" else (0, 2, 3)
    for width, lib in library.libs.items():
        for precision, kt, n_stack, tile in itertools.product(
                mp.TIERS, kts, (0, 9, 19, 99), (16, 96, 128)):
            want = mp.plan(kernel, width, n_stack, kt, precision, tile, limit=optin)
            args = (n_stack, tile) if kernel == "k1" else (n_stack, kt, tile)
            if kernel == "k4":
                assert entry(lib, "k4_ckpt_every", precision)(*args[:2], 0, tile) == (
                    want.ckpt if want else 0)
                args = (n_stack, kt, want.ckpt if want else 0, tile)
            got = (entry(lib, f"{kernel}_chunk_layers", precision)(*args),
                   entry(lib, f"{kernel}_mma_regions", precision)(*args),
                   entry(lib, f"{kernel}_mma_smem", precision)(*args))
            assert got == ((want.chunk, want.regions, want.smem) if want else (0, 0, 0)), (
                width, precision, kt, n_stack, tile, want)


@pytest.mark.cuda
def test_cuda_training_launches_k1_once_per_evaluation(cuda_device, tmp_path):
    from pinn_depthestimation_tpu_torch.config import parse_config
    from pinn_depthestimation_tpu_torch.training.driver import Trainer
    from pinn_depthestimation_tpu_torch.training.logging_utils import read_log
    from pinn_depthestimation_tpu_torch.utils import synthetic

    mat = str(tmp_path / "d.mat")
    synthetic.make_newmethod_mat(mat, nx=16, ny=20, nan_fraction=0.05, seed=2)
    raw = {
        "layers": {"input_features": 2, "hidden_layers": 4, "hidden_width": 20,
                   "output_features": 3, "dropout_rate": 0.0, "init_type": "xavier"},
        "adam_optimizer": {"max_it": 30, "learning_rate": 1e-3,
                           "scheduler_step_size": 10, "scheduler_gamma": 0.8},
        "lbfgs_optimizer": {"max_it": 5, "learning_rate": 1, "max_evaluation": 8,
                            "history_size": 10, "tolerance_grad": 1e-12,
                            "tolerance_change": 1e-14, "line_search_fn": "strong_wolfe"},
        "loss": {"weight_fid_loss": 1, "weight_res_loss": 1},
        "data": {"file": mat, "inputs": {"x": {"requires_grad": ["true"]},
                                         "y": {"requires_grad": ["true"]}},
                 "trues": ["U", "V"], "unknowns": ["h"]},
        "snapshot_iteration": 30,
    }
    run = str(tmp_path / "run")
    import os

    os.makedirs(run)
    trainer = Trainer(parse_config(raw), run_dir=run, echo_every=0, device=cuda_device)
    assert trainer.fused_step_fn is not None
    before = kernels_step.fused_loss_and_grad.launches
    trainer.train()
    epochs, _, _, totals = read_log(run)
    assert kernels_step.fused_loss_and_grad.launches - before == len(epochs) > 30
    assert np.isfinite(totals).all() and totals[29] < totals[0]


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,init_type,kt,n", [
    ((2,) + (10,) * 10 + (6,), "xavier", 2, 20_513),   # the CMB residual term
    ((2,) + (10,) * 10 + (6,), "xavier", 0, 200),      # the CMB fidelity term
    ((2,) + (20,) * 100 + (3,), "xavier", 2, 1_003),   # the flagship
    ((3,) + (16,) * 5 + (4,), "kaiming", 3, 777),      # leaky-relu, three tangents
    ((2, 8, 1), "kaiming", 1, 129),                    # one hidden layer, no stack
    ((3,) + (32,) * 60 + (5,), "xavier", 3, 300),      # deeper than one smem chunk
])
def test_cuda_k3_matches_plain_on_card(cuda_device, sizes, init_type, kt, n):
    spec = MLPSpec(sizes=sizes, init_type=init_type)
    params = params_from_numpy(numpy_params(sizes, init_type, seed=8), cuda_device)
    rs = np.random.RandomState(9)
    x = torch.from_numpy(rs.uniform(-1, 1, (n, sizes[0])).astype(np.float32)).to(cuda_device)
    ybar = torch.from_numpy(rs.randn(n, sizes[-1]).astype(np.float32)).to(cuda_device)
    dybar = torch.from_numpy(rs.randn(kt, n, sizes[-1]).astype(np.float32)).to(cuda_device)
    before = kernels_vjp.packed_mlp_bwd.launches
    g = kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, spec, kt)
    assert kernels_vjp.packed_mlp_bwd.launches == before + 1
    g_p = kernels_vjp.packed_mlp_bwd_plain(params, x, ybar, dybar, spec, kt)
    for k in g:
        assert_close_to_plain(g[k], g_p[k])
    g2 = kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, spec, kt)
    assert all(torch.equal(g[k], g2[k]) for k in g)  # deterministic


@pytest.mark.cuda
def test_cuda_cmb_training_runs_on_k2_and_k3(cuda_device, tmp_path):
    """A CMB Trainer on the card: every loss evaluation launches K2 and K3
    twice (residual at K=2, fidelity at K=0), and iteration 1 equals the
    plain path's from the same weights."""
    import os

    from pinn_depthestimation_tpu_torch.config import parse_config
    from pinn_depthestimation_tpu_torch.parity import make_cmb_config
    from pinn_depthestimation_tpu_torch.training.driver import Trainer
    from pinn_depthestimation_tpu_torch.training.logging_utils import read_log
    from pinn_depthestimation_tpu_torch.utils import synthetic

    csv, mat = str(tmp_path / "f.csv"), str(tmp_path / "r.mat")
    synthetic.make_cmb_dataset(csv, mat, nx=41, ny=61, n_csv=120, seed=6, nan_fraction=0.03)
    raw = make_cmb_config(csv, mat, 20, 4, tol_grad=1e-12, tol_change=1e-14, nx=41, ny=61,
                          interval=1, training_points=100)
    init = numpy_params((2,) + (10,) * 10 + (6,), "xavier", seed=1)
    init["b_out"][3] += 1.0  # eta + h away from 0
    logs = {}
    for mode in ("auto", "off"):
        run = str(tmp_path / mode)
        os.makedirs(run)
        trainer = Trainer(parse_config(dict(raw, fused_kernel=mode)), run_dir=run,
                          echo_every=0, initial_params=init, device=cuda_device)
        assert trainer.kernel_plan.fused == (mode == "auto")
        k2, k3 = kernels.mlp_fwd_tangents.launches, kernels_vjp.packed_mlp_bwd.launches
        trainer.train_adam()
        trainer.train_lbfgs()
        epochs, fid, res, totals = read_log(run)
        n = len(epochs)
        if mode == "auto":
            assert kernels_vjp.packed_mlp_bwd.launches - k3 == 2 * n
            assert kernels.mlp_fwd_tangents.launches - k2 == 2 * n
        assert n > 20 and np.isfinite(totals).all()
        logs[mode] = np.array([fid, res, totals])
    np.testing.assert_allclose(logs["auto"][:, 0], logs["off"][:, 0], rtol=1e-5)


# ----------------------------------------------------------- the bf16 tier

def assert_tier_close(got, want_tier, want_f32, want_tier64, rel_floor=1e-4, distinct=0.0):
    """A bf16 kernel output against its plain versions at the tier (f32
    sums), at f32 and at the tier with float64 sums, as
    ``chip_smoke.py::compare_tier`` holds it: the L2 gap to plain bf16
    within max(a quarter of the tier's own error, 4 x the spread between
    the two summation orders) plus the f32 tolerance, and at least half the
    tier's error away from plain f32 where that error exceeds the floor (a
    kernel that forgot to round fails). With ``distinct`` that check, and
    the return value, also need the tier's error above ``distinct`` x the
    spread (at f32x3 the spread can reach the tier's error on deep stacks,
    ``chip_smoke.compare_tier``). Returns whether the tier showed."""
    l2 = lambda d: float(d.double().norm())  # noqa: E731
    tier = l2(want_tier - want_f32)
    spread = l2(want_tier.double() - want_tier64)
    floor = rel_floor * l2(want_tier) + 1e-7
    err = l2(got - want_tier)
    assert err <= max(0.25 * tier, 4 * spread) + floor, (err, tier, spread, floor)
    real = tier > floor and tier > distinct * spread
    if real:
        assert l2(got - want_f32) >= 0.5 * tier
    return real


def f64(params):
    return {k: v.double() for k, v in params.items()}


K2_TIER_CASES = [
    ((2,) + (20,) * 100 + (3,), "xavier", 2, 1_003),   # the flagship
    ((2,) + (10,) * 10 + (6,), "xavier", 0, 200),      # the CMB fidelity rows
    ((3,) + (16,) * 5 + (4,), "kaiming", 3, 777),      # leaky-relu, three tangents
    ((2,) + (32,) * 120 + (3,), "xavier", 2, 300),     # deeper than one smem chunk
    ((3,) + (8,) * 4 + (4,), "xavier", 3, 257),        # one m16n8k8 per product
    ((3,) + (20,) * 8 + (3,), "kaiming", 3, 401),      # three tangents at the flagship's width
]


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,init_type,kt,n", K2_TIER_CASES)
def test_cuda_k2_bf16_matches_plain_tier(cuda_device, sizes, init_type, kt, n):
    spec = MLPSpec(sizes=sizes, init_type=init_type)
    params = params_from_numpy(numpy_params(sizes, init_type, seed=3), cuda_device)
    x = torch.from_numpy(np.random.RandomState(4).uniform(-1, 1, (n, sizes[0]))
                         .astype(np.float32)).to(cuda_device)
    before = kernels.mlp_fwd_tangents.launches_by_tier["bf16"]
    y, dy = kernels.mlp_fwd_tangents(params, x, spec, kt, precision="bf16")
    assert kernels.mlp_fwd_tangents.launches_by_tier["bf16"] == before + 1
    yb, dyb = kernels.mlp_fwd_tangents_plain(params, x, spec, kt, "bf16")
    yf, dyf = kernels.mlp_fwd_tangents_plain(params, x, spec, kt, "f32")
    y6, dy6 = kernels.mlp_fwd_tangents_plain(f64(params), x.double(), spec, kt, "bf16")
    real = assert_tier_close(y, yb, yf, y6)
    if kt:
        real |= assert_tier_close(dy, dyb, dyf, dy6)
    assert real
    y2, dy2 = kernels.mlp_fwd_tangents(params, x, spec, kt, precision="bf16")
    assert torch.equal(y, y2) and torch.equal(dy, dy2)


@pytest.mark.cuda
@pytest.mark.parametrize("impl,precision", [("stream", "bf16"), ("rebuild", "f32"),
                                            ("rebuild", "bf16")])
@pytest.mark.parametrize("sizes,init_type,kt,n", [
    ((2,) + (20,) * 100 + (3,), "xavier", 2, 1_003),   # the flagship
    ((2,) + (10,) * 10 + (6,), "xavier", 0, 200),      # the CMB fidelity rows
    ((3,) + (16,) * 5 + (4,), "kaiming", 3, 777),      # leaky-relu, three tangents
    ((2,) + (20,) * 11 + (3,), "xavier", 1, 129),      # a short last K4 segment
    ((2,) + (32,) * 60 + (5,), "xavier", 2, 300),      # deeper than one smem chunk
])
def test_cuda_k3_bf16_and_k4_match_plain_tier(cuda_device, impl, precision, sizes, init_type,
                                              kt, n):
    spec = MLPSpec(sizes=sizes, init_type=init_type)
    params = params_from_numpy(numpy_params(sizes, init_type, seed=8), cuda_device)
    rs = np.random.RandomState(9)
    x = torch.from_numpy(rs.uniform(-1, 1, (n, sizes[0])).astype(np.float32)).to(cuda_device)
    ybar = torch.from_numpy(rs.randn(n, sizes[-1]).astype(np.float32)).to(cuda_device)
    dybar = torch.from_numpy(rs.randn(kt, n, sizes[-1]).astype(np.float32)).to(cuda_device)
    wrapper = kernels_vjp.packed_mlp_bwd_rebuild if impl == "rebuild" else kernels_vjp.packed_mlp_bwd
    other = kernels_vjp.packed_mlp_bwd if impl == "rebuild" else kernels_vjp.packed_mlp_bwd_rebuild
    before, before_other = wrapper.launches_by_tier[precision], other.launches
    g = kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, spec, kt, precision=precision,
                                   impl=impl)
    assert wrapper.launches_by_tier[precision] == before + 1 and other.launches == before_other
    g_t = kernels_vjp.packed_mlp_bwd_plain(params, x, ybar, dybar, spec, kt, precision)
    if precision == "f32":
        for k in g:
            assert_close_to_plain(g[k], g_t[k])
    else:
        g_f = kernels_vjp.packed_mlp_bwd_plain(params, x, ybar, dybar, spec, kt, "f32")
        g_6 = kernels_vjp.packed_mlp_bwd_plain(f64(params), x.double(), ybar.double(),
                                               dybar.double(), spec, kt, "bf16")
        assert any([assert_tier_close(g[k], g_t[k], g_f[k], g_6[k]) for k in g])
    g2 = kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, spec, kt, precision=precision,
                                    impl=impl)
    assert all(torch.equal(g[k], g2[k]) for k in g)  # deterministic


@pytest.mark.cuda
def test_cuda_k4_segment_lengths_agree(cuda_device):
    """K4 at every segment length that fits, against K3 at the same tier:
    one function, replayed from other checkpoints (at bf16 and f32x3 on the
    tensor-core walk, where the replay repeats the forward's operations)."""
    sizes = (2,) + (20,) * 23 + (3,)
    spec = MLPSpec(sizes=sizes)
    params = params_from_numpy(numpy_params(sizes, seed=5), cuda_device)
    rs = np.random.RandomState(2)
    x = torch.from_numpy(rs.uniform(-1, 1, (517, 2)).astype(np.float32)).to(cuda_device)
    ybar = torch.from_numpy(rs.randn(517, 3).astype(np.float32)).to(cuda_device)
    dybar = torch.from_numpy(rs.randn(2, 517, 3).astype(np.float32)).to(cuda_device)
    for precision in ("f32", "bf16", "f32x3"):
        g3 = kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, spec, 2, precision=precision,
                                        impl="stream")
        for c in (1, 2, 3, 5):
            g4 = kernels_vjp.packed_mlp_bwd_rebuild(params, x, ybar, dybar, spec, 2,
                                                    precision=precision, ckpt_every=c)
            for k in g3:
                assert_close_to_plain(g4[k], g3[k])
        # at 20,000 points (tiles of 128) a segment buffer of 8 states
        # (245,760 B) does not fit beside the staging rows; the planned C
        # does, and at 517 points (tiles of 16) up to 8 fit
        with pytest.raises(ValueError, match="does not fit"):
            kernels_vjp.rebuild_ckpt_every(spec, 2, precision, 8, n_points=20_000)
        assert 1 <= kernels_vjp.rebuild_ckpt_every(spec, 2, precision, n_points=20_000) <= 5
        assert 1 <= kernels_vjp.rebuild_ckpt_every(spec, 2, precision, n_points=517) <= 8


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,n_true,has_anchor", [
    ((2,) + (20,) * 100 + (3,), 2, True),   # the flagship
    ((2,) + (16,) * 6 + (3,), 3, False),
])
def test_cuda_k1_bf16_matches_plain_tier(cuda_device, sizes, n_true, has_anchor):
    spec = MLPSpec(sizes=sizes)
    params = params_from_numpy(numpy_params(sizes, seed=6), cuda_device)
    rs = np.random.RandomState(5)
    n = 2_001
    x = torch.from_numpy(rs.uniform(-1, 1, (n, 2)).astype(np.float32)).to(cuda_device)
    trues = torch.from_numpy((rs.randn(n, n_true) * 0.1).astype(np.float32)).to(cuda_device)
    mask = torch.from_numpy((rs.rand(n) > 0.1).astype(np.float32)).to(cuda_device)
    b = kernels_step.make_step_batch(x, trues, (x[:, 0] < 0.3).float() * mask, mask,
                                     [1.0, 0.7, 1.3][:n_true], n_true, 0.7, 1.3,
                                     has_anchor=has_anchor)
    before = kernels_step.fused_loss_and_grad.launches_by_tier["bf16"]
    (t, (f, r)), g = kernels_step.fused_loss_and_grad(params, b, spec, precision="bf16")
    assert kernels_step.fused_loss_and_grad.launches_by_tier["bf16"] == before + 1
    (tb, (fb, rb)), gb = kernels_step.fused_loss_and_grad_plain(params, b, spec, "bf16")
    (tf, (ff, rf)), gf = kernels_step.fused_loss_and_grad_plain(params, b, spec, "f32")
    b64 = dataclasses.replace(b, **{k: getattr(b, k).double() for k in (
        "coords", "trues", "sel", "mask", "fid_weights", "n_res", "n_sel", "scal")})
    (t6, (f6, r6)), g6 = kernels_step.fused_loss_and_grad_plain(f64(params), b64, spec, "bf16")
    real = [assert_tier_close(got, wb, wf, w6) for got, wb, wf, w6 in
            ((t, tb, tf, t6), (f, fb, ff, f6), (r, rb, rf, r6))]
    real += [assert_tier_close(g[k], gb[k], gf[k], g6[k]) for k in g]
    assert any(real)


@pytest.mark.cuda
def test_cuda_bf16_cmb_training_runs_on_k2_and_k4(cuda_device, tmp_path):
    """A CMB Trainer at kernel_precision bf16 on the card: every loss
    evaluation launches K2-bf16 and K4-bf16 twice, and K3 never."""
    import os

    from pinn_depthestimation_tpu_torch.config import parse_config
    from pinn_depthestimation_tpu_torch.parity import make_cmb_config
    from pinn_depthestimation_tpu_torch.training.driver import Trainer
    from pinn_depthestimation_tpu_torch.training.logging_utils import read_log
    from pinn_depthestimation_tpu_torch.utils import synthetic

    csv, mat = str(tmp_path / "f.csv"), str(tmp_path / "r.mat")
    synthetic.make_cmb_dataset(csv, mat, nx=41, ny=61, n_csv=120, seed=6, nan_fraction=0.03)
    raw = make_cmb_config(csv, mat, 20, 4, tol_grad=1e-12, tol_change=1e-14, nx=41, ny=61,
                          interval=1, training_points=100)
    init = numpy_params((2,) + (10,) * 10 + (6,), "xavier", seed=1)
    init["b_out"][3] += 1.0
    run = str(tmp_path / "bf16")
    os.makedirs(run)
    trainer = Trainer(parse_config(dict(raw, kernel_precision="bf16")), run_dir=run,
                      echo_every=0, initial_params=init, device=cuda_device)
    k2 = dict(kernels.mlp_fwd_tangents.launches_by_tier)
    k4 = dict(kernels_vjp.packed_mlp_bwd_rebuild.launches_by_tier)
    k3 = kernels_vjp.packed_mlp_bwd.launches
    trainer.train_adam()
    trainer.train_lbfgs()
    epochs, _, _, totals = read_log(run)
    n = len(epochs)
    assert n > 20 and np.isfinite(totals).all()
    assert kernels_vjp.packed_mlp_bwd_rebuild.launches_by_tier["bf16"] - k4["bf16"] == 2 * n
    assert kernels.mlp_fwd_tangents.launches_by_tier["bf16"] - k2["bf16"] == 2 * n
    assert kernels_vjp.packed_mlp_bwd.launches == k3


# ------------------------------------- the walk's tensor-core body (both tiers)

WALK_RAGGED = ("1", "15", "17", "wave+1")


def walk_ragged_n(which: str, lib, kernel: str, precision: str) -> int:
    """One point, one either side of a warp's 16, and a count past one wave
    of the width's largest tiles (a block then walks a second tile)."""
    from pinn_depthestimation_tpu_torch.ops.kernels import entry

    wave = (torch.cuda.get_device_properties(0).multi_processor_count
            * entry(lib, f"{kernel}_max_tile", precision)())
    return {"1": 1, "15": 15, "17": 17, "wave+1": wave + 1}[which]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k1", "k3", "k4"])
@pytest.mark.parametrize("precision", ["bf16", "f32x3"])
@pytest.mark.parametrize("width", [8, 10, 16, 20, 32])
@pytest.mark.parametrize("which", WALK_RAGGED)
def test_cuda_walk_cheap_tiers_ragged_tiles(cuda_device, kernel, precision, width, which):
    """K1, K3 and K4 at bf16 and f32x3 (csrc/mlp_bwd_mma.cuh) at every
    compiled width and at point counts around the warp's 16 points and the
    tiles, against the plain tier versions (``assert_tier_close``); two
    launches give the same bits."""
    tol = X3 if precision == "f32x3" else {}
    if kernel == "k1":
        sizes = (2,) + (width,) * 5 + (3,)
        spec = MLPSpec(sizes=sizes)
        params = params_from_numpy(numpy_params(sizes, seed=21), cuda_device)
        n = walk_ragged_n(which, kernels_step.k1_library().libs[width], "k1", precision)
        rs = np.random.RandomState(22)
        x = torch.from_numpy(rs.uniform(-1, 1, (n, 2)).astype(np.float32)).to(cuda_device)
        x[0, 0] = -0.5  # at least one anchored point
        trues = torch.from_numpy((rs.randn(n, 2) * 0.1).astype(np.float32)).to(cuda_device)
        mask = torch.ones(n, device=cuda_device)
        b = kernels_step.make_step_batch(x, trues, (x[:, 0] < 0.3).float(), mask, [1.0, 0.7],
                                         2, 0.7, 1.3, anchor_depth=0.6, has_anchor=True)
        b64 = dataclasses.replace(b, **{k: getattr(b, k).double() for k in (
            "coords", "trues", "sel", "mask", "fid_weights", "n_res", "n_sel", "scal")})
        run = lambda: kernels_step.fused_loss_and_grad(params, b, spec, precision=precision)  # noqa: E731
        (t, _), g = run()
        outs = dict(g, total=t)
        refs = {}
        for key, p, bb, tier in (("tier", params, b, precision), ("f32", params, b, "f32"),
                                 ("f64", f64(params), b64, precision)):
            (tt, _), gg = kernels_step.fused_loss_and_grad_plain(p, bb, spec, tier)
            refs[key] = dict(gg, total=tt)
        (t2, _), g2 = run()
        again = dict(g2, total=t2)
    else:
        sizes = (3,) + (width,) * 5 + (5,)
        kt = 3 if kernel == "k4" else 2
        spec = MLPSpec(sizes=sizes)
        params = params_from_numpy(numpy_params(sizes, seed=23), cuda_device)
        lib = (kernels_vjp.k3_library if kernel == "k3" else kernels_vjp.k4_library)()
        n = walk_ragged_n(which, lib.libs[width], kernel, precision)
        rs = np.random.RandomState(24)
        x = torch.from_numpy(rs.uniform(-1, 1, (n, 3)).astype(np.float32)).to(cuda_device)
        ybar = torch.from_numpy(rs.randn(n, 5).astype(np.float32)).to(cuda_device)
        dybar = torch.from_numpy(rs.randn(kt, n, 5).astype(np.float32)).to(cuda_device)
        impl = "stream" if kernel == "k3" else "rebuild"
        run = lambda: kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, spec, kt,  # noqa: E731
                                                 precision=precision, impl=impl)
        outs = run()
        refs = {key: kernels_vjp.packed_mlp_bwd_plain(p, xx, yb, db, spec, kt, tier)
                for key, p, xx, yb, db, tier in (
                    ("tier", params, x, ybar, dybar, precision),
                    ("f32", params, x, ybar, dybar, "f32"),
                    ("f64", f64(params), x.double(), ybar.double(), dybar.double(), precision))}
        again = run()
    for k in outs:
        assert_tier_close(outs[k], refs["tier"][k], refs["f32"][k], refs["f64"][k], **tol)
        assert torch.equal(outs[k], again[k]), k  # deterministic


# ---------------------------------------------------------- the f32x3 tier

X3 = dict(rel_floor=2e-6, distinct=2.0)  # chip_smoke.X3_REL_FLOOR, X3_DISTINCT


def shows_tier(sizes) -> bool:
    """Whether the f32x3 tier's error stands clear of the spread on this
    net: on the 60- to 120-layer stacks it need not (PERF.md)."""
    return len(sizes) < 30


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,init_type,kt,n", K2_TIER_CASES)
def test_cuda_k2_f32x3_matches_plain_tier(cuda_device, sizes, init_type, kt, n):
    spec = MLPSpec(sizes=sizes, init_type=init_type)
    params = params_from_numpy(numpy_params(sizes, init_type, seed=3), cuda_device)
    x = torch.from_numpy(np.random.RandomState(4).uniform(-1, 1, (n, sizes[0]))
                         .astype(np.float32)).to(cuda_device)
    before = kernels.mlp_fwd_tangents.launches_by_tier["f32x3"]
    y, dy = kernels.mlp_fwd_tangents(params, x, spec, kt, precision="f32x3")
    assert kernels.mlp_fwd_tangents.launches_by_tier["f32x3"] == before + 1
    yx, dyx = kernels.mlp_fwd_tangents_plain(params, x, spec, kt, "f32x3")
    yf, dyf = kernels.mlp_fwd_tangents_plain(params, x, spec, kt, "f32")
    y6, dy6 = kernels.mlp_fwd_tangents_plain(f64(params), x.double(), spec, kt, "f32x3")
    real = assert_tier_close(y, yx, yf, y6, **X3)
    if kt:
        real |= assert_tier_close(dy, dyx, dyf, dy6, **X3)
    assert real or not shows_tier(sizes)
    if spec.d_out == 3 and init_type == "xavier":
        fc = kernels.fused_residual_continuity(params, x, spec, precision="f32x3")
        assert_tier_close(fc, kernels.residual_continuity_plain(params, x, spec, "f32x3"),
                          kernels.residual_continuity_plain(params, x, spec, "f32"),
                          kernels.residual_continuity_plain(f64(params), x.double(), spec,
                                                            "f32x3"), **X3)
    y2, dy2 = kernels.mlp_fwd_tangents(params, x, spec, kt, precision="f32x3")
    assert torch.equal(y, y2) and torch.equal(dy, dy2)


# ------------------------------------------------ K2's f32 body and its plan

K2_F32_RAGGED = (1, 17, 255, 257, 21_141, 26_691, 10_000_000)


def k2_f32_outputs(params, x, spec, kt, lanes, epilogue=False):
    """One K2-f32 launch on its plan with ``lanes`` forced through it (None:
    the plan's own), through the port's launcher."""
    n = x.shape[0]
    if epilogue:
        fc = torch.empty(n, device=x.device)
        kernels._launch_k2_narrow(params, x, spec, 2, "f32", epilogue=True, fc=fc, lanes=lanes)
        return {"fc": fc}
    y = torch.empty((n, spec.d_out), device=x.device)
    dy = torch.empty((kt, n, spec.d_out), device=x.device)
    kernels._launch_k2_narrow(params, x, spec, kt, "f32", epilogue=False, y=y,
                              dy=dy if kt else None, lanes=lanes)
    return {"y": y, "dy": dy}


@pytest.mark.cuda
@pytest.mark.parametrize("init_type", ["xavier", "kaiming"])
@pytest.mark.parametrize("lanes", [1, 2])
@pytest.mark.parametrize("width", [8, 10, 16, 20, 32])
def test_cuda_k2_f32_every_width_and_lane_count(cuda_device, width, lanes, init_type):
    """K2-f32 at each compiled width, each lane count forced through the
    plan, K = 0..3 and the epilogue, both activations, against its plain
    version; and one lane a point against two bit for bit (every output's
    sum keeps its order whoever computes it)."""
    sizes = (3,) + (width,) * 7 + (3,)
    spec = MLPSpec(sizes=sizes, init_type=init_type)
    params = params_from_numpy(numpy_params(sizes, init_type, seed=31), cuda_device)
    x = torch.from_numpy(np.random.RandomState(32).uniform(-1, 1, (2_051, 3))
                         .astype(np.float32)).to(cuda_device)
    other = 3 - lanes
    for kt in range(4):
        got = k2_f32_outputs(params, x, spec, kt, lanes)
        y_p, dy_p = kernels.mlp_fwd_tangents_plain(params, x, spec, kt)
        assert_close_to_plain(got["y"], y_p)
        assert_close_to_plain(got["dy"], dy_p)
        again = k2_f32_outputs(params, x, spec, kt, other)
        assert torch.equal(got["y"], again["y"]) and torch.equal(got["dy"], again["dy"])
    if init_type == "xavier":
        fc = k2_f32_outputs(params, x, spec, 2, lanes, epilogue=True)["fc"]
        assert_close_to_plain(fc, kernels.residual_continuity_plain(params, x, spec))
        assert torch.equal(fc, k2_f32_outputs(params, x, spec, 2, other, epilogue=True)["fc"])


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [None, 1, 2])
@pytest.mark.parametrize("n", K2_F32_RAGGED)
def test_cuda_k2_f32_ragged_points(cuda_device, n, lanes):
    """K2-f32 at point counts around its warp tiles and the path's sizes, at
    the plan's lanes and each forced: against the plain version, and the
    first n points of a launch on more points give the same bits (a point's
    outputs do not depend on its tile)."""
    sizes = (2,) + (20,) * 6 + (3,)
    spec = MLPSpec(sizes=sizes)
    params = params_from_numpy(numpy_params(sizes, seed=33), cuda_device)
    x = torch.from_numpy(np.random.RandomState(34).uniform(-1, 1, (n + 37, 2))
                         .astype(np.float32)).to(cuda_device)
    for kt in (0, 2):
        got = k2_f32_outputs(params, x[:n], spec, kt, lanes)
        y_p, dy_p = kernels.mlp_fwd_tangents_plain(params, x[:n], spec, kt)
        assert_close_to_plain(got["y"], y_p)
        assert_close_to_plain(got["dy"], dy_p)
        longer = k2_f32_outputs(params, x, spec, kt, lanes)
        assert torch.equal(got["y"], longer["y"][:n]) and torch.equal(got["dy"], longer["dy"][:, :n])
    fc = k2_f32_outputs(params, x[:n], spec, 2, lanes, epilogue=True)["fc"]
    assert_close_to_plain(fc, kernels.residual_continuity_plain(params, x[:n], spec))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 2])
def test_cuda_k2_f32_stack_in_several_chunks(cuda_device, lanes):
    """2->[32]x100->3: its 99 stacked layers take two shared-memory slots
    of 27 layers, staged chunk after chunk while the last one computes, for
    several rounds of tiles; K = 0..2 and the epilogue against the plain
    version."""
    from pinn_depthestimation_tpu_torch.ops import k2_plan

    sizes = (2,) + (32,) * 100 + (3,)
    spec = MLPSpec(sizes=sizes)
    params = params_from_numpy(numpy_params(sizes, seed=35), cuda_device)
    lib = kernels.k2_library().libs[32]
    n = 40_003
    plan = k2_plan.card_f32_plan(lib, n, 32, 99, 2, cuda_device, lanes)
    assert plan.slots == 2 and plan.chunks >= 3 and plan.rounds >= 2
    x = torch.from_numpy(np.random.RandomState(36).uniform(-1, 1, (n, 2))
                         .astype(np.float32)).to(cuda_device)
    for kt in range(3):
        got = k2_f32_outputs(params, x, spec, kt, lanes)
        y_p, dy_p = kernels.mlp_fwd_tangents_plain(params, x, spec, kt)
        assert_close_to_plain(got["y"], y_p)
        assert_close_to_plain(got["dy"], dy_p)
    fc = k2_f32_outputs(params, x, spec, 2, lanes, epilogue=True)["fc"]
    assert_close_to_plain(fc, kernels.residual_continuity_plain(params, x, spec))


@pytest.mark.cuda
def test_cuda_k2_f32_library_reports_the_plan(cuda_device):
    """Every width's K2 library answers, at f32, the most threads a block
    takes and the shared-memory bytes of a chunk that the CPU tests of the
    plan (tests/test_torch_k2_f32_plan.py) take from ops/k2_plan.py, none
    for a lane count the body does not take; the chunks the plan picks fit
    the card."""
    from pinn_depthestimation_tpu_torch.ops import k2_plan

    optin = getattr(torch.cuda.get_device_properties(0), "shared_memory_per_block_optin",
                    k2_plan.SMEM_LIMIT)
    for width, lib in kernels.k2_library().libs.items():
        for lanes in k2_plan.F32_LANES:
            for kt in range(4):
                assert lib.k2_f32_threads(lanes, kt) == k2_plan.f32_max_threads(width, lanes, kt)
            for chunk, slots in ((0, 1), (1, 1), (9, 1), (27, 2), (99, 1)):
                assert (lib.k2_f32_smem(lanes, chunk, slots)
                        == k2_plan.f32_smem_bytes(width, lanes, chunk, slots)), (width, lanes)
            for n_stack in (9, 99, 119):
                chunk, slots = k2_plan.f32_chunk(width, lanes, n_stack, optin)
                assert 1 <= chunk <= n_stack and lib.k2_f32_smem(lanes, chunk, slots) <= optin
        assert lib.k2_f32_threads(4, 0) == 0 and lib.k2_f32_smem(3, 1, 1) == 0


# ------------------------------------------- K2's tensor-core body (both tiers)

K2_RAGGED = ("1", "15", "17", "wave-1", "wave+1")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", "f32x3"])
@pytest.mark.parametrize("which", K2_RAGGED)
def test_cuda_k2_cheap_tiers_ragged_tiles(cuda_device, precision, which):
    """K2 at bf16 and f32x3 at point counts around its 16-point warp tiles:
    one point, one either side of a tile, and one either side of a
    persistent wave (every warp of every SM one tile; ops/k2_plan.py), with
    K=2 and the continuity epilogue. The first n points of a launch on more
    points are the same rows of the same tiles, and an MMA's rows are
    independent, so the ragged launch must give their bits; the longer
    launch is held to the plain tier (the L2 gap over many points)."""
    from pinn_depthestimation_tpu_torch.ops.kernels import entry

    sizes = (2,) + (20,) * 6 + (3,)
    spec = MLPSpec(sizes=sizes)
    params = params_from_numpy(numpy_params(sizes, seed=21), cuda_device)
    lib = kernels.k2_library().libs[20]
    wave = (torch.cuda.get_device_properties(0).multi_processor_count * lib.k2_mma_rows()
            * entry(lib, "k2_mma_warps", precision)())
    n = {"1": 1, "15": 15, "17": 17, "wave-1": wave - 1, "wave+1": wave + 1}[which]
    x = torch.from_numpy(np.random.RandomState(22).uniform(-1, 1, (wave + 33, 2))
                         .astype(np.float32)).to(cuda_device)
    tol = X3 if precision == "f32x3" else {}
    y, dy = kernels.mlp_fwd_tangents(params, x, spec, 2, precision=precision)
    yt, dyt = kernels.mlp_fwd_tangents_plain(params, x, spec, 2, precision)
    yf, dyf = kernels.mlp_fwd_tangents_plain(params, x, spec, 2, "f32")
    y6, dy6 = kernels.mlp_fwd_tangents_plain(f64(params), x.double(), spec, 2, precision)
    assert_tier_close(y, yt, yf, y6, **tol)
    assert_tier_close(dy, dyt, dyf, dy6, **tol)
    fc = kernels.fused_residual_continuity(params, x, spec, precision=precision)
    assert_tier_close(fc, kernels.residual_continuity_plain(params, x, spec, precision),
                      kernels.residual_continuity_plain(params, x, spec, "f32"),
                      kernels.residual_continuity_plain(f64(params), x.double(), spec, precision),
                      **tol)
    yn, dyn = kernels.mlp_fwd_tangents(params, x[:n], spec, 2, precision=precision)
    assert torch.equal(yn, y[:n]) and torch.equal(dyn, dy[:, :n])
    assert torch.equal(kernels.fused_residual_continuity(params, x[:n], spec, precision=precision),
                       fc[:n])


@pytest.mark.cuda
def test_cuda_k2_libraries_report_the_mma_tile(cuda_device):
    """Every width's K2 library answers, at bf16 and f32x3, the warp tile,
    the warps per block and the shared-memory bytes of a chunk that the CPU
    tests of the launch plan (tests/test_torch_k2_plan.py) take from
    ops/k2_plan.py, and the chunks the plan picks fit the card."""
    from pinn_depthestimation_tpu_torch.ops import k2_plan
    from pinn_depthestimation_tpu_torch.ops.kernels import entry

    optin = getattr(torch.cuda.get_device_properties(0), "shared_memory_per_block_optin",
                    k2_plan.SMEM_LIMIT)
    for width, lib in kernels.k2_library().libs.items():
        assert lib.k2_mma_rows() == k2_plan.ROWS
        for precision in ("bf16", "f32x3"):
            assert (entry(lib, "k2_mma_warps", precision)()
                    == k2_plan.block_warps(precision, width)), (width, precision)
            for chunk in (0, 1, 9, 56, 99):
                assert (entry(lib, "k2_mma_smem", precision)(chunk)
                        == k2_plan.smem_bytes(width, chunk, precision)), (width, precision, chunk)
            for n_stack in (9, 99, 119):  # the plan's chunk fits the card's opt-in bytes
                chunk = k2_plan.chunk_layers(width, n_stack, precision, optin)
                assert 1 <= chunk <= n_stack, (width, precision, n_stack)
                assert entry(lib, "k2_mma_smem", precision)(chunk) <= optin


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["stream", "rebuild"])
@pytest.mark.parametrize("sizes,init_type,kt,n", [
    ((2,) + (20,) * 100 + (3,), "xavier", 2, 1_003),   # the flagship
    ((2,) + (10,) * 10 + (6,), "xavier", 0, 200),      # the CMB fidelity rows
    ((3,) + (16,) * 5 + (4,), "kaiming", 3, 777),      # leaky-relu, three tangents
    ((2,) + (20,) * 11 + (3,), "xavier", 1, 129),      # a short last K4 segment
    ((2,) + (32,) * 60 + (5,), "xavier", 2, 300),      # deeper than one smem chunk
])
def test_cuda_k3_k4_f32x3_match_plain_tier(cuda_device, impl, sizes, init_type, kt, n):
    spec = MLPSpec(sizes=sizes, init_type=init_type)
    params = params_from_numpy(numpy_params(sizes, init_type, seed=8), cuda_device)
    rs = np.random.RandomState(9)
    x = torch.from_numpy(rs.uniform(-1, 1, (n, sizes[0])).astype(np.float32)).to(cuda_device)
    ybar = torch.from_numpy(rs.randn(n, sizes[-1]).astype(np.float32)).to(cuda_device)
    dybar = torch.from_numpy(rs.randn(kt, n, sizes[-1]).astype(np.float32)).to(cuda_device)
    wrapper = kernels_vjp.packed_mlp_bwd_rebuild if impl == "rebuild" else kernels_vjp.packed_mlp_bwd
    before = wrapper.launches_by_tier["f32x3"]
    g = kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, spec, kt, precision="f32x3",
                                   impl=impl)
    assert wrapper.launches_by_tier["f32x3"] == before + 1
    g_t = kernels_vjp.packed_mlp_bwd_plain(params, x, ybar, dybar, spec, kt, "f32x3")
    g_f = kernels_vjp.packed_mlp_bwd_plain(params, x, ybar, dybar, spec, kt, "f32")
    g_6 = kernels_vjp.packed_mlp_bwd_plain(f64(params), x.double(), ybar.double(),
                                           dybar.double(), spec, kt, "f32x3")
    assert any([assert_tier_close(g[k], g_t[k], g_f[k], g_6[k], **X3) for k in g]) \
        or not shows_tier(sizes)
    g2 = kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, spec, kt, precision="f32x3",
                                    impl=impl)
    assert all(torch.equal(g[k], g2[k]) for k in g)  # deterministic


@pytest.mark.cuda
@pytest.mark.parametrize("sizes,n_true,has_anchor", [
    ((2,) + (20,) * 100 + (3,), 2, True),   # the flagship
    ((2,) + (16,) * 6 + (3,), 3, False),
])
def test_cuda_k1_f32x3_matches_plain_tier(cuda_device, sizes, n_true, has_anchor):
    spec = MLPSpec(sizes=sizes)
    params = params_from_numpy(numpy_params(sizes, seed=6), cuda_device)
    rs = np.random.RandomState(5)
    n = 2_001
    x = torch.from_numpy(rs.uniform(-1, 1, (n, 2)).astype(np.float32)).to(cuda_device)
    trues = torch.from_numpy((rs.randn(n, n_true) * 0.1).astype(np.float32)).to(cuda_device)
    mask = torch.from_numpy((rs.rand(n) > 0.1).astype(np.float32)).to(cuda_device)
    b = kernels_step.make_step_batch(x, trues, (x[:, 0] < 0.3).float() * mask, mask,
                                     [1.0, 0.7, 1.3][:n_true], n_true, 0.7, 1.3,
                                     has_anchor=has_anchor)
    before = kernels_step.fused_loss_and_grad.launches_by_tier["f32x3"]
    (t, (f, r)), g = kernels_step.fused_loss_and_grad(params, b, spec, precision="f32x3")
    assert kernels_step.fused_loss_and_grad.launches_by_tier["f32x3"] == before + 1
    (tx, (fx, rx)), gx = kernels_step.fused_loss_and_grad_plain(params, b, spec, "f32x3")
    (tf, (ff, rf)), gf = kernels_step.fused_loss_and_grad_plain(params, b, spec, "f32")
    b64 = dataclasses.replace(b, **{k: getattr(b, k).double() for k in (
        "coords", "trues", "sel", "mask", "fid_weights", "n_res", "n_sel", "scal")})
    (t6, (f6, r6)), g6 = kernels_step.fused_loss_and_grad_plain(f64(params), b64, spec, "f32x3")
    real = [assert_tier_close(got, wx, wf, w6, **X3) for got, wx, wf, w6 in
            ((t, tx, tf, t6), (f, fx, ff, f6), (r, rx, rf, r6))]
    real += [assert_tier_close(g[k], gx[k], gf[k], g6[k], **X3) for k in g]
    assert any(real)  # the flagship's K1 outputs show it too (PERF.md)


@pytest.mark.cuda
def test_cuda_f32x3_cmb_training_runs_on_k2_and_k3(cuda_device, tmp_path):
    """A CMB Trainer at kernel_precision f32x3 on the card, with
    residual_chunk_size set (dropped on the kernel path): every loss
    evaluation launches K2-f32x3 and K3-f32x3 twice, and K4 never."""
    import os

    from pinn_depthestimation_tpu_torch.config import parse_config
    from pinn_depthestimation_tpu_torch.parity import make_cmb_config
    from pinn_depthestimation_tpu_torch.training.driver import Trainer
    from pinn_depthestimation_tpu_torch.training.logging_utils import read_log
    from pinn_depthestimation_tpu_torch.utils import synthetic

    csv, mat = str(tmp_path / "f.csv"), str(tmp_path / "r.mat")
    synthetic.make_cmb_dataset(csv, mat, nx=41, ny=61, n_csv=120, seed=6, nan_fraction=0.03)
    raw = make_cmb_config(csv, mat, 20, 4, tol_grad=1e-12, tol_change=1e-14, nx=41, ny=61,
                          interval=1, training_points=100)
    init = numpy_params((2,) + (10,) * 10 + (6,), "xavier", seed=1)
    init["b_out"][3] += 1.0
    run = str(tmp_path / "x3")
    os.makedirs(run)
    trainer = Trainer(parse_config(dict(raw, kernel_precision="f32x3", residual_chunk_size=512)),
                      run_dir=run, echo_every=0, initial_params=init, device=cuda_device)
    k2 = dict(kernels.mlp_fwd_tangents.launches_by_tier)
    k3 = dict(kernels_vjp.packed_mlp_bwd.launches_by_tier)
    k4 = kernels_vjp.packed_mlp_bwd_rebuild.launches
    trainer.train_adam()
    trainer.train_lbfgs()
    epochs, _, _, totals = read_log(run)
    n = len(epochs)
    assert n > 20 and np.isfinite(totals).all()
    assert kernels_vjp.packed_mlp_bwd.launches_by_tier["f32x3"] - k3["f32x3"] == 2 * n
    assert kernels.mlp_fwd_tangents.launches_by_tier["f32x3"] - k2["f32x3"] == 2 * n
    assert kernels_vjp.packed_mlp_bwd_rebuild.launches == k4


# ------------------------------------------------ test-time adaptation (M6)

def adapt_config(tmp_path, kind: str, tier: str):
    """A small newmethod (2->[20]x6->3) or CMB (2->[10]x4->6) config whose
    test grid the adaptation runs on, and seeded weights for it (.npz)."""
    from pinn_depthestimation_tpu_torch.config import parse_config
    from pinn_depthestimation_tpu_torch.parity import make_cmb_config, make_config
    from pinn_depthestimation_tpu_torch.utils import synthetic

    mat = str(tmp_path / "grid.mat")
    if kind == "newmethod":
        synthetic.make_newmethod_mat(mat, nx=41, ny=61, nan_fraction=0.1, seed=3)
        raw = make_config(mat, 1, 1, hidden_layers=6, hidden_width=20)
        raw["data_test"].update(file=mat, outputs=["U", "V", "h"], nx=41, ny=61,
                                inputs={"x": {"requires_grad": ["true"]},
                                        "y": {"requires_grad": ["true"]}})
        arrays = numpy_params((2,) + (20,) * 6 + (3,), seed=4)
    else:
        csv = str(tmp_path / "fid.csv")
        synthetic.make_cmb_dataset(csv, mat, nx=41, ny=61, n_csv=60, seed=6, nan_fraction=0.03)
        raw = make_cmb_config(csv, mat, 1, 1, hidden_layers=4, nx=41, ny=61, interval=2,
                              training_points=40)
        raw["data_test"].pop("model")
        arrays = numpy_params((2,) + (10,) * 4 + (6,), seed=5)
        arrays["b_out"][3] += 1.0  # eta + h away from 0
    npz = str(tmp_path / "w.npz")
    np.savez(npz, **arrays)
    return parse_config(dict(raw, kernel_precision=tier)), npz


@pytest.mark.cuda
@pytest.mark.parametrize("kind,tier", [("newmethod", "f32"), ("cmb", "f32"),
                                       ("newmethod", "bf16")])
def test_cuda_adaptation_through_the_kernels_matches_plain(cuda_device, tmp_path, kind, tier):
    """``Predictor.adapt`` on the card: K2 once and the backward (K3 at f32,
    K4 at bf16) once per evaluation. At f32 against ``use_kernel=False``:
    the same evaluations, losses within 1e-4 relative (the residuals
    cancel: ``chip_smoke.adapt_compare``), parameters within 1e-4 x
    max|change| + 1e-7. At bf16 the first evaluation (the same weights on
    both routes) against the plain bf16 loss, within a quarter of the
    tier's own error + 1e-4 relative."""
    from pinn_depthestimation_tpu_torch import physics
    from pinn_depthestimation_tpu_torch.data import load_test_data
    from pinn_depthestimation_tpu_torch.inference import Predictor

    cfg, npz = adapt_config(tmp_path, kind, tier)
    x = load_test_data(cfg).inputs
    kern = Predictor(cfg, npz, device=cuda_device)
    plain = Predictor(cfg, npz, device=cuda_device, use_kernel=False)
    assert kern.use_kernel
    p0 = {k: v.clone() for k, v in kern.params.items()}
    bwd = kernels_vjp.packed_mlp_bwd_rebuild if tier == "bf16" else kernels_vjp.packed_mlp_bwd
    k2, kb = kernels.mlp_fwd_tangents.launches_by_tier[tier], bwd.launches_by_tier[tier]
    n = kern.adapt(x)
    assert kernels.mlp_fwd_tangents.launches_by_tier[tier] - k2 == n
    assert bwd.launches_by_tier[tier] - kb == n
    n_plain = plain.adapt(x)
    lk, lp = kern.adapt_losses, plain.adapt_losses
    assert np.isfinite(lk).all() and all(bool(v.isfinite().all()) for v in kern.params.values())
    if tier == "f32":
        assert n == n_plain
        np.testing.assert_allclose(lk, lp, rtol=1e-4)
        moved = max(float((plain.params[k] - p0[k]).abs().max()) for k in p0)
        for k in p0:
            assert float((kern.params[k] - plain.params[k]).abs().max()) <= 1e-4 * moved + 1e-7
        return
    # the plain bf16 loss at the starting weights: the adaptation's first evaluation
    finite = torch.as_tensor(x[np.isfinite(x).all(axis=1)]).to(cuda_device)
    y, dy = kernels.mlp_fwd_tangents_plain(p0, finite, kern.spec, 2, "bf16")
    names = list(cfg.data_test.outputs)
    fields = {name: y[:, i] for i, name in enumerate(names)}
    grads = {c: {name: dy[j][:, i] for i, name in enumerate(names)}
             for j, c in enumerate(("x", "y"))}
    coords = {"x": finite[:, 0], "y": finite[:, 1]}
    want = float(physics.residual_loss(cfg.physics)(coords, fields, grads, parity=cfg.parity))
    assert abs(lk[0] - want) <= 0.25 * abs(want - lp[0]) + 1e-4 * abs(want)


# ------------------------------------------------------- the legacy pipeline

LEGACY_SIZES = (5,) + (20,) * 20 + (4,)  # examples/legacy.json


def legacy_points(n, seed):
    """``n`` points shaped as the legacy loader's (t, x, y, u, v) rows."""
    rs = np.random.RandomState(seed)
    return torch.from_numpy(rs.uniform(-1, 1, (n, 5)).astype(np.float32)), rs


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16", "f32x3"])
@pytest.mark.parametrize("kt,n", [(3, 4_099), (0, 300)])
def test_cuda_legacy_shape_kernels_match_plain(cuda_device, precision, kt, n):
    """K2, K3 and K4 at the legacy net (d_in 5, the tangents of t, x, y
    leading it; width 20, 20 hidden layers) at each tier, against the plain
    version (f32: the f32 tolerance; bf16, f32x3: ``assert_tier_close``)."""
    spec = MLPSpec(sizes=LEGACY_SIZES, init_type="xavier")
    params = params_from_numpy(numpy_params(LEGACY_SIZES, "xavier", seed=25), cuda_device)
    x, rs = legacy_points(n, seed=26)
    x = x.to(cuda_device)
    ybar = torch.from_numpy(rs.randn(n, 4).astype(np.float32)).to(cuda_device)
    dybar = torch.from_numpy(rs.randn(kt, n, 4).astype(np.float32)).to(cuda_device)
    kw = X3 if precision == "f32x3" else {}
    with torch.no_grad():
        y, dy = kernels.mlp_fwd_tangents(params, x, spec, kt, precision=precision)
        want = kernels.mlp_fwd_tangents_plain(params, x, spec, kt, precision)
        f32 = kernels.mlp_fwd_tangents_plain(params, x, spec, kt, "f32")
        w64 = kernels.mlp_fwd_tangents_plain(f64(params), x.double(), spec, kt, precision)
    outs = [(y, want[0], f32[0], w64[0])] + ([(dy, want[1], f32[1], w64[1])] if kt else [])
    for impl in ("stream", "rebuild"):
        g = kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, spec, kt, precision=precision,
                                       impl=impl)
        g_t = kernels_vjp.packed_mlp_bwd_plain(params, x, ybar, dybar, spec, kt, precision)
        g_f = kernels_vjp.packed_mlp_bwd_plain(params, x, ybar, dybar, spec, kt, "f32")
        g_6 = kernels_vjp.packed_mlp_bwd_plain(f64(params), x.double(), ybar.double(),
                                               dybar.double(), spec, kt, precision)
        outs += [(g[k], g_t[k], g_f[k], g_6[k]) for k in g]
    if precision == "f32":
        for got, want_t, _, _ in outs:
            assert_close_to_plain(got, want_t)
    else:
        shown = [assert_tier_close(*o, **kw) for o in outs]
        assert precision == "f32x3" or any(shown)


def legacy_trainer_raw(tmp_path, adam_iters):
    from pinn_depthestimation_tpu_torch.benchmarks import legacy_config
    from pinn_depthestimation_tpu_torch.utils import synthetic

    snap_dir, csv = synthetic.make_funwave_snapshot_dir(
        str(tmp_path / "beach2d"), nx=21, ny=17, snapshots=(200, 201, 202, 203), seed=2)
    raw = legacy_config(snap_dir, csv, adam_iters, 0)
    raw["numerical_model"].update(nx=21, ny=17, x_max=40.0, y_max=32.0)
    raw["data_residual"]["numerical_model_snapshots"] = [200, 201, 202, 203]
    return raw


@pytest.mark.cuda
def test_cuda_legacy_trainer_kernels_match_plain(cuda_device, tmp_path):
    """A few Adam steps of the legacy net (full width, 21x17x4 points)
    through K2 + K3 against the plain Trainer from the same weights:
    iteration 1 within rel 1e-5, the parameters after 5 steps within 1e-6;
    K2 and K3 launch twice per step, K1 and K4 never."""
    import os

    from pinn_depthestimation_tpu_torch.config import parse_config
    from pinn_depthestimation_tpu_torch.training.driver import Trainer

    raw = legacy_trainer_raw(tmp_path, 5)
    init = numpy_params(LEGACY_SIZES, "xavier", seed=3)
    out = {}
    for mode in ("auto", "off"):
        run = str(tmp_path / mode)
        os.makedirs(run)
        trainer = Trainer(parse_config(dict(raw, fused_kernel=mode)), run_dir=run,
                          echo_every=0, initial_params=init, device=cuda_device)
        assert trainer.kernel_plan.fused == (mode == "auto") and not trainer.kernel_plan.k1
        counts = [w.launches for w in (kernels.mlp_fwd_tangents, kernels_vjp.packed_mlp_bwd,
                                       kernels_vjp.packed_mlp_bwd_rebuild,
                                       kernels_step.fused_loss_and_grad)]
        losses = trainer._adam_steps(5).cpu().numpy()
        after = [w.launches for w in (kernels.mlp_fwd_tangents, kernels_vjp.packed_mlp_bwd,
                                      kernels_vjp.packed_mlp_bwd_rebuild,
                                      kernels_step.fused_loss_and_grad)]
        want = [10, 10, 0, 0] if mode == "auto" else [0, 0, 0, 0]
        assert [a - b for a, b in zip(after, counts)] == want
        out[mode] = (losses, {k: v.clone() for k, v in trainer.state.params.items()})
    (l_k, p_k), (l_p, p_p) = out["auto"], out["off"]
    np.testing.assert_allclose(l_k[0], l_p[0], rtol=1e-5)
    assert max(float((p_k[k] - p_p[k]).abs().max()) for k in p_k) <= 1e-6


@pytest.mark.cuda
def test_cuda_chunked_plain_loss_equals_unchunked(cuda_device, tmp_path):
    """The chunked plain loss on the card (``fused_kernel='off'``,
    ``residual_chunk_size`` 4096 over the legacy net's 26,691 points):
    the loss within rel 1e-6 of the unchunked one, each gradient within the
    f32 tolerance of its largest entry (cuBLAS may sum a chunk's products in
    another order than the whole batch's)."""
    from pinn_depthestimation_tpu_torch import data
    from pinn_depthestimation_tpu_torch.benchmarks import legacy_config
    from pinn_depthestimation_tpu_torch.config import parse_config
    from pinn_depthestimation_tpu_torch.training import loss
    from pinn_depthestimation_tpu_torch.utils import synthetic

    snap_dir, csv = synthetic.make_funwave_snapshot_dir(
        str(tmp_path / "beach2d"), nx=41, ny=31, snapshots=tuple(range(200, 221)), seed=0)
    cfg = parse_config(dict(legacy_config(snap_dir, csv, 1, 0), fused_kernel="off"))
    td = data.load_training_data(cfg)
    assert td.residual_input.shape[0] == 26_691
    spec = MLPSpec(sizes=LEGACY_SIZES, init_type="xavier")
    batch = {k: torch.from_numpy(getattr(td, k)).to(cuda_device)
             for k in ("fidelity_input", "fidelity_true", "residual_input")}
    params = params_from_numpy(numpy_params(LEGACY_SIZES, "xavier", seed=4), cuda_device)
    (t_f, (f_f, r_f)), g_f = loss.value_and_grad(loss.build_loss_fn(cfg, spec))(params, batch)
    (t_c, (f_c, r_c)), g_c = loss.value_and_grad(
        loss.build_loss_fn(cfg, spec, residual_chunk_size=4096))(params, batch)
    for a, b in ((t_c, t_f), (f_c, f_f), (r_c, r_f)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    for k in g_f:
        assert_close_to_plain(g_c[k], g_f[k])


# ------------------------------------------------- the f64 polish, the mesh


def polish_raw(mat, backend):
    """A flagship-shaped config (width 20, K1's width) with no f32 phase:
    the polish alone from given weights."""
    return {
        "layers": {"input_features": 2, "hidden_layers": 4, "hidden_width": 20,
                   "output_features": 3, "dropout_rate": 0.0, "init_type": "xavier"},
        "adam_optimizer": {"max_it": 0, "learning_rate": 1e-3,
                           "scheduler_step_size": 10, "scheduler_gamma": 0.8},
        "lbfgs_optimizer": {"max_it": 0, "learning_rate": 1, "max_evaluation": 0,
                            "history_size": 10, "tolerance_grad": 1e-12,
                            "tolerance_change": 1e-14, "line_search_fn": "strong_wolfe"},
        "loss": {"weight_fid_loss": 1, "weight_res_loss": 1},
        "data": {"file": mat, "inputs": {"x": {"requires_grad": ["true"]},
                                         "y": {"requires_grad": ["true"]}},
                 "trues": ["U", "V"], "unknowns": ["h"]},
        "f64_polish": {"max_it": 15, "backend": backend},
    }


@pytest.mark.cuda
def test_cuda_f64_polish_matches_the_cpu_polish(cuda_device, tmp_path):
    """The f64 polish on the card (``backend='device_eval'``: loop and
    evaluations there) against the same polish on the CPU from the same f32
    weights: both float64, so the rows as ``log.txt`` prints them agree for
    the first 5 evaluations and the minima within 1e-9 relative (the CPU
    polish against the JAX package's measured 5.1e-13,
    ``tests/test_torch_f64_polish.py``). No K1 launch in the polish."""
    import os

    from pinn_depthestimation_tpu_torch.config import parse_config
    from pinn_depthestimation_tpu_torch.training.driver import Trainer
    from pinn_depthestimation_tpu_torch.training.logging_utils import read_log
    from pinn_depthestimation_tpu_torch.utils import synthetic

    mat = str(tmp_path / "d.mat")
    synthetic.make_newmethod_mat(mat, nx=16, ny=20, nan_fraction=0.05, seed=2)
    init = numpy_params((2,) + (20,) * 4 + (3,), "xavier", seed=4)
    out = {}
    for backend, device in (("device_eval", cuda_device), ("cpu", "cpu")):
        run = str(tmp_path / backend)
        os.makedirs(run)
        tr = Trainer(parse_config(polish_raw(mat, backend)), run_dir=run, echo_every=0,
                     initial_params=init, device=device)
        before = kernels_step.fused_loss_and_grad.launches
        tr.train()
        assert kernels_step.fused_loss_and_grad.launches == before
        state = tr._live_lbfgs64_state
        assert state.x.dtype == torch.float64 and state.x.device.type == torch.device(device).type
        assert all(v.dtype == torch.float32 for v in tr.state.params.values())
        out[backend] = (read_log(run), float(state.f))
    (card, f_card), (cpu, f_cpu) = out["device_eval"], out["cpu"]
    assert card[0] == list(range(1, len(card[0]) + 1))
    for col in (1, 2, 3):
        assert card[col][:5] == cpu[col][:5]
    assert abs(f_card - f_cpu) <= 1e-9 * abs(f_cpu)


@pytest.mark.cuda
def test_cuda_sharded_k1_matches_unsharded(cuda_device, tmp_path):
    """K1 on 4 shards of one card (the data-parallel step) against one
    unsharded launch: one launch per shard, the loss and every gradient
    within the f32 tolerance; a one-shard mesh is the unsharded step bit
    for bit."""
    from pinn_depthestimation_tpu_torch import parallel
    from pinn_depthestimation_tpu_torch.config import parse_config
    from pinn_depthestimation_tpu_torch.data import load_training_data
    from pinn_depthestimation_tpu_torch.training.loss import build_value_and_grad_fn
    from pinn_depthestimation_tpu_torch.utils import synthetic

    mat = str(tmp_path / "d.mat")
    synthetic.make_newmethod_mat(mat, nx=41, ny=61, nan_fraction=0.2, seed=3)
    raw = polish_raw(mat, "cpu")
    raw["layers"]["hidden_layers"] = 20
    cfg = parse_config(raw)
    td = load_training_data(cfg)
    spec = MLPSpec.from_layers(cfg.layers)
    params = params_from_numpy(numpy_params(spec.sizes, "xavier", seed=5), cuda_device)
    kw = dict(input_min_max=td.input_min_max, fused_kernel=True, fidelity_is_residual=True)
    host = {k: np.asarray(getattr(td, k)) for k in
            ("fidelity_input", "fidelity_true", "residual_input")}
    whole = {k: torch.from_numpy(v).to(cuda_device) for k, v in host.items()}
    (t0, (f0, r0)), g0 = build_value_and_grad_fn(cfg, spec, **kw)(params, whole)
    for n in (4, 1):
        mesh = parallel.make_mesh(n, devices=[cuda_device] * n)
        fn = build_value_and_grad_fn(cfg, spec, **kw)
        shards = parallel.shard_batch(host, mesh)
        before = kernels_step.fused_loss_and_grad.launches
        (t1, (f1, r1)), g1 = fn(params, shards)
        assert kernels_step.fused_loss_and_grad.launches == before + n
        if n == 1:
            assert torch.equal(t1, t0) and all(torch.equal(g1[k], g0[k]) for k in g0)
        for a, b in ((t1, t0), (f1, f0), (r1, r0), *((g1[k], g0[k]) for k in g0)):
            assert_close_to_plain(a, b)


@pytest.mark.cuda
def test_cuda_sharded_cmb_loss_matches_unsharded(cuda_device, tmp_path):
    """The CMB loss through K2 + K3 on 4 shards of one card against the
    unsharded K2 + K3 loss: K2 and K3 launch twice per shard (residual at
    K=2, fidelity at K=0); the loss terms within rel 1e-5, the gradients
    within the f32 tolerance of their scale."""
    from pinn_depthestimation_tpu_torch import parallel
    from pinn_depthestimation_tpu_torch.config import parse_config
    from pinn_depthestimation_tpu_torch.data import load_training_data
    from pinn_depthestimation_tpu_torch.parity import make_cmb_config
    from pinn_depthestimation_tpu_torch.training.loss import build_loss_fn, value_and_grad
    from pinn_depthestimation_tpu_torch.utils import synthetic

    csv, mat = str(tmp_path / "f.csv"), str(tmp_path / "r.mat")
    synthetic.make_cmb_dataset(csv, mat, nx=41, ny=61, n_csv=120, seed=6, nan_fraction=0.03)
    cfg = parse_config(make_cmb_config(csv, mat, 1, 0, nx=41, ny=61, interval=1,
                                       training_points=100))
    td = load_training_data(cfg)
    spec = MLPSpec.from_layers(cfg.layers)
    init = numpy_params(spec.sizes, "xavier", seed=1)
    init["b_out"][3] += 1.0  # eta + h away from 0
    params = params_from_numpy(init, cuda_device)
    host = {k: np.asarray(getattr(td, k)) for k in
            ("fidelity_input", "fidelity_true", "residual_input")}
    whole = {k: torch.from_numpy(v).to(cuda_device) for k, v in host.items()}
    (t0, (f0, r0)), g0 = value_and_grad(build_loss_fn(cfg, spec, fused_kernel=True))(params, whole)
    mesh = parallel.make_mesh(4, devices=[cuda_device] * 4)
    counts = (kernels.mlp_fwd_tangents.launches, kernels_vjp.packed_mlp_bwd.launches)
    (t1, (f1, r1)), g1 = value_and_grad(build_loss_fn(cfg, spec, fused_kernel=True, mesh=mesh))(
        params, parallel.shard_batch(host, mesh))
    assert (kernels.mlp_fwd_tangents.launches - counts[0],
            kernels_vjp.packed_mlp_bwd.launches - counts[1]) == (8, 8)
    for a, b in ((t1, t0), (f1, f0), (r1, r0)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    for k in g0:
        assert_close_to_plain(g1[k], g0[k])


# ------------------------------------------------ every Pallas shape (PR 12)

WIDE_CASES = [
    ((2,) + (17,) * 4 + (3,), "xavier"),    # narrow, padded to 20
    ((2,) + (64,) * 4 + (3,), "kaiming"),   # the wide body
    ((2,) + (128,) * 3 + (3,), "xavier"),   # the wide body at the JAX gate's limit
]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16", "f32x3"])
@pytest.mark.parametrize("sizes,init_type", WIDE_CASES)
def test_cuda_kernels_at_every_pallas_width(cuda_device, sizes, init_type, precision):
    """K2 (K = 0-2, the epilogue), K3, K4 and K1 (loss and gradients) at
    widths 17, 64 and 128 against their plain versions at each tier (bf16
    and f32x3 by ``assert_tier_close``); width 17 runs the narrow body at
    width 20, the others the wide body."""
    from pinn_depthestimation_tpu_torch.ops import widths

    spec = MLPSpec(sizes=sizes, init_type=init_type)
    params = params_from_numpy(numpy_params(sizes, init_type, seed=12), cuda_device)
    rs = np.random.RandomState(12)
    n = 2_003
    x = torch.from_numpy(rs.uniform(-1, 1, (n, 2)).astype(np.float32)).to(cuda_device)
    ybar = torch.from_numpy(rs.randn(n, 3).astype(np.float32)).to(cuda_device)
    dybar = torch.from_numpy(rs.randn(2, n, 3).astype(np.float32)).to(cuda_device)
    floor, distinct = (2e-6, 2.0) if precision == "f32x3" else (1e-4, 0.0)

    def check(got, fn, *args):
        if precision == "f32":
            assert_close_to_plain(got, fn(params, x, *args, "f32"))
            return True
        return assert_tier_close(got, fn(params, x, *args, precision),
                                 fn(params, x, *args, "f32"),
                                 fn(f64(params), x.double(), *args, precision), floor, distinct)

    def bwd_flat(p, xx, impl_args, tier):
        yb, db = (ybar, dybar) if xx.dtype == torch.float32 else (ybar.double(), dybar.double())
        g = kernels_vjp.packed_mlp_bwd_plain(p, xx, yb, db, spec, 2, tier)
        return torch.cat([g[k].reshape(-1) for k in kernels_step.FLAT_KEYS])

    body = widths.body(spec)
    before = {w: dict(w.launches_by_body) for w in (kernels.mlp_fwd_tangents,
                                                    kernels_vjp.packed_mlp_bwd,
                                                    kernels_step.fused_loss_and_grad)}
    real = []
    with torch.no_grad():
        for k in range(3):
            y, dy = kernels.mlp_fwd_tangents(params, x, spec, k, precision=precision)
            torch.cuda.synchronize()
            real.append(check(y, lambda p, xx, kk, t: kernels.mlp_fwd_tangents_plain(
                p, xx, spec, kk, t)[0], k))
            if k:
                real.append(check(dy, lambda p, xx, kk, t: kernels.mlp_fwd_tangents_plain(
                    p, xx, spec, kk, t)[1], k))
        fc = kernels.fused_residual_continuity(params, x, spec, precision=precision)
        real.append(check(fc, lambda p, xx, t: kernels.residual_continuity_plain(p, xx, spec, t)))
        for impl in ("stream", "rebuild"):
            g = kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, spec, 2, precision=precision,
                                           impl=impl)
            real.append(check(torch.cat([g[k].reshape(-1) for k in kernels_step.FLAT_KEYS]),
                              bwd_flat, None))
    trues = torch.from_numpy((rs.randn(n, 2) * 0.1).astype(np.float32)).to(cuda_device)
    ones = torch.ones(n, device=cuda_device)
    b = kernels_step.make_step_batch(x, trues, (x[:, 0] < 0.3).float(), ones, [1.0, 1.0], 2,
                                     1.0, 1.0, anchor_depth=0.75, has_anchor=True)

    def k1_flat(p, xx, tier):
        bb = b if xx.dtype == torch.float32 else kernels_step.make_step_batch(
            xx, trues.double(), b.sel.double(), ones.double(), [1.0, 1.0], 2, 1.0, 1.0,
            anchor_depth=0.75, has_anchor=True)
        (t, _), g = kernels_step.fused_loss_and_grad_plain(p, bb, spec, tier)
        return torch.cat([t.reshape(1)] + [g[k].reshape(-1) for k in kernels_step.FLAT_KEYS])

    (t1, _), g1 = kernels_step.fused_loss_and_grad(params, b, spec, precision=precision)
    if precision == "f32":
        (t2, _), g2 = kernels_step.fused_loss_and_grad_plain(params, b, spec)
        assert_close_to_plain(t1, t2)
        for k in g1:
            assert_close_to_plain(g1[k], g2[k])
    else:
        with torch.no_grad():
            real.append(check(torch.cat([t1.reshape(1)] + [g1[k].reshape(-1)
                                                           for k in kernels_step.FLAT_KEYS]),
                              k1_flat))
    assert any(real)
    for w, counts in before.items():
        assert w.launches_by_body[body] > counts[body], w.__name__


@pytest.mark.cuda
def test_cuda_wide_libraries_report_their_variants(cuda_device):
    """The wide build holds one library per kernel and tier (under the width
    key 0), each answering its threads and, for a plan, the shared-memory
    bytes, the weight images' bytes and the state slots that
    ops/wide_plan.py computes."""
    from pinn_depthestimation_tpu_torch.ops import cuda_build, wide_plan
    from pinn_depthestimation_tpu_torch.ops.kernels import entry

    built = cuda_build._ensure(cuda_build.WIDE)
    for name in cuda_build.WIDE:
        assert list(built[name].libs) == [0]
        lib = built[name].libs[0]
        kernel = name[:2]
        assert getattr(lib, f"{name}_threads")() == wide_plan.THREADS
        for precision in cuda_build.TIERS:
            for W, d_in, d_out, kt, tile in ((128, 2, 3, 2, 32), (64, 12, 16, 3, 48), (33, 2, 2, 0, 16)):
                if kernel == "k1":
                    got = entry(lib, "k1w_smem", precision)(W, d_in, tile)
                    want = wide_plan.smem_bytes("k1", W, d_in, 3, 2, tile, precision)
                    img = entry(lib, "k1w_image_bytes", precision)(W, d_in, 99)
                    want_img = wide_plan.image_bytes("k1", W, d_in, 3, 99, precision)
                else:
                    got = entry(lib, f"{name}_smem", precision)(W, d_in, d_out, kt, tile)
                    want = wide_plan.smem_bytes(kernel, W, d_in, d_out, kt, tile, precision)
                    img = entry(lib, f"{name}_image_bytes", precision)(W, d_in, d_out, 9)
                    want_img = wide_plan.image_bytes(kernel, W, d_in, d_out, 9, precision)
                assert got == want, (name, precision, W)
                assert img == want_img, (name, precision, W)
        if kernel in ("k3", "k4"):
            for n_stack, c in ((99, 8), (9, 3), (0, 1)):
                assert getattr(lib, f"{name}_state_slots")(n_stack, c) == \
                    wide_plan.state_slots(kernel, n_stack, c)


# -------------------------------------------------- the wide walk at W = 128

@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16", "f32x3"])
def test_cuda_wide_walk_at_width_128_matches_plain_and_repeats_its_bits(cuda_device, precision):
    """K1, K3 and K4 (segments of C = 2 layers, so that the backward re-runs
    several) on 2->[128]x6->3 at every tier, on three tiles a block (the
    plan's 32-point tiles at W = 128 over three times the SMs): held to
    their plain versions (bf16 and f32x3 by ``assert_tier_close``), and two
    launches of each give the same bits (per-block partial rows summed in
    block order, no atomics)."""
    from pinn_depthestimation_tpu_torch.ops import wide_plan

    sizes = (2,) + (128,) * 6 + (3,)
    spec = MLPSpec(sizes=sizes)
    params = params_from_numpy(numpy_params(sizes, "xavier", seed=13), cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    n = 3 * sms * 32 - 5
    rs = np.random.RandomState(13)
    x = torch.from_numpy(rs.uniform(-1, 1, (n, 2)).astype(np.float32)).to(cuda_device)
    ybar = torch.from_numpy(rs.randn(n, 3).astype(np.float32)).to(cuda_device)
    dybar = torch.from_numpy(rs.randn(2, n, 3).astype(np.float32)).to(cuda_device)
    trues = torch.from_numpy((rs.randn(n, 2) * 0.1).astype(np.float32)).to(cuda_device)
    ones = torch.ones(n, device=cuda_device)
    b = kernels_step.make_step_batch(x, trues, (x[:, 0] < 0.3).float(), ones, [1.0, 1.0], 2,
                                     1.0, 1.0, anchor_depth=0.75, has_anchor=True)
    for kernel in ("k1", "k3", "k4"):
        plan = wide_plan.card_plan(kernel, n, spec, 2, precision, cuda_device,
                                   2 if kernel == "k4" else 0)
        assert plan.tile == 32 and plan.rounds == 3, plan
    floor, distinct = (2e-6, 2.0) if precision == "f32x3" else (1e-4, 0.0)

    def k1_flat(p, xx, tier):
        bb = b if xx.dtype == torch.float32 else kernels_step.make_step_batch(
            xx, trues.double(), b.sel.double(), ones.double(), [1.0, 1.0], 2, 1.0, 1.0,
            anchor_depth=0.75, has_anchor=True)
        _, _, _, stats, g = kernels_step._plain_stats_and_grads(p, bb, spec, tier)
        return torch.cat([g[k].reshape(-1) for k in kernels_step.FLAT_KEYS]
                         + [stats.reshape(-1)[:5]])

    def bwd_flat(p, xx, tier):
        yb, db = (ybar, dybar) if xx.dtype == torch.float32 else (ybar.double(), dybar.double())
        g = kernels_vjp.packed_mlp_bwd_plain(p, xx, yb, db, spec, 2, tier)
        return torch.cat([g[k].reshape(-1) for k in kernels_step.FLAT_KEYS])

    n_p = kernels_step.n_flat(spec)
    launches = {
        "k1": (lambda: kernels_step._launch_k1_wide(params, b, spec, precision)[:n_p + 5],
               k1_flat),
        "k3": (lambda: kernels_vjp._launch_wide("k3", params, x, ybar, dybar, spec, 2,
                                                precision),
               bwd_flat),
        "k4": (lambda: kernels_vjp._launch_wide("k4", params, x, ybar, dybar, spec, 2,
                                                precision, 2),
               bwd_flat),
    }
    real = []
    with torch.no_grad():
        for kernel, (launch, plain) in launches.items():
            got, again = launch(), launch()
            torch.cuda.synchronize()
            assert torch.equal(got, again), kernel
            if precision == "f32":
                assert_close_to_plain(got, plain(params, x, "f32"))
                real.append(True)
            else:
                real.append(assert_tier_close(got, plain(params, x, precision),
                                              plain(params, x, "f32"),
                                              plain(f64(params), x.double(), precision), floor,
                                              distinct))
    assert any(real)


# ------------------------------------------- Adam's update as one kernel

def torch_foreach_adam(config, params):
    """``training.driver.make_adam_optimizer`` as the port had it: torch's
    own Adam, its foreach path, under the same StepLR."""
    optimizer = torch.optim.Adam(params, lr=config.adam.learning_rate, foreach=True)
    return optimizer, torch.optim.lr_scheduler.StepLR(
        optimizer, step_size=config.adam.scheduler_step_size, gamma=config.adam.scheduler_gamma)


def adam_run(raw, init, out, device, monkeypatch, fused, steps, restore=None):
    """A Trainer on the port's Adam (``fused``) or torch's foreach Adam,
    from ``init`` (or the checkpoint ``restore``) through ``train_adam`` to
    ``steps``; returns it and the loss rows of every block, as the device
    gave them."""
    from pinn_depthestimation_tpu_torch.config import parse_config
    from pinn_depthestimation_tpu_torch.optim.adam import FusedAdam
    from pinn_depthestimation_tpu_torch.training import driver

    if not fused:
        monkeypatch.setattr(driver, "make_adam_optimizer", torch_foreach_adam)
    raw = dict(raw, adam_optimizer=dict(raw["adam_optimizer"], max_it=steps))
    trainer = driver.Trainer(parse_config(raw), run_dir=out, echo_every=0,
                             initial_params=init, device=device)
    monkeypatch.undo()
    assert isinstance(trainer.optimizer, FusedAdam) == fused
    if restore is not None:
        trainer.restore(restore)
    rows, record = [], trainer._record
    trainer._record = lambda losses: (rows.append(np.array(losses, copy=True)), record(losses))
    trainer.train_adam()
    return trainer, np.concatenate(rows)


def assert_same_adam_state(a, b):
    from pinn_depthestimation_tpu_torch.models.mlp import PARAM_KEYS

    for k in PARAM_KEYS:
        pa, pb = a.state.params[k], b.state.params[k]
        sa, sb = a.optimizer.state[pa], b.optimizer.state[pb]
        assert torch.equal(pa, pb), k
        assert torch.equal(sa["exp_avg"], sb["exp_avg"]), k
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"]), k
        assert float(sa["step"]) == float(sb["step"]), k
    assert a.optimizer.param_groups[0]["lr"] == b.optimizer.param_groups[0]["lr"]


@pytest.mark.cuda
def test_cuda_fused_adam_equals_torch_foreach_on_odd_leaves(cuda_device):
    """The kernel alone against torch.optim.Adam's foreach path, 30 steps:
    leaves of sizes that no quad divides, as views at odd offsets of one
    buffer (the element-by-element path) and as whole tensors (float4),
    gradients as views of one flat buffer as K1 gives them, and a learning
    rate changed between steps. Every parameter and moment bit for bit."""
    from pinn_depthestimation_tpu_torch.optim import adam

    sizes = [(39_600,), (1, 1_983), (7,), (3,), (4, 5), (1,)]
    gen = torch.Generator(device=cuda_device).manual_seed(31)
    total = sum(int(np.prod(s)) for s in sizes) + 1
    buffer = torch.randn(total, device=cuda_device, generator=gen)
    ours, off = [], 1
    for i, s in enumerate(sizes):
        n = int(np.prod(s))
        # odd leaves: views at an odd offset of one buffer, not 16-byte aligned
        ours.append(buffer[off:off + n].view(s) if i % 2
                    else torch.randn(s, device=cuda_device, generator=gen))
        off += n
    ref = [p.clone() for p in ours]
    fused, torch_adam = adam.FusedAdam(ours, lr=1e-2), torch.optim.Adam(ref, lr=1e-2, foreach=True)
    launches = adam.fused_adam_update.launches
    for t in range(30):
        gflat = torch.randn(total, device=cuda_device, generator=gen) * 10.0 ** (t % 4 - 2)
        off = t % 2
        for p, q in zip(ours, ref):
            n = p.numel()
            p.grad = gflat[off:off + n].view(p.shape)
            q.grad = p.grad.clone()
            off += n
        for group in (fused.param_groups[0], torch_adam.param_groups[0]):
            group["lr"] = 1e-2 * 0.9 ** (t // 7)
        fused.step()
        torch_adam.step()
    torch.cuda.synchronize()
    assert adam.fused_adam_update.launches - launches == 30
    for p, q in zip(ours, ref):
        assert torch.equal(p.detach(), q)
        assert torch.equal(fused.state[p]["exp_avg"], torch_adam.state[q]["exp_avg"])
        assert torch.equal(fused.state[p]["exp_avg_sq"], torch_adam.state[q]["exp_avg_sq"])
        assert float(fused.state[p]["step"]) == 30.0


@pytest.mark.cuda
def test_cuda_fused_adam_takes_what_torch_takes(cuda_device):
    """20 leaves in one group with ``foreach=False``: two launches a step
    (16 + 4), a transposed gradient through a contiguous copy, and a leaf
    whose gradient is None on every third step left alone, step count and
    all. Against torch's foreach Adam given the same gradients made
    contiguous: every parameter, moment and step count bit for bit."""
    from pinn_depthestimation_tpu_torch.optim import adam

    gen = torch.Generator(device=cuda_device).manual_seed(41)
    ours = [torch.randn(3 + 7 * i, 5, device=cuda_device, generator=gen) for i in range(20)]
    ref = [p.clone() for p in ours]
    fused = adam.FusedAdam(ours, lr=1e-2, foreach=False)
    torch_adam = torch.optim.Adam(ref, lr=1e-2, foreach=True)
    launches = adam.fused_adam_update.launches
    for t in range(30):
        for i, (p, q) in enumerate(zip(ours, ref)):
            if i == 11 and t % 3 == 0:
                p.grad = q.grad = None
                continue
            g = torch.randn(p.shape[::-1], device=cuda_device, generator=gen) * 10.0 ** (t % 4 - 2)
            p.grad = g.t() if i == 5 else g.t().contiguous()
            q.grad = p.grad.contiguous()
        fused.step()
        torch_adam.step()
    torch.cuda.synchronize()
    assert adam.fused_adam_update.launches - launches == 60
    for p, q in zip(ours, ref):
        assert torch.equal(p, q)
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(fused.state[p][key], torch_adam.state[q][key])
    assert float(fused.state[ours[11]]["step"]) == 20.0


@pytest.mark.cuda
def test_cuda_fused_adam_equals_torch_foreach_flagship(cuda_device, tmp_path, monkeypatch):
    """The flagship net (2->[20]x100->3 on K1) trained 1,000 steps from one
    seed by the port's Adam and by torch's foreach Adam, StepLR every 300
    steps: every parameter, both moments and every loss row bit for bit,
    one launch a step; and the same again from a checkpoint at step 500
    restored into a new Trainer."""
    import os

    from pinn_depthestimation_tpu_torch.optim import adam
    from pinn_depthestimation_tpu_torch.utils import synthetic

    mat = str(tmp_path / "d.mat")
    synthetic.make_newmethod_mat(mat, nx=41, ny=61, nan_fraction=0.05, seed=7)
    raw = {
        "layers": {"input_features": 2, "hidden_layers": 100, "hidden_width": 20,
                   "output_features": 3, "dropout_rate": 0.0, "init_type": "xavier"},
        "adam_optimizer": {"max_it": 0, "learning_rate": 1e-4,
                           "scheduler_step_size": 300, "scheduler_gamma": 0.8},
        "lbfgs_optimizer": {"max_it": 0},
        "loss": {"weight_fid_loss": 1, "weight_res_loss": 1},
        "data": {"file": mat, "inputs": {"x": {"requires_grad": ["true"]},
                                         "y": {"requires_grad": ["true"]}},
                 "trues": ["U", "V"], "unknowns": ["h"]},
        "seed": 11,
    }
    dirs = {}
    for name in ("torch", "fused", "half"):
        dirs[name] = str(tmp_path / name)
        os.makedirs(dirs[name])
    ref, ref_rows = adam_run(raw, None, dirs["torch"], cuda_device, monkeypatch, False, 1_000)
    before = adam.fused_adam_update.launches
    ours, rows = adam_run(raw, None, dirs["fused"], cuda_device, monkeypatch, True, 1_000)
    assert adam.fused_adam_update.launches - before == 1_000
    assert ours.optimizer.param_groups[0]["lr"] == pytest.approx(1e-4 * 0.8**3)
    assert_same_adam_state(ours, ref)
    assert rows.shape == (1_000, 3) and np.array_equal(rows, ref_rows)

    half, half_rows = adam_run(raw, None, dirs["half"], cuda_device, monkeypatch, True, 500)
    path = half.save("model_500")
    before = adam.fused_adam_update.launches
    resumed, resumed_rows = adam_run(raw, None, dirs["half"], cuda_device, monkeypatch, True,
                                     1_000, restore=path)
    assert adam.fused_adam_update.launches - before == 500
    assert_same_adam_state(resumed, ref)
    assert np.array_equal(np.concatenate([half_rows, resumed_rows]), ref_rows)


@pytest.mark.cuda
def test_cuda_fused_adam_equals_torch_foreach_cmb(cuda_device, tmp_path, monkeypatch):
    """The CMB net (2->[10]x10->6 through K2 + K3 under autograd) on the
    synthetic CMB pair, 100 steps from the same weights: the port's Adam and
    torch's foreach Adam agree bit for bit, one launch a step."""
    import os

    from pinn_depthestimation_tpu_torch.optim import adam
    from pinn_depthestimation_tpu_torch.parity import make_cmb_config
    from pinn_depthestimation_tpu_torch.utils import synthetic

    csv, mat = str(tmp_path / "f.csv"), str(tmp_path / "r.mat")
    synthetic.make_cmb_dataset(csv, mat, nx=41, ny=61, n_csv=120, seed=6, nan_fraction=0.03)
    raw = make_cmb_config(csv, mat, 100, 0, nx=41, ny=61, interval=1, training_points=100)
    init = numpy_params((2,) + (10,) * 10 + (6,), "xavier", seed=1)
    init["b_out"][3] += 1.0  # eta + h away from 0
    runs = {}
    for fused in (False, True):
        out = str(tmp_path / str(fused))
        os.makedirs(out)
        before = adam.fused_adam_update.launches
        runs[fused] = adam_run(raw, init, out, cuda_device, monkeypatch, fused, 100)
        assert runs[fused][0].kernel_plan.fused
        assert adam.fused_adam_update.launches - before == (100 if fused else 0)
    assert_same_adam_state(runs[True][0], runs[False][0])
    assert np.array_equal(runs[True][1], runs[False][1])
