"""The port's CUDA kernel K2 on a card, against its plain PyTorch version.

Every test here carries the ``cuda`` marker and skips without a CUDA device
(a CUDA kernel has no CPU mode). The file imports no JAX, so it runs on the
card's machine, which has none:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: max|kernel - plain| <= 1e-4 * max|plain| + 1e-7 per output —
f32 FMA chains in the kernel against f32 cuBLAS products in the plain
version, over up to 120 layers, agree to ~1e-5 of the output's scale
(``PERF.md``); the 1e-7 only covers outputs that are all near zero.
"""

import numpy as np
import pytest
import torch

from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
from pinn_depthestimation_tpu_torch.ops import kernels


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
    spec = MLPSpec(sizes=(2, 64, 64, 3))  # width not compiled
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
