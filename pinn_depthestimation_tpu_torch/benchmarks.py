"""Residual-evaluation benchmark of the port.

Port of the JAX package's ``benchmarks.py::residual_eval_fn`` and
``run_residual_bench``. Metric: collocation-point residual evaluations per
second on one device, on the flagship newmethod network (2 -> [20]x100 -> 3,
tanh, ``continuity_only`` residual: forward + x/y tangents + residual
algebra per point), in true f32.

Unlike the JAX bench, a kernel failure is an error: nothing falls back to
the plain path and reports that instead. ``vs_baseline`` is null: the JAX
bench's target was set for a TPU slice and is no aim for this port.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pinn_depthestimation_tpu_torch.device import resolve_device

FLAGSHIP_SIZES = (2,) + (20,) * 100 + (3,)


def residual_eval_fn(spec, backend: str = "kernel", precision: str = "f32"):
    """Returns ``(f(params, coords) -> per-point residual, backend_name)``.

    ``backend='kernel'`` is K2 with its continuity epilogue
    (``ops.kernels.fused_residual_continuity``; its plain version on CPU
    tensors); ``'plain'`` is that plain version (model + physics in plain
    PyTorch) on any device."""
    from pinn_depthestimation_tpu_torch.ops import kernels

    if backend == "kernel":
        def fn(params, coords):
            return kernels.fused_residual_continuity(params, coords, spec, precision=precision)
        return fn, f"k2-{precision}"
    if backend == "plain":
        def fn(params, coords):
            return kernels.residual_continuity_plain(params, coords, spec)
        return fn, "plain"
    raise ValueError(f"backend must be 'kernel' or 'plain', got {backend!r}")


def flagship_bench_inputs(n_points: int, device: torch.device, seed: int = 0):
    """The bench's ``(spec, params, coords)``: the flagship network with
    weights from a CPU ``torch.Generator`` seeded with ``seed`` (other
    numbers than the JAX bench's ``jax.random`` weights) and ``n_points``
    uniform coordinates in ``[-1, 1]^2`` from ``np.random.RandomState(seed)``."""
    from pinn_depthestimation_tpu_torch.models import MLPSpec, init_mlp_params

    spec = MLPSpec(sizes=FLAGSHIP_SIZES, init_type="xavier")
    params = init_mlp_params(torch.Generator().manual_seed(seed), spec, device=device)
    coords = torch.as_tensor(
        np.random.RandomState(seed).uniform(-1, 1, (n_points, 2)).astype(np.float32)
    ).to(device)
    return spec, params, coords


@torch.no_grad()
def run_residual_bench(
    *,
    n_points: int = 10_000_000,
    backend: str = "kernel",
    precision: str = "f32",
    reps: int = 7,
    device: str | torch.device = "cuda",
    seed: int = 0,
) -> dict:
    """Time ``reps`` synchronised residual evaluations of
    :func:`flagship_bench_inputs` after one warm-up; report the median."""
    dev = resolve_device(device)
    spec, params, coords = flagship_bench_inputs(n_points, dev, seed)
    fn, backend_name = residual_eval_fn(spec, backend, precision)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fc = fn(params, coords)  # warm-up (the first call in a process builds K2)
    sync()
    if fc.shape != (n_points,) or not bool(torch.isfinite(fc).all()):
        raise RuntimeError(f"residual bench: bad output {tuple(fc.shape)} or non-finite values")
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(params, coords)
        sync()
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[len(times) // 2]

    if dev.type == "cuda":
        metric = f"residual_evals_per_sec_per_chip[{backend_name}]"
        where = torch.cuda.get_device_name(dev)
    else:  # the plain version on the host: never a device number
        metric, where = "residual_evals_per_sec[cpu-plain]", "the CPU"
    return {
        "metric": metric,
        "value": round(n_points / dt, 1),
        "unit": f"collocation-point residual evals/s on {where} "
                "(2->[20]x100->3 MLP, continuity)",
        "vs_baseline": None,
    }
