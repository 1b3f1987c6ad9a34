"""Benchmarks of the port.

Port of the JAX package's ``benchmarks.py``:

* ``residual_eval_fn`` / ``run_residual_bench``: collocation-point residual
  evaluations per second on one device, on the flagship newmethod network
  (2 -> [20]x100 -> 3, tanh, ``continuity_only`` residual: forward + x/y
  tangents + residual algebra per point), at the tier ``precision``
  (``f32``, ``f32x3`` or ``bf16``);
* ``run_train_step_bench``: the flagship Adam step in ms per iteration on
  the 81x261 grid with 40.8 % NaN rows (12,516 points), through the
  ``Trainer``'s own step loop — K1, the reduction and the Adam update, at
  the tier ``kernel_precision``;
* ``run_cmb_step_bench``: the CMB Adam step in ms per iteration (the
  reference CMB net 2->[10]x10->6, ``wave_averaged``, 200 fidelity rows and
  ~20,500 collocation points), through the ``Trainer``'s step loop — K2 and
  K3 (``f32``, ``f32x3``) or K4 (``bf16``) for the residual and the
  fidelity term, the physics in PyTorch, Adam;
* ``run_legacy_step_bench``: the legacy Adam step in ms per iteration
  (``examples/legacy.json``'s 5->[20]x20->4 net, ``navier_stokes``, the
  26,691 ``(t, x, y, u, v)`` points of ``synth --legacy --nx 41 --ny 31``
  at K=3 and its 300 fidelity rows), through the same step loop;
* ``run_bench_suite``: the JAX suite's one-line record — the f32 residual
  headline, then ``extras``: the ``f32x3`` and ``bf16`` residual rates, the
  plain version's rate at a quarter of the points under ``plain`` (the port
  has no XLA path: the JAX record's ``xla`` key has no counterpart), the
  flagship Adam step at each tier (``adam_step_ms``, ``adam_step_ms_f32x3``,
  ``adam_step_ms_bf16``) and the CMB Adam step (``cmb_step_ms``). A step
  bench that fails is recorded as ``<name>_error``, as in the JAX suite.

Unlike the JAX bench, a kernel failure is an error: nothing falls back to
the plain path and reports that instead. ``vs_baseline`` is null: the JAX
bench's target was set for a TPU slice and is no aim for this port. The
Trainers the step benches build print to standard error, so a bench's
standard output is its JSON record alone.
"""

from __future__ import annotations

import contextlib
import sys
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
            return kernels.residual_continuity_plain(params, coords, spec, precision)
        return fn, "plain" if precision == "f32" else f"plain-{precision}"
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


def make_train_config(mat_path: str, adam_iters: int, lbfgs_iters: int,
                      tol_grad: float = 1e-5, tol_change: float = 1e-7,
                      hidden_layers: int = 3, hidden_width: int = 16,
                      weight_res: float = 1.0) -> dict:
    """A newmethod config (raw dict) on ``mat_path``: the port's copy of the
    JAX package's ``parity.make_config``."""
    return {
        "layers": {"input_features": 2, "hidden_layers": hidden_layers,
                   "hidden_width": hidden_width,
                   "output_features": 3, "dropout_rate": 0.0, "init_type": "xavier"},
        "adam_optimizer": {"max_it": adam_iters, "learning_rate": 1e-4,
                           "scheduler_step_size": 10000, "scheduler_gamma": 0.8},
        "lbfgs_optimizer": {"max_it": lbfgs_iters, "learning_rate": 1,
                            "max_evaluation": round(lbfgs_iters * 1.25),
                            "history_size": 100, "tolerance_grad": tol_grad,
                            "tolerance_change": tol_change,
                            "line_search_fn": "strong_wolfe"},
        "loss": {"weight_fid_loss": 1, "weight_res_loss": weight_res},
        "data": {"file": mat_path,
                 "inputs": {"x": {"requires_grad": ["true"]},
                            "y": {"requires_grad": ["true"]}},
                 "trues": ["U", "V"], "unknowns": ["h"]},
        "data_test": {"x_min": 25.0, "x_max": 33.0, "y_min": -13.0, "y_max": 13.0},
    }


def run_train_step_bench(
    *,
    n_iters: int = 500,
    reps: int = 3,
    nx: int = 81,
    ny: int = 261,
    hidden_layers: int = 100,
    width: int = 20,
    kernel_precision: str | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Flagship Adam-step time, ms per iteration (median of ``reps`` runs of
    ``n_iters`` steps after one warm-up run), on the workload the reference's
    primary product trains: 2->[20]x100->3 on an 81x261 grid with 40.8 % NaN
    rows (12,516 points shared by the fidelity and residual terms). Each run
    ends in ``torch.cuda.synchronize()``. ``kernel_precision`` overrides the
    config's tier (default ``'auto'``, f32). Returns ``{"ms_per_iter",
    "points", "path", "precision", "device"}``."""
    import os
    import tempfile

    from pinn_depthestimation_tpu_torch.config import parse_config
    from pinn_depthestimation_tpu_torch.training.driver import Trainer
    from pinn_depthestimation_tpu_torch.utils import synthetic

    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with tempfile.TemporaryDirectory() as tmp:
        mat = os.path.join(tmp, "data.mat")
        synthetic.make_newmethod_mat(mat, nx=nx, ny=ny, nan_fraction=0.408, seed=21)
        raw = make_train_config(mat, n_iters, 0, hidden_layers=hidden_layers, hidden_width=width)
        if kernel_precision is not None:
            raw["kernel_precision"] = kernel_precision
        run_dir = os.path.join(tmp, "run")
        os.makedirs(run_dir)
        with contextlib.redirect_stdout(sys.stderr):
            trainer = Trainer(parse_config(raw), run_dir=run_dir, echo_every=0, device=dev)
        trainer._adam_steps(n_iters)  # warm-up (the first call in a process builds K1)
        sync()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            trainer._adam_steps(n_iters)
            sync()
            times.append(time.perf_counter() - t0)
    return {
        "ms_per_iter": sorted(times)[len(times) // 2] / n_iters * 1e3,
        "points": int(trainer.data.residual_input.shape[0]),
        "path": "k1" if trainer.fused_step_fn is not None else "autograd",
        "precision": trainer.config.resolved_kernel_precision(),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def cmb_bench_trainer(tmp: str, n_iters: int, device: torch.device,
                      kernel_precision: str | None = None):
    """A ``Trainer`` on the workload of the JAX package's
    ``run_cmb_step_bench``, its files under ``tmp``: the reference
    ``config_CMB.json`` net (2->[10]x10->6, ``make_cmb_config``'s per-output
    weights), a synthetic CMB pair (``make_cmb_dataset(nx=81, ny=261,
    n_csv=400, seed=6, nan_fraction=0.03)``), 200 fidelity rows and the
    residual grid at interval 1 (~20,500 points after the NaN rows are
    dropped), ``n_iters`` Adam steps, at ``kernel_precision`` if given."""
    import os

    from pinn_depthestimation_tpu_torch.config import parse_config
    from pinn_depthestimation_tpu_torch.parity import make_cmb_config
    from pinn_depthestimation_tpu_torch.training.driver import Trainer
    from pinn_depthestimation_tpu_torch.utils import synthetic

    csv, mat = os.path.join(tmp, "fid.csv"), os.path.join(tmp, "res.mat")
    synthetic.make_cmb_dataset(csv, mat, nx=81, ny=261, n_csv=400, seed=6, nan_fraction=0.03)
    raw = make_cmb_config(csv, mat, n_iters, 0, interval=1, training_points=200)
    if kernel_precision is not None:
        raw["kernel_precision"] = kernel_precision
    run_dir = os.path.join(tmp, "run")
    os.makedirs(run_dir)
    with contextlib.redirect_stdout(sys.stderr):
        return Trainer(parse_config(raw), run_dir=run_dir, echo_every=0, device=device)


def legacy_config(snap_dir: str, csv_path: str, adam_iters: int, lbfgs_iters: int) -> dict:
    """``examples/legacy.json`` as a raw config dict, its files at
    ``snap_dir``/``csv_path`` and its Adam and L-BFGS iterations (the
    example's: 500 and 100, at most 125 evaluations) set: the reference's
    legacy ``config.json`` schema (5->[20]x20->4, xavier, ``navier_stokes``,
    a 41x31 grid of 2 m cells, snapshots 200-220)."""
    return {
        "layers": {"input_features": 5, "hidden_layers": 20, "hidden_width": 20,
                   "output_features": 4, "dropout_rate": 0.0, "init_type": "xavier"},
        "adam_optimizer": {"max_it": adam_iters, "learning_rate": 1e-3,
                           "scheduler_step_size": 200, "scheduler_gamma": 0.8},
        "lbfgs_optimizer": {"max_it": lbfgs_iters, "learning_rate": 1,
                            "max_evaluation": round(lbfgs_iters * 1.25), "history_size": 50,
                            "tolerance_grad": 1e-7, "tolerance_change": 1e-9,
                            "line_search_fn": "strong_wolfe"},
        "loss": {"weight_fid_loss": 1, "weight_res_loss": 1},
        "data_fidelity": {"dir": csv_path, "inputs": ["t", "x", "y", "u", "v"],
                          "outputs": ["h", "z", "u", "v"], "training_points": 500},
        "data_residual": {
            "inputs": {"t": {"file": "t", "requires_grad": ["true"]},
                       "x": {"file": "X", "requires_grad": ["true"]},
                       "y": {"file": "Y", "requires_grad": ["true"]},
                       "u": {"file": "u", "requires_grad": ["false"]},
                       "v": {"file": "v", "requires_grad": ["false"]}},
            "outputs": {"h": {"file": "dep.out"}, "z": {"file": "eta"},
                        "u": {"file": "u"}, "v": {"file": "v"}},
            "numerical_model_snapshots": list(range(200, 221)),
        },
        "numerical_model": {"dir": snap_dir, "nx": 41, "ny": 31, "dx": 2.0, "dy": 2.0,
                            "x_min": 0.0, "x_max": 80.0, "y_min": 0.0, "y_max": 60.0,
                            "interval_x": 1, "interval_y": 1, "dt": 1.0,
                            "number_of_files": 501},
        "physics": "navier_stokes",
    }


def legacy_bench_trainer(tmp: str, n_iters: int, device: torch.device,
                         kernel_precision: str | None = None):
    """A ``Trainer`` on :func:`legacy_config`'s workload, its files under
    ``tmp`` (what ``synth --legacy --nx 41 --ny 31`` writes: 21 snapshots,
    26,691 collocation points, 300 fidelity rows), ``n_iters`` Adam steps, at
    ``kernel_precision`` if given."""
    import os

    from pinn_depthestimation_tpu_torch.config import parse_config
    from pinn_depthestimation_tpu_torch.training.driver import Trainer
    from pinn_depthestimation_tpu_torch.utils import synthetic

    snap_dir, csv = synthetic.make_funwave_snapshot_dir(
        os.path.join(tmp, "beach2d"), nx=41, ny=31, snapshots=tuple(range(200, 221)), seed=0)
    raw = legacy_config(snap_dir, csv, n_iters, 0)
    if kernel_precision is not None:
        raw["kernel_precision"] = kernel_precision
    run_dir = os.path.join(tmp, "run")
    os.makedirs(run_dir)
    with contextlib.redirect_stdout(sys.stderr):
        return Trainer(parse_config(raw), run_dir=run_dir, echo_every=0, device=device)


def _step_bench(make_trainer, n_iters: int, reps: int, kernel_precision, device) -> dict:
    """Adam-step time of ``make_trainer(tmp, n_iters, dev, kernel_precision)``,
    ms per iteration: the median of ``reps`` runs of ``n_iters`` steps after
    one warm-up run, each run ending in ``torch.cuda.synchronize()``."""
    import tempfile

    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with tempfile.TemporaryDirectory() as tmp:
        trainer = make_trainer(tmp, n_iters, dev, kernel_precision)
        trainer._adam_steps(n_iters)  # the first call in a process builds the kernels
        sync()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            trainer._adam_steps(n_iters)
            sync()
            times.append(time.perf_counter() - t0)
    plan = trainer.kernel_plan
    tier = trainer.config.resolved_kernel_precision()
    bwd = "k4" if tier == "bf16" else "k3"  # the tier's default backward
    return {
        "ms_per_iter": sorted(times)[len(times) // 2] / n_iters * 1e3,
        "points": int(trainer.data.residual_input.shape[0]),
        "fidelity_points": int(trainer.data.fidelity_input.shape[0]),
        "path": "k1" if plan.k1 else (f"k2+{bwd}" if plan.fused else "autograd"),
        "precision": tier,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def run_cmb_step_bench(
    *,
    n_iters: int = 500,
    reps: int = 3,
    kernel_precision: str | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """CMB Adam-step time, ms per iteration (median of ``reps`` runs of
    ``n_iters`` steps after one warm-up run), on :func:`cmb_bench_trainer`'s
    workload, at ``kernel_precision`` if given. Each run ends in
    ``torch.cuda.synchronize()``. Returns ``{"ms_per_iter", "points",
    "fidelity_points", "path", "precision", "device"}``."""
    return _step_bench(cmb_bench_trainer, n_iters, reps, kernel_precision, device)


def run_legacy_step_bench(
    *,
    n_iters: int = 500,
    reps: int = 3,
    kernel_precision: str | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """Legacy Adam-step time, ms per iteration, on
    :func:`legacy_bench_trainer`'s workload: :func:`run_cmb_step_bench`'s
    protocol and record."""
    return _step_bench(legacy_bench_trainer, n_iters, reps, kernel_precision, device)


def run_bench_suite(*, n_points: int = 10_000_000, reps: int = 7,
                    device: str | torch.device = "cuda") -> dict:
    """The one-line record of the JAX ``run_bench_suite``: the f32 residual
    headline (:func:`run_residual_bench`) with ``extras``: the ``f32x3`` and
    ``bf16`` residual rates at ``n_points``, the plain version's rate at a
    quarter of them (``plain``, in place of the JAX record's ``xla``), the
    flagship Adam step in ms at the config's default tier, at f32x3 and at
    bf16 (``adam_step_ms``, ``adam_step_ms_f32x3``, ``adam_step_ms_bf16``)
    and the CMB Adam step (``cmb_step_ms``), each at its defaults (500
    steps, median of 3). A step bench that raises
    is recorded as ``<name>_error`` with its message, as the JAX suite does;
    the residual rates raise."""
    headline = run_residual_bench(n_points=n_points, reps=reps, device=device)
    extras: dict = {}
    for tier in ("f32x3", "bf16"):
        extras[tier] = run_residual_bench(n_points=n_points, precision=tier, reps=reps,
                                          device=device)["value"]
    extras["plain"] = run_residual_bench(n_points=max(n_points // 4, 1), backend="plain",
                                         reps=max(reps - 2, 3), device=device)["value"]
    steps = [(f"adam_step_ms{suffix}",
              lambda t=tier: run_train_step_bench(kernel_precision=t, device=device))
             for suffix, tier in (("", None), ("_f32x3", "f32x3"), ("_bf16", "bf16"))]
    steps.append(("cmb_step_ms", lambda: run_cmb_step_bench(device=device)))
    for name, bench in steps:
        try:
            extras[name] = bench()["ms_per_iter"]
        except Exception as e:  # the record keeps the failure, as the JAX suite's
            extras[name + "_error"] = f"{type(e).__name__}: {e}"[:200]
    headline["extras"] = extras
    return headline
