#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (any failure exits non-zero; nothing falls back to the CPU):

1. device: the card's name and power limit, as nvidia-smi reports them;
2. build: K2 (``csrc/mlp_fwd_tangents.cu``), K1
   (``csrc/continuity_train_step.cu``) and K3 (``csrc/mlp_bwd.cu``) from the
   checkout's sources, every ``nvcc`` started together; registers and
   spills per width;
3. K2 against its plain PyTorch version on the card: the 2->[20]x100->3
   flagship (xavier, seeded numpy weights) at a ragged N for K=0, K=2 and
   the continuity epilogue; a small leaky-relu net (K=1, K=3); a width-32
   stack deeper than one shared-memory chunk holds;
4. the serving path through its entry point: ``synth`` writes the 81x261
   newmethod grid, seeded flagship weights go to a reference-layout .pth,
   and the CLI ``test`` verb predicts the grid (``--save``); predictions
   must be finite, shaped (261, 81) and equal to the plain version;
5. residual evaluation: ``run_residual_bench`` at 10M points, checked
   against the plain version at the same inputs;
6. times (CUDA events, median of reps) of each kernel beside its plain
   version and its bound;
7. K1 against its plain version on the card: the flagship on the 12,516
   points of the 81x261 grid with 40.8 % NaN rows, anchored with two
   observed heads, under parity (every point selected) and parity=false
   (some selected), twice for determinism; width 10 anchorless with three
   heads; width 16 leaky-relu; a width-32 stack deeper than one
   shared-memory chunk; a batch with masked rows;
8. the training path through its entry points: CLI ``train`` on
   ``examples/newmethod.json`` with the synthetic grid (Adam, the snapshot,
   L-BFGS, ``model.npz``), then CLI ``test`` on the trained model; the log,
   the files and the loss trend are checked, and K1's launch count must
   equal the number of loss evaluations;
9. iteration-1 equality and a 20-step Adam prefix of a Trainer on K1
   against one on the plain autograd path, from the same numpy weights;
10. training times: K1 beside its plain version and bound, the flagship
   Adam step (``run_train_step_bench``) and L-BFGS evaluations per second
   (median, min and max of 5 runs of the configured 500-iteration phase);
11. K3 (``csrc/mlp_bwd.cu``) against its plain version on the card: the
   2->[10]x10->6 CMB net at K=2 on the ~20,500 points of the CMB bench grid
   and at K=0 on its 200 fidelity rows, the flagship at K=2 on the 12,516
   grid points, a leaky-relu net at K=1 and K=3, a width-32 stack deeper
   than one shared-memory chunk, a ragged N; two launches bit-identical;
12. the CMB training path through its entry points: ``synth`` writes the
   CMB pair, CLI ``train`` runs ``examples/cmb.json`` on it (interval 1,
   300 Adam steps, L-BFGS cut to 20 iterations), CLI ``test`` serves the
   trained model; the log, the files, the loss trend and the launch counts
   (K3 == 2 x loss evaluations) are checked; then iteration 1 and a
   20-step Adam prefix of a K2+K3 Trainer against an autograd Trainer from
   the same numpy weights, under parity and parity=false;
13. times: K3 beside its plain version and bound at the CMB and flagship
   shapes, and the CMB Adam step (``run_cmb_step_bench``) with K2 + K3's
   share of it.

Launch counts are set to 0 before phase 4 and read after phase 5 (the
serving path), set to 0 again before phase 8 and read after it (the
flagship training path), and again before phase 12's CLI ``train`` and
read after its CLI ``test`` (the CMB path): each kernel must have launched
on each path that runs it.
The last two lines are the ``kernels`` JSON object and ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

REPLACES = "pinn_depthestimation_tpu/ops/kernels.py:217"  # _mlp_kernel
K2_SOURCE = "pinn_depthestimation_tpu_torch/csrc/mlp_fwd_tangents.cu"
K1_REPLACES = "pinn_depthestimation_tpu/ops/kernels_step.py:205"  # _stats_and_grads
K1_SOURCE = "pinn_depthestimation_tpu_torch/csrc/continuity_train_step.cu"
K3_REPLACES = "pinn_depthestimation_tpu/ops/kernels_vjp.py:701"  # packed_mlp_bwd(impl='stream')
K3_SOURCE = "pinn_depthestimation_tpu_torch/csrc/mlp_bwd.cu"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# kernel vs plain: max|kernel - plain| <= REL_TOL * max|plain| + ABS_TOL. f32 FMA
# chains against f32 cuBLAS products over ~100 layers agree to ~1e-5 of the
# output's scale; ABS_TOL only covers outputs that are all near zero.
REL_TOL, ABS_TOL = 1e-4, 1e-7


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def numpy_params(sizes, init_type: str, seed: int) -> dict:
    """Seeded numpy weights in the exchange layout: xavier/kaiming uniform
    weights and small nonzero biases (so the bias paths are checked too)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    d_in, W, d_out, n_stack = sizes[0], sizes[1], sizes[-1], len(sizes) - 3

    def w(shape, fan_in, fan_out):
        b = math.sqrt(6.0 / (fan_in + fan_out)) if init_type == "xavier" else math.sqrt(6.0 / fan_in)
        return rng.uniform(-b, b, shape).astype(np.float32)

    return {
        "w_in": w((d_in, W), d_in, W),
        "b_in": rng.uniform(-0.1, 0.1, W).astype(np.float32),
        "w_hidden": w((n_stack, W, W), W, W),
        "b_hidden": rng.uniform(-0.1, 0.1, (n_stack, W)).astype(np.float32),
        "w_out": w((W, d_out), W, d_out),
        "b_out": rng.uniform(-0.2, 0.2, d_out).astype(np.float32),
    }


def compare(name: str, got, want) -> float:
    """Max abs error of kernel vs plain; fails above REL_TOL x max|plain| + ABS_TOL."""
    import torch

    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != plain {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite kernel output")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    tol = REL_TOL * scale + ABS_TOL
    print(f"  {name}: max_abs_err {err:.3e}  max_rel_err {err / max(scale, 1e-30):.3e}  "
          f"tolerance {tol:.3e} (= {REL_TOL:g} x max|plain| {scale:.3e} + {ABS_TOL:g})")
    if not err <= tol:
        fail(f"{name}: kernel disagrees with its plain version")
    return err


def cuda_ms(fn, reps: int, inner: int) -> float:
    """Median over ``reps`` of CUDA-event time per call, ``inner`` calls each,
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return sorted(times)[len(times) // 2]


def host_ms(fn, reps: int) -> float:
    """Median host-clock ms of ``reps`` calls after one warm-up; each call
    ends with its results on the host, so no synchronise is missing."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def k2_flops(spec, n_points: int, n_tangents: int, epilogue: bool) -> float:
    W = spec.width
    per_point = 2 * (spec.d_in * W + (spec.n_hidden - 1) * W * W + W * spec.d_out) * (1 + n_tangents)
    return float(n_points) * (per_point + (7 if epilogue else 0))


def k2_bytes(params, n_points: int, spec, out_floats_per_point: int) -> float:
    weights = sum(int(t.numel()) for t in params.values()) * 4
    return float(weights + n_points * (spec.d_in + out_floats_per_point) * 4)


def k1_flops(spec, n_points: int) -> float:
    """K1's operations: the forward with two tangents, 2*(d_in*W + (L-1)*W^2
    + W*d_out)*3 per point, and the backward, 2*2*3*((L-1)*W^2 + W*d_out) +
    2*d_in*W per point (the weight-gradient and cotangent products of every
    layer; the input layer has no cotangent product); tanh not counted."""
    W, d_in, d_out, n_stack = spec.width, spec.d_in, spec.d_out, spec.n_hidden - 1
    fwd = 2 * (d_in * W + n_stack * W * W + W * d_out) * 3
    bwd = 2 * 2 * 3 * (n_stack * W * W + W * d_out) + 2 * d_in * W
    return float(n_points) * (fwd + bwd)


def k1_bytes(params, n_points: int, d_in: int, n_true: int) -> float:
    """Each input read once (coords, trues, sel, mask, the weights) and each
    output written once (the gradients, the statistics)."""
    weights = sum(int(t.numel()) for t in params.values()) * 4
    return float(2 * weights + 8 * 4 + n_points * (d_in + n_true + 2) * 4)


def newmethod_config(tmp: str, repo: str, **overrides) -> str:
    """``examples/newmethod.json`` on the synthetic 81x261 grid with 40.8 %
    NaN rows (12,516 training points), with ``overrides`` merged in; returns
    the config path."""
    from pinn_depthestimation_tpu_torch.utils import synthetic

    mat = os.path.join(tmp, "grid_0408.mat")
    if not os.path.exists(mat):
        synthetic.make_newmethod_mat(mat, nx=81, ny=261, nan_fraction=0.408, seed=21)
    with open(os.path.join(repo, "examples", "newmethod.json")) as f:
        raw = json.load(f)
    raw["data"]["file"] = mat
    raw["data_test"]["file"] = mat
    for key, value in overrides.items():
        if isinstance(value, dict):
            raw[key] = {**raw.get(key, {}), **value}
        else:
            raw[key] = value
    path = os.path.join(tmp, f"newmethod_{len(os.listdir(tmp))}.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def k1_cases(dev, repo: str, tmp: str):
    """Phase 7's cases ``[(name, spec, params or None, StepBatch)]``, the
    grid's point count and the flagship weights: the flagship on the 12,516
    points of the 81x261 grid with 40.8 % NaN rows, anchored with two
    observed heads, under parity (every point selected) and parity=false
    (some selected); width 10 anchorless with three heads; width 16
    leaky-relu; a width-32 stack deeper than one shared-memory chunk; a
    batch with masked rows."""
    import numpy as np
    import torch

    from pinn_depthestimation_tpu_torch import benchmarks
    from pinn_depthestimation_tpu_torch.config import load_config
    from pinn_depthestimation_tpu_torch.data import load_training_data
    from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
    from pinn_depthestimation_tpu_torch.ops import kernels_step

    flagship = MLPSpec(sizes=benchmarks.FLAGSHIP_SIZES, init_type="xavier")
    td = load_training_data(load_config(newmethod_config(tmp, repo)))
    coords = torch.as_tensor(td.residual_input).to(dev)
    trues = torch.as_tensor(td.fidelity_true).to(dev)
    n_grid = coords.shape[0]
    ones = torch.ones(n_grid, device=dev)
    lo, hi = td.input_min_max["x"]
    x_anchor = 2 * (25.5 - lo) / (hi - lo) - 1  # parity=false: physical 25.5 m
    rng = np.random.RandomState(11)

    def batch(x, tr, sel, mask, n_true, has_anchor):
        weights = [1.0, 1.0, 1.0][:n_true]
        return kernels_step.make_step_batch(x, tr, sel, mask, weights, n_true, 1.0, 1.0,
                                            anchor_depth=0.75, has_anchor=has_anchor)

    def rand_batch(n, n_true, has_anchor, masked):
        x = torch.as_tensor(rng.uniform(-1, 1, (n, 2)).astype(np.float32)).to(dev)
        tr = torch.as_tensor((rng.randn(n, n_true) * 0.1).astype(np.float32)).to(dev)
        m = torch.as_tensor((rng.rand(n) > (0.15 if masked else -1)).astype(np.float32)).to(dev)
        return batch(x, tr, (x[:, 0] < 0.3).float() * m, m, n_true, has_anchor)

    flag_params = params_from_numpy(numpy_params(flagship.sizes, "xavier", 4), dev)
    cases = [
        ("flagship, parity (all selected)", flagship, flag_params,
         batch(coords, trues, (coords[:, 0] < 25.5).float(), ones, 2, True)),
        ("flagship, parity=false", flagship, flag_params,
         batch(coords, trues, (coords[:, 0] < x_anchor).float(), ones, 2, True)),
        ("width 10, anchorless, 3 heads", MLPSpec(sizes=(2,) + (10,) * 10 + (3,)), None,
         rand_batch(3_001, 3, False, False)),
        ("width 16, leaky-relu", MLPSpec(sizes=(2,) + (16,) * 6 + (3,), init_type="kaiming"),
         None, rand_batch(2_000, 2, True, False)),
        ("width 32 x 120 (several smem chunks)", MLPSpec(sizes=(2,) + (32,) * 120 + (3,)),
         None, rand_batch(1_500, 2, True, False)),
        ("flagship, masked rows", flagship, flag_params, rand_batch(4_099, 2, True, True)),
    ]
    cases = [(name, spec, params or params_from_numpy(numpy_params(spec.sizes, spec.init_type, 5), dev), b)
             for name, spec, params, b in cases]
    return cases, n_grid, flag_params


def training_phases(dev, repo: str, bound) -> dict:
    """Phases 7-10; returns K1's entry of the ``kernels`` line."""
    import numpy as np
    import torch

    from pinn_depthestimation_tpu_torch import benchmarks, cli
    from pinn_depthestimation_tpu_torch.config import load_config
    from pinn_depthestimation_tpu_torch.models import MLPSpec
    from pinn_depthestimation_tpu_torch.ops import kernels, kernels_step
    from pinn_depthestimation_tpu_torch.training.driver import Trainer
    from pinn_depthestimation_tpu_torch.training.logging_utils import read_log

    flagship = MLPSpec(sizes=benchmarks.FLAGSHIP_SIZES, init_type="xavier")
    with tempfile.TemporaryDirectory() as tmp:
        # 7. K1 vs plain ---------------------------------------------------
        print("== phase 7: K1 against its plain version on the card")
        cases, n_grid, flag_params = k1_cases(dev, repo, tmp)
        err_k1 = 0.0
        for name, spec, params, b in cases:
            chunk = kernels_step.k1_library().libs[spec.width].k1_chunk_layers(spec.n_hidden - 1)
            print(f" {name}: sizes {spec.d_in}->[{spec.width}]x{spec.n_hidden}->{spec.d_out} "
                  f"{spec.init_type}, N={b.coords.shape[0]}, selected {int(b.n_sel)}, "
                  f"{chunk} hidden layers per smem chunk")
            (t1, (f1, r1)), g1 = kernels_step.fused_loss_and_grad(params, b, spec)
            torch.cuda.synchronize()
            (t2, (f2, r2)), g2 = kernels_step.fused_loss_and_grad_plain(params, b, spec)
            errs = [compare(f"{term}", got, want)
                    for term, got, want in (("total", t1, t2), ("fidelity", f1, f2),
                                            ("residual", r1, r2))]
            errs += [compare(f"d{k}", g1[k], g2[k]) for k in kernels_step.FLAT_KEYS]
            if spec.sizes == flagship.sizes:
                err_k1 = max(err_k1, *errs)
                (t3, _), g3 = kernels_step.fused_loss_and_grad(params, b, spec)
                if not (torch.equal(t1, t3) and all(torch.equal(g1[k], g3[k]) for k in g1)):
                    fail(f"{name}: two K1 launches on the same inputs differ")
                print("  two launches bit-identical")
        flag_batch = cases[0][3]

        # 8. the training path ---------------------------------------------
        print("== phase 8: training path (CLI train, then CLI test on the trained model)")
        cfg_path = newmethod_config(
            tmp, repo, adam_optimizer={"max_it": 300}, snapshot_iteration=300,
            # tolerances below what 300 Adam steps reach, so L-BFGS runs
            lbfgs_optimizer={"max_it": 20, "max_evaluation": 25, "tolerance_grad": 1e-9,
                             "tolerance_change": 1e-12})
        run_name = "train_smoke"
        kernels_step.fused_loss_and_grad.launches = 0
        kernels.mlp_fwd_tangents.launches = 0
        kernels.fused_residual_continuity.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(["train", "--config", cfg_path, "--log-root", tmp, "--run-name", run_name,
                       "--device", "cuda", "--debug"])
        train_s = time.perf_counter() - t0
        if rc != 0:
            fail(f"CLI train exited {rc}")
        run_dir = os.path.join(tmp, run_name)
        model = os.path.join(run_dir, "model.npz")
        pred_out = os.path.join(tmp, "pred_trained.mat")
        rc = cli.main(["test", "--config", cfg_path, "--model", model, "--save", pred_out,
                       "--device", "cuda", "--debug"])
        if rc != 0:
            fail(f"CLI test on the trained model exited {rc}")
        train_launches = {
            "fused_loss_and_grad": kernels_step.fused_loss_and_grad.launches,
            "mlp_fwd_tangents": kernels.mlp_fwd_tangents.launches,
        }
        print(f"  training-path launches: {train_launches}")
        epochs, _, _, totals = read_log(run_dir)
        n_evals = len(epochs)
        if epochs != list(range(1, n_evals + 1)) or n_evals < 302:
            fail(f"log.txt rows are not epochs 1..n with n >= 302: {epochs[:3]}..{epochs[-3:]}")
        if not all(math.isfinite(v) for v in totals):
            fail("log.txt holds a non-finite total")
        if not totals[299] < totals[0]:
            fail(f"Adam did not lower the loss: {totals[0]} -> {totals[299]}")
        if not min(totals[300:]) <= totals[299]:
            fail(f"L-BFGS minimum {min(totals[300:])} above the last Adam total {totals[299]}")
        for fname in ("model.npz", "data_at300.mat", "log.txt"):
            if not os.path.exists(os.path.join(run_dir, fname)):
                fail(f"the run wrote no {fname}")
        if train_launches["fused_loss_and_grad"] != n_evals:
            fail(f"K1 launched {train_launches['fused_loss_and_grad']} times for {n_evals} "
                 "loss evaluations: some evaluation bypassed the kernel")
        if train_launches["mlp_fwd_tangents"] < 2:
            fail("the snapshot and CLI test did not both go through K2")
        from scipy.io import loadmat

        served = loadmat(pred_out)
        for key in ("U", "V", "h"):
            arr = served[f"pred_{key}"]
            if arr.shape != (261, 81) or not np.isfinite(arr).all():
                fail(f"trained model served pred_{key} of shape {arr.shape}, finite "
                     f"{bool(np.isfinite(arr).all())}")
        print(f"  {n_evals} loss evaluations (300 Adam + {n_evals - 300} L-BFGS), total "
              f"{totals[0]:.5e} -> {totals[299]:.5e} (Adam) -> {min(totals[300:]):.5e} "
              f"(L-BFGS); CLI train wall time {train_s:.2f} s")

        # 9. iteration-1 equality and a tracked prefix ----------------------
        print("== phase 9: iteration 1 and a 20-step Adam prefix, K1 against the plain path")
        init = numpy_params(flagship.sizes, "xavier", 6)
        runs = {}
        for mode in ("on", "off"):
            path = newmethod_config(tmp, repo, fused_kernel=mode)
            os.makedirs(os.path.join(tmp, f"prefix_{mode}"))
            tr = Trainer(load_config(path), run_dir=os.path.join(tmp, f"prefix_{mode}"),
                         echo_every=0, initial_params=init, device=dev)
            losses = tr._adam_steps(20).cpu().numpy()
            runs[mode] = (losses, {k: v.clone() for k, v in tr.state.params.items()})
        (l_on, p_on), (l_off, p_off) = runs["on"], runs["off"]
        rel1 = np.abs(l_on[0] - l_off[0]) / np.abs(l_off[0])
        print(f"  iteration 1 (fid, res, total): K1 {l_on[0]} plain {l_off[0]} rel {rel1}")
        if not (rel1 <= 1e-5).all():
            fail("iteration-1 losses of K1 and the plain path differ by more than 1e-5")
        dp = max(float((p_on[k] - p_off[k]).abs().max()) for k in p_on)
        drift = float(np.max(np.abs(l_on - l_off) / np.abs(l_off)))
        # K1's gradients agree with the plain path's to ~1e-6 of their scale;
        # through 20 Adam steps of lr 1e-4 that kept the parameters within
        # 4.5e-8 on an H100. 1e-6 is 0.05 % of the largest move 20 steps
        # can make (20 * lr); one gradient entry flipping sign on noise
        # would break it, and the run would say so.
        prefix_tol = 1e-6
        print(f"  after 20 steps: max |p_K1 - p_plain| {dp:.3e} (tolerance {prefix_tol:.1e}); "
              f"max relative loss gap over the prefix {drift:.3e}")
        if not dp <= prefix_tol:
            fail("the 20-step Adam prefix of K1 and the plain path diverged")

        # 10. training times -------------------------------------------------
        print("== phase 10: training times")
        ms_k1 = cuda_ms(lambda: kernels_step.fused_loss_and_grad(flag_params, flag_batch, flagship), 7, 20)
        plain_k1 = cuda_ms(lambda: kernels_step.fused_loss_and_grad_plain(flag_params, flag_batch, flagship), 5, 3)
        b_k1, by_k1 = bound(k1_flops(flagship, n_grid), k1_bytes(flag_params, n_grid, 2, 2))
        step = benchmarks.run_train_step_bench(device=dev)
        print(f"  K1 + reduction, {n_grid} points: {ms_k1:.4f} ms (plain {plain_k1:.4f} ms, bound "
              f"{b_k1:.4f} ms by {by_k1}, {b_k1 / ms_k1:.1%} of bound; "
              f"{k1_flops(flagship, 1):,.0f} FLOP per point)")
        print(f"  run_train_step_bench: {json.dumps(step)}; K1 is "
              f"{ms_k1 / step['ms_per_iter']:.1%} of the Adam step")
        # the L-BFGS phase as examples/newmethod.json configures it (500
        # iterations, 625 evaluations), its tolerances lowered so that it
        # runs to those limits; several repetitions from the same weights
        def lbfgs_phase(max_it: int, max_eval: int):
            path = newmethod_config(tmp, repo, adam_optimizer={"max_it": 0},
                                    lbfgs_optimizer={"max_it": max_it, "max_evaluation": max_eval,
                                                     "tolerance_grad": 1e-9,
                                                     "tolerance_change": 1e-12})
            run = os.path.join(tmp, f"lbfgs_timing_{len(os.listdir(tmp))}")
            os.makedirs(run)
            tr = Trainer(load_config(path), run_dir=run, echo_every=0, initial_params=init,
                         device=dev)
            t0 = time.perf_counter()
            tr.train_lbfgs()
            torch.cuda.synchronize()
            return tr.state.iteration, time.perf_counter() - t0, tr.lbfgs_stop_reason

        lbfgs_phase(30, 40)  # warm-up: allocations, first launches
        lbfgs_reps = [lbfgs_phase(500, 625) for _ in range(5)]
        rates = sorted(n / s for n, s, _ in lbfgs_reps)
        lbfgs_rate = rates[len(rates) // 2]
        n_lbfgs = [n for n, _, _ in lbfgs_reps]
        print(f"  L-BFGS (500 iterations / 625 evaluations configured), 5 repetitions: "
              f"evaluations {n_lbfgs} ({lbfgs_reps[0][2]}), seconds "
              f"{[round(s, 4) for _, s, _ in lbfgs_reps]}; evaluations/s median "
              f"{lbfgs_rate:.1f}, min {rates[0]:.1f}, max {rates[-1]:.1f} (host clock, "
              f"{ms_k1 * lbfgs_rate / 1e3:.1%} of it in K1)")

    return {"name": "k1_continuity_train_step", "route": "cuda", "source": K1_SOURCE,
            "replaces": K1_REPLACES, "launches": train_launches["fused_loss_and_grad"],
            "max_abs_err": err_k1, "ms": ms_k1, "plain_ms": plain_k1, "bound_ms": b_k1,
            "bound_by": by_k1, "points": n_grid, "library_ms": None,
            "adam_ms_per_iter": step["ms_per_iter"],
            "lbfgs_evals_per_s": lbfgs_rate,
            "lbfgs_evals_per_s_min_max": [rates[0], rates[-1]]}


def k3_flops(spec, n_points: int, n_tangents: int) -> float:
    """K3's operations: the forward replay with K tangents, 2*(d_in*W +
    (L-1)*W^2 + W*d_out)*(1+K) per point, and the backward, 2*2*(1+K)*((L-1)*W^2
    + W*d_out) + 2*d_in*W per point; tanh not counted."""
    W, d_in, d_out, n_stack = spec.width, spec.d_in, spec.d_out, spec.n_hidden - 1
    fwd = 2 * (d_in * W + n_stack * W * W + W * d_out) * (1 + n_tangents)
    bwd = 2 * 2 * (1 + n_tangents) * (n_stack * W * W + W * d_out) + 2 * d_in * W
    return float(n_points) * (fwd + bwd)


def k3_bytes(params, spec, n_points: int, n_tangents: int) -> float:
    """Each input read once (coords, ybar, dybar, the weights) and each
    output written once (the gradients)."""
    weights = sum(int(t.numel()) for t in params.values()) * 4
    return float(2 * weights + n_points * (spec.d_in + (1 + n_tangents) * spec.d_out) * 4)


def cmb_config(tmp: str, repo: str, csv: str, mat: str, **overrides) -> str:
    """``examples/cmb.json`` with its files replaced by ``csv``/``mat`` and
    ``overrides`` merged in; returns the config path."""
    with open(os.path.join(repo, "examples", "cmb.json")) as f:
        raw = json.load(f)
    raw["data_fidelity"]["file"] = csv
    raw["data_residual"]["file"] = mat
    raw["data_test"]["file"] = mat
    for key, value in overrides.items():
        if isinstance(value, dict):
            raw[key] = {**raw.get(key, {}), **value}
        else:
            raw[key] = value
    path = os.path.join(tmp, f"cmb_{len(os.listdir(tmp))}.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def cmb_phases(dev, repo: str, bound) -> dict:
    """Phases 11-13; returns K3's entry of the ``kernels`` line."""
    import numpy as np
    import torch
    from scipy.io import loadmat

    from pinn_depthestimation_tpu_torch import benchmarks, cli
    from pinn_depthestimation_tpu_torch.config import load_config, parse_config
    from pinn_depthestimation_tpu_torch.data import load_training_data
    from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
    from pinn_depthestimation_tpu_torch.ops import kernels, kernels_vjp
    from pinn_depthestimation_tpu_torch.parity import make_cmb_config
    from pinn_depthestimation_tpu_torch.training.driver import Trainer
    from pinn_depthestimation_tpu_torch.training.logging_utils import read_log
    from pinn_depthestimation_tpu_torch.utils import synthetic

    cmb_net = MLPSpec(sizes=(2,) + (10,) * 10 + (6,), init_type="xavier")
    flagship = MLPSpec(sizes=benchmarks.FLAGSHIP_SIZES, init_type="xavier")
    with tempfile.TemporaryDirectory() as tmp:
        # the workload of run_cmb_step_bench: ~20,500 grid points, 200 rows
        csv, mat = os.path.join(tmp, "fid.csv"), os.path.join(tmp, "res.mat")
        synthetic.make_cmb_dataset(csv, mat, nx=81, ny=261, n_csv=400, seed=6,
                                   nan_fraction=0.03)
        bench_raw = make_cmb_config(csv, mat, 0, 0, interval=1, training_points=200)
        td = load_training_data(parse_config(bench_raw))
        res_pts = torch.as_tensor(td.residual_input).to(dev)
        fid_pts = torch.as_tensor(td.fidelity_input).to(dev)
        n_res, n_fid = res_pts.shape[0], fid_pts.shape[0]

        # 11. K3 vs plain ------------------------------------------------------
        print("== phase 11: K3 against its plain version on the card")
        rng = np.random.RandomState(13)
        flag_pts = torch.as_tensor(  # phase 7's 12,516 grid points
            load_training_data(load_config(newmethod_config(tmp, repo))).residual_input).to(dev)

        def rand_pts(n, d_in):
            return torch.as_tensor(rng.uniform(-1, 1, (n, d_in)).astype(np.float32)).to(dev)

        cases = [
            ("CMB net, residual grid", cmb_net, res_pts, 2),
            ("CMB net, fidelity rows", cmb_net, fid_pts, 0),
            ("flagship, train grid", flagship, flag_pts, 2),
            ("leaky-relu, K=1", MLPSpec(sizes=(3,) + (16,) * 6 + (4,), init_type="kaiming"),
             rand_pts(4_099, 3), 1),
            ("leaky-relu, K=3", MLPSpec(sizes=(3,) + (16,) * 6 + (4,), init_type="kaiming"),
             rand_pts(4_099, 3), 3),
            ("width 32 x 120 (several smem chunks)", MLPSpec(sizes=(2,) + (32,) * 120 + (5,)),
             rand_pts(1_500, 2), 2),
            ("CMB net, ragged N", cmb_net, rand_pts(1_001, 2), 2),
        ]
        main_path = ("CMB net, residual grid", "CMB net, fidelity rows")
        inputs, err_k3 = {}, 0.0
        for name, spec, x, kt in cases:
            params = params_from_numpy(numpy_params(spec.sizes, spec.init_type, 8), dev)
            n = x.shape[0]
            ybar = torch.as_tensor(rng.randn(n, spec.d_out).astype(np.float32)).to(dev)
            dybar = torch.as_tensor(rng.randn(kt, n, spec.d_out).astype(np.float32)).to(dev)
            chunk = kernels_vjp.k3_library().libs[spec.width].k3_chunk_layers(spec.n_hidden - 1, kt)
            print(f" {name}: sizes {spec.d_in}->[{spec.width}]x{spec.n_hidden}->{spec.d_out} "
                  f"{spec.init_type}, K={kt}, N={n}, {chunk} hidden layers per smem chunk")
            g1 = kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, spec, kt)
            torch.cuda.synchronize()
            g2 = kernels_vjp.packed_mlp_bwd_plain(params, x, ybar, dybar, spec, kt)
            errs = [compare(f"d{k}", g1[k], g2[k]) for k in g1]
            if name in main_path:
                err_k3 = max(err_k3, *errs)
            g3 = kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, spec, kt)
            if not all(torch.equal(g1[k], g3[k]) for k in g1):
                fail(f"{name}: two K3 launches on the same inputs differ")
            print("  two launches bit-identical")
            inputs[name] = (params, x, ybar, dybar, spec, kt)

        # 12. the CMB training path ---------------------------------------------
        print("== phase 12: CMB training path (CLI synth, train, then test on the trained model)")
        synth = os.path.join(tmp, "synth")
        if cli.main(["synth", "--out", synth]) != 0:
            fail("synth failed")
        synth_csv, synth_mat = (os.path.join(synth, f) for f in ("input_fid.csv", "input_res.mat"))
        cfg_path = cmb_config(
            tmp, repo, synth_csv, synth_mat, adam_optimizer={"max_it": 300},
            data_residual={"interval_x": 1, "interval_y": 1},
            # tolerances below what 300 Adam steps reach, so L-BFGS runs
            lbfgs_optimizer={"max_it": 20, "max_evaluation": 25, "tolerance_grad": 1e-9,
                             "tolerance_change": 1e-12})
        run_name = "cmb_smoke"
        kernels.mlp_fwd_tangents.launches = 0
        kernels_vjp.packed_mlp_bwd.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(["train", "--config", cfg_path, "--log-root", tmp, "--run-name", run_name,
                       "--device", "cuda", "--debug"])
        train_s = time.perf_counter() - t0
        if rc != 0:
            fail(f"CLI train on the CMB config exited {rc}")
        train_launches = {"k2": kernels.mlp_fwd_tangents.launches,
                          "k3": kernels_vjp.packed_mlp_bwd.launches}
        run_dir = os.path.join(tmp, run_name)
        pred_out = os.path.join(tmp, "pred_cmb.mat")
        rc = cli.main(["test", "--config", cfg_path, "--model", os.path.join(run_dir, "model.npz"),
                       "--save", pred_out, "--device", "cuda", "--debug"])
        if rc != 0:
            fail(f"CLI test on the trained CMB model exited {rc}")
        predict_launches = kernels.mlp_fwd_tangents.launches - train_launches["k2"]
        launches = {"k2": kernels.mlp_fwd_tangents.launches,
                    "k3": kernels_vjp.packed_mlp_bwd.launches}
        print(f"  CMB-path launches: {launches} (CLI train {train_launches}, CLI test "
              f"{predict_launches} K2)")
        epochs, _, _, totals = read_log(run_dir)
        n_evals = len(epochs)
        if epochs != list(range(1, n_evals + 1)) or n_evals < 302:
            fail(f"log.txt rows are not epochs 1..n with n >= 302: {epochs[:3]}..{epochs[-3:]}")
        if not all(math.isfinite(v) for v in totals):
            fail("log.txt holds a non-finite total")
        if not totals[299] < totals[0]:
            fail(f"Adam did not lower the CMB loss: {totals[0]} -> {totals[299]}")
        if not min(totals[300:]) <= totals[299]:
            fail(f"L-BFGS minimum {min(totals[300:])} above the last Adam total {totals[299]}")
        for fname in ("model.npz", "log.txt"):
            if not os.path.exists(os.path.join(run_dir, fname)):
                fail(f"the CMB run wrote no {fname}")
        if launches["k3"] != 2 * n_evals:
            fail(f"K3 launched {launches['k3']} times for {n_evals} loss evaluations "
                 "(2 per evaluation): some evaluation bypassed the kernel")
        if train_launches["k2"] != 2 * n_evals or predict_launches < 1:
            fail(f"K2 launched {train_launches['k2']} times in training for {n_evals} loss "
                 f"evaluations (2 per evaluation) and {predict_launches} in CLI test")
        served, grid_x = loadmat(pred_out), loadmat(synth_mat)["x"]
        for key in ("h", "U", "V", "eta_mean", "Hrms", "k"):
            arr = served[f"pred_{key}"]
            if arr.shape != (261, 81) or not np.array_equal(np.isnan(arr), np.isnan(grid_x)):
                fail(f"trained CMB model served pred_{key} of shape {arr.shape}, with NaN "
                     "elsewhere than at the grid's masked cells")
        print(f"  {n_evals} loss evaluations (300 Adam + {n_evals - 300} L-BFGS) on "
              f"{load_training_data(load_config(cfg_path)).residual_input.shape[0]} collocation "
              f"points, total {totals[0]:.5e} -> {totals[299]:.5e} (Adam) -> "
              f"{min(totals[300:]):.5e} (L-BFGS); CLI train wall time {train_s:.2f} s")

        # iteration 1 and a tracked prefix, K2 + K3 against autograd ----------
        print("== phase 12b: iteration 1 and a 20-step Adam prefix, K2 + K3 against autograd")
        init = numpy_params(cmb_net.sizes, "xavier", 6)
        init["b_out"][3] += 1.0  # the eta head shifted, so eta + h stays away from 0
        prefix = {}
        for parity in (True, False):
            runs = {}
            for mode in ("auto", "off"):
                raw = dict(make_cmb_config(csv, mat, 20, 0, interval=1, training_points=200),
                           fused_kernel=mode, parity=parity)
                run = os.path.join(tmp, f"prefix_{parity}_{mode}")
                os.makedirs(run)
                tr = Trainer(parse_config(raw), run_dir=run, echo_every=0, initial_params=init,
                             device=dev)
                if tr.kernel_plan.fused != (mode == "auto"):
                    fail(f"fused_kernel={mode!r} chose {tr.kernel_plan} on the card")
                losses = tr._adam_steps(20).cpu().numpy()
                runs[mode] = (losses, {k: v.clone() for k, v in tr.state.params.items()})
            (l_on, p_on), (l_off, p_off) = runs["auto"], runs["off"]
            rel1 = np.abs(l_on[0] - l_off[0]) / np.abs(l_off[0])
            dp = max(float((p_on[k] - p_off[k]).abs().max()) for k in p_on)
            drift = float(np.max(np.abs(l_on - l_off) / np.abs(l_off)))
            print(f"  parity={parity}: iteration 1 (fid, res, total): K2+K3 {l_on[0]} "
                  f"autograd {l_off[0]} rel {rel1}; after 20 steps max |p_kernels - p_plain| "
                  f"{dp:.3e}, max relative loss gap {drift:.3e}")
            if not (rel1 <= 1e-5).all():
                fail("iteration-1 CMB losses of K2+K3 and autograd differ by more than 1e-5")
            prefix[parity] = dp
        # K2 + K3 against autograd kept the parameters within 2.98e-8 after
        # 20 steps on an H100, under both parity modes; 1e-6 is a ~34x
        # margin and 0.05 % of the largest move 20 steps of lr 1e-4 can make
        prefix_tol = 1e-6
        print(f"  prefix tolerance {prefix_tol:.1e}")
        if not max(prefix.values()) <= prefix_tol:
            fail("the 20-step Adam prefix of K2+K3 and autograd diverged")

        # 13. times ---------------------------------------------------------------
        print("== phase 13: CMB times")
        times = {}
        for name in ("CMB net, residual grid", "CMB net, fidelity rows", "flagship, train grid"):
            params, x, ybar, dybar, spec, kt = inputs[name]
            ms = cuda_ms(lambda: kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, spec, kt), 7, 20)
            plain = cuda_ms(lambda: kernels_vjp.packed_mlp_bwd_plain(params, x, ybar, dybar, spec, kt), 5, 3)
            b, by = bound(k3_flops(spec, x.shape[0], kt), k3_bytes(params, spec, x.shape[0], kt))
            times[name] = (ms, plain, b, by)
            print(f"  K3 {name} (K={kt}, {x.shape[0]} points): {ms:.4f} ms (plain {plain:.4f} ms, "
                  f"bound {b:.5f} ms by {by}, {b / ms:.1%} of bound; "
                  f"{k3_flops(spec, 1, kt):,.0f} FLOP per point)")
        params = inputs["CMB net, residual grid"][0]
        fwd = {kt: cuda_ms(lambda kt=kt, x=x: kernels.mlp_fwd_tangents(params, x, cmb_net, kt), 7, 20)
               for kt, x in ((2, res_pts), (0, fid_pts))}
        kernel_ms = fwd[2] + fwd[0] + times["CMB net, residual grid"][0] + times["CMB net, fidelity rows"][0]
        step = benchmarks.run_cmb_step_bench(device=dev)
        print(f"  K2 forward: residual (K=2, {n_res} points) {fwd[2]:.4f} ms, fidelity (K=0, "
              f"{n_fid} rows) {fwd[0]:.4f} ms")
        print(f"  run_cmb_step_bench: {json.dumps(step)}; K2 + K3 take {kernel_ms:.4f} ms, "
              f"{kernel_ms / step['ms_per_iter']:.1%} of the Adam step")

    ms, plain, b, by = times["CMB net, residual grid"]
    return {"name": "k3_mlp_bwd", "route": "cuda", "source": K3_SOURCE,
            "replaces": K3_REPLACES, "launches": launches["k3"], "max_abs_err": err_k3,
            "ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": by, "points": n_res,
            "library_ms": None,
            "ms_fidelity_k0": times["CMB net, fidelity rows"][0],
            "bound_ms_fidelity_k0": times["CMB net, fidelity rows"][2],
            "ms_flagship_k2": times["flagship, train grid"][0],
            "bound_ms_flagship_k2": times["flagship, train grid"][2],
            "cmb_adam_ms_per_iter": step["ms_per_iter"],
            "cmb_prefix_gap": max(prefix.values())}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    try:
        import pinn_depthestimation_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port package is not importable ({e}): run from the repository root")
    import numpy as np
    from scipy.io import loadmat

    from pinn_depthestimation_tpu_torch import benchmarks, cli
    from pinn_depthestimation_tpu_torch.config import load_config
    from pinn_depthestimation_tpu_torch.data import load_test_data
    from pinn_depthestimation_tpu_torch.inference import Predictor
    from pinn_depthestimation_tpu_torch.models import MLPSpec, mlp_apply, params_from_numpy
    from pinn_depthestimation_tpu_torch.ops import cuda_build, kernels
    from pinn_depthestimation_tpu_torch.utils.torch_interop import torch_state_dict_from_params

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    repo = os.path.dirname(os.path.abspath(__file__))

    # 1. device -------------------------------------------------------------
    print("== phase 1: device")
    smi = nvidia_smi("name,power.limit")
    print(smi)
    props = torch.cuda.get_device_properties(dev)
    sm_clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    f32_peak = props.multi_processor_count * 128 * 2 * sm_clock_mhz * 1e6
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}; {props.multi_processor_count} SMs, "
          f"max SM clock {sm_clock_mhz:.0f} MHz -> f32 FMA peak {f32_peak / 1e12:.2f} TFLOP/s")

    # 2. build --------------------------------------------------------------
    print("== phase 2: build")
    t_build = time.perf_counter()
    lib = cuda_build.k2_library()  # builds K1, K2 and K3 together
    lib_k1, lib_k3 = cuda_build.k1_library(), cuda_build.k3_library()
    print(f"  K2, K1 and K3 built in {time.perf_counter() - t_build:.1f} s, one nvcc per "
          f"(kernel, width), all at once")
    for name, built in (("k2", lib), ("k1", lib_k1), ("k3", lib_k3)):
        print(f"  {name.upper()}: {len(built.libs)} widths {sorted(built.libs)}; "
              f"log {os.path.relpath(built.log_path, repo)}")
        log = built.log_path.read_text() if built.log_path.exists() else ""
        for block in log.split(f"== {name} variant ")[1:]:
            width = block.split(" ", 1)[0]
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", block)]
            spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", block)]
            print(f"  ptxas {name.upper()} width {width}: registers "
                  f"{min(regs, default=0)}..{max(regs, default=0)}, max spill stores "
                  f"{max(spills, default=0)} B over {len(regs)} kernels")

    # 3. kernel vs plain ----------------------------------------------------
    print("== phase 3: K2 against its plain version on the card")
    flagship = MLPSpec(sizes=benchmarks.FLAGSHIP_SIZES, init_type="xavier")
    rng = np.random.RandomState(7)
    cases = [
        (flagship, numpy_params(flagship.sizes, "xavier", 1), 100_003, (0, 2)),
        (MLPSpec(sizes=(3,) + (10,) * 6 + (4,), init_type="kaiming"),
         None, 4_099, (1, 3)),
        (MLPSpec(sizes=(2,) + (32,) * 120 + (3,), init_type="xavier"),  # 3 smem chunks
         None, 5_003, (2,)),
    ]
    with torch.no_grad():
        for spec, arrays, n, tangent_counts in cases:
            arrays = arrays or numpy_params(spec.sizes, spec.init_type, 2)
            params = params_from_numpy(arrays, dev)
            x = torch.as_tensor(rng.uniform(-1, 1, (n, spec.d_in)).astype(np.float32)).to(dev)
            chunk = lib.libs[spec.width].k2_chunk_layers(spec.n_hidden - 1)
            print(f" sizes {spec.d_in}->[{spec.width}]x{spec.n_hidden}->{spec.d_out} "
                  f"{spec.init_type}, N={n}, {chunk} hidden layers per smem chunk")
            for k in tangent_counts:
                y, dy = kernels.mlp_fwd_tangents(params, x, spec, k)
                torch.cuda.synchronize()
                y_ref, dy_ref = kernels.mlp_fwd_tangents_plain(params, x, spec, k)
                compare(f"K={k} y", y, y_ref)
                if k:
                    compare(f"K={k} dy", dy, dy_ref)
            if spec.d_out == 3 and spec.init_type == "xavier":
                fc = kernels.fused_residual_continuity(params, x, spec)
                torch.cuda.synchronize()
                compare("continuity epilogue fc", fc, kernels.residual_continuity_plain(params, x, spec))
    print(f"  launches so far (comparisons, not counted below): "
          f"mlp_fwd_tangents {kernels.mlp_fwd_tangents.launches}, "
          f"fused_residual_continuity {kernels.fused_residual_continuity.launches}")

    # 4.+5. the main path ---------------------------------------------------
    kernels.mlp_fwd_tangents.launches = 0
    kernels.fused_residual_continuity.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        print("== phase 4: serving path (CLI synth + test --save) on the flagship")
        if cli.main(["synth", "--out", tmp]) != 0:
            fail("synth failed")
        mat = os.path.join(tmp, "data_synth.mat")
        serve_arrays = numpy_params(flagship.sizes, "xavier", 3)
        pth = os.path.join(tmp, "model_flagship.pth")
        torch.save(torch_state_dict_from_params(serve_arrays), pth)
        with open(os.path.join(repo, "examples", "newmethod.json")) as f:
            raw = json.load(f)
        raw["data"]["file"] = mat
        raw["data_test"]["file"] = mat
        cfg_path = os.path.join(tmp, "newmethod.json")
        with open(cfg_path, "w") as f:
            json.dump(raw, f)
        out = os.path.join(tmp, "pred.mat")
        t0 = time.perf_counter()
        rc = cli.main(["test", "--config", cfg_path, "--model", pth, "--save", out,
                       "--device", "cuda", "--debug"])
        serve_s = time.perf_counter() - t0
        if rc != 0:
            fail(f"CLI test exited {rc}")
        saved = loadmat(out)
        config = load_config(cfg_path)
        td = load_test_data(config)
        serve_params = params_from_numpy(serve_arrays, dev)
        x_grid = torch.as_tensor(td.inputs).to(dev)
        with torch.no_grad():
            plain = mlp_apply(serve_params, x_grid, flagship)
        pred = torch.stack([torch.as_tensor(saved[f"pred_{k}"]) for k in ("U", "V", "h")], -1)
        for key in ("U", "V", "h"):
            if saved[f"pred_{key}"].shape != (261, 81):
                fail(f"pred_{key} has shape {saved[f'pred_{key}'].shape}, expected (261, 81)")
        err_pred = compare("served grid vs plain mlp_apply", pred.reshape(-1, 3).to(dev), plain)
        print(f"  CLI test wall time {serve_s:.2f} s for {td.inputs.shape[0]} points")

        print("== phase 5: residual evaluation at 10M points (run_residual_bench)")
        bench = benchmarks.run_residual_bench(n_points=10_000_000, device=dev)
        print(json.dumps(bench))
        launches = {
            "mlp_fwd_tangents": kernels.mlp_fwd_tangents.launches,
            "fused_residual_continuity": kernels.fused_residual_continuity.launches,
        }
        print(f"  main-path launches: {launches}")
        for name, count in launches.items():
            if count < 1:
                fail(f"the main path never launched K2 through {name}")

        # end-to-end serving times, after the launch counts are read
        predictor = Predictor(config, pth, device=dev)
        serve = {
            "predict": host_ms(lambda: predictor.predict(td.inputs), 21),
            "run": host_ms(predictor.run, 7),
        }
    print(f"  Predictor.predict on the {td.inputs.shape[0]}-point grid (host clock, inputs "
          f"to the card and predictions back): {serve['predict']:.4f} ms "
          f"-> {td.inputs.shape[0] / serve['predict'] * 1e3:.4g} predictions/s; "
          f"Predictor.run (with the .mat read): {serve['run']:.3f} ms")

    with torch.no_grad():
        spec, params, coords = benchmarks.flagship_bench_inputs(10_000_000, dev)
        fc = kernels.fused_residual_continuity(params, coords, spec)
        fc_plain = kernels.residual_continuity_plain(params, coords, spec)
        err_res = compare("10M-point residual vs plain", fc, fc_plain)
        del fc, fc_plain

        # 6. times --------------------------------------------------------
        print("== phase 6: times (CUDA events; median of reps)")
        n_grid = x_grid.shape[0]
        ms_pred = cuda_ms(lambda: kernels.mlp_fwd_tangents(serve_params, x_grid, flagship, 0), 7, 20)
        plain_pred = cuda_ms(lambda: mlp_apply(serve_params, x_grid, flagship), 7, 5)
        ms_res = cuda_ms(lambda: kernels.fused_residual_continuity(params, coords, spec), 5, 1)
        plain_res = cuda_ms(lambda: kernels.residual_continuity_plain(params, coords, spec), 3, 1)
        c1m = coords[:1_000_000]
        ms_res_1m = cuda_ms(lambda: kernels.fused_residual_continuity(params, c1m, spec), 5, 3)
        plain_res_1m = cuda_ms(lambda: kernels.residual_continuity_plain(params, c1m, spec), 5, 1)

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / f32_peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    b_pred, by_pred = bound(k2_flops(flagship, n_grid, 0, False),
                            k2_bytes(serve_params, n_grid, flagship, 3))
    n_res = coords.shape[0]
    b_res, by_res = bound(k2_flops(spec, n_res, 2, True), k2_bytes(params, n_res, spec, 1))
    b_1m, _ = bound(k2_flops(spec, 1_000_000, 2, True), k2_bytes(params, 1_000_000, spec, 1))
    print(f"  K2 predict (K=0), {n_grid} points: {ms_pred:.4f} ms (plain {plain_pred:.4f} ms, "
          f"bound {b_pred:.4f} ms by {by_pred}, {b_pred / ms_pred:.1%} of bound; "
          f"{ms_pred / serve['predict']:.1%} of Predictor.predict's wall time)")
    print(f"  K2 residual, {n_res} points: {ms_res:.3f} ms (plain {plain_res:.3f} ms, "
          f"bound {b_res:.3f} ms by {by_res}, {b_res / ms_res:.1%} of bound; "
          f"{n_res / ms_res * 1e3:.4g} evals/s)")
    print(f"  K2 residual, 1M points: {ms_res_1m:.3f} ms (plain {plain_res_1m:.3f} ms, "
          f"bound {b_1m:.3f} ms, {b_1m / ms_res_1m:.1%} of bound)")
    # 7.-10. the training slice ------------------------------------------
    k1_report = training_phases(dev, repo, bound)
    # 11.-13. the CMB slice ------------------------------------------------
    k3_report = cmb_phases(dev, repo, bound)
    print(f"  total {time.perf_counter() - t_start:.1f} s")

    common = {"route": "cuda", "source": K2_SOURCE, "replaces": REPLACES, "library_ms": None}
    report = {"kernels": [
        {"name": "k2_mlp_fwd_tangents[K=0,predict]", **common,
         "launches": launches["mlp_fwd_tangents"], "max_abs_err": err_pred,
         "ms": ms_pred, "plain_ms": plain_pred, "bound_ms": b_pred, "bound_by": by_pred,
         "points": n_grid},
        {"name": "k2_mlp_fwd_tangents[K=2,continuity]", **common,
         "launches": launches["fused_residual_continuity"], "max_abs_err": err_res,
         "ms": ms_res, "plain_ms": plain_res, "bound_ms": b_res, "bound_by": by_res,
         "points": n_res, "ms_1m": ms_res_1m, "plain_ms_1m": plain_res_1m},
        k1_report,
        k3_report,
    ]}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
