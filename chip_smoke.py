#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (any failure exits non-zero; nothing falls back to the CPU):

1. device: the card's name and power limit, as nvidia-smi reports them;
2. build: K2 (``csrc/mlp_fwd_tangents.cu``) from the checkout's sources;
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
   version and its bound.

Launch counts are set to 0 before phase 4 and read after phase 5: each
kernel must have launched on that main path. The last two lines are the
``kernels`` JSON object and ``{"ok": true, "device": {...}}``.
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
    lib = cuda_build.k2_library()
    print(f"  K2 built in {lib.build_seconds:.1f} s ({len(lib.libs)} widths: {sorted(lib.libs)}); "
          f"log {os.path.relpath(lib.log_path, repo)}")
    log = lib.log_path.read_text() if lib.log_path.exists() else ""
    for block in log.split("== k2 variant ")[1:]:
        width = block.split(" ", 1)[0]
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", block)]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", block)]
        print(f"  ptxas width {width}: registers {min(regs, default=0)}..{max(regs, default=0)}, "
              f"max spill stores {max(spills, default=0)} B over {len(regs)} kernels")

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
    ]}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
