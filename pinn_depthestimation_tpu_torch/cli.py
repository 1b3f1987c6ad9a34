"""Command-line interface of the port.

Counterpart of the JAX package's ``cli.py`` for the serving and training
slices:

    python -m pinn_depthestimation_tpu_torch.cli train --config CFG [--log-root DIR]
                                                       [--run-name NAME] [--resume CKPT.npz]
                                                       [--init-from PTH|NPZ|MSGPACK]
                                                       [--device cuda|cpu]
                                                       [--precision-schedule PREFIX_ITERS[:TIER]]
                                                       [--mesh N] [--f64-polish MAX_IT]
                                                       [--profile DIR]
    python -m pinn_depthestimation_tpu_torch.cli test  --config CFG
                                                       [--model PTH|NPZ|MSGPACK]
                                                       [--save OUT.mat] [--device cuda|cpu]
                                                       [--plot [DIR]] [--cross-section ROW]
    python -m pinn_depthestimation_tpu_torch.cli parity [--iters 50000] [--lbfgs 500]
                                                       [--ref-cache REF.npz] [--fw-cache FW.npz]
                                                       [--out REPORT.md] [--device cuda|cpu]
    python -m pinn_depthestimation_tpu_torch.cli synth --out DIR [--nx 81 --ny 261]
                                                       [--legacy [--snapshots 21]]
    python -m pinn_depthestimation_tpu_torch.cli bench [--points 10000000] [--device cuda|cpu]
                                                       [--precision f32|f32x3|bf16]
                                                       [--suite | --step]
    python -m pinn_depthestimation_tpu_torch.cli video --dir PNG_DIR --out OUT.avi [--fps 5]
    python -m pinn_depthestimation_tpu_torch.cli plot-log --run-dir RUN [--out DIR]

``train`` takes newmethod, CMB and legacy configs, ``test`` newmethod and
CMB ones; ``test`` on a config with ``perform_optimization: true`` first
adapts the weights to the physics on the test grid (``Predictor.adapt``)
and prints how many loss evaluations that took. ``parity`` runs the full-schedule parity experiment against the
reference (``parity.py``, whose flags it takes). ``bench`` prints one
JSON line: the residual rate at ``--precision``, with ``--suite`` the JAX
suite's record (every tier's residual rate, the plain version's under
``plain``, the Adam steps; ``benchmarks.run_bench_suite``), with ``--step``
the flagship Adam step in ms. ``synth`` writes the newmethod grid
``data_synth.mat`` and the CMB pair ``input_fid.csv`` + ``input_res.mat``,
and with ``--legacy`` the FUNWAVE snapshot directory ``beach2d/``
(``dep.out``, ``eta_/u_/v_NNNNN`` for ``--snapshots`` snapshots from 200,
``fidelity.csv``) that ``examples/legacy.json`` reads. ``--device``
defaults to ``cuda``; without a CUDA device the verb fails unless
``--device cpu`` is given. ``train
--precision-schedule PREFIX_ITERS[:TIER]`` runs the first PREFIX_ITERS Adam
steps at TIER (default ``bf16``), merged onto the config's
``precision_schedule`` block; ``0`` disables it. ``train --f64-polish
MAX_IT`` appends the float64 L-BFGS polish with MAX_IT iterations, merged
onto the config's ``f64_polish`` block (its evaluation budget re-derived);
``0`` disables it. ``train --mesh N`` (or a config's ``parallel.data``)
trains data-parallel over N shards: one per visible CUDA device, or N
shards in the one CPU process with ``--device cpu``; too few devices exit 1
with "Error building device mesh". ``train --profile DIR`` writes a
``torch.profiler`` trace of the training (CPU activity, and CUDA activity
on the card) to ``DIR/trace.json`` (Chrome trace format), the program's
spans among its ranges, and the spans themselves to ``DIR/spans.json``
(``tracing.summary()`` under ``summary``, the raw spans under ``spans``):
the Trainer's construction and blocks, the Adam step, the K1 and K2 calls,
the kernel libraries' build and load. ``test --plot
[DIR]`` writes the reference's plot products (``plotting.
make_result_plots``; DIR overrides the config's ``plot.dir``), with the
1-D profiles at ``--cross-section ROW``; ``video`` turns a folder of PNGs
into an XVID AVI and ``plot-log`` draws a run's ``log.txt``. The plots need
``matplotlib`` and the video ``cv2``, which the port does not install:
where one is missing ``test --plot`` prints ``Error making plots: ...`` and
``video``/``plot-log`` exit 1 naming the module. ``--model`` and
``--init-from`` also read the JAX package's ``.msgpack`` checkpoints.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def cmd_train(args) -> int:
    import time

    import torch

    from pinn_depthestimation_tpu_torch import tracing
    from pinn_depthestimation_tpu_torch.config import load_config
    from pinn_depthestimation_tpu_torch.device import resolve_device
    from pinn_depthestimation_tpu_torch.models import MLPSpec
    from pinn_depthestimation_tpu_torch.parallel import make_mesh
    from pinn_depthestimation_tpu_torch.training.checkpoint import restore_params_any
    from pinn_depthestimation_tpu_torch.training.driver import Trainer
    from pinn_depthestimation_tpu_torch.training.logging_utils import make_run_dir

    try:
        config = load_config(args.config)
    except Exception as e:
        if args.debug:
            raise
        print(f"Error reading config file: {e}")
        return 1
    mesh = None
    try:
        if args.mesh:
            n_data, n_model = args.mesh, 1
        else:
            n_data, n_model = config.parallel.data, config.parallel.model
        if n_data:
            # the visible CUDA devices; N shards in this process on the CPU
            on_cpu = torch.device(args.device).type == "cpu"
            mesh = make_mesh(n_data, n_model, devices=[args.device] * n_data if on_cpu else None)
    except ValueError as e:
        if args.debug:
            raise
        print(f"Error building device mesh: {e}")
        return 1
    # no CUDA device: raise, never the CPU
    device = mesh.first_device if mesh is not None else resolve_device(args.device)
    if args.f64_polish is not None:
        # N > 0 re-budgets max_it on top of a JSON-configured block (its
        # backend, tolerances and history stay; the evaluation budget is
        # re-derived from the new max_it); 0 disables the phase
        from pinn_depthestimation_tpu_torch.config import _parse_f64_polish

        if args.f64_polish > 0:
            block = config.raw.get("f64_polish")
            block = dict(block) if isinstance(block, dict) else {}
            block["max_it"] = args.f64_polish
            block.pop("max_evaluation", None)
            config.f64_polish = _parse_f64_polish(block)
        else:
            config.f64_polish = None
    if args.precision_schedule is not None:
        # "PREFIX_ITERS[:TIER]" merges onto a JSON-configured block (an
        # explicit :TIER overrides its tier); "0" disables the schedule
        from pinn_depthestimation_tpu_torch.config import _parse_precision_schedule

        spec_str = str(args.precision_schedule)
        iters_str, _, tier = spec_str.partition(":")
        try:
            prefix_iters = int(iters_str)
        except ValueError:
            print(f"Error: --precision-schedule expects PREFIX_ITERS[:TIER], got {spec_str!r}")
            return 1
        if prefix_iters < 0:
            print(f"Error: --precision-schedule PREFIX_ITERS must be >= 0, got "
                  f"{prefix_iters} (0 disables the schedule)")
            return 1
        if prefix_iters > 0:
            block = config.raw.get("precision_schedule")
            block = dict(block) if isinstance(block, dict) else {}
            block["prefix_iters"] = prefix_iters
            if tier:
                block["prefix_precision"] = tier
            try:
                config.precision_schedule = _parse_precision_schedule(block)
            except Exception as e:
                if args.debug:
                    raise
                print(f"Error: {e}")
                return 1
        else:
            config.precision_schedule = None
    if args.init_from and args.resume:
        # --resume restores the checkpoint's own weights, which would
        # silently discard the --init-from weights
        print("Error: --init-from and --resume are mutually exclusive "
              "(--resume restores the checkpoint's own weights)")
        return 1
    initial_params = None
    if args.init_from:
        try:
            initial_params = restore_params_any(
                args.init_from, spec=MLPSpec.from_layers(config.layers), device="cpu")
        except Exception as e:
            if args.debug:
                raise
            print(f"Error loading --init-from weights: {e}")
            return 1

    if args.profile:
        tracing.reset()
        tracing.enable()
    run_dir = make_run_dir(args.log_root, args.run_name)
    print(f"Run directory: {run_dir}")
    trainer = Trainer(config, run_dir=run_dir, initial_params=initial_params, device=device,
                      mesh=mesh)
    if args.init_from:
        print(f"Initialized weights from {args.init_from}")
    if args.resume:
        trainer.restore(args.resume)
        print(f"Resumed from {args.resume} at iteration {trainer.state.iteration}")
    import contextlib

    profile_ctx = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profile_ctx = profile(activities=activities)
        print(f"Profiler trace -> {args.profile}")
    start = time.time()
    with profile_ctx as prof:
        trainer.train()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    # the reference's only perf instrumentation (train.py:286)
    print("Training time: %.4f" % (time.time() - start))
    if args.profile:
        tracing.disable()
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        with open(os.path.join(args.profile, "spans.json"), "w") as f:
            json.dump({"summary": tracing.summary(),
                       "spans": [s._asdict() for s in tracing.spans()]}, f, indent=1)
    return 0


def cmd_test(args) -> int:
    import numpy as np
    from scipy.io import savemat

    from pinn_depthestimation_tpu_torch.config import load_config
    from pinn_depthestimation_tpu_torch.device import resolve_device
    from pinn_depthestimation_tpu_torch.inference import Predictor

    device = resolve_device(args.device)  # no CUDA device: raise, never the CPU
    try:
        config = load_config(args.config)
    except Exception as e:
        if args.debug:
            raise
        print(f"Error reading config file: {e}")
        return 1
    try:
        predictor = Predictor(config, checkpoint_path=args.model, device=device)
    except Exception as e:
        if args.debug:
            raise
        print(f"Error loading model: {e}")
        return 1
    result = predictor.run()
    if result.adapted:
        losses = predictor.adapt_losses
        print(f"Test-time adaptation: {result.adapt_evaluations} loss evaluations, "
              f"physics loss {losses[0]:.5e} -> {losses.min():.5e}")
    for key, arr in result.pred.items():
        # masked (NaN) grid cells are data-driven; summarize over wet cells
        nan_pct = 100.0 * float(np.isnan(arr).mean())
        line = f"pred_{key}: shape {arr.shape}, mean {float(np.nanmean(arr)):.5f}"
        if nan_pct:
            line += f" ({nan_pct:.1f}% masked cells)"
        print(line)
    if args.save:
        savemat(args.save, {f"pred_{k}": v for k, v in result.pred.items()})
        print(f"Predictions saved to {args.save}")
    if args.plot:
        from pinn_depthestimation_tpu_torch.plotting import make_result_plots

        plot_cfg = dict(config.raw)
        plot_cfg.setdefault("plot", {})
        if args.plot is not True:  # a directory was given
            plot_cfg["plot"] = {**plot_cfg["plot"], "dir": args.plot}
        try:
            paths = make_result_plots(result, plot_cfg, cross_section=args.cross_section)
        except (ValueError, ImportError) as e:
            print(f"Error making plots: {e}")
            return 1
        for path in paths:
            print(f"Wrote {path}")
    print("Prediction done!")
    return 0


def cmd_video(args) -> int:
    from pinn_depthestimation_tpu_torch.plotting import images_to_video

    try:
        out = images_to_video(args.dir, args.out, frame_rate=args.fps)
    except (ValueError, ImportError) as e:
        print(f"Error making the video: {e}")
        return 1
    print(f"Video saved to {out}")
    return 0


def cmd_plot_log(args) -> int:
    from pinn_depthestimation_tpu_torch.plotting import plot_log

    try:
        path = plot_log(args.run_dir, args.out or args.run_dir)
    except ImportError as e:
        print(f"Error plotting the log: {e}")
        return 1
    print(f"Wrote {path}")
    return 0


def cmd_parity(args) -> int:
    from pinn_depthestimation_tpu_torch.parity import run_args

    return run_args(args)[0]


def cmd_bench(args) -> int:
    from pinn_depthestimation_tpu_torch import benchmarks

    if args.step:
        step = benchmarks.run_train_step_bench(device=args.device)
        print(json.dumps({"metric": "flagship_adam_step_ms", "value": step["ms_per_iter"],
                          "unit": f"ms/iteration (shipped defaults) on {step['device']}"}))
    elif args.suite:
        print(json.dumps(benchmarks.run_bench_suite(n_points=args.points, device=args.device)))
    else:
        print(json.dumps(benchmarks.run_residual_bench(
            n_points=args.points, backend=args.backend, precision=args.precision,
            device=args.device,
        )))
    return 0


def cmd_synth(args) -> int:
    from pinn_depthestimation_tpu_torch.utils import synthetic

    os.makedirs(args.out, exist_ok=True)
    mat = os.path.join(args.out, "data_synth.mat")
    synthetic.make_newmethod_mat(mat, nx=args.nx, ny=args.ny, seed=args.seed)
    print(f"Wrote {mat}")
    csv, res = os.path.join(args.out, "input_fid.csv"), os.path.join(args.out, "input_res.mat")
    synthetic.make_cmb_dataset(csv, res, nx=args.nx, ny=args.ny, seed=args.seed)
    print(f"Wrote {csv} and {res}")
    if args.legacy:
        snap_dir, fid_csv = synthetic.make_funwave_snapshot_dir(
            os.path.join(args.out, "beach2d"), nx=args.nx, ny=args.ny,
            snapshots=tuple(range(200, 200 + args.snapshots)), seed=args.seed,
        )
        print(f"Wrote {snap_dir}/ (FUNWAVE snapshots) and {fid_csv}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pinn_depthestimation_tpu_torch.cli", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = p.add_subparsers(dest="command", required=True)

    tr = sub.add_parser("train", help="train a model (Adam, then L-BFGS)")
    tr.add_argument("--config", required=True, help="JSON config (reference schema)")
    tr.add_argument("--log-root", default="./log", help="parent of the run directory")
    tr.add_argument("--run-name", default=None,
                    help="run directory name (default: YYYYmmdd_HHMM)")
    tr.add_argument("--resume", default=None, help="continue from a model_<iter>.npz")
    tr.add_argument("--init-from", default=None,
                    help="start from these weights: reference .pth/.pt, exchange .npz "
                         "or the JAX package's .msgpack")
    tr.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    tr.add_argument("--debug", action="store_true",
                    help="re-raise errors with a full traceback")
    tr.add_argument("--precision-schedule", default=None, metavar="PREFIX_ITERS[:TIER]",
                    help="run the first PREFIX_ITERS Adam steps at TIER (default bf16); "
                         "0 disables the config's schedule")
    tr.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="data-parallel mesh of N shards (one per CUDA device; with "
                         "--device cpu, N shards on the CPU)")
    tr.add_argument("--f64-polish", type=int, default=None, metavar="MAX_IT",
                    help="append the float64 L-BFGS polish with MAX_IT iterations, "
                         "merged onto the config's f64_polish block (its backend, "
                         "tolerances and history kept; the evaluation budget "
                         "re-derived); 0 disables it")
    tr.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace (CPU, and CUDA on the card) "
                         "to DIR/trace.json and the program's spans (the Trainer's "
                         "construction and blocks, the Adam step, the K1 and K2 calls, "
                         "the kernel build and load) to DIR/spans.json")
    tr.set_defaults(fn=cmd_train)

    te = sub.add_parser("test", help="predict the test grid")
    te.add_argument("--config", required=True, help="JSON config (reference schema)")
    te.add_argument("--model", default=None,
                    help="weights: reference .pth/.pt, exchange .npz or the JAX "
                         "package's .msgpack (default: data_test.model)")
    te.add_argument("--save", default=None, help="write predictions to this .mat")
    te.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    te.add_argument("--debug", action="store_true",
                    help="re-raise errors with a full traceback instead of "
                         "the friendly exit-1 message")
    te.add_argument("--plot", nargs="?", const=True, default=False, metavar="DIR",
                    help="write the reference plot products (test.py:110-130); "
                         "an optional DIR overrides the config's plot.dir")
    te.add_argument("--cross-section", type=int, default=None,
                    help="row index for the 1-D profiles (default: mid row; "
                         "the reference hardcodes 131)")
    te.set_defaults(fn=cmd_test)

    from pinn_depthestimation_tpu_torch.parity import build_parser as parity_parser

    pa = sub.add_parser(
        "parity", parents=[parity_parser(add_help=False)],
        help="full-schedule parity experiment vs the actual reference",
    )
    pa.set_defaults(fn=cmd_parity)

    b = sub.add_parser("bench", help="residual-evaluation benchmark (one JSON line)")
    b.add_argument("--points", type=int, default=10_000_000)
    b.add_argument("--backend", choices=["kernel", "plain"], default="kernel")
    b.add_argument("--precision", choices=["f32", "f32x3", "bf16"], default="f32")
    b.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    mode = b.add_mutually_exclusive_group()
    mode.add_argument("--suite", action="store_true",
                      help="the full record: every tier's residual rate, the plain "
                           "version's, and the Adam steps, in one line")
    mode.add_argument("--step", action="store_true",
                      help="only the flagship Adam-step time (ms/iteration)")
    b.set_defaults(fn=cmd_bench)

    s = sub.add_parser("synth",
                       help="write synthetic newmethod, CMB and legacy data (reference schema)")
    s.add_argument("--out", required=True)
    s.add_argument("--nx", type=int, default=81)
    s.add_argument("--ny", type=int, default=261)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--legacy", action="store_true",
                   help="also write a FUNWAVE snapshot dir + fidelity CSV "
                        "for the legacy numerical_model pipeline (config.json schema)")
    s.add_argument("--snapshots", type=int, default=21,
                   help="snapshot count for --legacy (reference uses 21: 200-220)")
    s.set_defaults(fn=cmd_synth)

    v = sub.add_parser("video", help="PNG sequence -> AVI (utilities/imgtovid.py)")
    v.add_argument("--dir", required=True)
    v.add_argument("--out", required=True)
    v.add_argument("--fps", type=int, default=5)
    v.set_defaults(fn=cmd_video)

    pl = sub.add_parser("plot-log", help="loss curves from a run dir's log.txt")
    pl.add_argument("--run-dir", required=True)
    pl.add_argument("--out", default=None)
    pl.set_defaults(fn=cmd_plot_log)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
