#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (any failure exits non-zero; nothing falls back to the CPU):

1. device: the card's name and power limit, as nvidia-smi reports them;
2. build: K2 (``csrc/mlp_fwd_tangents.cu``), K1
   (``csrc/continuity_train_step.cu``), K3 (``csrc/mlp_bwd.cu``) and K4
   (``csrc/mlp_bwd_rebuild.cu``) from the checkout's sources, each library
   holding the f32, bf16 and f32x3 tiers, every ``nvcc`` started together;
   registers and spills per width, and K2-f32's per width and lanes a
   point; the HMMA instructions of K2's kernels
   at width 20 and of K1's, K3's and K4's walk kernels at every width
   (``cuobjdump -sass``): in every bf16 and f32x3 kernel (the tensor-core
   bodies, ``csrc/mlp_fwd_tangents_mma.cuh``, ``csrc/mlp_bwd_mma.cuh``),
   in no f32 one; Adam's update (``csrc/adam_step.cu``) in the same wave;
2b. Adam's update against ``torch.optim.Adam``'s foreach path on the card:
   the leaves of the flagship, the CMB net and the legacy net, 100 steps
   under ``StepLR(30, 0.8)`` from seeded weights and gradients, every
   parameter and both moments bit for bit, one launch a step; the
   kernel's device time on the flagship's leaves beside torch's seven
   foreach kernels and its bound, and the host's time of a step and
   ``StepLR`` beside torch's;
3. K2 against its plain PyTorch version on the card: the 2->[20]x100->3
   flagship (xavier, seeded numpy weights) at a ragged N for K=0, K=2 and
   the continuity epilogue; a small leaky-relu net (K=1, K=3); a width-32
   stack deeper than one shared-memory chunk holds; then the ragged point
   counts 1, 17, 255 and 257, the serving grid's 21,141 and the legacy
   shape's 26,691 points, and the 2->[32]x100->3 stack (several chunks at
   f32), each with its f32 plan (``ops/k2_plan.py::f32_plan``);
4. the serving path through its entry point: ``synth`` writes the 81x261
   newmethod grid, seeded flagship weights go to a reference-layout .pth,
   and the CLI ``test`` verb predicts the grid (``--save``); predictions
   must be finite, shaped (261, 81) and equal to the plain version;
5. residual evaluation: ``run_residual_bench`` at 10M points, checked
   against the plain version at the same inputs;
6. times (CUDA events, median of reps) of each kernel beside its plain
   version and its bound; K2-f32's device time (``torch.profiler``),
   bound, share of the bound and plan at the serving grid, 10M points,
   the CMB grid at K=2, the CMB net's 200 fidelity rows (K=0) and the
   legacy shape at K=3;
7. K1 against its plain version on the card: the flagship on the 12,516
   points of the 81x261 grid with 40.8 % NaN rows, anchored with two
   observed heads, under parity (every point selected) and parity=false
   (some selected), twice for determinism; width 10 anchorless with three
   heads; width 16 leaky-relu; a width-32 stack deeper than one
   shared-memory chunk; a batch with masked rows; then widths 20 and 10 at
   point counts around the walk's tiles (1, 15, 17, 12,516, and one either
   side of a full wave of the width's largest tiles), each launched twice;
8. the training path through its entry points: CLI ``train`` on
   ``examples/newmethod.json`` with the synthetic grid (Adam, the snapshot,
   L-BFGS, ``model.npz``), then CLI ``test`` on the trained model; the log,
   the files and the loss trend are checked, and K1's launch count must
   equal the number of loss evaluations;
9. iteration-1 equality and a 20-step Adam prefix of a Trainer on K1
   against one on the plain autograd path, from the same numpy weights;
10. training times: K1 beside its plain version, its bound and the share
   of it, with CUDA events and with the device time ``torch.profiler``
   records (``device_ms``), with the walk's launch plan (tiles, points per tile, blocks), the
   flagship Adam step (``run_train_step_bench``) and L-BFGS evaluations per
   second (median, min and max of 5 runs of the configured 500-iteration
   phase);
11. K3 (``csrc/mlp_bwd.cu``) against its plain version on the card: the
   2->[10]x10->6 CMB net at K=2 on the ~20,500 points of the CMB bench grid
   and at K=0 on its 200 fidelity rows, the flagship at K=2 on the 12,516
   grid points, a leaky-relu net at K=1 and K=3, a width-32 stack deeper
   than one shared-memory chunk, a ragged N; two launches bit-identical;
   then the CMB net at K=2 at the point counts around the tiles of phase 7;
12. the CMB training path through its entry points: ``synth`` writes the
   CMB pair, CLI ``train`` runs ``examples/cmb.json`` on it (interval 1,
   300 Adam steps, L-BFGS cut to 20 iterations), CLI ``test`` serves the
   trained model; the log, the files, the loss trend and the launch counts
   (K3 == 2 x loss evaluations) are checked; then iteration 1 and a
   20-step Adam prefix of a K2+K3 Trainer against an autograd Trainer from
   the same numpy weights, under parity and parity=false; then 10 more
   replays of the K2+K3 Trainer's step graph under ``torch.profiler``, the
   K2, K3 and Adam kernels the card ran, by name, equal to the launches
   the program counted for them;
13. times: K3 beside its plain version and bound at the CMB and flagship
   shapes, with CUDA events (on the CMB grid they measure the host's launch
   rate; ``tools/k1_refactor_check.py --time`` gives the device time), and
   the CMB Adam step (``run_cmb_step_bench``) with K2 +
   K3's share of it;
14. the bf16 tier and K4 against their plain versions on the card, each
   bf16 output held to the tier's own error (``compare_tier``: an L2 gap
   within a quarter of gap(plain-bf16, plain-f32), or four times the
   spread of two valid summation orders where deep chains make that
   larger, plus f32's tolerance; and at least half the tier's error away
   from plain f32), K4-f32 to ``REL_TOL``: K2-bf16
   on phase 3's cases and the CMB net at K=2 (~20,500 points), K=0 (200
   rows) and a ragged N; K1-bf16 on phase 7's cases; K3-bf16, K4-f32 and
   K4-bf16 on phase 11's cases and a depth that leaves a short last K4
   segment; two launches bit-identical each;
15. the CMB path at bf16 through its entry points: CLI ``train`` on
   ``examples/cmb.json`` with ``kernel_precision: "bf16"`` at phase 12's
   cuts (K4-bf16 launches == 2 x loss evaluations, no K3, K2-bf16 == 2 x
   loss evaluations), CLI ``test`` through K2-bf16; then iteration 1 through
   K2 + K4 against the plain bf16 functions on the card;
16. the flagship under ``--precision-schedule 150:bf16`` through CLI
   ``train`` at phase 8's cuts (exactly 150 K1-bf16 launches, K1-f32 for
   every later evaluation), CLI ``test``; a 100-step scheduled run's final
   checkpoint (inside the prefix) resumed with ``--resume`` runs exactly 50
   K1-bf16 launches, then f32;
17. times: K2-bf16 (CMB grid, 10M points, serve grid), K1-bf16 and K4
   (both tiers, beside K3) beside the f32 tier, their plain versions and
   their bounds (f32 on the CUDA cores' FMA rate, bf16 on the tensor
   cores' bf16 rate; K2-bf16 also beside the CUDA-core issue count of its
   tensor-core body, ``k2_issue_count``), K4's segment length
   C swept, and the bf16 Adam steps of the flagship and the CMB net beside
   f32;
18. the f32x3 tier of K2, K1, K3 and K4 against the plain f32x3 versions on
   the cases of phases 3, 7, 11 and 14 (``compare_tier`` with the f32x3
   floor ``X3_REL_FLOOR``), two launches bit-identical each;
19. the paths at f32x3: CLI ``train`` of the flagship with
   ``kernel_precision: "f32x3"`` and ``residual_chunk_size: 4096`` (K1-f32x3
   launches == loss evaluations, no other tier; the chunk size is dropped
   on the kernel path), CLI ``test`` through K2-f32x3 held to the plain
   f32x3 prediction; the CMB config at f32x3 (K3-f32x3 == 2 x evaluations,
   no K4, no other tier), CLI ``test``; iteration 1 through K2 + K3 at
   f32x3 against the plain f32x3 functions; ``--precision-schedule
   150:f32x3`` (exactly 150 K1-f32x3, then f32; a resume from iteration 100
   runs 50); 20 Adam steps of the CMB Trainer with the custom VJP's
   backward picked (``bwd_impl``, ``PickedBackward``): K3-bf16, K4-f32 and
   K4-f32x3, 40 launches each and nothing else;
20. ``bench --suite`` through the CLI: one JSON line, every extra present,
   no ``_error`` key;
21. times of the f32x3 tier (K2 on the CMB grid, at 10M points and on the
   serve grid; K1; K3 and K4 with K4's C swept), beside the plain f32x3 versions and the bound of the tier's
   three bf16 products on the tensor cores (with the CUDA cores' figure
   beside it; K2 also beside its CUDA-core issue count), and the CMB Adam
   step at f32x3;
22. the flagship parity run at full width: CLI ``parity`` with the flags of
   the reference's own 50,000-step run (50,000 Adam, 500 L-BFGS,
   2->[20]x100->3, 81x261, NaN fraction 0.408) on ``.soak/ref_50k.npz``,
   K1 on every evaluation, then the harness recomposed from the caches it
   wrote for its numbers: the verdict PASS (h RMSE <= 1 % of the truth or
   predicted range), iteration 1 within 1e-5 relative, the first 10 Adam
   losses within 2e-4, the terminal log10 gap < 0.1, K1 launches == log
   rows, every row finite; prints the Adam prefix within 5e-3, the wall
   time, the Adam and L-BFGS seconds and the evaluations;
23. the same on the structured fields (``.soak/ref_50k_structured.npz``),
   gated on the port's predicted h range >= 10 % of the truth range in
   place of the verdict, its h RMSE printed beside the JAX package's
   1.28 % and the reference's fork spread of 1.22 %;
24. test-time adaptation: CLI ``test`` with ``perform_optimization: true``
   on phase 8's trained flagship and phase 12's trained CMB model at f32
   and on the flagship at bf16: K2 == evaluations + 1, K3 (K4 at bf16) ==
   evaluations, no call of a plain version; then ``Predictor.adapt``
   through the kernels against the plain path on the card (f32:
   ``use_kernel=False``, the same evaluations, losses within 1e-4
   relative, parameters within 1e-4 x max|change| + 1e-7, predictions by
   ``compare``; bf16: the plain bf16 functions, held to the tier's own
   error, the served prediction by ``compare_tier`` at the adapted
   weights);
25. the legacy pipeline at ``examples/legacy.json``'s width
   (5->[20]x20->4, ``navier_stokes``): ``synth --legacy --nx 41 --ny 31``
   and the loader (26,691 collocation points, 300 fidelity rows); K2 at
   K=3 and K=0, K3 and K4 at that shape against their plain versions at
   each tier (f32 by ``compare``, bf16 and f32x3 by ``compare_tier``); CLI
   ``train`` on the example uncut (500 Adam, L-BFGS 100/125) at f32 (K2 ==
   K3 == 2 x evaluations, no K1 or K4, no plain call, every log row finite,
   the last total below the first) and at bf16 with Adam cut to 100
   (K4-bf16 == 2 x evaluations, no K3); iteration 1 and a 20-step Adam
   prefix of a K2 + K3 Trainer against an autograd one (rel 1e-5, 1e-6);
   the legacy Adam step at f32 and bf16 (``run_legacy_step_bench``), K2
   (K=3), K3 and K4-bf16 beside their bounds, and the step's profile
   (``tools/profile_cmb_step.py --pipeline legacy``, in a process of its
   own): the device's idle share and the device time of K2 (K=3) and K3.

26. the float64 polish at the flagship's full width: one f64 evaluation
   (loss and gradient by autograd) timed by CUDA events beside its bound
   (714,200 FLOP per point over the f64 tensor-core peak, derived from the
   SM count and clock), then CLI ``train`` on ``examples/deep_f64.json`` on
   the train-grid cell's 12,516 points with the cuts ``DEEP_F64_CUTS``
   lists: K1 launches == the f32 evaluations, none inside the polish, the
   polish's iterate float64 on the card, the log rows the f32 evaluations
   plus the polish's numbered 1..n, the polish's final f64 loss below the
   f64 loss at the f32 phases' end (its log minimum at or below theirs),
   the final ``model.npz`` with f32 parameters and ``params64``;
   a checkpoint cut inside the polish (by a Trainer subclass the CLI runs,
   near the end of its budget) resumed through CLI ``--resume``: no K1
   launch, the first row the next evaluation, whether the rest replays bit
   for bit printed;
27. the mesh: ``examples/newmethod_scaled.json`` as shipped
   (``parallel.data`` 8) exits 1 with the mesh error on fewer than 8
   devices; CLI ``--mesh 1`` gives the unsharded run's log rows and final
   parameters bit for bit, K1 == evaluations; a flagship Trainer and a CMB
   Trainer on 4 shards of the one card against unsharded ones (K1 == 4 x
   evaluations; K2 == K3 == 2 x 4 x evaluations; iteration 1 within 1e-5
   relative; the flagship's parameters after 20 Adam steps within 1e-6), and
   the Adam step's time on 4 shards beside the unsharded one;
28. every shape the Pallas kernels take: K2 (K = 0-3, the epilogue), K1, K3
   and K4 (the C sweep's default) at f32, bf16 and f32x3 held to their
   plain versions (``compare``, ``compare_tier``) at width 17 and 24 (the
   narrow body, padded to 20 and 32), 33 (the wide body, padded to 36), 64,
   100 and 128 (at (d_in, d_out) = (2, 2), the JAX kernel tests' g = 1
   shape, and with heads (U, V, h)), a net with d_out = 16 and one with d_in
   = 12 (``csrc/mlp_wide.cuh``; phase 2 also builds it and reports its
   registers); then each kernel and tier timed at widths 64 and 128 on the
   path's shapes (K1, K2: 2->[W]x100->3 at 12,516 points; K3, K4:
   2->[W]x10->6 on the ~20,500-point CMB grid), CUDA events and device
   time, beside the plain version and the bound, after every tier is held
   to its plain version at each shape phase 29 launches (K1 and the K2
   epilogue there, K2 at K = 0 on the 81x261 serving grid for both nets, K2
   at K = 2 and K3/K4 on the CMB grid, K2/K3/K4 at K = 0 on its 200
   fidelity rows); last, K1 and the K2 epilogue at widths 17 and 24
   (2->[W]x100->3) on the narrow body, padded, against the wide body at
   the net's own width, in turns;
29. the paths at full width on the wide body: CLI ``train`` and ``test`` on
   ``examples/newmethod.json`` at ``hidden_width`` 128 and 64 (100 hidden
   layers, phase 8's cuts; K1 == log rows, K2 serves the 81x261 grid) and on
   ``examples/cmb.json`` at ``hidden_width`` 128, f32 (K3 == 2 x
   evaluations) and bf16 (K4 == 2 x evaluations), every launch a wide one;
   then, outside the path's counts, a K2 + K3 Trainer against autograd on
   the CMB net at width 128 (iteration 1 within 1e-5, a 20-step prefix
   within 1e-5), a K2 + K4 bf16 Trainer against the plain bf16 functions
   (the prefix within half the tier's own gap from f32) and a K1 Trainer
   against an autograd Trainer at width 128, iteration 1 within 1e-5;
30. the last modules: CLI ``test`` on the JAX package's ``.msgpack``
   fixture (``tests/data/jax_state_w20x3``) through K2, bit for bit its
   ``.npz``; ``train --profile`` writes a Chrome trace naming K1's kernel;
   ``Trainer(training_data=)`` takes one Adam step; ``test --plot``,
   ``plot-log`` and ``video`` make their files or, where the machine lacks
   ``matplotlib``/``cv2``, print or exit 1 naming the module.

Launch counts are set to 0 before phase 4 and read after phase 5 (the
serving path), set to 0 again before phase 8 and read after it (the
flagship training path), again before phase 12's CLI ``train`` and read
after its CLI ``test`` (the CMB path), before phase 15's CLI ``train`` and
after its ``test`` (the bf16 CMB path), and before phase 16's CLI
``train`` and after its ``test`` (the schedule), and likewise around each
of phase 19's paths, each CLI ``parity`` run of phases 22-23 (K1) and
each CLI ``test`` of phase 24 (K2, K3, K4), each CLI ``train`` of
phase 25 (K1, K2, K3, K4), each CLI ``train`` of phases 26 and 27 and each
sharded Trainer of phase 27 (K1, K2, K3): each kernel must have launched
on each path that runs it, at the tier that path asks for. Adam's kernel
is counted phase by phase: its launches are set to 0 at each phase's start
and read at its end, and must equal the steps FusedAdam took on card
float32 leaves there (a global optimizer step hook counts them); torch's own
Adam may step on card float32 leaves only in phase 2b. The ``kernels`` line holds one
entry per kernel and tier (K2, K1, K3, K4 x f32, bf16, f32x3); the
entries of K2-f32, K2-bf16, K3-f32 and K4-bf16 also carry phase 25's
launches (``launches_legacy``) and times (``*_legacy*``); K1-f32's carries
phase 26's ``f64_polish`` record and K1-f32's, K2-f32's and K3-f32's phase
27's launches and step times (``*mesh*``); every entry carries phase 28's
wide-body numbers (``*_w64``, ``*_w128``, ``max_abs_err_wide``) and phase
29's launches (``launches_wide``: counts set to 0 at the phase's start and
read after its CLI runs, before its check Trainers; K1-f32, K2-f32,
K2-bf16, K3-f32 and K4-bf16 run there); K1's and K2's entries also carry
the padded-against-wide times (``padded_ms_w17``, ``wide_ms_w17``, ...). A last
entry, ``adam_step[f32]``, holds phase 2b's numbers and Adam's launches in
all and by phase (``launches_by_phase``). The last
two lines are the ``kernels`` JSON object and ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
K4_REPLACES = "pinn_depthestimation_tpu/ops/kernels_vjp.py:268"  # _make_bwd_kernel (impl='rebuild')
K4_SOURCE = "pinn_depthestimation_tpu_torch/csrc/mlp_bwd_rebuild.cu"
ADAM_SOURCE = "pinn_depthestimation_tpu_torch/csrc/adam_step.cu"
# the walk kernel's name, for device_ms
WALK_KERNEL = {"k1": "k1_train_step_kernel", "k3": "cotangent_walk_kernel",
               "k4": "cotangent_walk_kernel"}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12  # H100 SXM data sheet, dense bf16 on the tensor cores
# kernel vs plain: max|kernel - plain| <= REL_TOL * max|plain| + ABS_TOL. f32 FMA
# chains against f32 cuBLAS products over ~100 layers agree to ~1e-5 of the
# output's scale; ABS_TOL only covers outputs that are all near zero.
REL_TOL, ABS_TOL = 1e-4, 1e-7


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


# Adam's kernel on every path. A global optimizer step hook counts, phase by
# phase, the steps of FusedAdam and of torch's own Adam on card float32
# leaves; at each phase's end the kernel's launches (set to 0 at its start)
# must equal FusedAdam's steps (one launch a step: one group of at most 16
# leaves on one device), and torch's own Adam may step there only in phase
# 2b, which holds the kernel to it. A Trainer that replays its step from a
# CUDA graph calls the step once, at the capture, which launches nothing
# (the hook sees the stream capturing); each replay launches once without a
# call: FusedAdam's steps are the hook's uncaptured ones plus the replays
# (the program's count ``step#replay``). Phase 12b holds the launches counted
# a replay to the kernels a profile of the replays records.
ADAM_COUNTS: dict[str, dict] = {}
_adam_now: dict = {"phase": None, "fused": 0, "torch": 0, "captures": 0, "replays": 0}


def adam_step_hook(optimizer, args, kwargs) -> None:
    import torch
    from pinn_depthestimation_tpu_torch.optim.adam import FusedAdam

    leaves = [p for g in optimizer.param_groups for p in g["params"]]
    if isinstance(optimizer, torch.optim.Adam) and all(
            p.is_cuda and p.dtype == torch.float32 for p in leaves):
        if torch.cuda.is_current_stream_capturing():
            _adam_now["captures"] += 1
        else:
            _adam_now["fused" if isinstance(optimizer, FusedAdam) else "torch"] += 1


def close_adam_count() -> None:
    """The running phase's Adam launches and steps, into ``ADAM_COUNTS``."""
    from pinn_depthestimation_tpu_torch import tracing
    from pinn_depthestimation_tpu_torch.optim import adam

    name = _adam_now["phase"]
    if name is None:
        return
    _adam_now["phase"] = None
    captures = _adam_now["captures"]
    replays = tracing.counts().get("step#replay", 0) - _adam_now["replays"]
    launches, plain = adam.fused_adam_update.launches, _adam_now["torch"]
    fused = _adam_now["fused"] + replays
    if launches or fused or plain:
        ADAM_COUNTS[name] = {"launches": launches, "steps": fused, "replays": replays}
        print(f"  Adam in phase {name}: {launches} launches of its kernel, {fused} FusedAdam "
              f"steps on card float32 leaves ({replays} of them graph replays, "
              f"{captures} captures)" + (f", {plain} of torch.optim.Adam" if plain else ""))
    if launches != fused:
        fail(f"phase {name}: Adam's kernel launched {launches} times for {fused} FusedAdam steps")
    if plain and name != "2b":
        fail(f"phase {name}: torch.optim.Adam stepped {plain} times on card float32 leaves, "
             "bypassing Adam's kernel")


def phase(title: str) -> None:
    """Starts a phase: closes the last one's Adam count, prints the title
    and sets Adam's launches to 0 (the step hook put in place at the
    first)."""
    from torch.optim.optimizer import register_optimizer_step_post_hook

    from pinn_depthestimation_tpu_torch import tracing
    from pinn_depthestimation_tpu_torch.ops import kernels
    from pinn_depthestimation_tpu_torch.optim import adam

    if "hook" not in _adam_now:
        _adam_now["hook"] = register_optimizer_step_post_hook(adam_step_hook)
    close_adam_count()
    print(f"== phase {title}")
    kernels.reset_launches(adam.fused_adam_update)
    _adam_now.update(phase=title.split(":")[0], fused=0, torch=0, captures=0,
                     replays=tracing.counts().get("step#replay", 0))


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


def compare_tier(name: str, got, want_tier, want_f32, want_tier64, tier: str = "bf16",
                 rel_floor: float = REL_TOL, distinct: float = 0.0) -> tuple[float, bool]:
    """A kernel output at a reduced tier (bf16, or f32x3 with ``rel_floor``
    ``X3_REL_FLOOR``) against its plain version at the tier (f32
    sums), at f32, and at the tier with float64 sums (``want_tier64``),
    held to the tier's own error. A gap is the L2 norm of a difference over
    the whole output. The kernel passes when gap(kernel, plain-bf16) <=
    max(gap(plain-bf16, plain-f32) / 4, 4 x spread) + f32's tolerance, where
    spread = gap(plain-bf16, plain-bf16 with f64 sums): the distance between
    two valid summation orders of the same bf16 function. On shallow nets
    the spread is f32 roundoff and the quarter of the tier's error binds; in
    a deep chain one f32 roundoff can flip one bf16 rounding and move that
    point's output about as far as the tier's own roundings do, so the
    spread reaches 0.1-0.28 of the tier's error (PERF.md) and no
    implementation with its own summation order can beat it. The kernel
    and the plain version carry independent f32 noise, the kernel's from
    its own sums (sequential FMAs, 128-point tiles), so their gap is a few
    times the spread: up to 2.97 x on the width-32 stack (PERF.md); 4 x
    leaves room for the few points that flip. Where the
    tier's error exceeds the floor, gap(kernel, plain-f32) must reach half
    of it (a kernel that forgot to round fails). The floor is ``rel_floor``
    x |plain| + ABS_TOL: f32's tolerance at bf16; at f32x3, whose own error
    is ~1e-5 of the output, a floor above f32's own L2 noise (PERF.md). At
    f32x3 the spread is most of the tier's error on deep stacks (a flipped
    hi rounding moves lo by the tier's own 2^-16), so 4 x spread binds; and
    where the spread reaches the tier's error (up to 1.8 x it on the
    flagship's backward, PERF.md) no output can show the tier apart from
    f32, so with ``distinct`` the half-the-error check and the returned
    flag need the tier's error above ``distinct`` x spread too. Prints every
    gap and the maxima; returns the kernel's max abs error against the
    plain tier (for the ``kernels`` line) and whether the tier's error
    exceeded the floor (and ``distinct`` x spread)."""
    if got.shape != want_tier.shape:
        fail(f"{name}: shape {tuple(got.shape)} != plain {tuple(want_tier.shape)}")
    if not bool(got.isfinite().all()):
        fail(f"{name}: non-finite kernel output")
    l2 = lambda d: float(d.double().norm())  # noqa: E731
    label = tier
    err, tier, off = l2(got - want_tier), l2(want_tier - want_f32), l2(got - want_f32)
    spread = l2(want_tier.double() - want_tier64)
    floor = rel_floor * l2(want_tier) + ABS_TOL
    limit = max(0.25 * tier, 4 * spread) + floor
    err_max = float((got - want_tier).abs().max())
    tier_max = float((want_tier - want_f32).abs().max())
    print(f"  {name}: L2 gap(kernel, plain-{label}) {err:.3e}, gap(plain-{label}, plain-f32) "
          f"{tier:.3e}, spread {spread:.3e}, gap(kernel, plain-f32) {off:.3e}; limit "
          f"{limit:.3e} ({'4 x spread' if 4 * spread > 0.25 * tier else 'gap/4'} + "
          f"{rel_floor:g} x |plain| + {ABS_TOL:g}); max |diff| {err_max:.3e} against the "
          f"tier's {tier_max:.3e}")
    if not err <= limit:
        fail(f"{name}: the {label} kernel disagrees with its plain {label} version")
    real = tier > floor and tier > distinct * spread
    if real and not off >= 0.5 * tier:
        fail(f"{name}: the {label} kernel sits nearer plain f32 than the tier allows: it does "
             "not round as the tier does")
    return err_max, real


def f64(params) -> dict:
    """The parameters in float64, for the plain bf16 versions with exact sums."""
    return {k: v.double() for k, v in params.items()}


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


def device_ms(fn, calls: int, kernel: str):
    """Device time per call of ``fn``: the own times of the launches of
    ``kernel`` (a substring of the walk kernel's name) and of the walk's
    fixed-order reduction (and of the wide body's weight images) that
    ``torch.profiler`` records over ``calls``
    calls, after one warm-up call; None, said so, unless it recorded
    exactly one ``kernel`` launch per call (a profiler that drops events
    would undercount). CUDA events around back-to-back calls measure the
    host instead where a call takes longer to enqueue than the card takes
    to run it (the walk's kernels on the CMB grid)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and ("reduce_kernel" in e.name or "images_kernel" in e.name or kernel in e.name)]
    walks = sum(kernel in e.name for e in events)
    if walks != calls:
        print(f"  (torch.profiler recorded {walks} of {calls} {kernel} launches: no device time)")
        return None
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / calls


def fmt_ms(ms) -> str:
    """A device time for the log: ms, or 'not recorded'."""
    return "not recorded" if ms is None else f"{ms:.4f} ms"


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


def k2_issue_count(spec, n_points: int, n_tangents: int, tier: str) -> int:
    """The CUDA-core count of K2's tensor-core body (bf16, f32x3): warp
    instructions around the MMAs over every 16-point tile and hidden layer
    (``csrc/mlp_fwd_tangents_mma.cuh``; per tile and layer counted from the
    code: 300 and 462 at W=20, K=2, where phase 2 reads 304 and 467 in the
    SASS). With T column tiles, E = 4T elements a lane per stream and S = T
    * ceil(T/2) MMA steps a stream: S vector loads of B fragments, 2T bias
    loads, 19 a primal element (accurate tanhf and act'), K per element (the
    tangent products), and per stream its MMAs and conversions (bf16: S +
    2T packs; f32x3: 3S + 4T packs + 3 a split element). A model of the
    code, not a measurement."""
    T = -(-spec.width // 8)
    E, steps = 4 * T, T * -(-T // 2)
    per = steps + 2 * T + 19 * E + n_tangents * E
    per += (1 + n_tangents) * ((steps + 2 * T) if tier == "bf16" else (3 * steps + 4 * T + 3 * E))
    return -(-n_points // 16) * (spec.n_hidden - 1) * per


def issue_ms(count: int) -> float:
    """The time ``count`` warp instructions take when each of the SMs' four
    schedulers issues one a clock at the card's maximum SM clock."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    return count / (sms * 4 * clock_hz) * 1e3


def sass_kernels(so_path: str) -> dict:
    """Per kernel of a built library (``cuobjdump -sass``): its HMMA
    instructions, and the instructions and HMMA of its innermost loop that
    holds an HMMA (K2's hidden layer), or None where none does."""
    from pinn_depthestimation_tpu_torch.ops import cuda_build

    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so_path], check=True, capture_output=True,
                          text=True, timeout=300).stdout
    out = {}
    for fn in sass.split("Function : ")[1:]:
        code = [(int(m.group(1), 16), line) for line in fn.split("\n")
                if (m := re.search(r"/\*([0-9a-f]{4,})\*/", line))]
        loops = []
        for at, line in code:  # a branch back to an earlier address closes a loop
            target = re.search(r"BRA\s.*?0x([0-9a-f]+)", line)
            if target and int(target.group(1), 16) < at:
                body = [ln for a, ln in code if int(target.group(1), 16) <= a <= at]
                if any("HMMA" in ln for ln in body):
                    loops.append((len(body), sum("HMMA" in ln for ln in body)))
        out[fn.split("\n")[0].strip()] = (fn.count("HMMA"), min(loops) if loops else None)
    return out


def walk_sass_report(libs: dict) -> None:
    """Phase 2's lines for the narrow walk's libraries (K1, K3, K4 at every
    width and tier, ``cuobjdump -sass``, read at once): the HMMA of each
    walk kernel (the reduction kernel aside) and of its innermost HMMA
    loop; an HMMA in every bf16 and f32x3 walk kernel (the tensor-core body,
    ``csrc/mlp_bwd_mma.cuh``) and none at f32, or the phase fails."""
    from concurrent.futures import ThreadPoolExecutor

    from pinn_depthestimation_tpu_torch.ops import cuda_build

    keys = [(name, w, tier) for name, built in libs.items() for w in sorted(built.libs)
            for tier in cuda_build.TIERS]
    with ThreadPoolExecutor(max_workers=16) as pool:
        sass = dict(zip(keys, pool.map(lambda k: sass_kernels(
            str(libs[k[0]].log_path.parent / f"lib{k[0]}_{k[1]}_{k[2]}.so")), keys)))
    for name in libs:
        for tier in cuda_build.TIERS:
            walks = [n for (nm, _, t), fns in sass.items() if nm == name and t == tier
                     for fn, (n, _) in fns.items() if "reduce_kernel" not in fn]
            loops = [lp for (nm, _, t), fns in sass.items() if nm == name and t == tier
                     for _, lp in fns.values() if lp]
            print(f"  SASS of {name.upper()} {tier}, widths {sorted(libs[name].libs)}: "
                  f"{len(walks)} walk kernels, HMMA per kernel "
                  f"{min(walks, default=0)}..{max(walks, default=0)}"
                  + (f"; innermost HMMA loops {min(loops)[0]}..{max(loops)[0]} instructions, "
                     f"{min(lp[1] for lp in loops)}..{max(lp[1] for lp in loops)} HMMA"
                     if loops else ""))
            if not walks or not all((n == 0) == (tier == "f32") for n in walks):
                fail(f"{name.upper()}-{tier}: expected {'no' if tier == 'f32' else 'an'} HMMA "
                     "in every walk kernel")


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


def wg_flops(spec, n_points: int, n_tangents: int) -> float:
    """The weight-gradient products among the operations of K1, K3 and K4
    (:func:`k1_flops`, :func:`k3_flops`, :func:`k4_flops`): 2*(1+K)*((L-1)*W^2 +
    W*d_out) + 2*d_in*W per point. The bf16 tier keeps them f32 (ops/tiers.py
    mm_tn, the JAX ops/kernels_vjp.py:257-259), on the CUDA cores."""
    W, d_in, d_out, n_stack = spec.width, spec.d_in, spec.d_out, spec.n_hidden - 1
    return float(n_points) * (2 * (1 + n_tangents) * (n_stack * W * W + W * d_out)
                              + 2 * d_in * W)


def bf16_bound(bound, bound_bf16, flops: float, nbytes: float, wg: float = 0.0):
    """The bf16 tier's bound: its tier-typed products (``flops - wg``) over
    the tensor cores' rate, its f32 weight-gradient products (``wg``) over
    the CUDA cores' FMA rate, or the bytes, whichever takes longest."""
    t_tc, by_tc = bound_bf16(flops - wg, nbytes)
    if not wg:
        return t_tc, by_tc
    t_cc, by_cc = bound(wg, nbytes)
    return (t_tc, by_tc) if t_tc >= t_cc else (t_cc, by_cc)


def k1_bytes(params, n_points: int, d_in: int, n_true: int) -> float:
    """Each input read once (coords, trues, sel, mask, the weights) and each
    output written once (the gradients, the statistics)."""
    weights = sum(int(t.numel()) for t in params.values()) * 4
    return float(2 * weights + 8 * 4 + n_points * (d_in + n_true + 2) * 4)


def k2_cases(dev):
    """Phase 3's cases ``[(spec, params, x, tangent counts)]``: the
    2->[20]x100->3 flagship (xavier, seeded numpy weights) at a ragged N for
    K=0, K=2 and the continuity epilogue; a small leaky-relu net (K=1, K=3);
    a width-32 stack deeper than one shared-memory chunk holds."""
    import numpy as np
    import torch

    from pinn_depthestimation_tpu_torch import benchmarks
    from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy

    flagship = MLPSpec(sizes=benchmarks.FLAGSHIP_SIZES, init_type="xavier")
    rng = np.random.RandomState(7)
    cases = [
        (flagship, numpy_params(flagship.sizes, "xavier", 1), 100_003, (0, 2)),
        (MLPSpec(sizes=(3,) + (10,) * 6 + (4,), init_type="kaiming"),
         None, 4_099, (1, 3)),
        (MLPSpec(sizes=(2,) + (32,) * 120 + (3,), init_type="xavier"),  # 3 smem chunks
         None, 5_003, (2,)),
    ]
    out = []
    for spec, arrays, n, tangent_counts in cases:
        arrays = arrays or numpy_params(spec.sizes, spec.init_type, 2)
        x = torch.as_tensor(rng.uniform(-1, 1, (n, spec.d_in)).astype(np.float32)).to(dev)
        out.append((spec, params_from_numpy(arrays, dev), x, tangent_counts))
    return out


def k2_ragged_cases(dev):
    """Phase 3's cases around K2-f32's launch plan, as :func:`k2_cases`: a
    2->[20]x6->3 net at 1, 17, 255 and 257 points, the flagship at the
    serving grid's 21,141, the legacy net (5->[20]x20->4) at its 26,691
    residual points (K=3, K=0), and the 2->[32]x100->3 stack, which takes
    several shared-memory chunks at f32; seeded numpy weights, uniform
    points."""
    import numpy as np
    import torch

    from pinn_depthestimation_tpu_torch import benchmarks
    from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy

    rng = np.random.RandomState(9)
    short = MLPSpec(sizes=(2,) + (20,) * 6 + (3,), init_type="xavier")
    cases = [(short, n, (0, 2)) for n in (1, 17, 255, 257)] + [
        (MLPSpec(sizes=benchmarks.FLAGSHIP_SIZES, init_type="xavier"), 21_141, (0,)),
        (MLPSpec(sizes=(5,) + (20,) * 20 + (4,), init_type="xavier"), 26_691, (3, 0)),
        (MLPSpec(sizes=(2,) + (32,) * 100 + (3,), init_type="xavier"), 5_003, (0, 2)),
    ]
    out = []
    for spec, n, tangent_counts in cases:
        x = torch.as_tensor(rng.uniform(-1, 1, (n, spec.d_in)).astype(np.float32)).to(dev)
        params = params_from_numpy(numpy_params(spec.sizes, spec.init_type, 4), dev)
        out.append((spec, params, x, tangent_counts))
    return out


def f32_plan_text(spec, n: int, n_tangents: int, dev) -> str:
    """K2-f32's plan of one launch (``ops/k2_plan.py::f32_plan``), for the log."""
    from pinn_depthestimation_tpu_torch.ops import cuda_build, k2_plan

    p = k2_plan.card_f32_plan(cuda_build.k2_library().libs[spec.width], n, spec.width,
                              spec.n_hidden - 1, n_tangents, dev)
    return (f"{p.lanes} lane(s) a point, {p.grid} blocks x {p.warps} warps, {p.rounds} rounds, "
            f"{p.chunk} hidden layers a chunk in {p.slots} slot(s), {p.smem} B")


def k2_f32_ptxas(log: str, lib) -> None:
    """Phase 2's lines for K2-f32 from one width's ptxas report: per lanes a
    point, the registers and spill stores of its kernels beside the
    registers a thread its largest block allows (``k2_f32_threads``)."""
    per = {}
    for block in log.split("Compiling entry function '")[1:]:
        m = re.match(r"_ZN5k2f3213k2_f32_kernelILi(\d+)ELi(\d)ELi(\d)ELi(\d)ELb(\d)E", block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        if m and regs:
            per.setdefault(int(m.group(2)), []).append(
                (int(m.group(4)), int(regs.group(1)), int(spill.group(1)) if spill else 0))
    for lanes, kernels in sorted(per.items()):
        caps = {k: 65536 // lib.k2_f32_threads(lanes, k) for k, _, _ in kernels}
        print(f"    K2-f32 {lanes} lane(s) a point: registers by K "
              + ", ".join(f"K={k} {r} (cap {caps[k]})" for k, r, _ in sorted(set(kernels)))
              + f"; max spill stores {max(s for _, _, s in kernels)} B over {len(kernels)} kernels")


def newmethod_config(tmp: str, repo: str, **overrides) -> str:
    """``examples/newmethod.json`` on the synthetic 81x261 grid with 40.8 %
    NaN rows (12,516 training points), with ``overrides`` merged in; returns
    the config path."""
    mat = flagship_grid(tmp)
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


def ragged_points(lib, kernel: str, dev) -> list[int]:
    """Point counts around the walk's tiles (``ops/walk_plan.py``): one
    point, one either side of the smallest tile, the flagship's 12,516, and
    one either side of a full wave of the width's largest tiles at f32 (the
    last block then walks a second tile of one point, or the last tile is
    one short)."""
    import torch

    from pinn_depthestimation_tpu_torch.ops.walk_plan import TILE_STEP

    wave = (torch.cuda.get_device_properties(dev).multi_processor_count
            * getattr(lib, f"{kernel}_max_tile")())
    return [1, TILE_STEP - 1, TILE_STEP + 1, 12_516, wave - 1, wave + 1]


def adam_phase(dev) -> dict:
    """Phase 2b; returns Adam's entry of the ``kernels`` line (its
    launches are filled in at the end, from ``ADAM_COUNTS``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pinn_depthestimation_tpu_torch import benchmarks
    from pinn_depthestimation_tpu_torch.models.mlp import PARAM_KEYS
    from pinn_depthestimation_tpu_torch.optim import adam

    phase("2b: Adam's update (csrc/adam_step.cu) against torch.optim.Adam's foreach path")
    nets = {"flagship": benchmarks.FLAGSHIP_SIZES, "cmb": (2,) + (10,) * 10 + (6,),
            "legacy": (5,) + (20,) * 20 + (4,)}
    steps = 100

    def pair(sizes):
        init = numpy_params(sizes, "xavier", 8)
        ours = [torch.as_tensor(init[k]).to(dev) for k in PARAM_KEYS]
        ref = [p.clone() for p in ours]
        return ours, ref, adam.FusedAdam(ours, lr=1e-3), torch.optim.Adam(ref, lr=1e-3, foreach=True)

    def kernel_ms(opt, calls: int, match: str, per_call: int):
        """Device time of ``opt.step`` a call: the own times of the kernels
        whose names hold ``match``, unless the profiler dropped some."""
        opt.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                opt.step()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA and match in e.name]
        if len(events) != calls * per_call:
            print(f"  (torch.profiler recorded {len(events)} of {calls * per_call} {match} "
                  "launches: no device time)")
            return None
        return sum(e.time_range.elapsed_us() for e in events) / 1e3 / calls

    def host_us(opt, sched, calls: int = 2000) -> float:
        """Host time of a step and StepLR, untraced, the card not waited for."""
        for _ in range(100):
            opt.step()
            sched.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            opt.step()
            sched.step()
        us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        return us

    entry = {"name": "adam_step[f32]", "route": "cuda", "source": ADAM_SOURCE, "replaces": None,
             "library_ms": None, "max_abs_err": 0.0}
    for name, sizes in nets.items():
        ours, ref, fused, torch_adam = pair(sizes)
        scheds = [torch.optim.lr_scheduler.StepLR(o, step_size=30, gamma=0.8)
                  for o in (fused, torch_adam)]
        gen = torch.Generator(device=dev).manual_seed(9)
        before = adam.fused_adam_update.launches
        for t in range(steps):
            for p, q in zip(ours, ref):
                p.grad = torch.randn(p.shape, device=dev, generator=gen) * 10.0 ** (t % 5 - 3)
                q.grad = p.grad.clone()
            fused.step()
            torch_adam.step()
            for sched in scheds:
                sched.step()
        torch.cuda.synchronize()
        launched = adam.fused_adam_update.launches - before
        differ = {"p": sum(int((p != q).sum()) for p, q in zip(ours, ref))}
        for key in ("exp_avg", "exp_avg_sq"):
            differ[key] = sum(int((fused.state[p][key] != torch_adam.state[q][key]).sum())
                              for p, q in zip(ours, ref))
        n = sum(p.numel() for p in ours)
        print(f"  {name}: {len(ours)} leaves, {n} parameters, {steps} steps under StepLR(30, "
              f"0.8), {launched} launches; elements unequal to torch's foreach Adam: {differ}")
        if launched != steps or any(differ.values()):
            fail(f"Adam's kernel on the {name} leaves is not torch's foreach Adam bit for bit "
                 f"({launched} launches for {steps} steps, unequal elements {differ})")
        if name != "flagship":
            continue
        entry["parameters"] = n
        entry["ms"] = kernel_ms(fused, 200, "adam_kernel", 1)
        entry["plain_ms"] = kernel_ms(torch_adam, 200, "multi_tensor_apply_kernel", 7)
        entry["bound_ms"] = 28 * n / HBM_BYTES_PER_S * 1e3  # p, g, m, v read; p, m, v written
        entry["bound_by"] = "bytes"
        entry["host_us"] = host_us(fused, scheds[0])
        entry["plain_host_us"] = host_us(torch_adam, scheds[1])
        print(f"  flagship leaves: device {fmt_ms(entry['ms'])} a step (torch's seven foreach "
              f"kernels {fmt_ms(entry['plain_ms'])}, bound {entry['bound_ms']:.6f} ms by bytes); "
              f"host, step and StepLR untraced: {entry['host_us']:.1f} us (torch's "
              f"{entry['plain_host_us']:.1f} us)")
    return entry


def training_phases(dev, repo: str, bound, keep: str) -> dict:
    """Phases 7-10; returns K1's entry of the ``kernels`` line. Phase 8's
    trained model goes to ``keep`` (:func:`keep_run`)."""
    import numpy as np
    import torch

    from pinn_depthestimation_tpu_torch import benchmarks, cli
    from pinn_depthestimation_tpu_torch.config import load_config
    from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
    from pinn_depthestimation_tpu_torch.ops import kernels, kernels_step
    from pinn_depthestimation_tpu_torch.ops.walk_plan import card_plan
    from pinn_depthestimation_tpu_torch.training.driver import Trainer
    from pinn_depthestimation_tpu_torch.training.logging_utils import read_log

    flagship = MLPSpec(sizes=benchmarks.FLAGSHIP_SIZES, init_type="xavier")
    with tempfile.TemporaryDirectory() as tmp:
        # 7. K1 vs plain ---------------------------------------------------
        phase("7: K1 against its plain version on the card")
        cases, n_grid, flag_params = k1_cases(dev, repo, tmp)
        err_k1 = 0.0
        for name, spec, params, b in cases:
            lib = kernels_step.k1_library().libs[spec.width]
            plan = card_plan(lib, "k1", "f32", b.coords.shape[0], dev)
            chunk = lib.k1_chunk_layers(spec.n_hidden - 1, plan.tile)
            print(f" {name}: sizes {spec.d_in}->[{spec.width}]x{spec.n_hidden}->{spec.d_out} "
                  f"{spec.init_type}, N={b.coords.shape[0]}, selected {int(b.n_sel)}, "
                  f"{plan.tiles} tiles of {plan.tile} points on {plan.grid} blocks of "
                  f"{plan.threads} threads, {chunk} hidden layers per smem chunk")
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
        # ragged point counts around the tiles, at the flagship's width and
        # at width 10 (five neurons per lane)
        rng = np.random.RandomState(12)
        for width in (20, 10):
            spec = MLPSpec(sizes=(2,) + (width,) * 6 + (3,))
            params = params_from_numpy(numpy_params(spec.sizes, "xavier", 12), dev)
            for n in ragged_points(kernels_step.k1_library().libs[width], "k1", dev):
                x = torch.as_tensor(rng.uniform(-1, 1, (n, 2)).astype(np.float32)).to(dev)
                x[0, 0] = -0.5  # at least one anchored point
                tr = torch.as_tensor((rng.randn(n, 2) * 0.1).astype(np.float32)).to(dev)
                ones = torch.ones(n, device=dev)
                b = kernels_step.make_step_batch(x, tr, (x[:, 0] < 0.3).float(), ones, [1.0, 1.0],
                                                 2, 1.0, 1.0, anchor_depth=0.75, has_anchor=True)
                plan = card_plan(kernels_step.k1_library().libs[width], "k1", "f32", n, dev)
                print(f" ragged: 2->[{width}]x6->3, N={n}: {plan.tiles} tiles of {plan.tile} "
                      f"points on {plan.grid} blocks")
                (t1, (f1, r1)), g1 = kernels_step.fused_loss_and_grad(params, b, spec)
                torch.cuda.synchronize()
                (t2, (f2, r2)), g2 = kernels_step.fused_loss_and_grad_plain(params, b, spec)
                for term, got, want in (("total", t1, t2), ("fidelity", f1, f2),
                                        ("residual", r1, r2), *((f"d{k}", g1[k], g2[k]) for k in g1)):
                    compare(term, got, want)
                (t3, _), g3 = kernels_step.fused_loss_and_grad(params, b, spec)
                if not (torch.equal(t1, t3) and all(torch.equal(g1[k], g3[k]) for k in g1)):
                    fail(f"ragged K1 at N={n}, width {width}: two launches differ")

        # 8. the training path ---------------------------------------------
        phase("8: training path (CLI train, then CLI test on the trained model)")
        cfg_path = newmethod_config(
            tmp, repo, adam_optimizer={"max_it": 300}, snapshot_iteration=300,
            # tolerances below what 300 Adam steps reach, so L-BFGS runs
            lbfgs_optimizer={"max_it": 20, "max_evaluation": 25, "tolerance_grad": 1e-9,
                             "tolerance_change": 1e-12})
        run_name = "train_smoke"
        kernels.reset_launches(kernels_step.fused_loss_and_grad)
        kernels.reset_launches(kernels.mlp_fwd_tangents)
        kernels.reset_launches(kernels.fused_residual_continuity)
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
        keep_run(keep, "flagship", cfg_path, model)

        # 9. iteration-1 equality and a tracked prefix ----------------------
        phase("9: iteration 1 and a 20-step Adam prefix, K1 against the plain path")
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
        phase("10: training times")
        ms_k1 = cuda_ms(lambda: kernels_step.fused_loss_and_grad(flag_params, flag_batch, flagship), 7, 20)
        dev_k1 = device_ms(lambda: kernels_step.fused_loss_and_grad(flag_params, flag_batch, flagship),
                           20, "k1_train_step_kernel")
        plain_k1 = cuda_ms(lambda: kernels_step.fused_loss_and_grad_plain(flag_params, flag_batch, flagship), 5, 3)
        b_k1, by_k1 = bound(k1_flops(flagship, n_grid), k1_bytes(flag_params, n_grid, 2, 2))
        step = benchmarks.run_train_step_bench(device=dev)
        plan = card_plan(kernels_step.k1_library().libs[flagship.width], "k1", "f32", n_grid, dev)
        print(f"  K1 + reduction, {n_grid} points: {ms_k1:.4f} ms, device time {fmt_ms(dev_k1)} "
              f"(plain {plain_k1:.4f} ms, bound {b_k1:.4f} ms by {by_k1}, {b_k1 / ms_k1:.1%} of bound; "
              f"{k1_flops(flagship, 1):,.0f} FLOP per point; {plan.tiles} tiles of {plan.tile} "
              f"points on {plan.grid} blocks of {plan.threads} threads)")
        print(f"  run_train_step_bench: {json.dumps(step)}; K1 is "
              f"{ms_k1 / step['ms_per_iter']:.1%} of the Adam step")
        # the L-BFGS phase as examples/newmethod.json configures it (500
        # iterations, 625 evaluations), its tolerances lowered so that it
        # runs to those limits; several repetitions from the same weights.
        # tolerance_change 0 stops only on a step or loss change of exactly
        # zero: at 1e-12 the chaotic f32 trajectory stopped after 73
        # evaluations once K1's sums changed order
        def lbfgs_phase(max_it: int, max_eval: int):
            path = newmethod_config(tmp, repo, adam_optimizer={"max_it": 0},
                                    lbfgs_optimizer={"max_it": max_it, "max_evaluation": max_eval,
                                                     "tolerance_grad": 1e-9,
                                                     "tolerance_change": 0.0})
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
            "max_abs_err": err_k1, "ms": ms_k1, "device_ms": dev_k1, "plain_ms": plain_k1,
            "bound_ms": b_k1,
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


def cmb_bench_points(dev, tmp: str):
    """The points of ``run_cmb_step_bench``'s workload on the card: the
    ~20,500 collocation points and the 200 fidelity rows, with the files
    under ``tmp``."""
    import torch

    from pinn_depthestimation_tpu_torch.config import parse_config
    from pinn_depthestimation_tpu_torch.data import load_training_data
    from pinn_depthestimation_tpu_torch.parity import make_cmb_config
    from pinn_depthestimation_tpu_torch.utils import synthetic

    csv, mat = os.path.join(tmp, "fid.csv"), os.path.join(tmp, "res.mat")
    synthetic.make_cmb_dataset(csv, mat, nx=81, ny=261, n_csv=400, seed=6, nan_fraction=0.03)
    td = load_training_data(parse_config(
        make_cmb_config(csv, mat, 0, 0, interval=1, training_points=200)))
    return (csv, mat, torch.as_tensor(td.residual_input).to(dev),
            torch.as_tensor(td.fidelity_input).to(dev))


def k3_cases(dev, repo: str, tmp: str, res_pts, fid_pts):
    """Phase 11's cases ``[(name, spec, params, x, ybar, dybar, K)]``: the
    2->[10]x10->6 CMB net at K=2 on the ~20,500 points of the CMB bench grid
    and at K=0 on its 200 fidelity rows, the flagship at K=2 on the 12,516
    grid points, a leaky-relu net at K=1 and K=3, a width-32 stack deeper
    than one shared-memory chunk, a ragged N; seeded numpy weights and
    cotangents."""
    import numpy as np
    import torch

    from pinn_depthestimation_tpu_torch import benchmarks
    from pinn_depthestimation_tpu_torch.config import load_config
    from pinn_depthestimation_tpu_torch.data import load_training_data
    from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy

    cmb_net = MLPSpec(sizes=(2,) + (10,) * 10 + (6,), init_type="xavier")
    flagship = MLPSpec(sizes=benchmarks.FLAGSHIP_SIZES, init_type="xavier")
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
    out = []
    for name, spec, x, kt in cases:
        params = params_from_numpy(numpy_params(spec.sizes, spec.init_type, 8), dev)
        n = x.shape[0]
        ybar = torch.as_tensor(rng.randn(n, spec.d_out).astype(np.float32)).to(dev)
        dybar = torch.as_tensor(rng.randn(kt, n, spec.d_out).astype(np.float32)).to(dev)
        out.append((name, spec, params, x, ybar, dybar, kt))
    return out


def write_config(tmp: str, name: str, raw: dict, overrides: dict) -> str:
    """``raw`` with ``overrides`` merged in (a dict value into its section),
    written to a new file under ``tmp``; returns its path."""
    for key, value in overrides.items():
        if isinstance(value, dict):
            raw[key] = {**raw.get(key, {}), **value}
        else:
            raw[key] = value
    path = os.path.join(tmp, f"{name}_{len(os.listdir(tmp))}.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def cmb_config(tmp: str, repo: str, csv: str, mat: str, **overrides) -> str:
    """``examples/cmb.json`` with its files replaced by ``csv``/``mat`` and
    ``overrides`` merged in; returns the config path."""
    with open(os.path.join(repo, "examples", "cmb.json")) as f:
        raw = json.load(f)
    raw["data_fidelity"]["file"] = csv
    raw["data_residual"]["file"] = mat
    raw["data_test"]["file"] = mat
    return write_config(tmp, "cmb", raw, overrides)


def cmb_phases(dev, repo: str, bound, keep: str) -> dict:
    """Phases 11-13; returns K3's entry of the ``kernels`` line. Phase 12's
    trained model goes to ``keep`` (:func:`keep_run`)."""
    import numpy as np
    import torch
    from scipy.io import loadmat

    from pinn_depthestimation_tpu_torch import benchmarks, cli
    from pinn_depthestimation_tpu_torch.config import load_config, parse_config
    from pinn_depthestimation_tpu_torch.data import load_training_data
    from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
    from pinn_depthestimation_tpu_torch.ops import kernels, kernels_vjp
    from pinn_depthestimation_tpu_torch.ops.walk_plan import card_plan
    from pinn_depthestimation_tpu_torch.parity import make_cmb_config
    from pinn_depthestimation_tpu_torch.training.driver import Trainer
    from pinn_depthestimation_tpu_torch.training.logging_utils import read_log

    cmb_net = MLPSpec(sizes=(2,) + (10,) * 10 + (6,), init_type="xavier")
    with tempfile.TemporaryDirectory() as tmp:
        # the workload of run_cmb_step_bench: ~20,500 grid points, 200 rows
        csv, mat, res_pts, fid_pts = cmb_bench_points(dev, tmp)
        n_res, n_fid = res_pts.shape[0], fid_pts.shape[0]

        # 11. K3 vs plain ------------------------------------------------------
        phase("11: K3 against its plain version on the card")
        main_path = ("CMB net, residual grid", "CMB net, fidelity rows")
        inputs, err_k3 = {}, 0.0
        for name, spec, params, x, ybar, dybar, kt in k3_cases(dev, repo, tmp, res_pts, fid_pts):
            n = x.shape[0]
            lib = kernels_vjp.k3_library().libs[spec.width]
            plan = card_plan(lib, "k3", "f32", n, dev)
            chunk = lib.k3_chunk_layers(spec.n_hidden - 1, kt, plan.tile)
            print(f" {name}: sizes {spec.d_in}->[{spec.width}]x{spec.n_hidden}->{spec.d_out} "
                  f"{spec.init_type}, K={kt}, N={n}, {plan.tiles} tiles of {plan.tile} points on "
                  f"{plan.grid} blocks, {chunk} hidden layers per smem chunk")
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
        # ragged point counts around the tiles, on the CMB net at K=2
        rng = np.random.RandomState(14)
        params = params_from_numpy(numpy_params(cmb_net.sizes, "xavier", 14), dev)
        for n in ragged_points(kernels_vjp.k3_library().libs[10], "k3", dev):
            x = torch.as_tensor(rng.uniform(-1, 1, (n, 2)).astype(np.float32)).to(dev)
            ybar = torch.as_tensor(rng.randn(n, 6).astype(np.float32)).to(dev)
            dybar = torch.as_tensor(rng.randn(2, n, 6).astype(np.float32)).to(dev)
            plan = card_plan(kernels_vjp.k3_library().libs[10], "k3", "f32", n, dev)
            print(f" ragged: CMB net, K=2, N={n}: {plan.tiles} tiles of {plan.tile} points on "
                  f"{plan.grid} blocks")
            g1 = kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, cmb_net, 2)
            torch.cuda.synchronize()
            g2 = kernels_vjp.packed_mlp_bwd_plain(params, x, ybar, dybar, cmb_net, 2)
            for k in g1:
                compare(f"d{k}", g1[k], g2[k])
            g3 = kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, cmb_net, 2)
            if not all(torch.equal(g1[k], g3[k]) for k in g1):
                fail(f"ragged K3 at N={n}: two launches differ")

        # 12. the CMB training path ---------------------------------------------
        phase("12: CMB training path (CLI synth, train, then test on the trained model)")
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
        kernels.reset_launches(kernels.mlp_fwd_tangents)
        kernels.reset_launches(kernels_vjp.packed_mlp_bwd)
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
        keep_run(keep, "cmb", cfg_path, os.path.join(run_dir, "model.npz"))

        # iteration 1 and a tracked prefix, K2 + K3 against autograd ----------
        phase("12b: iteration 1 and a 20-step Adam prefix, K2 + K3 against autograd")
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
                if parity and mode == "auto":
                    graphed = tr
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
        if not graphed.graph_step or graphed._graph is None:
            fail("the CMB Trainer on the card did not replay its Adam step from a CUDA graph")
        recorded, counted = replayed_launches(graphed, 10)
        print(f"  10 more replays of its graph: the card ran {recorded} kernels by name, the "
              f"program counted {counted} launches")
        if recorded != counted or recorded != {"k2": 20, "k3": 20, "adam": 10}:
            fail("the launches counted for the graph's replays are not the kernels they ran")

        # 13. times ---------------------------------------------------------------
        phase("13: CMB times")
        times = {}
        for name in ("CMB net, residual grid", "CMB net, fidelity rows", "flagship, train grid"):
            params, x, ybar, dybar, spec, kt = inputs[name]
            ms = cuda_ms(lambda: kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, spec, kt), 7, 20)
            plain = cuda_ms(lambda: kernels_vjp.packed_mlp_bwd_plain(params, x, ybar, dybar, spec, kt), 5, 3)
            b, by = bound(k3_flops(spec, x.shape[0], kt), k3_bytes(params, spec, x.shape[0], kt))
            times[name] = (ms, plain, b, by)
            plan = card_plan(kernels_vjp.k3_library().libs[spec.width], "k3", "f32", x.shape[0], dev)
            print(f"  K3 {name} (K={kt}, {x.shape[0]} points): {ms:.4f} ms "
                  f"(plain {plain:.4f} ms, bound {b:.5f} ms by {by}, {b / ms:.1%} of bound; "
                  f"{k3_flops(spec, 1, kt):,.0f} FLOP per point; {plan.tiles} tiles of "
                  f"{plan.tile} points on {plan.grid} blocks)")
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


def replayed_launches(trainer, steps: int) -> tuple[dict, dict]:
    """``(recorded, counted)``: the K2, K3 and Adam kernels that a profile of
    ``steps`` replays of ``trainer``'s Adam step graph records by name, and
    the launches the program counted for them (noted at the capture, added
    a block). The profiler warms up over one replay first: a profile
    without its warm-up may miss the first kernel it should record."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from pinn_depthestimation_tpu_torch import tracing
    from pinn_depthestimation_tpu_torch.ops import kernels, kernels_vjp
    from pinn_depthestimation_tpu_torch.optim import adam

    kinds = {"k2": (kernels.mlp_fwd_tangents, "k2_f32_kernel"),
             "k3": (kernels_vjp.packed_mlp_bwd, "cotangent_walk_kernel"),
             "adam": (adam.fused_adam_update, "adam_kernel")}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        trainer._adam_steps(1)
        torch.cuda.synchronize()
        prof.step()
        before = {k: w.launches for k, (w, _) in kinds.items()}
        replays = tracing.counts().get("step#replay", 0)
        trainer._adam_steps(steps)
        torch.cuda.synchronize()
        prof.step()
    if tracing.counts().get("step#replay", 0) - replays != steps:
        fail(f"{steps} Adam steps of a captured CMB Trainer were not {steps} replays")
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    recorded = {k: sum(name in e.name for e in events) for k, (_, name) in kinds.items()}
    counted = {k: w.launches - before[k] for k, (w, _) in kinds.items()}
    if recorded != counted:
        names = [e.name[:60] for e in events]
        print(f"  the profile's {len(events)} device events: first {names[:4]}, "
              f"last {names[-4:]}")
    return recorded, counted


def k4_flops(spec, n_points: int, n_tangents: int) -> float:
    """K4's operations: K3's (:func:`k3_flops`) and the second replay of the
    hidden stack from the checkpoints, 2*(L-1)*W^2*(1+K) per point."""
    W, n_stack = spec.width, spec.n_hidden - 1
    return k3_flops(spec, n_points, n_tangents) + float(n_points) * 2 * n_stack * W * W * (1 + n_tangents)


class PlainFused:
    """``ops.kernels_vjp.fused_apply_with_tangents`` through the plain
    versions of K2 and K3/K4 at the tier, for a loss on the card: the
    reference phase 15 holds the kernels' loss and gradients to."""

    def __init__(self):
        import torch

        from pinn_depthestimation_tpu_torch.models.mlp import PARAM_KEYS
        from pinn_depthestimation_tpu_torch.ops import kernels, kernels_vjp

        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, spec, kt, precision, coords, *flat):
                y, dy = kernels.mlp_fwd_tangents_plain(dict(zip(PARAM_KEYS, flat)), coords,
                                                       spec, kt, precision)
                ctx.save_for_backward(coords, *flat)
                ctx.meta = (spec, kt, precision)
                return y.detach(), dy.detach()

            @staticmethod
            def backward(ctx, ybar, dybar):
                coords, *flat = ctx.saved_tensors
                spec, kt, precision = ctx.meta
                g = kernels_vjp.packed_mlp_bwd_plain(dict(zip(PARAM_KEYS, flat)), coords,
                                                     ybar.contiguous(), dybar.contiguous(),
                                                     spec, kt, precision)
                return (None, None, None, None, *(g[k] for k in PARAM_KEYS))

        self.module, self.keys, self.fn = kernels_vjp, PARAM_KEYS, Fn

    def __enter__(self):
        self.real = self.module.fused_apply_with_tangents
        self.module.fused_apply_with_tangents = (
            lambda params, coords, spec, kt, precision="f32", bwd_impl="auto": self.fn.apply(
                spec, kt, precision, coords.detach(), *(params[k] for k in self.keys)))
        return self

    def __exit__(self, *exc):
        self.module.fused_apply_with_tangents = self.real


class PickedBackward:
    """``ops.kernels_vjp.fused_apply_with_tangents`` with its backward
    picked (``bwd_impl``), for a loss on the card: how a user of the custom
    VJP reaches K3 at bf16 and K4 at f32 and f32x3, which no tier's default
    takes (the JAX package reaches them by ``impl=`` alone)."""

    def __init__(self, impl: str):
        from pinn_depthestimation_tpu_torch.ops import kernels_vjp

        self.module, self.impl = kernels_vjp, impl

    def __enter__(self):
        self.real = real = self.module.fused_apply_with_tangents
        self.module.fused_apply_with_tangents = (
            lambda params, coords, spec, kt, precision="f32", bwd_impl="auto": real(
                params, coords, spec, kt, precision, self.impl))
        return self

    def __exit__(self, *exc):
        self.module.fused_apply_with_tangents = self.real


def bf16_phases(dev, repo: str, bound, bound_bf16, f32_steps: dict) -> dict:
    """Phases 14-17; returns the ``kernels`` line's entries of K4-bf16,
    K2-bf16 and K1-bf16, and K3-bf16's times for K3's entry. ``f32_steps``:
    the f32 Adam steps of phases 10 and 13 (ms per iteration), printed
    beside the bf16 ones."""
    import numpy as np
    import torch
    from scipy.io import loadmat

    from pinn_depthestimation_tpu_torch import benchmarks, cli
    from pinn_depthestimation_tpu_torch.config import parse_config
    from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
    from pinn_depthestimation_tpu_torch.ops import k2_plan, kernels, kernels_step, kernels_vjp
    from pinn_depthestimation_tpu_torch.parity import make_cmb_config
    from pinn_depthestimation_tpu_torch.training.driver import Trainer
    from pinn_depthestimation_tpu_torch.training.loss import build_loss_fn, value_and_grad
    from pinn_depthestimation_tpu_torch.training.logging_utils import read_log

    flagship = MLPSpec(sizes=benchmarks.FLAGSHIP_SIZES, init_type="xavier")
    cmb_net = MLPSpec(sizes=(2,) + (10,) * 10 + (6,), init_type="xavier")
    wrappers = (kernels.mlp_fwd_tangents, kernels.fused_residual_continuity,
                kernels_step.fused_loss_and_grad, kernels_vjp.packed_mlp_bwd,
                kernels_vjp.packed_mlp_bwd_rebuild)

    def reset_counts():
        for w in wrappers:
            kernels.reset_launches(w)

    def counts() -> dict:
        return {w.__name__: dict(w.launches_by_tier) for w in wrappers}

    main_path = ("CMB net, residual grid", "CMB net, fidelity rows")
    with tempfile.TemporaryDirectory() as tmp:
        csv, mat, res_pts, fid_pts = cmb_bench_points(dev, tmp)
        n_res = res_pts.shape[0]

        # 14. the bf16 tier and K4 against their plain versions -----------------
        phase("14: K2-bf16, K1-bf16, K3-bf16, K4-f32 and K4-bf16 against their "
              "plain versions on the card")
        err = {"k2": 0.0, "k1": 0.0, "k3": 0.0, "k4": 0.0, "k4_f32": 0.0}

        def tier_case(name, outs, main=None):
            """outs: [(label, kernel, plain-bf16, plain-f32, plain-bf16 with f64
            sums)]; one real tier gap needed."""
            real = []
            for label, got, want, want32, want64 in outs:
                e, r = compare_tier(f"{name}: {label}", got, want, want32, want64)
                real.append(r)
                if main:
                    err[main] = max(err[main], e)
            if not any(real):
                fail(f"{name}: no output shows the bf16 tier's error above the floor")

        with torch.no_grad():
            rng = np.random.RandomState(17)
            k2_more = [
                ("CMB net, residual grid", cmb_net, res_pts, (2,)),
                ("CMB net, fidelity rows", cmb_net, fid_pts, (0,)),
                ("CMB net, ragged N", cmb_net,
                 torch.as_tensor(rng.uniform(-1, 1, (1_001, 2)).astype(np.float32)).to(dev), (2,)),
            ]
            for spec, params, x, tangent_counts in k2_cases(dev):
                k2_more.append((f"{spec.d_in}->[{spec.width}]x{spec.n_hidden}->{spec.d_out} "
                                f"{spec.init_type}", spec, x, tangent_counts, params))
            for case in k2_more:
                name, spec, x, tangent_counts = case[:4]
                params = case[4] if len(case) > 4 else params_from_numpy(
                    numpy_params(spec.sizes, spec.init_type, 8), dev)
                plan = k2_plan.card_plan(kernels.k2_library().libs[spec.width], x.shape[0],
                                         spec.width, spec.n_hidden - 1, "bf16", x.device)
                print(f" K2-bf16 {name}, N={x.shape[0]}, {plan.chunk} hidden layers per bf16 "
                      f"smem chunk (ops/k2_plan.py)")
                for k in tangent_counts:
                    y, dy = kernels.mlp_fwd_tangents(params, x, spec, k, precision="bf16")
                    torch.cuda.synchronize()
                    yb, dyb = kernels.mlp_fwd_tangents_plain(params, x, spec, k, "bf16")
                    yf, dyf = kernels.mlp_fwd_tangents_plain(params, x, spec, k, "f32")
                    y64, dy64 = kernels.mlp_fwd_tangents_plain(f64(params), x.double(), spec, k, "bf16")
                    main = "k2" if name in main_path else None
                    tier_case(name, [(f"K={k} y", y, yb, yf, y64)]
                              + ([(f"K={k} dy", dy, dyb, dyf, dy64)] if k else []), main)
                    y2, dy2 = kernels.mlp_fwd_tangents(params, x, spec, k, precision="bf16")
                    if not (torch.equal(y, y2) and torch.equal(dy, dy2)):
                        fail(f"K2-bf16 {name}: two launches differ")
                if spec.d_out == 3 and spec.init_type == "xavier":
                    fc = kernels.fused_residual_continuity(params, x, spec, precision="bf16")
                    torch.cuda.synchronize()
                    tier_case(name, [("continuity epilogue fc", fc,
                                      kernels.residual_continuity_plain(params, x, spec, "bf16"),
                                      kernels.residual_continuity_plain(params, x, spec, "f32"),
                                      kernels.residual_continuity_plain(f64(params), x.double(),
                                                                        spec, "bf16"))])

        cases, n_grid, flag_params = k1_cases(dev, repo, tmp)
        for name, spec, params, b in cases:
            print(f" K1-bf16 {name}: sizes {spec.d_in}->[{spec.width}]x{spec.n_hidden}->"
                  f"{spec.d_out}, N={b.coords.shape[0]}")
            (t1, (f1, r1)), g1 = kernels_step.fused_loss_and_grad(params, b, spec, precision="bf16")
            torch.cuda.synchronize()
            (tb, (fb, rb)), gb = kernels_step.fused_loss_and_grad_plain(params, b, spec, "bf16")
            (tf, (ff, rf)), gf = kernels_step.fused_loss_and_grad_plain(params, b, spec, "f32")
            b64 = dataclasses.replace(b, **{k: getattr(b, k).double() for k in (
                "coords", "trues", "sel", "mask", "fid_weights", "n_res", "n_sel", "scal")})
            (t6, (f6, r6)), g6 = kernels_step.fused_loss_and_grad_plain(f64(params), b64, spec, "bf16")
            main = "k1" if spec.sizes == flagship.sizes else None
            tier_case(name, [("total", t1, tb, tf, t6), ("fidelity", f1, fb, ff, f6),
                             ("residual", r1, rb, rf, r6)]
                      + [(f"d{k}", g1[k], gb[k], gf[k], g6[k]) for k in kernels_step.FLAT_KEYS],
                      main)
            (t2, _), g2 = kernels_step.fused_loss_and_grad(params, b, spec, precision="bf16")
            if not (torch.equal(t1, t2) and all(torch.equal(g1[k], g2[k]) for k in g1)):
                fail(f"K1-bf16 {name}: two launches differ")
        flag_batch = cases[0][3]

        k34 = k3_cases(dev, repo, tmp, res_pts, fid_pts)
        short = MLPSpec(sizes=(2,) + (20,) * 11 + (3,))  # 10 stacked: segments 4, 4, 2
        xs = torch.as_tensor(rng.uniform(-1, 1, (2_050, 2)).astype(np.float32)).to(dev)
        k34.append(("short last K4 segment (C=4)", short,
                    params_from_numpy(numpy_params(short.sizes, "xavier", 8), dev), xs,
                    torch.as_tensor(rng.randn(2_050, 3).astype(np.float32)).to(dev),
                    torch.as_tensor(rng.randn(2, 2_050, 3).astype(np.float32)).to(dev), 2))
        bwd_inputs = {}
        for name, spec, params, x, ybar, dybar, kt in k34:
            ckpt = 4 if name.startswith("short") else 0
            cs = {t: kernels_vjp.rebuild_ckpt_every(spec, kt, t, ckpt, n_points=x.shape[0])
                  for t in ("f32", "bf16")}
            print(f" K3-bf16 / K4 {name}: sizes {spec.d_in}->[{spec.width}]x{spec.n_hidden}->"
                  f"{spec.d_out} {spec.init_type}, K={kt}, N={x.shape[0]}, K4 segments of "
                  f"{cs['f32']} (f32) and {cs['bf16']} (bf16) layers")
            gb = kernels_vjp.packed_mlp_bwd_plain(params, x, ybar, dybar, spec, kt, "bf16")
            gf = kernels_vjp.packed_mlp_bwd_plain(params, x, ybar, dybar, spec, kt, "f32")
            g6 = kernels_vjp.packed_mlp_bwd_plain(f64(params), x.double(), ybar.double(),
                                                  dybar.double(), spec, kt, "bf16")
            g3 = kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, spec, kt, precision="bf16",
                                            impl="stream")
            g4b = kernels_vjp.packed_mlp_bwd_rebuild(params, x, ybar, dybar, spec, kt,
                                                     precision="bf16", ckpt_every=ckpt)
            g4f = kernels_vjp.packed_mlp_bwd_rebuild(params, x, ybar, dybar, spec, kt,
                                                     precision="f32", ckpt_every=ckpt)
            torch.cuda.synchronize()
            main = "k4" if name in main_path else None
            tier_case(f"K3-bf16 {name}", [(f"d{k}", g3[k], gb[k], gf[k], g6[k]) for k in g3],
                      main and "k3")
            tier_case(f"K4-bf16 {name}", [(f"d{k}", g4b[k], gb[k], gf[k], g6[k]) for k in g4b],
                      main)
            for k in g4f:
                e4 = compare(f"K4-f32 {name}: d{k}", g4f[k], gf[k])
                if main:
                    err["k4_f32"] = max(err["k4_f32"], e4)
            g3f = kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, spec, kt, precision="f32")
            for tier, g4, g3t in (("f32", g4f, g3f), ("bf16", g4b, g3)):
                same = all(torch.equal(g4[k], g3t[k]) for k in g4)
                diff = max(float((g4[k] - g3t[k]).abs().max()) for k in g4)
                print(f"  K4 against K3 at {tier}: bit-identical {same} (max abs diff {diff:.3e})")
                again = kernels_vjp.packed_mlp_bwd_rebuild(params, x, ybar, dybar, spec, kt,
                                                           precision=tier, ckpt_every=ckpt)
                if not all(torch.equal(g4[k], again[k]) for k in g4):
                    fail(f"K4-{tier} {name}: two launches differ")
            g3b = kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, spec, kt, precision="bf16",
                                             impl="stream")
            if not all(torch.equal(g3[k], g3b[k]) for k in g3):
                fail(f"K3-bf16 {name}: two launches differ")
            print("  two launches bit-identical (K3-bf16, K4-f32, K4-bf16)")
            bwd_inputs[name] = (params, x, ybar, dybar, spec, kt)

        # 15. the CMB path at bf16 -------------------------------------------------
        phase("15: CMB path at bf16 (CLI synth, train, then test on the trained model)")
        synth = os.path.join(tmp, "synth")
        if cli.main(["synth", "--out", synth]) != 0:
            fail("synth failed")
        synth_csv, synth_mat = (os.path.join(synth, f) for f in ("input_fid.csv", "input_res.mat"))
        cfg_path = cmb_config(
            tmp, repo, synth_csv, synth_mat, adam_optimizer={"max_it": 300},
            data_residual={"interval_x": 1, "interval_y": 1}, kernel_precision="bf16",
            lbfgs_optimizer={"max_it": 20, "max_evaluation": 25, "tolerance_grad": 1e-9,
                             "tolerance_change": 1e-12})
        reset_counts()
        t0 = time.perf_counter()
        rc = cli.main(["train", "--config", cfg_path, "--log-root", tmp, "--run-name", "cmb_bf16",
                       "--device", "cuda", "--debug"])
        train_s = time.perf_counter() - t0
        if rc != 0:
            fail(f"CLI train on the bf16 CMB config exited {rc}")
        train_counts = counts()
        run_dir = os.path.join(tmp, "cmb_bf16")
        pred_out = os.path.join(tmp, "pred_cmb_bf16.mat")
        rc = cli.main(["test", "--config", cfg_path, "--model", os.path.join(run_dir, "model.npz"),
                       "--save", pred_out, "--device", "cuda", "--debug"])
        if rc != 0:
            fail(f"CLI test on the bf16 CMB model exited {rc}")
        cmb_counts = counts()
        print(f"  bf16 CMB-path launches by tier: {cmb_counts}")
        epochs, _, _, totals = read_log(run_dir)
        n_evals = len(epochs)
        if epochs != list(range(1, n_evals + 1)) or n_evals < 302:
            fail(f"log.txt rows are not epochs 1..n with n >= 302: {epochs[:3]}..{epochs[-3:]}")
        if not all(math.isfinite(v) for v in totals):
            fail("the bf16 CMB log holds a non-finite total")
        if not totals[299] < totals[0]:
            fail(f"Adam at bf16 did not lower the CMB loss: {totals[0]} -> {totals[299]}")
        if not min(totals[300:]) <= totals[299]:
            fail(f"L-BFGS minimum {min(totals[300:])} above the last Adam total {totals[299]}")
        k4_train = train_counts["packed_mlp_bwd_rebuild"]
        if k4_train["bf16"] != 2 * n_evals or k4_train["f32"]:
            fail(f"K4 launched {k4_train} times for {n_evals} bf16 loss evaluations "
                 "(2 bf16 launches per evaluation): some evaluation bypassed the kernel")
        if any(cmb_counts["packed_mlp_bwd"].values()) or any(cmb_counts["fused_loss_and_grad"].values()):
            fail(f"the bf16 CMB path launched K3 or K1: {cmb_counts}")
        k2_train = train_counts["mlp_fwd_tangents"]
        k2_test = cmb_counts["mlp_fwd_tangents"]["bf16"] - k2_train["bf16"]
        if k2_train["bf16"] != 2 * n_evals or k2_train["f32"] or k2_test < 1 \
                or cmb_counts["mlp_fwd_tangents"]["f32"]:
            fail(f"K2 launched {k2_train} in training for {n_evals} bf16 evaluations (2 bf16 "
                 f"per evaluation) and {k2_test} bf16 in CLI test")
        served, grid_x = loadmat(pred_out), loadmat(synth_mat)["x"]
        for key in ("h", "U", "V", "eta_mean", "Hrms", "k"):
            arr = served[f"pred_{key}"]
            if arr.shape != (261, 81) or not np.array_equal(np.isnan(arr), np.isnan(grid_x)):
                fail(f"the bf16 CMB model served pred_{key} of shape {arr.shape}, with NaN "
                     "elsewhere than at the grid's masked cells")
        print(f"  {n_evals} loss evaluations (300 Adam + {n_evals - 300} L-BFGS) at bf16, total "
              f"{totals[0]:.5e} -> {totals[299]:.5e} (Adam) -> {min(totals[300:]):.5e} (L-BFGS); "
              f"CLI train wall time {train_s:.2f} s")

        phase("15b: iteration 1 at bf16 through K2 + K4 against the plain bf16 functions")
        init = numpy_params(cmb_net.sizes, "xavier", 6)
        init["b_out"][3] += 1.0
        raw = dict(make_cmb_config(csv, mat, 20, 0, interval=1, training_points=200),
                   kernel_precision="bf16")
        os.makedirs(os.path.join(tmp, "it1_bf16"))
        tr = Trainer(parse_config(raw), run_dir=os.path.join(tmp, "it1_bf16"), echo_every=0,
                     initial_params=init, device=dev)
        if not tr.kernel_plan.fused:
            fail(f"the bf16 CMB Trainer chose {tr.kernel_plan} on the card")
        (tk, (fk, rk)), gk = tr.value_and_grad_fn(tr.state.params, tr.batch)
        torch.cuda.synchronize()
        ref = {}
        batch64 = {k: v.double() for k, v in tr.batch.items()}
        with PlainFused():
            for tier, params, batch in (("bf16", tr.state.params, tr.batch),
                                        ("f32", tr.state.params, tr.batch),
                                        ("bf16 f64", f64(tr.state.params), batch64)):
                fn = build_loss_fn(tr.config, tr.spec, input_min_max=tr.data.input_min_max,
                                   fused_kernel=True, fused_precision=tier.split()[0])
                ref[tier] = value_and_grad(fn)(params, batch)
        (tb, (fb, rb)), gb = ref["bf16"]
        (tf, (ff, rf)), gf = ref["f32"]
        (t6, (f6, r6)), g6 = ref["bf16 f64"]
        tier_case("CMB iteration 1", [("total", tk, tb, tf, t6), ("fidelity", fk, fb, ff, f6),
                                      ("residual", rk, rb, rf, r6)]
                  + [(f"d{k}", gk[k], gb[k], gf[k], g6[k]) for k in gk])

        # 16. the flagship under the precision schedule ---------------------------
        phase("16: flagship under --precision-schedule 150:bf16 (CLI train, resume, test)")
        lbfgs = {"max_it": 20, "max_evaluation": 25, "tolerance_grad": 1e-9,
                 "tolerance_change": 1e-12}
        cfg_full = newmethod_config(tmp, repo, adam_optimizer={"max_it": 300},
                                    snapshot_iteration=300, lbfgs_optimizer=lbfgs)
        reset_counts()
        rc = cli.main(["train", "--config", cfg_full, "--log-root", tmp, "--run-name", "sched",
                       "--precision-schedule", "150:bf16", "--device", "cuda", "--debug"])
        if rc != 0:
            fail(f"CLI train --precision-schedule exited {rc}")
        sched_dir = os.path.join(tmp, "sched")
        rc = cli.main(["test", "--config", cfg_full, "--model", os.path.join(sched_dir, "model.npz"),
                       "--save", os.path.join(tmp, "pred_sched.mat"), "--device", "cuda", "--debug"])
        if rc != 0:
            fail(f"CLI test on the scheduled model exited {rc}")
        sched_counts = counts()
        print(f"  schedule-path launches by tier: {sched_counts}")
        epochs, _, _, sched_totals = read_log(sched_dir)
        n_evals_s = len(epochs)
        k1c = sched_counts["fused_loss_and_grad"]
        if epochs != list(range(1, n_evals_s + 1)) or n_evals_s < 302:
            fail(f"log.txt rows are not epochs 1..n with n >= 302: {epochs[:3]}..{epochs[-3:]}")
        if k1c["bf16"] != 150 or k1c["f32"] != n_evals_s - 150:
            fail(f"K1 launched {k1c} for {n_evals_s} evaluations under a 150-step bf16 prefix "
                 "(150 bf16, the rest f32)")
        if not all(math.isfinite(v) for v in sched_totals) or not sched_totals[299] < sched_totals[0]:
            fail(f"the scheduled run did not lower the loss: {sched_totals[0]} -> {sched_totals[299]}")
        if not min(sched_totals[300:]) <= sched_totals[299]:
            fail("L-BFGS after the schedule ended above the last Adam total")
        if sched_counts["mlp_fwd_tangents"]["f32"] < 2:
            fail("the snapshot and CLI test did not both go through K2-f32")
        print(f"  {n_evals_s} evaluations: 150 K1-bf16, {k1c['f32']} K1-f32; total "
              f"{sched_totals[0]:.5e} -> {sched_totals[149]:.5e} (bf16 prefix) -> "
              f"{sched_totals[299]:.5e} (Adam) -> {min(sched_totals[300:]):.5e} (L-BFGS)")
        # a checkpoint inside the prefix: a 100-step run's final save
        cfg_short = newmethod_config(tmp, repo, adam_optimizer={"max_it": 100},
                                     lbfgs_optimizer={"max_it": 0})
        if cli.main(["train", "--config", cfg_short, "--log-root", tmp, "--run-name", "sched_100",
                     "--precision-schedule", "150:bf16", "--device", "cuda", "--debug"]) != 0:
            fail("the 100-step scheduled run failed")
        reset_counts()
        if cli.main(["train", "--config", cfg_full, "--log-root", tmp, "--run-name", "resumed",
                     "--resume", os.path.join(tmp, "sched_100", "model.npz"),
                     "--precision-schedule", "150:bf16", "--device", "cuda", "--debug"]) != 0:
            fail("the resumed scheduled run failed")
        resumed = counts()["fused_loss_and_grad"]
        epochs_r, _, _, totals_r = read_log(os.path.join(tmp, "resumed"))
        if epochs_r[0] != 101 or resumed["bf16"] != 50 or resumed["f32"] != len(epochs_r) - 50:
            fail(f"the resume from iteration 100 ran {resumed} K1 launches for epochs "
                 f"{epochs_r[0]}..{epochs_r[-1]} (50 bf16, then f32)")
        gap_r = max(abs(a - b) / abs(b) for a, b in zip(totals_r[:200], sched_totals[100:300]))
        print(f"  resumed at iteration 100: {resumed['bf16']} K1-bf16 then {resumed['f32']} K1-f32 "
              f"launches; Adam rows 101-300 against the uninterrupted run: max relative gap "
              f"{gap_r:.3e} (row 101: {abs(totals_r[0] - sched_totals[100]) / abs(sched_totals[100]):.3e})")
        if not abs(totals_r[0] - sched_totals[100]) <= 1e-6 * abs(sched_totals[100]):
            fail("the resumed run's first row differs from the uninterrupted run's")

        # 17. times -------------------------------------------------------------------
        phase("17: times of the bf16 tier and K4 (CUDA events; median of reps)")
        times = {}

        def timed(key, fn, reps, inner, flops, nbytes, bf16, wg=0.0):
            ms = cuda_ms(fn, reps, inner)
            b, by = (bf16_bound(bound, bound_bf16, flops, nbytes, wg) if bf16
                     else bound(flops, nbytes))
            times[key] = (ms, b, by)
            return ms, b, by

        spec10, p10, c10 = benchmarks.flagship_bench_inputs(10_000_000, dev)
        with torch.no_grad():
            for tier in ("f32", "bf16"):
                timed(f"k2 10M continuity {tier}",
                      lambda t=tier: kernels.fused_residual_continuity(p10, c10, spec10, precision=t),
                      5, 1, k2_flops(spec10, 10_000_000, 2, True),
                      k2_bytes(p10, 10_000_000, spec10, 1), tier == "bf16")
            plain_10m = cuda_ms(lambda: kernels.residual_continuity_plain(p10, c10, spec10, "bf16"), 3, 1)
        del p10, c10
        bench_bf16 = benchmarks.run_residual_bench(n_points=10_000_000, precision="bf16", device=dev)
        print(f"  run_residual_bench(precision='bf16'): {json.dumps(bench_bf16)}")
        serve_params = params_from_numpy(numpy_params(flagship.sizes, "xavier", 3), dev)
        from pinn_depthestimation_tpu_torch.config import load_config
        from pinn_depthestimation_tpu_torch.data import load_test_data
        x_serve = torch.as_tensor(load_test_data(load_config(cfg_full)).inputs).to(dev)
        n_serve = x_serve.shape[0]
        with torch.no_grad():
            p_cmb = bwd_inputs["CMB net, residual grid"][0]
            for tier in ("f32", "bf16"):
                timed(f"k2 cmb grid {tier}",
                      lambda t=tier: kernels.mlp_fwd_tangents(p_cmb, res_pts, cmb_net, 2, precision=t),
                      7, 20, k2_flops(cmb_net, n_res, 2, False),
                      k2_bytes(p_cmb, n_res, cmb_net, 3 * cmb_net.d_out), tier == "bf16")
            plain_cmb = cuda_ms(lambda: kernels.mlp_fwd_tangents_plain(p_cmb, res_pts, cmb_net, 2, "bf16"), 5, 3)
            for tier in ("f32", "bf16"):
                timed(f"k2 serve {tier}",
                      lambda t=tier: kernels.mlp_fwd_tangents(serve_params, x_serve, flagship, 0, precision=t),
                      7, 20, k2_flops(flagship, n_serve, 0, False),
                      k2_bytes(serve_params, n_serve, flagship, 3), tier == "bf16")
            plain_serve = cuda_ms(lambda: kernels.mlp_fwd_tangents_plain(serve_params, x_serve, flagship, 0, "bf16"), 5, 3)
            for tier in ("f32", "bf16"):
                timed(f"k1 {tier}",
                      lambda t=tier: kernels_step.fused_loss_and_grad(flag_params, flag_batch, flagship, precision=t),
                      7, 20, k1_flops(flagship, n_grid), k1_bytes(flag_params, n_grid, 2, 2), tier == "bf16",
                      wg_flops(flagship, n_grid, 2))
            plain_k1 = cuda_ms(lambda: kernels_step.fused_loss_and_grad_plain(flag_params, flag_batch, flagship, "bf16"), 5, 3)
            plain_bwd = {}
            for name in ("CMB net, residual grid", "CMB net, fidelity rows", "flagship, train grid"):
                params, x, ybar, dybar, spec, kt = bwd_inputs[name]
                nb = k3_bytes(params, spec, x.shape[0], kt)
                for tier in ("f32", "bf16"):
                    timed(f"k3 {name} {tier}",
                          lambda t=tier: kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, spec, kt, precision=t, impl="stream"),
                          7, 20, k3_flops(spec, x.shape[0], kt), nb, tier == "bf16",
                          wg_flops(spec, x.shape[0], kt))
                    timed(f"k4 {name} {tier}",
                          lambda t=tier: kernels_vjp.packed_mlp_bwd_rebuild(params, x, ybar, dybar, spec, kt, precision=t),
                          7, 20, k4_flops(spec, x.shape[0], kt), nb, tier == "bf16",
                          wg_flops(spec, x.shape[0], kt))
                plain_bwd[name] = cuda_ms(lambda: kernels_vjp.packed_mlp_bwd_plain(params, x, ybar, dybar, spec, kt, "bf16"), 5, 3)
                # the segment length C, on the card
                c_auto = kernels_vjp.rebuild_ckpt_every(spec, kt, "bf16", n_points=x.shape[0])
                sweep = {}
                for c in (1, 2, 3, 4, 6, 8, 10):
                    try:
                        kernels_vjp.rebuild_ckpt_every(spec, kt, "bf16", c, n_points=x.shape[0])
                    except ValueError:
                        continue
                    if c > spec.n_hidden - 1:
                        continue
                    sweep[c] = cuda_ms(lambda c=c: kernels_vjp.packed_mlp_bwd_rebuild(
                        params, x, ybar, dybar, spec, kt, precision="bf16", ckpt_every=c), 5, 10)
                times[f"k4 C sweep {name}"] = (c_auto, sweep)
                print(f"  K4-bf16 {name}: segment length C -> ms {dict((c, round(v, 4)) for c, v in sweep.items())}; planned C = {c_auto}")
        step = benchmarks.run_train_step_bench(kernel_precision="bf16", device=dev)
        cmb_step = benchmarks.run_cmb_step_bench(kernel_precision="bf16", device=dev)

    for key, value in times.items():
        if key.startswith("k4 C sweep"):
            continue
        ms, b, by = value
        print(f"  {key}: {ms:.4f} ms, bound {b:.5f} ms by {by} ({b / ms:.2%} of bound)")
    print(f"  plain bf16: continuity at 10M points {plain_10m:.3f} ms, CMB grid (K=2) "
          f"{plain_cmb:.3f} ms, serve grid {plain_serve:.3f} ms, "
          f"K1 flagship {plain_k1:.3f} ms, backward {dict((k, round(v, 4)) for k, v in plain_bwd.items())}")
    print(f"  Adam step at bf16: flagship {json.dumps(step)}; CMB {json.dumps(cmb_step)}; at "
          f"f32 (phases 10, 13): flagship {f32_steps['flagship']:.4f} ms, CMB "
          f"{f32_steps['cmb']:.4f} ms")
    issue = {"k2 10M continuity bf16": k2_issue_count(spec10, 10_000_000, 2, "bf16"),
             "k2 serve bf16": k2_issue_count(flagship, n_serve, 0, "bf16"),
             "k2 cmb grid bf16": k2_issue_count(cmb_net, n_res, 2, "bf16")}
    for key, count in issue.items():
        ms, b, _ = times[key]
        print(f"  {key}: {ms:.4f} ms against the tensor-core bound {b:.5f} ms ({b / ms:.2%}) "
              f"and the CUDA-core count {count:.4e} warp instructions (modelled; "
              f"{issue_ms(count):.4f} ms of issue at the max clock, {issue_ms(count) / ms:.1%})")

    res, fidr, flag = ("CMB net, residual grid", "CMB net, fidelity rows", "flagship, train grid")
    k4_ms, k4_b, k4_by = times[f"k4 {res} bf16"]
    k2_ms, k2_b, k2_by = times["k2 cmb grid bf16"]
    k1_ms, k1_b, k1_by = times["k1 bf16"]
    common = {"route": "cuda", "library_ms": None}
    k4_entry = {
        "name": "k4_mlp_bwd_rebuild[bf16]", **common, "source": K4_SOURCE, "replaces": K4_REPLACES,
        "launches": cmb_counts["packed_mlp_bwd_rebuild"]["bf16"], "max_abs_err": err["k4"],
        "ms": k4_ms, "plain_ms": plain_bwd[res],
        "bound_ms": k4_b, "bound_by": k4_by,
        "points": n_res, "ckpt_every": times[f"k4 C sweep {res}"][0],
        "ms_f32": times[f"k4 {res} f32"][0], "bound_ms_f32": times[f"k4 {res} f32"][1],
        "ms_fidelity_k0": times[f"k4 {fidr} bf16"][0], "ms_flagship_k2": times[f"k4 {flag} bf16"][0],
        "ms_flagship_k2_f32": times[f"k4 {flag} f32"][0],
        "bound_ms_flagship_k2": times[f"k4 {flag} bf16"][1],
        "ckpt_sweep_ms": {name: times[f"k4 C sweep {name}"][1] for name in (res, fidr, flag)},
        "cmb_adam_ms_per_iter_bf16": cmb_step["ms_per_iter"],
    }
    k2_entry = {
        "name": "k2_mlp_fwd_tangents[bf16]", **common, "source": K2_SOURCE, "replaces": REPLACES,
        "launches": cmb_counts["mlp_fwd_tangents"]["bf16"], "max_abs_err": err["k2"],
        "ms": k2_ms, "plain_ms": plain_cmb,
        "bound_ms": k2_b, "bound_by": k2_by,
        "points": n_res, "ms_f32": times["k2 cmb grid f32"][0],
        "ms_10m_continuity": times["k2 10M continuity bf16"][0],
        "ms_10m_continuity_f32": times["k2 10M continuity f32"][0],
        "bound_ms_10m_continuity": times["k2 10M continuity bf16"][1],
        "plain_ms_10m_continuity": plain_10m,
        "ms_serve_grid": times["k2 serve bf16"][0], "ms_serve_grid_f32": times["k2 serve f32"][0],
        "bound_ms_serve_grid": times["k2 serve bf16"][1], "plain_ms_serve_grid": plain_serve,
        "residual_evals_per_s": bench_bf16["value"],
    }
    k1_entry = {
        "name": "k1_continuity_train_step[bf16]", **common, "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": sched_counts["fused_loss_and_grad"]["bf16"],
        "max_abs_err": err["k1"], "ms": k1_ms,
        "plain_ms": plain_k1, "bound_ms": k1_b,
        "bound_by": k1_by, "points": n_grid, "ms_f32": times["k1 f32"][0],
        "adam_ms_per_iter_bf16": step["ms_per_iter"],
    }
    # K3-bf16 and K4-f32: their launches come from phase 19's path, which
    # picks the backward (main() completes the entries)
    k3_bf16_entry = {
        "name": "k3_mlp_bwd[bf16]", **common, "source": K3_SOURCE, "replaces": K3_REPLACES,
        "max_abs_err": err["k3"], "ms": times[f"k3 {res} bf16"][0],
        "plain_ms": plain_bwd[res],
        "bound_ms": times[f"k3 {res} bf16"][1], "bound_by": times[f"k3 {res} bf16"][2],
        "points": n_res, "ms_fidelity_k0": times[f"k3 {fidr} bf16"][0],
        "ms_flagship_k2": times[f"k3 {flag} bf16"][0],
    }
    k4_f32_entry = {
        "name": "k4_mlp_bwd_rebuild[f32]", **common, "source": K4_SOURCE, "replaces": K4_REPLACES,
        "max_abs_err": err["k4_f32"], "ms": times[f"k4 {res} f32"][0],
       
        "bound_ms": times[f"k4 {res} f32"][1], "bound_by": times[f"k4 {res} f32"][2],
        "points": n_res, "ckpt_every": kernels_vjp.rebuild_ckpt_every(
            cmb_net, 2, "f32", n_points=n_res),
        "ms_fidelity_k0": times[f"k4 {fidr} f32"][0], "ms_flagship_k2": times[f"k4 {flag} f32"][0],
    }
    return {"k4": k4_entry, "k2_bf16": k2_entry, "k1_bf16": k1_entry,
            "k3_bf16": k3_bf16_entry, "k4_f32": k4_f32_entry}


X3_REL_FLOOR = 2e-6  # compare_tier's floor at f32x3 (see compare_tier; PERF.md)
X3_DISTINCT = 2.0     # an f32x3 output shows its tier where its error > 2 x spread


def x3_bounds(bound, bound_bf16, flops: float, nbytes: float):
    """The f32x3 bound: the tier's three bf16 products on the tensor cores
    (989 TFLOP/s dense) or the bytes, whichever is larger; and beside it the
    same three products on the CUDA cores' f32 FMA rate."""
    b_tc, by_tc = bound_bf16(3 * flops, nbytes)
    b_cc, _ = bound(3 * flops, nbytes)
    return b_tc, by_tc, b_cc


def f32x3_phases(dev, repo: str, bound, bound_bf16) -> dict:
    """Phases 18-21: the f32x3 tier of K2, K1, K3 and K4 against its plain
    version, the paths that ask for it, the bench suite, and the times.
    Returns the ``kernels`` line's four f32x3 entries, the launches of K3-bf16
    and K4-f32 on phase 19's path, and the suite's record."""
    import contextlib
    import io

    import numpy as np
    import torch
    from scipy.io import loadmat

    from pinn_depthestimation_tpu_torch import benchmarks, cli
    from pinn_depthestimation_tpu_torch.config import load_config, parse_config
    from pinn_depthestimation_tpu_torch.data import load_test_data
    from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
    from pinn_depthestimation_tpu_torch.ops import k2_plan, kernels, kernels_step, kernels_vjp
    from pinn_depthestimation_tpu_torch.ops.walk_plan import card_plan
    from pinn_depthestimation_tpu_torch.parity import make_cmb_config
    from pinn_depthestimation_tpu_torch.training.driver import Trainer
    from pinn_depthestimation_tpu_torch.training.loss import build_loss_fn, value_and_grad
    from pinn_depthestimation_tpu_torch.training.logging_utils import read_log

    X3 = "f32x3"
    flagship = MLPSpec(sizes=benchmarks.FLAGSHIP_SIZES, init_type="xavier")
    cmb_net = MLPSpec(sizes=(2,) + (10,) * 10 + (6,), init_type="xavier")
    wrappers = (kernels.mlp_fwd_tangents, kernels.fused_residual_continuity,
                kernels_step.fused_loss_and_grad, kernels_vjp.packed_mlp_bwd,
                kernels_vjp.packed_mlp_bwd_rebuild)

    def reset_counts():
        for w in wrappers:
            kernels.reset_launches(w)

    def counts() -> dict:
        return {w.__name__: dict(w.launches_by_tier) for w in wrappers}

    def only(tiers_count: dict, tier: str) -> bool:
        return all(v == 0 for t, v in tiers_count.items() if t != tier)

    err = {"k2": 0.0, "k1": 0.0, "k3": 0.0, "k4": 0.0}
    shown = {"k2": 0, "k1": 0, "k3": 0, "k4": 0}  # outputs that show the tier apart from f32

    def tier_case(name, outs, main=None, kernel=None):
        """outs: [(label, kernel, plain-f32x3, plain-f32, plain-f32x3 with f64
        sums)]; counts the outputs whose tier error stands clear of the
        spread for ``kernel`` (each kernel needs some, checked after the
        phase: on the deep stacks the spread hides the tier)."""
        for label, got, want, want32, want64 in outs:
            e, r = compare_tier(f"{name}: {label}", got, want, want32, want64, tier=X3,
                                rel_floor=X3_REL_FLOOR, distinct=X3_DISTINCT)
            shown[kernel or main] += r
            if main:
                err[main] = max(err[main], e)

    def check_log(run_dir: str, what: str):
        epochs, _, _, totals = read_log(run_dir)
        n = len(epochs)
        if epochs != list(range(1, n + 1)) or n < 302:
            fail(f"{what}: log.txt rows are not epochs 1..n with n >= 302: "
                 f"{epochs[:3]}..{epochs[-3:]}")
        if not all(math.isfinite(v) for v in totals) or not totals[299] < totals[0]:
            fail(f"{what}: Adam did not lower the loss: {totals[0]} -> {totals[299]}")
        if not min(totals[300:]) <= totals[299]:
            fail(f"{what}: L-BFGS minimum {min(totals[300:])} above the last Adam total")
        return n, totals

    main_path = ("CMB net, residual grid", "CMB net, fidelity rows")
    lbfgs = {"max_it": 20, "max_evaluation": 25, "tolerance_grad": 1e-9,
             "tolerance_change": 1e-12}
    with tempfile.TemporaryDirectory() as tmp:
        csv, mat, res_pts, fid_pts = cmb_bench_points(dev, tmp)
        n_res = res_pts.shape[0]

        # 18. the f32x3 tier against its plain version ------------------------
        phase("18: K2-f32x3, K1-f32x3, K3-f32x3 and K4-f32x3 against the plain "
              "f32x3 versions on the card")
        with torch.no_grad():
            rng = np.random.RandomState(19)
            k2_more = [
                ("CMB net, residual grid", cmb_net, res_pts, (2,), None),
                ("CMB net, fidelity rows", cmb_net, fid_pts, (0,), None),
                ("CMB net, ragged N", cmb_net,
                 torch.as_tensor(rng.uniform(-1, 1, (1_001, 2)).astype(np.float32)).to(dev),
                 (2,), None),
            ]
            for spec, params, x, tangent_counts in k2_cases(dev):
                k2_more.append((f"{spec.d_in}->[{spec.width}]x{spec.n_hidden}->{spec.d_out} "
                                f"{spec.init_type}", spec, x, tangent_counts, params))
            for name, spec, x, tangent_counts, params in k2_more:
                params = params or params_from_numpy(numpy_params(spec.sizes, spec.init_type, 8), dev)
                plan = k2_plan.card_plan(kernels.k2_library().libs[spec.width], x.shape[0],
                                         spec.width, spec.n_hidden - 1, X3, x.device)
                print(f" K2-f32x3 {name}, N={x.shape[0]}, {plan.chunk} hidden layers per smem "
                      f"chunk (ops/k2_plan.py)")
                main = "k2" if name in main_path or spec.sizes == flagship.sizes else None
                for k in tangent_counts:
                    y, dy = kernels.mlp_fwd_tangents(params, x, spec, k, precision=X3)
                    torch.cuda.synchronize()
                    yx, dyx = kernels.mlp_fwd_tangents_plain(params, x, spec, k, X3)
                    yf, dyf = kernels.mlp_fwd_tangents_plain(params, x, spec, k, "f32")
                    y64, dy64 = kernels.mlp_fwd_tangents_plain(f64(params), x.double(), spec, k, X3)
                    tier_case(name, [(f"K={k} y", y, yx, yf, y64)]
                              + ([(f"K={k} dy", dy, dyx, dyf, dy64)] if k else []), main, "k2")
                    y2, dy2 = kernels.mlp_fwd_tangents(params, x, spec, k, precision=X3)
                    if not (torch.equal(y, y2) and torch.equal(dy, dy2)):
                        fail(f"K2-f32x3 {name}: two launches differ")
                    del yx, dyx, yf, dyf, y64, dy64
                if spec.d_out == 3 and spec.init_type == "xavier":
                    fc = kernels.fused_residual_continuity(params, x, spec, precision=X3)
                    torch.cuda.synchronize()
                    tier_case(name, [("continuity epilogue fc", fc,
                                      kernels.residual_continuity_plain(params, x, spec, X3),
                                      kernels.residual_continuity_plain(params, x, spec, "f32"),
                                      kernels.residual_continuity_plain(f64(params), x.double(),
                                                                        spec, X3))], main, "k2")

        cases, n_grid, flag_params = k1_cases(dev, repo, tmp)
        for name, spec, params, b in cases:
            lib = kernels_step.k1_library().libs[spec.width]
            chunk = lib.k1_chunk_layers_f32x3(
                spec.n_hidden - 1, card_plan(lib, "k1", X3, b.coords.shape[0], dev).tile)
            print(f" K1-f32x3 {name}: sizes {spec.d_in}->[{spec.width}]x{spec.n_hidden}->"
                  f"{spec.d_out}, N={b.coords.shape[0]}, {chunk} hidden layers per smem chunk")
            (t1, (f1, r1)), g1 = kernels_step.fused_loss_and_grad(params, b, spec, precision=X3)
            torch.cuda.synchronize()
            (tx, (fx, rx)), gx = kernels_step.fused_loss_and_grad_plain(params, b, spec, X3)
            (tf, (ff, rf)), gf = kernels_step.fused_loss_and_grad_plain(params, b, spec, "f32")
            b64 = dataclasses.replace(b, **{k: getattr(b, k).double() for k in (
                "coords", "trues", "sel", "mask", "fid_weights", "n_res", "n_sel", "scal")})
            (t6, (f6, r6)), g6 = kernels_step.fused_loss_and_grad_plain(f64(params), b64, spec, X3)
            main = "k1" if spec.sizes == flagship.sizes else None
            tier_case(name, [("total", t1, tx, tf, t6), ("fidelity", f1, fx, ff, f6),
                             ("residual", r1, rx, rf, r6)]
                      + [(f"d{k}", g1[k], gx[k], gf[k], g6[k]) for k in kernels_step.FLAT_KEYS],
                      main, "k1")
            (t2, _), g2 = kernels_step.fused_loss_and_grad(params, b, spec, precision=X3)
            if not (torch.equal(t1, t2) and all(torch.equal(g1[k], g2[k]) for k in g1)):
                fail(f"K1-f32x3 {name}: two launches differ")
        flag_batch = cases[0][3]

        k34 = k3_cases(dev, repo, tmp, res_pts, fid_pts)
        short = MLPSpec(sizes=(2,) + (20,) * 11 + (3,))  # 10 stacked: segments 4, 4, 2
        xs = torch.as_tensor(rng.uniform(-1, 1, (2_050, 2)).astype(np.float32)).to(dev)
        k34.append(("short last K4 segment (C=4)", short,
                    params_from_numpy(numpy_params(short.sizes, "xavier", 8), dev), xs,
                    torch.as_tensor(rng.randn(2_050, 3).astype(np.float32)).to(dev),
                    torch.as_tensor(rng.randn(2, 2_050, 3).astype(np.float32)).to(dev), 2))
        bwd_inputs = {}
        for name, spec, params, x, ybar, dybar, kt in k34:
            ckpt = 4 if name.startswith("short") else 0
            c = kernels_vjp.rebuild_ckpt_every(spec, kt, X3, ckpt, n_points=x.shape[0])
            print(f" K3-f32x3 / K4-f32x3 {name}: sizes {spec.d_in}->[{spec.width}]x"
                  f"{spec.n_hidden}->{spec.d_out} {spec.init_type}, K={kt}, N={x.shape[0]}, "
                  f"K4 segments of {c} layers")
            gx = kernels_vjp.packed_mlp_bwd_plain(params, x, ybar, dybar, spec, kt, X3)
            gf = kernels_vjp.packed_mlp_bwd_plain(params, x, ybar, dybar, spec, kt, "f32")
            g6 = kernels_vjp.packed_mlp_bwd_plain(f64(params), x.double(), ybar.double(),
                                                  dybar.double(), spec, kt, X3)
            g3 = kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, spec, kt, precision=X3)
            g4 = kernels_vjp.packed_mlp_bwd_rebuild(params, x, ybar, dybar, spec, kt,
                                                    precision=X3, ckpt_every=ckpt)
            torch.cuda.synchronize()
            main = name in main_path
            tier_case(f"K3-f32x3 {name}", [(f"d{k}", g3[k], gx[k], gf[k], g6[k]) for k in g3],
                      "k3" if main else None, "k3")
            tier_case(f"K4-f32x3 {name}", [(f"d{k}", g4[k], gx[k], gf[k], g6[k]) for k in g4],
                      "k4" if main else None, "k4")
            same = all(torch.equal(g4[k], g3[k]) for k in g4)
            diff = max(float((g4[k] - g3[k]).abs().max()) for k in g4)
            print(f"  K4 against K3 at f32x3: bit-identical {same} (max abs diff {diff:.3e})")
            for label, fn, first in (
                    ("K3", lambda: kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, spec, kt,
                                                              precision=X3), g3),
                    ("K4", lambda: kernels_vjp.packed_mlp_bwd_rebuild(
                        params, x, ybar, dybar, spec, kt, precision=X3, ckpt_every=ckpt), g4)):
                again = fn()
                if not all(torch.equal(first[k], again[k]) for k in first):
                    fail(f"{label}-f32x3 {name}: two launches differ")
            print("  two launches bit-identical (K3-f32x3, K4-f32x3)")
            bwd_inputs[name] = (params, x, ybar, dybar, spec, kt)
        print(f"  outputs that show the f32x3 tier apart from f32 (error > {X3_DISTINCT:g} x "
              f"spread): {shown}")
        if not all(shown.values()):
            fail(f"a kernel shows the f32x3 tier on no output: {shown}")

        # 19. the paths at f32x3 ------------------------------------------------
        phase("19: the paths at f32x3 (CLI train and test, the schedule, the "
              "backward picked by the loss)")
        # a. the flagship at f32x3, residual_chunk_size set (dropped on K1)
        cfg_x3 = newmethod_config(tmp, repo, adam_optimizer={"max_it": 300},
                                  snapshot_iteration=300, lbfgs_optimizer=lbfgs,
                                  kernel_precision=X3, residual_chunk_size=4096)
        reset_counts()
        if cli.main(["train", "--config", cfg_x3, "--log-root", tmp, "--run-name", "flag_x3",
                     "--device", "cuda", "--debug"]) != 0:
            fail("CLI train of the flagship at f32x3 (residual_chunk_size 4096) failed")
        flag_dir = os.path.join(tmp, "flag_x3")
        pred_out = os.path.join(tmp, "pred_flag_x3.mat")
        if cli.main(["test", "--config", cfg_x3, "--model", os.path.join(flag_dir, "model.npz"),
                     "--save", pred_out, "--device", "cuda", "--debug"]) != 0:
            fail("CLI test of the f32x3 flagship model failed")
        flag_counts = counts()
        print(f"  flagship f32x3 path launches by tier: {flag_counts}")
        n_flag, flag_totals = check_log(flag_dir, "the f32x3 flagship run")
        k1c, k2c = flag_counts["fused_loss_and_grad"], flag_counts["mlp_fwd_tangents"]
        if k1c[X3] != n_flag or not only(k1c, X3):
            fail(f"K1 launched {k1c} for {n_flag} f32x3 loss evaluations (all f32x3)")
        if k2c[X3] < 2 or not only(k2c, X3):
            fail(f"K2 launched {k2c}: the snapshot and CLI test go through K2-f32x3 only")
        served = loadmat(pred_out)
        x_serve = torch.as_tensor(load_test_data(load_config(cfg_x3)).inputs).to(dev)
        from pinn_depthestimation_tpu_torch.training.checkpoint import restore_params_any
        trained = restore_params_any(os.path.join(flag_dir, "model.npz"), spec=flagship, device=dev)
        got = torch.stack([torch.as_tensor(served[f"pred_{k}"]).reshape(-1)
                           for k in ("U", "V", "h")], -1).to(dev)
        with torch.no_grad():
            tier_case("CLI test at f32x3 (the trained flagship)", kernel="k2", outs=[(
                "served grid", got,
                kernels.mlp_fwd_tangents_plain(trained, x_serve, flagship, 0, X3)[0],
                kernels.mlp_fwd_tangents_plain(trained, x_serve, flagship, 0, "f32")[0].detach(),
                kernels.mlp_fwd_tangents_plain(f64(trained), x_serve.double(), flagship, 0, X3)[0])])
        print(f"  {n_flag} evaluations, all K1-f32x3 (residual_chunk_size 4096 dropped on the "
              f"kernel path); total {flag_totals[0]:.5e} -> {flag_totals[299]:.5e} (Adam) -> "
              f"{min(flag_totals[300:]):.5e} (L-BFGS); {k2c[X3]} K2-f32x3 (snapshot, CLI test)")

        # b. the CMB pipeline at f32x3 (K3 is the tier's default backward)
        synth = os.path.join(tmp, "synth")
        if cli.main(["synth", "--out", synth]) != 0:
            fail("synth failed")
        synth_csv, synth_mat = (os.path.join(synth, f) for f in ("input_fid.csv", "input_res.mat"))
        cfg_cmb = cmb_config(tmp, repo, synth_csv, synth_mat, adam_optimizer={"max_it": 300},
                             data_residual={"interval_x": 1, "interval_y": 1},
                             kernel_precision=X3, residual_chunk_size=4096,
                             lbfgs_optimizer=lbfgs)
        reset_counts()
        if cli.main(["train", "--config", cfg_cmb, "--log-root", tmp, "--run-name", "cmb_x3",
                     "--device", "cuda", "--debug"]) != 0:
            fail("CLI train of the CMB config at f32x3 failed")
        cmb_train = counts()
        cmb_dir = os.path.join(tmp, "cmb_x3")
        pred_cmb = os.path.join(tmp, "pred_cmb_x3.mat")
        if cli.main(["test", "--config", cfg_cmb, "--model", os.path.join(cmb_dir, "model.npz"),
                     "--save", pred_cmb, "--device", "cuda", "--debug"]) != 0:
            fail("CLI test of the f32x3 CMB model failed")
        cmb_counts = counts()
        print(f"  CMB f32x3 path launches by tier: {cmb_counts}")
        n_cmb, cmb_totals = check_log(cmb_dir, "the f32x3 CMB run")
        k3c = cmb_train["packed_mlp_bwd"]
        if k3c[X3] != 2 * n_cmb or not only(k3c, X3):
            fail(f"K3 launched {k3c} for {n_cmb} f32x3 CMB evaluations (2 f32x3 per evaluation)")
        if any(cmb_counts["packed_mlp_bwd_rebuild"].values()) or \
                any(cmb_counts["fused_loss_and_grad"].values()):
            fail(f"the f32x3 CMB path launched K4 or K1: {cmb_counts}")
        k2t = cmb_train["mlp_fwd_tangents"]
        k2_test = cmb_counts["mlp_fwd_tangents"][X3] - k2t[X3]
        if k2t[X3] != 2 * n_cmb or k2_test < 1 or not only(cmb_counts["mlp_fwd_tangents"], X3):
            fail(f"K2 launched {k2t} in training for {n_cmb} f32x3 evaluations (2 per "
                 f"evaluation) and {k2_test} in CLI test")
        served, grid_x = loadmat(pred_cmb), loadmat(synth_mat)["x"]
        for key in ("h", "U", "V", "eta_mean", "Hrms", "k"):
            arr = served[f"pred_{key}"]
            if arr.shape != (261, 81) or not np.array_equal(np.isnan(arr), np.isnan(grid_x)):
                fail(f"the f32x3 CMB model served pred_{key} of shape {arr.shape}, with NaN "
                     "elsewhere than at the grid's masked cells")
        print(f"  {n_cmb} CMB evaluations at f32x3: {k3c[X3]} K3-f32x3, {k2t[X3]} K2-f32x3 "
              f"(+{k2_test} in CLI test); total {cmb_totals[0]:.5e} -> {cmb_totals[299]:.5e} "
              f"(Adam) -> {min(cmb_totals[300:]):.5e} (L-BFGS)")

        print("  iteration 1 at f32x3 through K2 + K3 against the plain f32x3 functions")
        init = numpy_params(cmb_net.sizes, "xavier", 6)
        init["b_out"][3] += 1.0
        raw = dict(make_cmb_config(csv, mat, 20, 0, interval=1, training_points=200),
                   kernel_precision=X3)
        os.makedirs(os.path.join(tmp, "it1_x3"))
        tr = Trainer(parse_config(raw), run_dir=os.path.join(tmp, "it1_x3"), echo_every=0,
                     initial_params=init, device=dev)
        if not tr.kernel_plan.fused:
            fail(f"the f32x3 CMB Trainer chose {tr.kernel_plan} on the card")
        (tk, (fk, rk)), gk = tr.value_and_grad_fn(tr.state.params, tr.batch)
        torch.cuda.synchronize()
        ref = {}
        batch64 = {k: v.double() for k, v in tr.batch.items()}
        with PlainFused():
            for tier, params, batch in ((X3, tr.state.params, tr.batch),
                                        ("f32", tr.state.params, tr.batch),
                                        ("f32x3 f64", f64(tr.state.params), batch64)):
                fn = build_loss_fn(tr.config, tr.spec, input_min_max=tr.data.input_min_max,
                                   fused_kernel=True, fused_precision=tier.split()[0])
                ref[tier] = value_and_grad(fn)(params, batch)
        (tb, (fb, rb)), gb = ref[X3]
        (tf, (ff, rf)), gf = ref["f32"]
        (t6, (f6, r6)), g6 = ref["f32x3 f64"]
        tier_case("CMB iteration 1", [("total", tk, tb, tf, t6), ("fidelity", fk, fb, ff, f6),
                                      ("residual", rk, rb, rf, r6)]
                  + [(f"d{k}", gk[k], gb[k], gf[k], g6[k]) for k in gk], kernel="k3")

        # c. the flagship under --precision-schedule 150:f32x3
        cfg_full = newmethod_config(tmp, repo, adam_optimizer={"max_it": 300},
                                    snapshot_iteration=300, lbfgs_optimizer=lbfgs,
                                    residual_chunk_size=4096)
        reset_counts()
        if cli.main(["train", "--config", cfg_full, "--log-root", tmp, "--run-name", "sched_x3",
                     "--precision-schedule", "150:f32x3", "--device", "cuda", "--debug"]) != 0:
            fail("CLI train --precision-schedule 150:f32x3 failed")
        sched_dir = os.path.join(tmp, "sched_x3")
        if cli.main(["test", "--config", cfg_full, "--model", os.path.join(sched_dir, "model.npz"),
                     "--save", os.path.join(tmp, "pred_sched_x3.mat"), "--device", "cuda",
                     "--debug"]) != 0:
            fail("CLI test of the scheduled model failed")
        sched_counts = counts()
        print(f"  schedule-path launches by tier: {sched_counts}")
        n_sched, sched_totals = check_log(sched_dir, "the 150:f32x3 scheduled run")
        k1s = sched_counts["fused_loss_and_grad"]
        if k1s[X3] != 150 or k1s["f32"] != n_sched - 150 or k1s["bf16"]:
            fail(f"K1 launched {k1s} for {n_sched} evaluations under a 150-step f32x3 prefix "
                 "(150 f32x3, the rest f32)")
        cfg_short = newmethod_config(tmp, repo, adam_optimizer={"max_it": 100},
                                     lbfgs_optimizer={"max_it": 0})
        if cli.main(["train", "--config", cfg_short, "--log-root", tmp, "--run-name", "sched_x3_100",
                     "--precision-schedule", "150:f32x3", "--device", "cuda", "--debug"]) != 0:
            fail("the 100-step f32x3-scheduled run failed")
        reset_counts()
        if cli.main(["train", "--config", cfg_full, "--log-root", tmp, "--run-name", "resumed_x3",
                     "--resume", os.path.join(tmp, "sched_x3_100", "model.npz"),
                     "--precision-schedule", "150:f32x3", "--device", "cuda", "--debug"]) != 0:
            fail("the resumed f32x3-scheduled run failed")
        resumed = counts()["fused_loss_and_grad"]
        epochs_r, _, _, totals_r = read_log(os.path.join(tmp, "resumed_x3"))
        if epochs_r[0] != 101 or resumed[X3] != 50 or resumed["f32"] != len(epochs_r) - 50:
            fail(f"the resume from iteration 100 ran {resumed} K1 launches for epochs "
                 f"{epochs_r[0]}..{epochs_r[-1]} (50 f32x3, then f32)")
        if not abs(totals_r[0] - sched_totals[100]) <= 1e-6 * abs(sched_totals[100]):
            fail("the resumed run's first row differs from the uninterrupted run's")
        print(f"  {n_sched} evaluations: 150 K1-f32x3 then {k1s['f32']} K1-f32; resumed at "
              f"iteration 100: {resumed[X3]} K1-f32x3 then {resumed['f32']} K1-f32")

        # d. the CMB Trainer with the fused path's backward picked
        # (PickedBackward): K3-bf16, K4-f32 and K4-f32x3
        picked = {}
        for tier, impl, wrapper in (("bf16", "stream", "packed_mlp_bwd"),
                                    ("f32", "rebuild", "packed_mlp_bwd_rebuild"),
                                    (X3, "rebuild", "packed_mlp_bwd_rebuild")):
            raw = dict(make_cmb_config(csv, mat, 20, 0, interval=1, training_points=200),
                       kernel_precision=tier)
            run = os.path.join(tmp, f"picked_{tier}_{impl}")
            os.makedirs(run)
            tr = Trainer(parse_config(raw), run_dir=run, echo_every=0, initial_params=init,
                         device=dev)
            reset_counts()
            with PickedBackward(impl):
                losses = tr._adam_steps(20).cpu().numpy()
            c = counts()
            bwd = {w: c[w] for w in ("packed_mlp_bwd", "packed_mlp_bwd_rebuild")}
            other = {w: v for w, v in bwd.items() if w != wrapper}
            if bwd[wrapper][tier] != 40 or not only(bwd[wrapper], tier) or \
                    any(any(v.values()) for v in other.values()):
                fail(f"20 Adam steps on the CMB loss at {tier} with impl={impl!r} launched "
                     f"{bwd} (40 {wrapper} at {tier}, nothing else)")
            if not np.isfinite(losses).all():
                fail(f"impl={impl!r} at {tier}: a non-finite loss in {losses}")
            picked[(tier, impl)] = bwd[wrapper][tier]
            print(f"  CMB loss, backward impl={impl!r} at {tier}: 20 Adam steps, "
                  f"{bwd[wrapper][tier]} {wrapper} launches, total {losses[0, 2]:.5e} -> "
                  f"{losses[-1, 2]:.5e}")

        # 20. the bench suite ---------------------------------------------------------
        phase("20: bench --suite (CLI)")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["bench", "--suite"])
        suite_s = time.perf_counter() - t0
        lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
        if rc != 0 or len(lines) != 1:
            fail(f"bench --suite exited {rc} with {len(lines)} JSON lines")
        suite = json.loads(lines[0])
        print(lines[0])
        extras = suite.get("extras", {})
        want_keys = {"f32x3", "bf16", "plain", "adam_step_ms", "adam_step_ms_f32x3",
                     "adam_step_ms_bf16", "cmb_step_ms"}
        errors = [k for k in extras if k.endswith("_error")]
        if errors or set(extras) != want_keys:
            fail(f"bench --suite extras {sorted(extras)} (errors {errors}); want {sorted(want_keys)}")
        if not all(isinstance(v, (int, float)) and v > 0 and math.isfinite(v)
                   for v in extras.values()):
            fail(f"bench --suite extras are not positive finite numbers: {extras}")
        print(f"  bench --suite took {suite_s:.1f} s")

        # 21. times -----------------------------------------------------------------
        phase("21: times of the f32x3 tier (CUDA events; median of reps)")
        times = {}

        def timed(key, fn, reps, inner, flops, nbytes):
            ms = cuda_ms(fn, reps, inner)
            times[key] = (ms, *x3_bounds(bound, bound_bf16, flops, nbytes))

        spec10, p10, c10 = benchmarks.flagship_bench_inputs(10_000_000, dev)
        with torch.no_grad():
            for tier in ("f32", X3):
                timed(f"k2 10M continuity {tier}",
                      lambda t=tier: kernels.fused_residual_continuity(p10, c10, spec10, precision=t),
                      5, 1, k2_flops(spec10, 10_000_000, 2, True), k2_bytes(p10, 10_000_000, spec10, 1))
            plain_10m = cuda_ms(lambda: kernels.residual_continuity_plain(p10, c10, spec10, X3), 3, 1)
        del p10, c10
        serve_params = params_from_numpy(numpy_params(flagship.sizes, "xavier", 3), dev)
        n_serve = x_serve.shape[0]
        plain = {}
        with torch.no_grad():
            p_cmb = bwd_inputs["CMB net, residual grid"][0]
            timed("k2 cmb grid", lambda: kernels.mlp_fwd_tangents(p_cmb, res_pts, cmb_net, 2, precision=X3),
                  7, 20, k2_flops(cmb_net, n_res, 2, False), k2_bytes(p_cmb, n_res, cmb_net, 3 * cmb_net.d_out))
            plain["k2 cmb grid"] = cuda_ms(lambda: kernels.mlp_fwd_tangents_plain(p_cmb, res_pts, cmb_net, 2, X3), 5, 3)
            timed("k2 serve", lambda: kernels.mlp_fwd_tangents(serve_params, x_serve, flagship, 0, precision=X3),
                  7, 20, k2_flops(flagship, n_serve, 0, False), k2_bytes(serve_params, n_serve, flagship, 3))
            plain["k2 serve"] = cuda_ms(lambda: kernels.mlp_fwd_tangents_plain(serve_params, x_serve, flagship, 0, X3), 5, 3)
            timed("k1", lambda: kernels_step.fused_loss_and_grad(flag_params, flag_batch, flagship, precision=X3),
                  7, 20, k1_flops(flagship, n_grid), k1_bytes(flag_params, n_grid, 2, 2))
            plain["k1"] = cuda_ms(lambda: kernels_step.fused_loss_and_grad_plain(flag_params, flag_batch, flagship, X3), 5, 3)
            sweeps = {}
            for name in ("CMB net, residual grid", "CMB net, fidelity rows", "flagship, train grid"):
                params, x, ybar, dybar, spec, kt = bwd_inputs[name]
                nb = k3_bytes(params, spec, x.shape[0], kt)
                timed(f"k3 {name}", lambda: kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, spec, kt, precision=X3),
                      7, 20, k3_flops(spec, x.shape[0], kt), nb)
                timed(f"k4 {name}", lambda: kernels_vjp.packed_mlp_bwd_rebuild(params, x, ybar, dybar, spec, kt, precision=X3),
                      7, 20, k4_flops(spec, x.shape[0], kt), nb)
                plain[f"bwd {name}"] = cuda_ms(lambda: kernels_vjp.packed_mlp_bwd_plain(params, x, ybar, dybar, spec, kt, X3), 5, 3)
                c_auto = kernels_vjp.rebuild_ckpt_every(spec, kt, X3, n_points=x.shape[0])
                sweep = {}
                for c in (1, 2, 3, 4, 6, 8, 10):
                    if c > spec.n_hidden - 1:
                        continue
                    try:
                        kernels_vjp.rebuild_ckpt_every(spec, kt, X3, c, n_points=x.shape[0])
                    except ValueError:
                        continue
                    sweep[c] = cuda_ms(lambda c=c: kernels_vjp.packed_mlp_bwd_rebuild(
                        params, x, ybar, dybar, spec, kt, precision=X3, ckpt_every=c), 5, 10)
                sweeps[name] = (c_auto, sweep)
                print(f"  K4-f32x3 {name}: segment length C -> ms "
                      f"{dict((c, round(v, 4)) for c, v in sweep.items())}; planned C = {c_auto}")
        # 100 steps, median of 3 (the suite's f32 CMB step takes 500): the
        # host-bound step moves with the host, not with the count
        cmb_step = benchmarks.run_cmb_step_bench(n_iters=100, kernel_precision=X3, device=dev)

    for key, (ms, b_tc, by, b_cc) in times.items():
        print(f"  {key}{'' if key.endswith(('f32', X3)) else ' f32x3'}: {ms:.4f} ms, "
              f"bound {b_tc:.5f} ms by {by} (three bf16 products on the tensor cores; "
              f"{b_tc / ms:.2%} of it), {b_cc:.4f} ms on the CUDA cores' f32 FMA rate "
              f"({b_cc / ms:.1%} of it)")
    print(f"  plain f32x3: continuity at 10M points {plain_10m:.3f} ms, "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in plain.items()))
    print(f"  Adam step at f32x3: flagship {extras['adam_step_ms_f32x3']} ms (bench --suite; "
          f"f32 {extras['adam_step_ms']} ms), CMB {json.dumps(cmb_step)}")
    issue = {f"k2 10M continuity {X3}": k2_issue_count(spec10, 10_000_000, 2, X3),
             "k2 serve": k2_issue_count(flagship, n_serve, 0, X3),
             "k2 cmb grid": k2_issue_count(cmb_net, n_res, 2, X3)}
    for key, count in issue.items():
        ms, b_tc = times[key][:2]
        print(f"  {key}{'' if key.endswith(X3) else ' f32x3'}: {ms:.4f} ms against the "
              f"tensor-core bound {b_tc:.5f} ms ({b_tc / ms:.2%}) and the CUDA-core count "
              f"{count:.4e} warp instructions (modelled; {issue_ms(count):.4f} ms of issue at "
              f"the max clock, {issue_ms(count) / ms:.1%})")

    res, fidr, flag = ("CMB net, residual grid", "CMB net, fidelity rows", "flagship, train grid")
    common = {"route": "cuda", "library_ms": None}

    def entry(name, source, replaces, key, launches, plain_ms, e, **more):
        ms, b_tc, by, b_cc = times[key]
        return {"name": name, **common, "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": e, "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": b_tc, "bound_by": by, "bound_ms_cuda_cores": b_cc, **more}

    k2_entry = entry("k2_mlp_fwd_tangents[f32x3]", K2_SOURCE, REPLACES, "k2 cmb grid",
                     cmb_counts["mlp_fwd_tangents"][X3], plain["k2 cmb grid"], err["k2"],
                     points=n_res, launches_flagship_path=flag_counts["mlp_fwd_tangents"][X3],
                     ms_10m_continuity=times[f"k2 10M continuity {X3}"][0],
                     ms_10m_continuity_f32=times["k2 10M continuity f32"][0],
                     bound_ms_10m_continuity=times[f"k2 10M continuity {X3}"][1],
                     bound_ms_10m_continuity_cuda_cores=times[f"k2 10M continuity {X3}"][3],
                     plain_ms_10m_continuity=plain_10m,
                     ms_serve_grid=times["k2 serve"][0], plain_ms_serve_grid=plain["k2 serve"],
                     bound_ms_serve_grid=times["k2 serve"][1],
                     residual_evals_per_s=extras["f32x3"])
    k1_entry = entry("k1_continuity_train_step[f32x3]", K1_SOURCE, K1_REPLACES, "k1",
                     flag_counts["fused_loss_and_grad"][X3], plain["k1"], err["k1"],
                     points=n_grid, launches_schedule_prefix=k1s[X3],
                     adam_ms_per_iter_f32x3=extras["adam_step_ms_f32x3"])
    k3_entry = entry("k3_mlp_bwd[f32x3]", K3_SOURCE, K3_REPLACES, f"k3 {res}",
                     cmb_counts["packed_mlp_bwd"][X3], plain[f"bwd {res}"], err["k3"],
                     points=n_res, ms_fidelity_k0=times[f"k3 {fidr}"][0],
                     ms_flagship_k2=times[f"k3 {flag}"][0],
                     bound_ms_flagship_k2=times[f"k3 {flag}"][1],
                     cmb_adam_ms_per_iter_f32x3=cmb_step["ms_per_iter"])
    k4_entry = entry("k4_mlp_bwd_rebuild[f32x3]", K4_SOURCE, K4_REPLACES, f"k4 {res}",
                     picked[(X3, "rebuild")], plain[f"bwd {res}"], err["k4"], points=n_res,
                     ckpt_every=sweeps[res][0], ms_fidelity_k0=times[f"k4 {fidr}"][0],
                     ms_flagship_k2=times[f"k4 {flag}"][0],
                     bound_ms_flagship_k2=times[f"k4 {flag}"][1],
                     ckpt_sweep_ms={name: sweeps[name][1] for name in (res, fidr, flag)})
    return {"k2": k2_entry, "k1": k1_entry, "k3": k3_entry, "k4": k4_entry,
            "picked": picked, "suite": suite, "suite_s": suite_s}


class Spy:
    """``obj.name`` wrapped for the length of a ``with`` block: counts the
    calls and keeps ``keep(args, result)`` of each (the result itself by
    default). How the smoke reads what an entry point did inside (a
    Trainer's phase times, an adaptation's evaluations) and shows that a
    path never called a plain version."""

    def __init__(self, obj, name: str, keep=None):
        self.obj, self.name, self.keep = obj, name, keep or (lambda args, result: result)

    def __enter__(self):
        self.real = real = getattr(self.obj, self.name)
        self.calls, self.results = 0, []

        def wrapper(*args, **kwargs):
            result = real(*args, **kwargs)
            self.calls += 1
            self.results.append(self.keep(args, result))
            return result

        setattr(self.obj, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self.real)


def keep_run(keep: str, name: str, cfg_path: str, model: str) -> None:
    """A trained run's config (``config.json``), the data files it names and
    its ``model.npz``, copied into ``keep/name`` for phase 24."""
    import shutil

    dst = os.path.join(keep, name)
    os.makedirs(dst)
    with open(cfg_path) as f:
        raw = json.load(f)
    for section in ("data", "data_fidelity", "data_residual", "data_test"):
        block = raw.get(section)
        if isinstance(block, dict) and block.get("file"):
            target = os.path.join(dst, os.path.basename(block["file"]))
            if not os.path.exists(target):
                shutil.copy(block["file"], target)
            block["file"] = target
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(raw, f)
    shutil.copy(model, os.path.join(dst, "model.npz"))


# the flags of the reference's own 50,000-step flagship runs (.soak/ref_50k*.npz)
FLAGSHIP_PARITY = ["--iters", "50000", "--lbfgs", "500", "--hidden-layers", "100", "--width", "20",
                   "--nx", "81", "--ny", "261", "--nan-fraction", "0.408"]


def parity_run(phase: str, repo: str, tmp: str, fields: str) -> dict:
    """CLI ``parity`` at the flagship's full width against the reference's
    committed 50,000-step run on ``fields``, through K1 on every
    evaluation; then the harness recomposed from the caches it wrote, for
    its numbers. Checks every gate both phases share and returns the
    numbers, the caches' losses and what the run did."""
    import numpy as np

    from pinn_depthestimation_tpu_torch import cli, parity
    from pinn_depthestimation_tpu_torch.ops import kernels, kernels_step
    from pinn_depthestimation_tpu_torch.training.driver import Trainer

    ref = os.path.join(repo, ".soak", "ref_50k.npz" if fields == "plane" else
                       "ref_50k_structured.npz")
    fw = os.path.join(tmp, f"fw_{fields}.npz")
    argv = FLAGSHIP_PARITY + ["--fields", fields, "--ref-cache", ref, "--fw-cache", fw,
                              "--device", "cuda"]
    kernels.reset_launches(kernels_step.fused_loss_and_grad)
    with Spy(Trainer, "train", keep=lambda args, _: dict(args[0].stats)) as train:
        t0 = time.perf_counter()
        rc = cli.main(["parity", *argv, "--out", os.path.join(tmp, f"report_{fields}.md")])
        wall = time.perf_counter() - t0
    k1 = kernels_step.fused_loss_and_grad.launches
    if train.calls != 1:
        fail(f"phase {phase}: CLI parity trained {train.calls} times, not once")
    rc_again, num = parity.run(argv + ["--out", os.path.join(tmp, f"recomposed_{fields}.md")])
    if rc_again != rc:
        fail(f"phase {phase}: the run exited {rc}, its recomposition {rc_again}")
    with np.load(ref) as z, np.load(fw) as zf:
        rt = np.asarray(z["totals"])
        rows = {k: np.asarray(zf[k]) for k in ("totals", "fids", "ress")}
    ot = rows["totals"]
    rel = np.abs(ot[:50_000] - rt[:50_000]) / np.abs(rt[:50_000])
    prefix = int(np.argmax(rel > 5e-3)) if (rel > 5e-3).any() else rel.size
    stats = train.results[0]
    print(f"  CLI parity exit {rc} ({num['verdict']}); {len(ot)} loss evaluations "
          f"({num['n_compared']} Adam + {num['lbfgs_evals_fw']} L-BFGS; the reference "
          f"{num['lbfgs_evals_ref']} L-BFGS), K1 launches {k1}; wall {wall:.1f} s, of which "
          f"Adam {stats['adam_seconds']:.1f} s and L-BFGS {stats['lbfgs_seconds']:.1f} s")
    print(f"  iteration 1: reference {rt[0]:.6e}, port {ot[0]:.6e}, rel {num['iter1_rel']:.3e}; "
          f"first 10 max rel {rel[:10].max():.3e}; Adam prefix within 5e-3: {prefix} of "
          f"{rel.size}; Adam median rel {num['adam_median_rel']:.3e}")
    print(f"  L-BFGS: tracked prefix {num.get('tracked', 0)}; terminal minima reference "
          f"{num.get('ref_min', float('nan')):.6e}, port {num.get('fw_min', float('nan')):.6e}, "
          f"log10 gap {num['log10_gap'] if 'log10_gap' in num else float('nan'):.4f}")
    print(f"  h field: RMSE {num['h_rmse']:.4e} m = {num['rmse_truth_frac']:.2%} of the truth "
          f"scale {num['h_truth_scale']:.4f} m, {num['rmse_pred_frac']:.2%} of the predicted "
          f"range; predicted ranges reference {num['ref_pred_range']:.4f} m, port "
          f"{num['fw_pred_range']:.4f} m ({num['fw_structure_frac']:.1%} of truth)")
    if not all(np.isfinite(v).all() for v in rows.values()):
        fail(f"phase {phase}: a log row is not finite")
    if k1 != len(ot):
        fail(f"phase {phase}: K1 launched {k1} times for {len(ot)} log rows: some evaluation "
             "bypassed the kernel")
    if not num["iter1_rel"] <= 1e-5:
        fail(f"phase {phase}: iteration 1 differs from the reference's by {num['iter1_rel']:.3e}")
    if not rel[:10].max() <= 2e-4:
        fail(f"phase {phase}: the first 10 Adam losses differ by up to {rel[:10].max():.3e}")
    if not num.get("log10_gap", float("inf")) < 0.1:
        fail(f"phase {phase}: the terminal minima are not in one basin (log10 gap "
             f"{num.get('log10_gap')})")
    return {**num, "exit": rc, "wall_s": wall, "k1_launches": k1, "adam_prefix_5e-3": prefix,
            **stats}


def adapt_compare(label: str, cfg, model: str, dev, tier: str) -> int:
    """``Predictor.adapt`` through the kernels against its plain version on
    the card, on the same weights and the config's test grid; returns the
    evaluation count. f32: against ``use_kernel=False``: the same count,
    each evaluation's loss within ``REL_TOL`` relative, the parameters
    after it within 1e-4 x max|change| + 1e-7, the predictions after it by
    ``compare``. The loss is a mean of squared residuals that cancel: on
    the trained flagship the residual is ~1e-3 of its terms, so the
    kernels' ~1e-5-of-scale agreement on y and dy reads as up to 7.0e-5 of
    the loss (measured on an H100 80GB HBM3 at 700 W), above the 1e-5
    a loss away from such cancellation keeps; ``REL_TOL`` is the smoke's
    kernel-against-plain tolerance for every f32 output. bf16: against the
    plain bf16 functions on the card (``PlainFused``), each held to the
    tier's own error, measured between the plain bf16 and plain f32 runs:
    the losses within a quarter of their first evaluation's gap +
    ``REL_TOL`` relative, the parameters within a quarter of their gap +
    f32's limit, the served prediction by ``compare_tier`` against the
    plain tier at the same adapted weights. Against the plain route's
    prediction at its own weights (8.2e-8 away) the L2 gap read 4.7 x the
    spread of two summation orders on the trained flagship, past
    ``compare_tier``'s 4 x: a weight gap that small flips bf16 roundings
    as a summation order does, so the weights and the kernel are held
    apart."""
    import numpy as np
    import torch

    from pinn_depthestimation_tpu_torch.data import load_test_data
    from pinn_depthestimation_tpu_torch.inference import Predictor
    from pinn_depthestimation_tpu_torch.ops import kernels

    x_all = load_test_data(cfg).inputs
    x = torch.as_tensor(x_all[np.isfinite(x_all).all(axis=1)]).to(dev)
    kern = Predictor(cfg, model, device=dev)
    p0 = {k: v.clone() for k, v in kern.params.items()}
    n = kern.adapt(x_all)
    plain = Predictor(cfg, model, device=dev, use_kernel=False)
    n_plain = plain.adapt(x_all)
    ref = plain
    if tier != "f32":
        with PlainFused():
            ref = Predictor(cfg, model, device=dev)
            n_plain = ref.adapt(x_all)
    if n != n_plain:
        fail(f"{label}: {n} evaluations through the kernels, {n_plain} on the plain path")
    lk, lr = kern.adapt_losses, ref.adapt_losses
    moved = max(float((ref.params[k] - p0[k]).abs().max()) for k in p0)
    gap = max(float((kern.params[k] - ref.params[k]).abs().max()) for k in p0)
    loss_tol = REL_TOL * np.abs(lr)
    param_tol = 1e-4 * moved + 1e-7
    if tier != "f32":
        loss_tol = loss_tol + 0.25 * abs(float(ref.adapt_losses[0] - plain.adapt_losses[0]))
        param_tol += 0.25 * max(float((ref.params[k] - plain.params[k]).abs().max()) for k in p0)
    rel = np.abs(lk - lr) / np.abs(lr)
    sci = lambda v: np.array2string(v, formatter={"float_kind": "{:.3e}".format})  # noqa: E731
    print(f"  {label}: {n} evaluations; losses {lk[0]:.6e} -> {lk.min():.6e} (plain "
          f"{lr[0]:.6e} -> {lr.min():.6e}), relative gaps {sci(rel)} "
          f"(tolerance {sci(loss_tol / np.abs(lr))}); parameters moved "
          f"{moved:.3e}, max |kernels - plain| {gap:.3e} (tolerance {param_tol:.3e})")
    if not (np.abs(lk - lr) <= loss_tol).all():
        fail(f"{label}: the adaptation's losses through the kernels and the plain path differ")
    if not gap <= param_tol:
        fail(f"{label}: the adapted parameters through the kernels and the plain path differ")
    with torch.no_grad():
        got, _ = kernels.mlp_fwd_tangents(kern.params, x, kern.spec, 0, precision=tier)
        if tier == "f32":
            compare(f"{label}: adapted prediction", got,
                    torch.as_tensor(plain.predict(x.cpu().numpy())).to(dev))
        else:
            # the plain tier at the kernels' own adapted weights: the two
            # routes' weights are held above, and at bf16 their ~1e-7 gap
            # flips roundings as another summation order would (the gap
            # across the routes is printed)
            fwd, p = kernels.mlp_fwd_tangents_plain, kern.params
            compare_tier(f"{label}: adapted prediction", got, fwd(p, x, kern.spec, 0, tier)[0],
                         fwd(p, x, kern.spec, 0, "f32")[0],
                         fwd(f64(p), x.double(), kern.spec, 0, tier)[0], tier)
            cross = float((got - fwd(ref.params, x, kern.spec, 0, tier)[0]).double().norm())
            print(f"  (L2 gap to the plain route's prediction at its own weights {cross:.3e})")
    return n


def parity_phases(dev, repo: str, keep: str) -> None:
    """Phases 22-24: the flagship's parity runs against the reference's
    committed 50,000-step runs through CLI ``parity``, and test-time
    adaptation through CLI ``test`` on phases 8 and 12's trained models."""
    import torch

    from pinn_depthestimation_tpu_torch import cli, inference
    from pinn_depthestimation_tpu_torch.config import load_config
    from pinn_depthestimation_tpu_torch.inference import Predictor
    from pinn_depthestimation_tpu_torch.ops import kernels, kernels_vjp

    with tempfile.TemporaryDirectory() as tmp:
        # 22. the flagship parity run -------------------------------------------
        phase("22: flagship parity against the reference's 50,000-step run "
              "(CLI parity, .soak/ref_50k.npz)")
        flag = parity_run("22", repo, tmp, "plane")
        if flag["exit"] != 0 or flag["verdict"] != "PASS":
            fail(f"phase 22: the harness's verdict is {flag['verdict']} (exit {flag['exit']}): "
                 f"h RMSE {flag['rmse_truth_frac']:.2%} of truth, {flag['rmse_pred_frac']:.2%} "
                 "of the predicted range, above 1 % on both")
        print(f"  verdict PASS: h RMSE {flag['rmse_truth_frac']:.2%} of truth (the JAX "
              "package read 0.08 %, PARITY_FLAGSHIP_50K.md)")

        # 23. the same on the structured fields -----------------------------------
        phase("23: structured-fields parity (CLI parity, .soak/ref_50k_structured.npz)")
        struct = parity_run("23", repo, tmp, "structured")
        print(f"  h RMSE {struct['rmse_truth_frac']:.2%} of the truth scale beside the JAX "
              "package's 1.28 % and the reference's own fork spread of 1.22 % "
              f"(PARITY_STRUCTURED_50K.md); harness verdict {struct['verdict']}; predicted range "
              f"{struct['fw_structure_frac']:.1%} of truth (reference "
              f"{struct['ref_structure_frac']:.1%}; criterion >= 10 %)")
        if not struct["fw_structure_frac"] >= 0.10:
            fail("phase 23: the port's recovered h field is degenerate (predicted range below "
                 "10 % of the truth range)")

        # 24. test-time adaptation on the card --------------------------------------
        phase("24: test-time adaptation (CLI test with perform_optimization)")
        counted = {"k2": kernels.mlp_fwd_tangents, "k3": kernels_vjp.packed_mlp_bwd,
                   "k4": kernels_vjp.packed_mlp_bwd_rebuild}
        plain_paths = [(inference, "mlp_apply_with_tangents"), (inference, "mlp_apply"),
                       (kernels, "mlp_fwd_tangents_plain"),
                       (kernels_vjp, "packed_mlp_bwd_plain")]
        for name, tier in (("flagship", "f32"), ("cmb", "f32"), ("flagship", "bf16")):
            with open(os.path.join(keep, name, "config.json")) as f:
                raw = json.load(f)
            raw.update(perform_optimization=True, kernel_precision=tier)
            path = os.path.join(tmp, f"adapt_{name}_{tier}.json")
            with open(path, "w") as f:
                json.dump(raw, f)
            model = os.path.join(keep, name, "model.npz")
            for wrapper in counted.values():
                kernels.reset_launches(wrapper)
            with contextlib.ExitStack() as stack:
                adapt = stack.enter_context(Spy(Predictor, "adapt"))
                spies = [stack.enter_context(Spy(obj, attr)) for obj, attr in plain_paths]
                rc = cli.main(["test", "--config", path, "--model", model, "--device", "cuda",
                               "--debug"])
            torch.cuda.synchronize()
            if rc != 0 or adapt.calls != 1:
                fail(f"CLI test with perform_optimization on the {name} model at {tier} exited "
                     f"{rc} after {adapt.calls} adaptations")
            evals = adapt.results[0]
            launches = {k: w.launches_by_tier[tier] for k, w in counted.items()}
            others = {k: w.launches - w.launches_by_tier[tier] for k, w in counted.items()}
            bwd = "k4" if tier == "bf16" else "k3"
            print(f"  {name} at {tier}: {evals} evaluations; launches {launches} (other tiers "
                  f"{others}); plain-path calls {[spy.calls for spy in spies]}")
            want = {"k2": evals + 1, bwd: evals, ("k3" if bwd == "k4" else "k4"): 0}
            if launches != want or any(others.values()):
                fail(f"{name} at {tier}: launches {launches} (other tiers {others}), expected "
                     f"{want}: K2 once per evaluation and once for the prediction, the "
                     "backward once per evaluation")
            if any(spy.calls for spy in spies):
                fail(f"{name} at {tier}: the adaptation or the prediction called a plain version")
            adapt_compare(f"{name} at {tier}, kernels against plain", load_config(path), model,
                          dev, tier)


LEGACY_POINTS, LEGACY_ROWS = 26_691, 300  # synth --legacy --nx 41 --ny 31: 41 x 31 x 21


def legacy_config_file(tmp: str, repo: str, snap_dir: str, **overrides) -> str:
    """``examples/legacy.json`` with its files in ``snap_dir`` and
    ``overrides`` merged in; returns the config path."""
    with open(os.path.join(repo, "examples", "legacy.json")) as f:
        raw = json.load(f)
    raw["data_fidelity"]["dir"] = os.path.join(snap_dir, "fidelity.csv")
    raw["numerical_model"]["dir"] = snap_dir
    return write_config(tmp, "legacy", raw, overrides)


def legacy_points(dev, tmp: str, repo: str):
    """The legacy shape's 26,691 residual points on the card (``cli synth
    --legacy --nx 41 --ny 31`` under ``tmp``, read through
    ``examples/legacy.json``'s loader)."""
    import torch

    from pinn_depthestimation_tpu_torch import cli
    from pinn_depthestimation_tpu_torch.config import load_config
    from pinn_depthestimation_tpu_torch.data import load_training_data

    out = os.path.join(tmp, "legacy")
    if cli.main(["synth", "--out", out, "--legacy", "--nx", "41", "--ny", "31"]) != 0:
        fail("synth --legacy failed")
    cfg = legacy_config_file(out, repo, os.path.join(out, "beach2d"))
    return torch.as_tensor(load_training_data(load_config(cfg)).residual_input).to(dev)


def k2_path_shapes(dev, repo: str, serve, residual) -> dict:
    """K2-f32's five path shapes ``{name: (spec, params, x, K, epilogue)}``:
    the serving grid (K=0) and the 10M-point residual (``serve``,
    ``residual``: ``(spec, params, x)``), the CMB grid at K=2 and the CMB
    net's 200 fidelity rows at K=0 (``cmb_bench_points``), the legacy shape
    at K=3 (:func:`legacy_points`); seeded numpy weights."""
    from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy

    cmb_net = MLPSpec(sizes=(2,) + (10,) * 10 + (6,), init_type="xavier")
    legacy = MLPSpec(sizes=(5,) + (20,) * 20 + (4,), init_type="xavier")
    with tempfile.TemporaryDirectory() as tmp:
        _, _, res_pts, fid_pts = cmb_bench_points(dev, tmp)
        leg_pts = legacy_points(dev, tmp, repo)
    cmb_params = params_from_numpy(numpy_params(cmb_net.sizes, "xavier", 8), dev)
    return {
        "serve": (*serve, 0, False),
        "10m": (*residual, 2, True),
        "cmb": (cmb_net, cmb_params, res_pts, 2, False),
        "fid": (cmb_net, cmb_params, fid_pts, 0, False),
        "legacy": (legacy, params_from_numpy(numpy_params(legacy.sizes, "xavier", 25), dev),
                   leg_pts, 3, False),
    }


def k2_f32_shapes(dev, repo: str, bound, serve, residual) -> dict:
    """Phase 6's K2-f32 at its five path shapes (:func:`k2_path_shapes`):
    the device time (``device_ms``), the bound, the share of it, the plan
    and (but at 10M, phase 6's own) the plain version's time. Returns the
    ``kernels`` line's keys."""
    from pinn_depthestimation_tpu_torch.ops import cuda_build, k2_plan, kernels

    out = {}
    for key, (spec, params, x, kt, epi) in k2_path_shapes(dev, repo, serve, residual).items():
        n = x.shape[0]
        def call(p=params, x=x, s=spec, k=kt, epi=epi):
            if epi:
                return kernels.fused_residual_continuity(p, x, s)
            return kernels.mlp_fwd_tangents(p, x, s, k)

        ms = device_ms(call, 3 if key == "10m" else 20, "k2_f32_kernel")
        if key != "10m":  # the plain version at 10M is phase 6's plain_ms
            out[f"plain_ms_{key}"] = cuda_ms(
                lambda p=params, x=x, s=spec, k=kt: kernels.mlp_fwd_tangents_plain(p, x, s, k),
                3, 1)
        b, by = bound(k2_flops(spec, n, kt, epi), k2_bytes(params, n, spec, 1 if epi else
                                                             spec.d_out * (1 + kt)))
        plan = k2_plan.card_f32_plan(cuda_build.k2_library().libs[spec.width], n, spec.width,
                                     spec.n_hidden - 1, kt, dev)
        print(f"  K2-f32 {key} ({spec.d_in}->[{spec.width}]x{spec.n_hidden}->{spec.d_out}, {n} "
              f"points, K={kt}{', epilogue' if epi else ''}): device {fmt_ms(ms)}, bound "
              f"{b:.5f} ms by {by}" + (f", {b / ms:.1%} of bound" if ms else "")
              + (f", plain {out[f'plain_ms_{key}']:.4f} ms" if key != "10m" else "")
              + f"; plan {f32_plan_text(spec, n, kt, dev)}")
        out.update({f"device_ms_{key}": ms, f"bound_ms_{key}": b, f"points_{key}": n,
                    f"lanes_{key}": plan.lanes, f"grid_{key}": plan.grid,
                    f"warps_{key}": plan.warps})
    return out


def legacy_phases(dev, repo: str, bound, bound_bf16) -> dict:
    """Phase 25: the legacy pipeline at ``examples/legacy.json``'s full
    width. Returns the legacy numbers of the ``kernels`` line's K2-f32,
    K2-bf16, K3-f32 and K4-bf16 entries."""
    import numpy as np
    import torch

    from pinn_depthestimation_tpu_torch import benchmarks, cli
    from pinn_depthestimation_tpu_torch.config import load_config, parse_config
    from pinn_depthestimation_tpu_torch.data import load_training_data
    from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
    from pinn_depthestimation_tpu_torch.ops import kernels, kernels_step, kernels_vjp
    from pinn_depthestimation_tpu_torch.training import driver
    from pinn_depthestimation_tpu_torch.training import loss as loss_mod
    from pinn_depthestimation_tpu_torch.training.logging_utils import read_log

    t_phase = time.perf_counter()
    spec = MLPSpec(sizes=(5,) + (20,) * 20 + (4,), init_type="xavier")
    counted = {"k1": kernels_step.fused_loss_and_grad, "k2": kernels.mlp_fwd_tangents,
               "k3": kernels_vjp.packed_mlp_bwd, "k4": kernels_vjp.packed_mlp_bwd_rebuild}
    plain_paths = [(loss_mod, "mlp_apply_with_tangents"), (loss_mod, "mlp_apply"),
                   (driver, "mlp_apply"), (kernels, "mlp_fwd_tangents_plain"),
                   (kernels_vjp, "packed_mlp_bwd_plain")]
    with tempfile.TemporaryDirectory() as tmp:
        phase("25: the legacy pipeline (CLI synth --legacy, the loader; K2, K3 and K4 "
              "at 5->[20]x20->4 against their plain versions)")
        if cli.main(["synth", "--out", tmp, "--legacy", "--nx", "41", "--ny", "31"]) != 0:
            fail("synth --legacy failed")
        snap_dir = os.path.join(tmp, "beach2d")
        cfg_path = legacy_config_file(tmp, repo, snap_dir)
        td = load_training_data(load_config(cfg_path))
        if td.residual_input.shape != (LEGACY_POINTS, 5) or td.fidelity_input.shape != (
                LEGACY_ROWS, 5):
            fail(f"the legacy loader gave {td.residual_input.shape} residual and "
                 f"{td.fidelity_input.shape} fidelity rows")
        res_pts = torch.as_tensor(td.residual_input).to(dev)
        fid_pts = torch.as_tensor(td.fidelity_input).to(dev)
        params = params_from_numpy(numpy_params(spec.sizes, "xavier", 25), dev)
        rng = np.random.RandomState(25)
        cases = []
        for name, x, kt in (("residual points", res_pts, 3), ("fidelity rows", fid_pts, 0)):
            n = x.shape[0]
            cases.append((name, x, kt,
                          torch.as_tensor(rng.randn(n, 4).astype(np.float32)).to(dev),
                          torch.as_tensor(rng.randn(kt, n, 4).astype(np.float32)).to(dev)))
        err = {"k2": 0.0, "k3": 0.0, "k4_bf16": 0.0}
        for name, x, kt, ybar, dybar in cases:
            print(f" {name}: K={kt}, N={x.shape[0]}, K4 segments of "
                  f"{kernels_vjp.rebuild_ckpt_every(spec, kt, 'f32', n_points=x.shape[0])} "
                  f"layers (f32)")
            with torch.no_grad():
                y, dy = kernels.mlp_fwd_tangents(params, x, spec, kt)
                torch.cuda.synchronize()
                y32, dy32 = kernels.mlp_fwd_tangents_plain(params, x, spec, kt)
                err["k2"] = max(err["k2"], compare(f"K2-f32 K={kt} y", y, y32),
                                *([compare(f"K2-f32 K={kt} dy", dy, dy32)] if kt else []))
            g3 = kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, spec, kt)
            g4 = kernels_vjp.packed_mlp_bwd_rebuild(params, x, ybar, dybar, spec, kt)
            torch.cuda.synchronize()
            g32 = kernels_vjp.packed_mlp_bwd_plain(params, x, ybar, dybar, spec, kt)
            err["k3"] = max(err["k3"], *(compare(f"K3-f32 d{k}", g3[k], g32[k]) for k in g3))
            for k in g4:
                compare(f"K4-f32 d{k}", g4[k], g32[k])
            for tier in ("bf16", "f32x3"):
                kw = dict(tier=tier) if tier == "bf16" else dict(
                    tier=tier, rel_floor=X3_REL_FLOOR, distinct=X3_DISTINCT)
                with torch.no_grad():
                    yt, dyt = kernels.mlp_fwd_tangents(params, x, spec, kt, precision=tier)
                    torch.cuda.synchronize()
                    yp, dyp = kernels.mlp_fwd_tangents_plain(params, x, spec, kt, tier)
                    y6, dy6 = kernels.mlp_fwd_tangents_plain(f64(params), x.double(), spec, kt,
                                                             tier)
                    outs = [(f"K2-{tier} K={kt} y", yt, yp, y32, y6)] + (
                        [(f"K2-{tier} K={kt} dy", dyt, dyp, dy32, dy6)] if kt else [])
                g3t = kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, spec, kt,
                                                 precision=tier, impl="stream")
                g4t = kernels_vjp.packed_mlp_bwd_rebuild(params, x, ybar, dybar, spec, kt,
                                                         precision=tier)
                torch.cuda.synchronize()
                gp = kernels_vjp.packed_mlp_bwd_plain(params, x, ybar, dybar, spec, kt, tier)
                g6 = kernels_vjp.packed_mlp_bwd_plain(f64(params), x.double(), ybar.double(),
                                                      dybar.double(), spec, kt, tier)
                outs += [(f"K3-{tier} d{k}", g3t[k], gp[k], g32[k], g6[k]) for k in g3t]
                outs += [(f"K4-{tier} d{k}", g4t[k], gp[k], g32[k], g6[k]) for k in g4t]
                real = {}
                for label, got, want, want32, want64 in outs:
                    e, r = compare_tier(f"{name}: {label}", got, want, want32, want64, **kw)
                    kernel = label.split("-")[0]
                    real[kernel] = real.get(kernel, False) or r
                    if tier == "bf16" and kernel == "K4":
                        err["k4_bf16"] = max(err["k4_bf16"], e)
                print(f"  {tier}: outputs that show the tier apart from f32, by kernel: {real}")
                if tier == "bf16" and not all(real.values()):
                    fail(f"{name}: a bf16 kernel shows no output with the tier's error above "
                         "the floor")
        compare_s = time.perf_counter() - t_phase

        # 25b. the uncut example through CLI train, at f32 and at bf16 -------------
        def train(label: str, path: str, tier: str) -> tuple[dict, int, float]:
            for wrapper in counted.values():
                kernels.reset_launches(wrapper)
            with contextlib.ExitStack() as stack:
                spies = [stack.enter_context(Spy(obj, attr)) for obj, attr in plain_paths]
                t0 = time.perf_counter()
                rc = cli.main(["train", "--config", path, "--log-root", tmp, "--run-name", label,
                               "--device", "cuda", "--debug"])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            if rc != 0:
                fail(f"CLI train on the legacy config at {tier} exited {rc}")
            launches = {k: w.launches_by_tier[tier] for k, w in counted.items()}
            others = {k: w.launches - w.launches_by_tier[tier] for k, w in counted.items()}
            epochs, fids, ress, totals = read_log(os.path.join(tmp, label))
            n = len(epochs)
            bwd = "k4" if tier == "bf16" else "k3"
            want = {"k1": 0, "k2": 2 * n, "k3": 0, "k4": 0, bwd: 2 * n}
            print(f"  {label}: {n} loss evaluations, launches {launches} (other tiers {others}), "
                  f"plain-path calls {[spy.calls for spy in spies]}; total {totals[0]:.5e} -> "
                  f"{totals[-1]:.5e} (min {min(totals):.5e}); CLI train wall time {wall:.2f} s")
            if epochs != list(range(1, n + 1)):
                fail(f"{label}: log.txt rows are not epochs 1..n")
            if not all(math.isfinite(v) for v in (*fids, *ress, *totals)):
                fail(f"{label}: log.txt holds a non-finite value")
            if not totals[-1] < totals[0]:
                fail(f"{label}: the last total {totals[-1]} is not below the first {totals[0]}")
            if launches != want or any(others.values()):
                fail(f"{label}: launches {launches} (other tiers {others}), expected {want}: K2 "
                     f"twice per loss evaluation (K=3 residual, K=0 fidelity), {bwd.upper()} "
                     "twice, no K1")
            if any(spy.calls for spy in spies):
                fail(f"{label}: training called a plain version")
            return launches, n, wall

        phase("25b: examples/legacy.json uncut through CLI train (500 Adam, L-BFGS "
              "100/125) at f32, then at bf16 with Adam cut to 100")
        launches_f32, evals_f32, wall_f32 = train("legacy_f32", cfg_path, "f32")
        if evals_f32 < 501:
            fail(f"the legacy run logged {evals_f32} evaluations, fewer than 500 Adam + 1")
        launches_bf16, evals_bf16, wall_bf16 = train(
            "legacy_bf16", legacy_config_file(tmp, repo, snap_dir, kernel_precision="bf16",
                                              adam_optimizer={"max_it": 100}), "bf16")

        # 25c. kernel and plain Trainers from the same weights -------------------------
        phase("25c: iteration 1 and a 20-step Adam prefix, K2 + K3 against autograd")
        with open(cfg_path) as f:
            raw = json.load(f)
        raw["adam_optimizer"]["max_it"], raw["lbfgs_optimizer"]["max_it"] = 20, 0
        init = numpy_params(spec.sizes, "xavier", 26)
        runs = {}
        for mode in ("auto", "off"):
            run = os.path.join(tmp, f"prefix_{mode}")
            os.makedirs(run)
            tr = driver.Trainer(parse_config(dict(raw, fused_kernel=mode)), run_dir=run,
                                echo_every=0, initial_params=init, device=dev)
            if tr.kernel_plan != (False, mode == "auto", mode == "auto"):
                fail(f"fused_kernel={mode!r} chose {tr.kernel_plan} for the legacy net on the card")
            losses = tr._adam_steps(20).cpu().numpy()
            runs[mode] = (losses, {k: v.clone() for k, v in tr.state.params.items()})
        (l_on, p_on), (l_off, p_off) = runs["auto"], runs["off"]
        rel1 = np.abs(l_on[0] - l_off[0]) / np.abs(l_off[0])
        gap = max(float((p_on[k] - p_off[k]).abs().max()) for k in p_on)
        moved = max(float((p_off[k] - torch.as_tensor(init[k]).to(dev)).abs().max()) for k in p_on)
        drift = float(np.max(np.abs(l_on - l_off) / np.abs(l_off)))
        print(f"  iteration 1 (fid, res, total): K2+K3 {l_on[0]} autograd {l_off[0]} rel {rel1}; "
              f"after 20 steps (parameters moved up to {moved:.3e}) max |p_kernels - p_plain| "
              f"{gap:.3e}, max relative loss gap {drift:.3e}; tolerances 1e-5 and 1e-6")
        if not (rel1 <= 1e-5).all():
            fail("iteration-1 legacy losses of K2+K3 and autograd differ by more than 1e-5")
        if not gap <= 1e-6:
            fail("the 20-step Adam prefix of K2+K3 and autograd diverged on the legacy net")

        # 25d. times ---------------------------------------------------------------------
        phase("25d: legacy times")
        smi = nvidia_smi("name,power.limit")
        steps = {t: benchmarks.run_legacy_step_bench(kernel_precision=t, device=dev)
                 for t in ("f32", "bf16")}
        _, x, kt, ybar, dybar = cases[0]
        times = {}
        for label, fn, plain, flops, nbytes, rate in (
            ("K2 (K=3)", lambda: kernels.mlp_fwd_tangents(params, x, spec, kt),
             lambda: kernels.mlp_fwd_tangents_plain(params, x, spec, kt),
             k2_flops(spec, x.shape[0], kt, False),
             k2_bytes(params, x.shape[0], spec, (1 + kt) * spec.d_out), bound),
            ("K3-f32", lambda: kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, spec, kt),
             lambda: kernels_vjp.packed_mlp_bwd_plain(params, x, ybar, dybar, spec, kt),
             k3_flops(spec, x.shape[0], kt), k3_bytes(params, spec, x.shape[0], kt), bound),
            ("K4-bf16", lambda: kernels_vjp.packed_mlp_bwd_rebuild(params, x, ybar, dybar, spec,
                                                                    kt, precision="bf16"),
             lambda: kernels_vjp.packed_mlp_bwd_plain(params, x, ybar, dybar, spec, kt, "bf16"),
             k4_flops(spec, x.shape[0], kt), k3_bytes(params, spec, x.shape[0], kt),
             lambda f, b: bf16_bound(bound, bound_bf16, f, b, wg_flops(spec, x.shape[0], kt))),
        ):
            with torch.no_grad() if label.startswith("K2") else contextlib.nullcontext():
                ms = cuda_ms(fn, 7, 10)
                plain_ms = cuda_ms(plain, 5, 2)
            b, by = rate(flops, nbytes)
            times[label] = (ms, plain_ms, b, by)
            print(f"  {label} at {x.shape[0]} points: {ms:.4f} ms by CUDA events (plain "
                  f"{plain_ms:.4f} ms, bound {b:.5f} ms by {by}, {b / ms:.1%} of bound; "
                  f"{flops / x.shape[0]:,.0f} FLOP per point)")
        # the step's profile runs in a process of its own: late in this long
        # process torch.profiler records no device event (device_ms)
        prof = subprocess.run([sys.executable, os.path.join(repo, "tools", "profile_cmb_step.py"),
                               "--pipeline", "legacy", "--steps", "50"], capture_output=True,
                              text=True, timeout=600, cwd=repo)
        if prof.returncode != 0:
            fail(f"tools/profile_cmb_step.py --pipeline legacy exited {prof.returncode}: "
                 f"{prof.stderr[-2000:]}")
        step_prof = json.loads(prof.stdout.strip().splitlines()[-1])
        idle, busy = step_prof["idle_share"], step_prof["device_busy_ms"]
        # one launch per step each at K=3 (the largest of its kernel's
        # entries: the K=0 fidelity launch on 300 rows is the smaller)
        per_step = step_prof["kernels_us_per_step"] or {}
        dev_ms = {label: max((us / 1e3 for name, us in per_step.items() if key in name),
                             default=None)
                  for label, key in (("K2 (K=3)", "k2_mlp_fwd"),
                                     ("K3-f32", WALK_KERNEL["k3"]))}
        for label, d in dev_ms.items():
            b = times[label][2]
            print(f"  {label} device time in the profiled step: {fmt_ms(d)}"
                  + ("" if d is None else f" ({b / d:.1%} of its {b:.5f} ms bound)"))
        ms_f32, ms_bf16 = steps["f32"]["ms_per_iter"], steps["bf16"]["ms_per_iter"]
        print(f"  {smi}: legacy Adam step (500 steps, median of 3) f32 {ms_f32:.4f} ms, bf16 "
              f"{ms_bf16:.4f} ms ({json.dumps(steps['f32'])}); one step under torch.profiler "
              f"(50 steps): {step_prof['ms_profiled']:.4f} ms ({step_prof['ms_unprofiled']:.4f} "
              f"unprofiled), device busy {fmt_ms(busy)}, idle share "
              + ("not recorded" if idle is None else
                 f"{idle:.1%} of the profiled step, "
                 f"{1 - busy / step_prof['ms_unprofiled']:.1%} of the unprofiled one"))
        print(f"  phase 25: {time.perf_counter() - t_phase:.1f} s (kernel checks "
              f"{compare_s:.1f} s, CLI train {wall_f32:.1f} s at f32 and {wall_bf16:.1f} s at "
              "bf16)")

    k2, k3, k4 = times["K2 (K=3)"], times["K3-f32"], times["K4-bf16"]
    return {
        "k2": {"launches_legacy": launches_f32["k2"], "max_abs_err_legacy": err["k2"],
               "ms_legacy_k3": k2[0], "device_ms_legacy_k3": dev_ms["K2 (K=3)"],
               "plain_ms_legacy_k3": k2[1], "bound_ms_legacy_k3": k2[2],
               "points_legacy": LEGACY_POINTS},
        "k2_bf16": {"launches_legacy": launches_bf16["k2"]},
        "k3": {"launches_legacy": launches_f32["k3"], "max_abs_err_legacy": err["k3"],
               "ms_legacy": k3[0], "device_ms_legacy": dev_ms["K3-f32"],
               "plain_ms_legacy": k3[1],
               "bound_ms_legacy": k3[2], "legacy_adam_ms_per_iter": steps["f32"]["ms_per_iter"],
               "legacy_idle_share": idle, "legacy_prefix_gap": gap},
        "k4_bf16": {"launches_legacy": launches_bf16["k4"], "max_abs_err_legacy": err["k4_bf16"],
                    "ms_legacy": k4[0], "plain_ms_legacy": k4[1],
                    "bound_ms_legacy": k4[2],
                    "legacy_adam_ms_per_iter": steps["bf16"]["ms_per_iter"]},
    }


# the cuts of examples/deep_f64.json in phase 26: none (its f32 L-BFGS
# phase stops on its step tolerance after ~500 evaluations on an H100; the
# polish runs its 1,250 evaluations in ~55 s): PERF.md section 4
DEEP_F64_CUTS: dict = {}


def flagship_grid(tmp: str) -> str:
    """The train-grid cell's data: the synthetic 81x261 grid with 40.8 % NaN
    rows (12,516 points), written once under ``tmp``."""
    from pinn_depthestimation_tpu_torch.utils import synthetic

    mat = os.path.join(tmp, "grid_0408.mat")
    if not os.path.exists(mat):
        synthetic.make_newmethod_mat(mat, nx=81, ny=261, nan_fraction=0.408, seed=21)
    return mat


def example_config(tmp: str, repo: str, example: str, **overrides) -> str:
    """``examples/<example>.json`` on :func:`flagship_grid` with ``overrides``
    merged in; returns the config path."""
    with open(os.path.join(repo, "examples", f"{example}.json")) as f:
        raw = json.load(f)
    raw["data"]["file"] = flagship_grid(tmp)
    if "file" in raw.get("data_test", {}):
        raw["data_test"]["file"] = raw["data"]["file"]
    return write_config(tmp, example, raw, overrides)


@contextlib.contextmanager
def patched(obj, name: str, value):
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, real)


def polish_phase(dev, repo: str, f64_fma_peak: float) -> dict:
    """Phase 26: ``examples/deep_f64.json`` through CLI ``train`` on the
    card, K1 for the f32 phases and the float64 polish on plain autograd,
    a mid-polish checkpoint resumed through CLI ``--resume``. Returns the
    numbers for K1-f32's entry of the ``kernels`` line."""
    import numpy as np
    import torch

    from pinn_depthestimation_tpu_torch import benchmarks, cli
    from pinn_depthestimation_tpu_torch.config import load_config
    from pinn_depthestimation_tpu_torch.data import load_training_data
    from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
    from pinn_depthestimation_tpu_torch.models.mlp import PARAM_KEYS
    from pinn_depthestimation_tpu_torch.ops import kernels, kernels_step
    from pinn_depthestimation_tpu_torch.optim import lbfgs as lbfgs_mod
    from pinn_depthestimation_tpu_torch.training import checkpoint as ckpt_mod
    from pinn_depthestimation_tpu_torch.training import driver
    from pinn_depthestimation_tpu_torch.training.logging_utils import read_log
    from pinn_depthestimation_tpu_torch.training.loss import build_loss_fn, value_and_grad

    t_phase = time.perf_counter()
    flagship = MLPSpec(sizes=benchmarks.FLAGSHIP_SIZES, init_type="xavier")
    k1 = kernels_step.fused_loss_and_grad
    keys = ("fidelity_input", "fidelity_true", "residual_input")
    seen: dict = {}

    class PolishWitness(driver.Trainer):
        """The CLI's Trainer, reading K1's count around the polish and saving
        one checkpoint inside it (the newmethod cadence cuts none there)."""

        def train_f64_polish(self):
            seen.update(trainer=self, k1_before=k1.launches, evals_before=self.state.iteration,
                        start={k: v.detach().clone() for k, v in self.state.params.items()})
            t0 = time.perf_counter()
            super().train_f64_polish()
            torch.cuda.synchronize()
            seen.update(k1_after=k1.launches, seconds=time.perf_counter() - t0)

        def _record(self, losses):
            super()._record(losses)
            live = self._live_lbfgs64_state
            if live is None or live.reason != lbfgs_mod.RUNNING:
                return
            # the first boundary inside the polish, replaced by the first one
            # within 200 evaluations of its budget: the resume then replays
            # a short tail, not the whole polish
            near_end = live.func_evals >= self.config.f64_polish.max_evaluation - 200
            if "mid" not in seen or (near_end and not seen.get("near_end")):
                seen.update(mid=self.save("model_midpolish"), mid_iteration=self.state.iteration,
                            near_end=near_end)

    with tempfile.TemporaryDirectory() as tmp:
        phase("26: examples/deep_f64.json through CLI train: K1 for the f32 phases, "
              f"the float64 polish on the card (cuts: {json.dumps(DEEP_F64_CUTS)})")
        path = example_config(tmp, repo, "deep_f64", **DEEP_F64_CUTS)
        cfg = load_config(path)
        td = load_training_data(cfg)
        n = td.residual_input.shape[0]
        # one f64 evaluation alone: the polish's loss and gradient
        loss_fn = build_loss_fn(cfg, flagship, input_min_max=td.input_min_max,
                                fidelity_is_residual=td.fidelity_is_residual)
        p64 = f64(params_from_numpy(numpy_params(flagship.sizes, "xavier", 26), dev))
        b64 = {k: torch.as_tensor(np.asarray(getattr(td, k), np.float64)).to(dev) for k in keys}
        vg = value_and_grad(loss_fn)
        ms_f64 = cuda_ms(lambda: vg(p64, b64), 5, 4)
        (t64, _), g64 = vg(p64, b64)
        if t64.dtype != torch.float64 or any(v.dtype != torch.float64 for v in g64.values()):
            fail("the polish's loss or gradient is not float64")
        flops = k1_flops(flagship, n)
        bound_fma = flops / f64_fma_peak * 1e3
        bound_tc = flops / (2 * f64_fma_peak) * 1e3
        print(f"  one f64 evaluation (loss + gradient, autograd) at {n} points: {ms_f64:.3f} ms "
              f"by CUDA events; bound {bound_tc:.4f} ms over the f64 tensor-core peak "
              f"{2 * f64_fma_peak / 1e12:.2f} TFLOP/s ({bound_tc / ms_f64:.2%} of it; "
              f"{bound_fma:.4f} ms over the f64 FMA peak {f64_fma_peak / 1e12:.2f} TFLOP/s), "
              f"{flops / n:,.0f} FLOP per point")

        kernels.reset_launches(k1)
        kernels.reset_launches(kernels.mlp_fwd_tangents)
        t0 = time.perf_counter()
        with patched(driver, "Trainer", PolishWitness):
            rc = cli.main(["train", "--config", path, "--log-root", tmp, "--run-name", "deep",
                           "--device", "cuda", "--debug"])
        wall = time.perf_counter() - t0
        if rc != 0:
            fail(f"CLI train on examples/deep_f64.json exited {rc}")
        tr = seen["trainer"]
        n_f32 = tr.stats["loss_evaluations"]
        n_pol = tr.stats["f64_polish_evaluations"]
        epochs, _, _, totals = read_log(os.path.join(tmp, "deep"))
        state = tr._live_lbfgs64_state
        # the f32 phases' end in float64: the polish's starting value
        (f_start, _), _ = vg(f64(seen["start"]), b64)
        f_start, f_end = float(f_start), float(state.f)
        print(f"  {n_f32} f32 evaluations ({cfg.adam.max_it} Adam + {n_f32 - cfg.adam.max_it} "
              f"L-BFGS, {tr.lbfgs_stop_reason}), K1 {seen['k1_before']} launches; polish "
              f"{n_pol} f64 evaluations ({tr.polish_stop_reason}; {state.num} curvature pairs "
              f"held at the end, {state.restarts} stall restarts) in {seen['seconds']:.2f} s "
              f"= {n_pol / seen['seconds']:.2f} evaluations/s, K1 "
              f"{seen['k1_after'] - seen['k1_before']} launches in it; the f64 loss "
              f"{f_start:.12e} at the f32 phases' end -> {f_end:.12e} at the polish's end "
              f"({(f_start - f_end) / f_start:.3e} relative); log.txt minimum "
              f"{min(totals[:n_f32]):.6e} (f32 rows) -> {min(totals[n_f32:]):.6e} (polish rows); "
              f"CLI wall {wall:.1f} s; phase times {json.dumps(tr.stats)}")
        if seen["k1_before"] != n_f32 or seen["evals_before"] != n_f32:
            fail(f"K1 launched {seen['k1_before']} times for {n_f32} f32 evaluations")
        if seen["k1_after"] != seen["k1_before"]:
            fail("K1 launched inside the f64 polish")
        if state.x.dtype != torch.float64 or state.x.device.type != "cuda" or not isinstance(
                state.f, np.float64):
            fail(f"the polish's iterate is {state.x.dtype} on {state.x.device}")
        if epochs != list(range(1, n_f32 + n_pol + 1)) or n_pol < 1:
            fail(f"log.txt has {len(epochs)} rows, not {n_f32} f32 + {n_pol} polish, numbered 1..n")
        if not (f_end < f_start and min(totals[n_f32:]) <= min(totals[:n_f32])):
            fail("the polish did not descend below the f32 phases' end")
        final = ckpt_mod.load_raw(os.path.join(tmp, "deep", "model.npz"))
        if any(final[k].dtype != np.float32 for k in PARAM_KEYS) or final.get(
                "params64") is None or final["params64"].dtype != np.float64:
            fail("the final model.npz lacks f32 parameters or the f64 iterate params64")
        if "mid" not in seen:
            fail("no checkpoint was cut inside the polish")

        # the mid-polish checkpoint through CLI --resume ---------------------------
        kernels.reset_launches(k1)
        t0 = time.perf_counter()
        rc = cli.main(["train", "--config", path, "--log-root", tmp, "--run-name", "resumed",
                       "--device", "cuda", "--debug", "--resume", seen["mid"]])
        resume_wall = time.perf_counter() - t0
        if rc != 0:
            fail(f"CLI train --resume from the mid-polish checkpoint exited {rc}")
        mid = seen["mid_iteration"]
        ep_b, _, _, tot_b = read_log(os.path.join(tmp, "resumed"))
        bitwise = ep_b == epochs[mid:] and tot_b == totals[mid:]
        same = next((i for i, (a, b) in enumerate(zip(tot_b, totals[mid:])) if a != b),
                    min(len(tot_b), len(totals) - mid))
        print(f"  resumed at evaluation {mid} (polish row {mid - n_f32}): {len(ep_b)} rows, K1 "
              f"{k1.launches} launches; the remaining rows bit for bit as the uninterrupted "
              f"run's: {bitwise} ({same} of {len(totals) - mid} rows equal as log.txt prints "
              f"them); minimum {min(tot_b):.6e}; CLI wall {resume_wall:.1f} s")
        if k1.launches != 0 or not ep_b or ep_b[0] != mid + 1:
            fail("the resumed run ran an f32 row or did not start at the checkpoint")
        if not (tot_b[0] <= totals[mid - 1] * 1.5 and min(tot_b) <= min(totals[mid:]) * 1.05):
            fail("the resumed polish restarted instead of continuing")
        print(f"  phase 26: {time.perf_counter() - t_phase:.1f} s")
    return {"f64_polish": {
        "launches_f32_phases": n_f32, "launches_in_polish": seen["k1_after"] - seen["k1_before"],
        "polish_evaluations": n_pol, "polish_seconds": seen["seconds"],
        "polish_evals_per_s": n_pol / seen["seconds"], "ms_per_f64_evaluation": ms_f64,
        "bound_ms_tensor_core": bound_tc, "bound_ms_fma": bound_fma,
        "f32_min": min(totals[:n_f32]), "f64_min": min(totals[n_f32:]),
        "f64_loss_at_f32_end": f_start, "f64_loss_at_polish_end": f_end,
        "curvature_pairs_at_end": state.num,
        "resume_bit_for_bit": bitwise, "cuts": DEEP_F64_CUTS}}


def mesh_phase(dev, repo: str) -> dict:
    """Phase 27: the data-parallel mesh on the one card. Returns the numbers
    for K1-f32's, K2-f32's and K3-f32's entries of the ``kernels`` line."""
    import io

    import numpy as np
    import torch

    from pinn_depthestimation_tpu_torch import benchmarks, cli, parallel
    from pinn_depthestimation_tpu_torch.config import load_config, parse_config
    from pinn_depthestimation_tpu_torch.models import MLPSpec
    from pinn_depthestimation_tpu_torch.ops import kernels, kernels_step, kernels_vjp
    from pinn_depthestimation_tpu_torch.parity import make_cmb_config
    from pinn_depthestimation_tpu_torch.training import checkpoint as ckpt_mod
    from pinn_depthestimation_tpu_torch.training.driver import Trainer
    from pinn_depthestimation_tpu_torch.training.logging_utils import read_log

    t_phase = time.perf_counter()
    k1, k2, k3 = (kernels_step.fused_loss_and_grad, kernels.mlp_fwd_tangents,
                  kernels_vjp.packed_mlp_bwd)
    flagship = MLPSpec(sizes=benchmarks.FLAGSHIP_SIZES, init_type="xavier")
    n_dev = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        phase("27: the data-parallel mesh (CLI --mesh, parallel.data, 4 shards of one "
              "card)")
        scaled = example_config(tmp, repo, "newmethod_scaled")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["train", "--config", scaled, "--log-root", tmp, "--run-name", "eight",
                           "--device", "cuda"])
        want = f"Error building device mesh: mesh 8x1 needs 8 devices, have {n_dev}"
        print(f"  examples/newmethod_scaled.json as shipped (parallel.data 8) on {n_dev} "
              f"device(s): exit {rc}, {out.getvalue().strip().splitlines()[-1]!r}")
        if n_dev < 8 and (rc != 1 or want not in out.getvalue()):
            fail("parallel.data 8 on fewer devices did not exit 1 with the mesh error")

        # --mesh 1 against the unsharded run, bit for bit ---------------------------------
        with open(scaled) as f:
            raw = json.load(f)
        raw["parallel"] = {}
        plain = write_config(tmp, "scaled_unsharded", raw, {})
        runs = {}
        for name, path, extra in (("mesh1", scaled, ["--mesh", "1"]), ("unsharded", plain, [])):
            kernels.reset_launches(k1)
            rc = cli.main(["train", "--config", path, "--log-root", tmp, "--run-name", name,
                           "--device", "cuda", "--debug"] + extra)
            if rc != 0:
                fail(f"CLI train ({name}) exited {rc}")
            log = read_log(os.path.join(tmp, name))
            runs[name] = (log, ckpt_mod.load_raw(os.path.join(tmp, name, "model.npz")),
                          k1.launches)
        (log1, model1, k1_mesh1), (log0, model0, _) = runs["mesh1"], runs["unsharded"]
        equal = log1 == log0 and all(np.array_equal(model1[k], model0[k])
                                     for k in ("w_in", "b_in", "w_hidden", "b_hidden",
                                               "w_out", "b_out"))
        print(f"  --mesh 1: {len(log1[0])} evaluations, K1 {k1_mesh1} launches; log rows and "
              f"final parameters bit for bit as the unsharded run's: {equal}")
        if not equal:
            fail("--mesh 1 differs from the unsharded run")
        if k1_mesh1 != len(log1[0]):
            fail(f"--mesh 1: K1 launched {k1_mesh1} times for {len(log1[0])} evaluations")

        # 4 shards of cuda:0 against the unsharded Trainer --------------------------------
        mesh4 = parallel.make_mesh(4, devices=[dev] * 4)
        csv, mat, _, _ = cmb_bench_points(dev, tmp)
        cmb_cfg = parse_config(make_cmb_config(csv, mat, 20, 0, interval=1, training_points=200))
        cmb_init = numpy_params(MLPSpec.from_layers(cmb_cfg.layers).sizes, "xavier", 27)
        cmb_init["b_out"][3] += 1.0  # eta + h away from 0
        cases = (("flagship", load_config(example_config(tmp, repo, "newmethod")),
                  numpy_params(flagship.sizes, "xavier", 27)),
                 ("cmb", cmb_cfg, cmb_init))
        numbers = {}
        for name, cfg, init in cases:
            got = {}
            for shards, mesh in ((1, None), (4, mesh4)):
                run = os.path.join(tmp, f"{name}_{shards}")
                os.makedirs(run)
                tr = Trainer(cfg, run_dir=run, echo_every=0, initial_params=init, mesh=mesh,
                             device=dev)
                for w in (k1, k2, k3):
                    kernels.reset_launches(w)
                losses = tr._adam_steps(20).cpu().numpy()
                counts = {"k1": k1.launches, "k2": k2.launches, "k3": k3.launches}
                params = {k: v.clone() for k, v in tr.state.params.items()}

                def steps(tr=tr):
                    tr._adam_steps(50)
                    torch.cuda.synchronize()

                ms = host_ms(steps, 3) / 50
                got[shards] = (losses, params, counts, ms)
            (l1, p1, c1, ms1), (l4, p4, c4, ms4) = got[1], got[4]
            rel1 = float(np.max(np.abs(l4[0] - l1[0]) / np.abs(l1[0])))
            gap = max(float((p4[k] - p1[k]).abs().max()) for k in p1)
            print(f"  {name}: 20 Adam steps unsharded {c1} launches, 4 shards {c4}; iteration 1 "
                  f"rel {rel1:.3e} (tolerance 1e-5), parameters after 20 steps {gap:.3e} apart "
                  f"(tolerance 1e-6); Adam step {ms1:.4f} ms unsharded, {ms4:.4f} ms on 4 "
                  f"shards (host clock, 50 steps, median of 3)")
            want = ({"k1": 80, "k2": 0, "k3": 0} if name == "flagship"
                    else {"k1": 0, "k2": 160, "k3": 160})
            if c4 != want or c1 != {k: v // 4 for k, v in want.items()}:
                fail(f"{name} on 4 shards launched {c4} (unsharded {c1}), expected {want}")
            if not rel1 <= 1e-5:
                fail(f"{name}: iteration 1 on 4 shards differs by {rel1:.3e}")
            if name == "flagship" and not gap <= 1e-6:
                fail(f"{name}: 20 Adam steps on 4 shards diverged by {gap:.3e}")
            numbers[name] = {"launches_mesh4": c4, "adam_ms": ms1, "adam_ms_mesh4": ms4,
                             "iter1_rel_mesh4": rel1, "params_gap_mesh4": gap}
        print(f"  phase 27: {time.perf_counter() - t_phase:.1f} s")
    return {"k1": {"launches_mesh1": k1_mesh1, "launches_mesh4": numbers["flagship"]["launches_mesh4"]["k1"],
                   "adam_ms_mesh4": numbers["flagship"]["adam_ms_mesh4"],
                   "adam_ms_unsharded_same_call": numbers["flagship"]["adam_ms"]},
            "k2": {"launches_mesh4_cmb": numbers["cmb"]["launches_mesh4"]["k2"]},
            "k3": {"launches_mesh4_cmb": numbers["cmb"]["launches_mesh4"]["k3"],
                   "cmb_adam_ms_mesh4": numbers["cmb"]["adam_ms_mesh4"],
                   "cmb_adam_ms_unsharded_same_call": numbers["cmb"]["adam_ms"]}}


WIDE_SOURCES = {
    "k2": "pinn_depthestimation_tpu_torch/csrc/mlp_fwd_tangents_wide.cu",
    "k1": "pinn_depthestimation_tpu_torch/csrc/continuity_train_step_wide.cu",
    "k3": "pinn_depthestimation_tpu_torch/csrc/mlp_bwd_wide.cu",
    "k4": "pinn_depthestimation_tpu_torch/csrc/mlp_bwd_wide.cu",  # -DWIDE_REBUILD=1
}
WIDE_KERNEL = {"k2": "fwd_kernel", "k1": "k1w_kernel", "k3": "cotangent_kernel",
               "k4": "cotangent_kernel"}
TIER_NAMES = ("f32", "bf16", "f32x3")


def wide_build_report(repo: str) -> float:
    """Phase 2's lines for the wide body's libraries (``cuda_build.WIDE``):
    per kernel and tier the HMMA of its kernels and of their innermost HMMA
    loops (``cuobjdump -sass``, the twelve libraries read at once: an HMMA in
    every bf16 and f32x3 walk or forward, none at f32, or the phase fails),
    and the registers and spills from ``build.log``; returns the CPU seconds
    of their ``nvcc``."""
    from concurrent.futures import ThreadPoolExecutor

    from pinn_depthestimation_tpu_torch.ops import cuda_build

    built = cuda_build._ensure(cuda_build.WIDE)
    libs = [(name, tier) for name in cuda_build.WIDE for tier in cuda_build.TIERS]
    with ThreadPoolExecutor(max_workers=len(libs)) as pool:
        sass = dict(zip(libs, pool.map(
            lambda nt: sass_kernels(str(built[nt[0]].log_path.parent / f"lib{nt[0]}_0_{nt[1]}.so")),
            libs)))
    cpu_s = 0.0
    for name in cuda_build.WIDE:
        log = built[name].log_path.read_text() if built[name].log_path.exists() else ""
        for block in log.split(f"== {name} variant ")[1:]:
            head = re.match(r"(\d+) tier (\w+) \(exit -?\d+, ended at ([\d.]+) s, "
                            r"([\d.]+) s of CPU\)", block)
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", block)]
            spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", block)]
            cpu_s += float(head.group(4))
            tier = head.group(2)
            walks = {fn: n for fn, (n, _) in sass[name, tier].items()
                     if "reduce_kernel" not in fn and "images_kernel" not in fn}
            loops = [lp for _, lp in sass[name, tier].values() if lp]
            print(f"  SASS of {name.upper()} (wide) {tier}: {len(walks)} kernels, HMMA per kernel "
                  f"{min(walks.values(), default=0)}..{max(walks.values(), default=0)}"
                  + (f"; innermost HMMA loops {min(loops)[0]}..{max(loops)[0]} instructions, "
                     f"{min(lp[1] for lp in loops)}..{max(lp[1] for lp in loops)} HMMA"
                     if loops else ""))
            if not walks or not all((n == 0) == (tier == "f32") for n in walks.values()):
                fail(f"{name.upper()} (wide) {tier}: expected {'no' if tier == 'f32' else 'an'} "
                     "HMMA in every kernel")
            print(f"  ptxas {name.upper()} (wide) {tier}: registers "
                  f"{min(regs, default=0)}..{max(regs, default=0)}, max spill stores "
                  f"{max(spills, default=0)} B over {len(regs)} kernels; nvcc ended at "
                  f"{head.group(3)} s after {head.group(4)} s of CPU; log "
                  f"{os.path.relpath(built[name].log_path, repo)}")
    return cpu_s


def tier_bounds(bound, bound_bf16):
    """The bound of a kernel's work (``f`` operations, ``b`` bytes, of which
    ``wg`` weight-gradient operations) at each tier: f32 on the CUDA cores'
    FMA rate; bf16 its tier-typed products on the tensor cores' rate and its
    f32 weight gradients on the CUDA cores' (:func:`bf16_bound`); f32x3
    (three bf16 products) on the tensor cores' rate; or the bytes (as phases
    6, 14 and 18 state them)."""
    return {"f32": lambda f, b, wg=0.0: bound(f, b),
            "bf16": lambda f, b, wg=0.0: bf16_bound(bound, bound_bf16, f, b, wg),
            "f32x3": lambda f, b, wg=0.0: x3_bounds(bound, bound_bf16, f, b)[:2]}


def held(name: str, tier: str, got, fn, params, x, *args) -> tuple[float, bool]:
    """``got`` (a kernel's output at ``tier``) held to its plain version
    ``fn(params, x, *args, tier)``: at f32 by :func:`compare`, at bf16 and
    f32x3 by :func:`compare_tier` against the plain tier, plain f32 and the
    plain tier with float64 sums. Returns the max abs error and whether the
    tier's error showed (always True at f32)."""
    want = fn(params, x, *args, tier)
    if tier == "f32":
        return compare(name, got, want), True
    want32 = fn(params, x, *args, "f32")
    want64 = fn(f64(params), x.double(), *args, tier)
    if tier == "f32x3":
        return compare_tier(name, got, want, want32, want64, tier=tier, rel_floor=X3_REL_FLOOR,
                            distinct=X3_DISTINCT)
    return compare_tier(name, got, want, want32, want64, tier=tier)


def wide_cases():
    """Phase 28's nets ``[(name, spec)]``: narrow widths the narrow body was
    not compiled for (padded), the wide body's widths, the JAX kernel
    tests' g = 1 shape and nets with d_out or d_in above 8."""
    from pinn_depthestimation_tpu_torch.models import MLPSpec

    return [
        ("width 17 (narrow, padded to 20)", MLPSpec(sizes=(2,) + (17,) * 4 + (3,))),
        ("width 24 (narrow, padded to 32)", MLPSpec(sizes=(3,) + (24,) * 4 + (3,),
                                                   init_type="kaiming")),
        ("width 33 (wide, padded to 36)", MLPSpec(sizes=(2,) + (33,) * 4 + (3,))),
        ("width 64", MLPSpec(sizes=(2,) + (64,) * 4 + (3,))),
        ("width 100", MLPSpec(sizes=(3,) + (100,) * 3 + (3,), init_type="kaiming")),
        ("width 128, (d_in, d_out) = (2, 2)", MLPSpec(sizes=(2,) + (128,) * 3 + (2,))),
        ("width 128, heads (U, V, h)", MLPSpec(sizes=(2,) + (128,) * 3 + (3,))),
        ("d_out = 16", MLPSpec(sizes=(3,) + (20,) * 3 + (16,))),
        ("d_in = 12", MLPSpec(sizes=(12,) + (24,) * 3 + (4,))),
    ]


def wide_phase(dev, repo: str, bound, bound_bf16) -> dict:
    """Phase 28: K2, K1, K3 and K4 at every tier on the shapes the narrow
    bodies were not compiled for (:func:`wide_cases`: padded narrow widths
    and the wide body), each held to its plain version; then each kernel
    and tier timed at widths 64 and 128 on the path's shapes (K1 and K2 on
    the 2->[W]x100->3 flagship at 12,516 points, K3 and K4 on the
    2->[W]x10->6 CMB net on the ~20,500-point CMB grid), CUDA events and the
    profiler's device time, beside the plain version and the bound. Returns
    per kernel and tier the numbers for the ``kernels`` line."""
    import numpy as np
    import torch

    from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
    from pinn_depthestimation_tpu_torch.ops import kernels, kernels_step, kernels_vjp, wide_plan, widths

    phase("28: K2, K1, K3 and K4 on the shapes the narrow bodies lack, every tier, "
          "against their plain versions")
    wrappers = (kernels.mlp_fwd_tangents, kernels.fused_residual_continuity,
                kernels_step.fused_loss_and_grad, kernels_vjp.packed_mlp_bwd,
                kernels_vjp.packed_mlp_bwd_rebuild)
    for w in wrappers:
        kernels.reset_launches(w)
    rng = np.random.RandomState(28)
    err = {(k, t): 0.0 for k in ("k1", "k2", "k3", "k4") for t in TIER_NAMES}
    n = 3_001

    def k1_batch(x, n_pts):
        tr = torch.as_tensor((rng.randn(n_pts, 2) * 0.1).astype(np.float32)).to(dev)
        ones = torch.ones(n_pts, device=dev)
        return kernels_step.make_step_batch(x, tr, (x[:, 0] < 0.3).float(), ones, [1.0, 1.0], 2,
                                            1.0, 1.0, anchor_depth=0.75, has_anchor=True)

    def k1_plain(p, x, b, spec, tier):
        bb = b if x.dtype == torch.float32 else kernels_step.make_step_batch(
            x, b.trues.double(), b.sel.double(), b.mask.double(), [1.0, 1.0], 2, 1.0, 1.0,
            anchor_depth=0.75, has_anchor=True)
        (t, _), g = kernels_step.fused_loss_and_grad_plain(p, bb, spec, tier)
        return torch.cat([t.reshape(1)] + [g[k].reshape(-1) for k in kernels_step.FLAT_KEYS])

    def bwd_plain(p, x, ybar, dybar, spec, kt, tier):
        if x.dtype == torch.float64:
            ybar, dybar = ybar.double(), dybar.double()
        g = kernels_vjp.packed_mlp_bwd_plain(p, x, ybar, dybar, spec, kt, tier)
        return torch.cat([g[k].reshape(-1) for k in kernels_step.FLAT_KEYS])

    with torch.no_grad():
        for name, spec in wide_cases():
            params = params_from_numpy(numpy_params(spec.sizes, spec.init_type, 28), dev)
            x = torch.as_tensor(rng.uniform(-1, 1, (n, spec.d_in)).astype(np.float32)).to(dev)
            kmax = min(3, spec.d_in)
            ybar = torch.as_tensor(rng.randn(n, spec.d_out).astype(np.float32)).to(dev)
            dybar = torch.as_tensor(rng.randn(kmax, n, spec.d_out).astype(np.float32)).to(dev)
            route = widths.narrow_width(spec)
            print(f" {name}: sizes {spec.sizes[0]}->[{spec.width}]x{spec.n_hidden}->"
                  f"{spec.d_out} {spec.init_type}, N={n}, body "
                  f"{'narrow at width %d' % route if route else 'wide'}")
            for tier in TIER_NAMES:
                real = []
                for k in range(kmax + 1):
                    y, dy = kernels.mlp_fwd_tangents(params, x, spec, k, precision=tier)
                    torch.cuda.synchronize()
                    fy = lambda p, xx, kk, t: kernels.mlp_fwd_tangents_plain(p, xx, spec, kk, t)[0]  # noqa: E731
                    fdy = lambda p, xx, kk, t: kernels.mlp_fwd_tangents_plain(p, xx, spec, kk, t)[1]  # noqa: E731
                    e, r = held(f"K2-{tier} K={k} y", tier, y, fy, params, x, k)
                    err["k2", tier] = max(err["k2", tier], e)
                    real.append(r)
                    if k:
                        e, r = held(f"K2-{tier} K={k} dy", tier, dy, fdy, params, x, k)
                        err["k2", tier] = max(err["k2", tier], e)
                        real.append(r)
                if spec.d_out == 3 and spec.d_in >= 2:  # heads (U, V, h), inputs (x, y)
                    fc = kernels.fused_residual_continuity(params, x, spec, precision=tier)
                    torch.cuda.synchronize()
                    fres = lambda p, xx, t: kernels.residual_continuity_plain(p, xx, spec, t)  # noqa: E731
                    e, r = held(f"K2-{tier} continuity epilogue", tier, fc, fres, params, x)
                    err["k2", tier] = max(err["k2", tier], e)
                    real.append(r)
                for kern, impl in (("k3", "stream"), ("k4", "rebuild")):
                    g = kernels_vjp.packed_mlp_bwd(params, x, ybar, dybar, spec, kmax,
                                                   precision=tier, impl=impl)
                    torch.cuda.synchronize()
                    flat = torch.cat([g[k].reshape(-1) for k in kernels_step.FLAT_KEYS])
                    fb = lambda p, xx, t: bwd_plain(p, xx, ybar, dybar[:kmax], spec, kmax, t)  # noqa: E731
                    e, r = held(f"{kern.upper()}-{tier} K={kmax} gradients", tier, flat, fb,
                                params, x)
                    err[kern, tier] = max(err[kern, tier], e)
                    real.append(r)
                if kernels_step.kernel_supports(spec):
                    b = k1_batch(x[:, :spec.d_in], n)
                    (t1, _), g1 = kernels_step.fused_loss_and_grad(params, b, spec, precision=tier)
                    torch.cuda.synchronize()
                    got = torch.cat([t1.reshape(1)] + [g1[k].reshape(-1)
                                                       for k in kernels_step.FLAT_KEYS])
                    f1 = lambda p, xx, t: k1_plain(p, xx, b, spec, t)  # noqa: E731
                    e, r = held(f"K1-{tier} loss and gradients", tier, got, f1, params, x)
                    err["k1", tier] = max(err["k1", tier], e)
                    real.append(r)
                if not any(real):
                    fail(f"{name}: no output shows the {tier} tier's error above its floor")
    checks = {w.__name__: (dict(w.launches_by_tier), dict(w.launches_by_body)) for w in wrappers}
    print(f"  phase 28 launches (comparisons; by tier, by body): {checks}")
    if not all(checks[w.__name__][1]["wide"] > 0 for w in wrappers):
        fail("a kernel never ran its wide body in phase 28")

    # the path's shapes at widths 64 and 128: every tier held to its plain
    # version at the shapes phase 29 launches, then timed
    bounds = tier_bounds(bound, bound_bf16)
    with tempfile.TemporaryDirectory() as tmp:
        _, _, res_pts, fid_pts = cmb_bench_points(dev, tmp)
    n_flag, n_grid = 12_516, 81 * 261
    grid = torch.as_tensor(rng.uniform(-1, 1, (n_grid, 2)).astype(np.float32)).to(dev)
    timed = {}
    for W in (64, 128):
        flag = MLPSpec(sizes=(2,) + (W,) * 100 + (3,))
        cmb = MLPSpec(sizes=(2,) + (W,) * 10 + (6,))
        fp = params_from_numpy(numpy_params(flag.sizes, "xavier", 29), dev)
        cp = params_from_numpy(numpy_params(cmb.sizes, "xavier", 29), dev)
        x = torch.as_tensor(rng.uniform(-1, 1, (n_flag, 2)).astype(np.float32)).to(dev)
        b = k1_batch(x, n_flag)
        n_res = res_pts.shape[0]
        ybar = torch.as_tensor(rng.randn(n_res, 6).astype(np.float32)).to(dev)
        dybar = torch.as_tensor(rng.randn(2, n_res, 6).astype(np.float32)).to(dev)
        fbar = torch.as_tensor(rng.randn(fid_pts.shape[0], 6).astype(np.float32)).to(dev)
        no_dy = torch.zeros(0, fid_pts.shape[0], 6, device=dev)
        # the f32 kernels against their plain versions, gradient by gradient
        with torch.no_grad():
            (t1, _), g1 = kernels_step.fused_loss_and_grad(fp, b, flag)
            (t2, _), g2 = kernels_step.fused_loss_and_grad_plain(fp, b, flag)
            for key in ("total",) + kernels_step.FLAT_KEYS:
                compare(f"K1 2->[{W}]x100->3, {n_flag} points: {key}",
                        t1 if key == "total" else g1[key], t2 if key == "total" else g2[key])
            for impl in ("stream", "rebuild"):
                g1 = kernels_vjp.packed_mlp_bwd(cp, res_pts, ybar, dybar, cmb, 2, impl=impl)
                g2 = kernels_vjp.packed_mlp_bwd_plain(cp, res_pts, ybar, dybar, cmb, 2)
                for key in kernels_step.FLAT_KEYS:
                    compare(f"{'K3' if impl == 'stream' else 'K4'} 2->[{W}]x10->6, {n_res} "
                            f"points: d{key}", g1[key], g2[key])
        # every tier: K1 and the K2 epilogue on the flagship's points, K2 at
        # K = 0 on the 81x261 serving grid (flagship and CMB nets), K2 at K = 2
        # and K3/K4 on the CMB grid, K2, K3 and K4 at K = 0 on its fidelity rows
        for tier in TIER_NAMES:
            tier_held = {"k1": [], "k2": [], "k3": [], "k4": []}
            with torch.no_grad():
                (t1, _), g1 = kernels_step.fused_loss_and_grad(fp, b, flag, precision=tier)
                got = torch.cat([t1.reshape(1)] + [g1[k].reshape(-1)
                                                   for k in kernels_step.FLAT_KEYS])
                tier_held["k1"].append(held(f"K1-{tier} 2->[{W}]x100->3, {n_flag} points", tier,
                                            got, lambda p, xx, t: k1_plain(p, xx, b, flag, t),
                                            fp, x))
                tier_held["k2"].append(held(
                    f"K2-{tier} 2->[{W}]x100->3 continuity epilogue, {n_flag} points", tier,
                    kernels.fused_residual_continuity(fp, x, flag, precision=tier),
                    lambda p, xx, t: kernels.residual_continuity_plain(p, xx, flag, t), fp, x))
                for spec, params, pts, k in ((flag, fp, grid, 0), (cmb, cp, grid, 0),
                                             (cmb, cp, res_pts, 2), (cmb, cp, fid_pts, 0)):
                    y, dy = kernels.mlp_fwd_tangents(params, pts, spec, k, precision=tier)
                    sizes = f"{spec.sizes[0]}->[{W}]x{spec.n_hidden}->{spec.d_out}"
                    for j, out in enumerate((y, dy)[:1 + bool(k)]):
                        tier_held["k2"].append(held(
                            f"K2-{tier} {sizes} K={k} {'y' if j == 0 else 'dy'}, {pts.shape[0]} "
                            "points", tier, out,
                            lambda p, xx, kk, t, s=spec, j=j: kernels.mlp_fwd_tangents_plain(
                                p, xx, s, kk, t)[j], params, pts, k))
                for kern, impl in (("k3", "stream"), ("k4", "rebuild")):
                    for pts, yb, dyb, k in ((res_pts, ybar, dybar, 2), (fid_pts, fbar, no_dy, 0)):
                        g = kernels_vjp.packed_mlp_bwd(cp, pts, yb, dyb, cmb, k, precision=tier,
                                                       impl=impl)
                        flat = torch.cat([g[key].reshape(-1) for key in kernels_step.FLAT_KEYS])
                        tier_held[kern].append(held(
                            f"{kern.upper()}-{tier} 2->[{W}]x10->6 K={k}, {pts.shape[0]} points",
                            tier, flat,
                            lambda p, xx, t, yb=yb, dyb=dyb, k=k: bwd_plain(p, xx, yb, dyb, cmb, k,
                                                                          t), cp, pts))
            for kern, held_out in tier_held.items():
                err[kern, tier] = max([err[kern, tier]] + [e for e, _ in held_out])
            if not any(r for held_out in tier_held.values() for _, r in held_out):
                fail(f"width {W}, {tier}: no output shows the tier's error above its floor")
            runs = {
                "k1": (lambda: kernels_step.fused_loss_and_grad(fp, b, flag, precision=tier),
                       lambda: kernels_step.fused_loss_and_grad_plain(fp, b, flag, tier),
                       k1_flops(flag, n_flag), k1_bytes(fp, n_flag, 2, 2), n_flag, flag,
                       wg_flops(flag, n_flag, 2)),
                "k2": (lambda: kernels.fused_residual_continuity(fp, x, flag, precision=tier),
                       lambda: kernels.residual_continuity_plain(fp, x, flag, tier),
                       k2_flops(flag, n_flag, 2, True), k2_bytes(fp, n_flag, flag, 1), n_flag,
                       flag, 0.0),
                "k3": (lambda: kernels_vjp.packed_mlp_bwd(cp, res_pts, ybar, dybar, cmb, 2,
                                                          precision=tier, impl="stream"),
                       lambda: kernels_vjp.packed_mlp_bwd_plain(cp, res_pts, ybar, dybar, cmb, 2,
                                                                tier),
                       k3_flops(cmb, n_res, 2), k3_bytes(cp, cmb, n_res, 2), n_res, cmb,
                       wg_flops(cmb, n_res, 2)),
                "k4": (lambda: kernels_vjp.packed_mlp_bwd_rebuild(cp, res_pts, ybar, dybar, cmb,
                                                                  2, precision=tier),
                       lambda: kernels_vjp.packed_mlp_bwd_plain(cp, res_pts, ybar, dybar, cmb, 2,
                                                                tier),
                       k4_flops(cmb, n_res, 2), k3_bytes(cp, cmb, n_res, 2), n_res, cmb,
                       wg_flops(cmb, n_res, 2)),
            }
            for kern, (fn, plain, flops, nbytes, pts, spec, wg) in runs.items():
                with torch.no_grad():
                    ms = cuda_ms(fn, 3, 2)
                    dev_ms = device_ms(fn, 3, WIDE_KERNEL[kern])
                    plain_ms = cuda_ms(plain, 3, 1)
                b_ms, by = bounds[tier](flops, nbytes, wg)
                kt = 0 if kern in ("k3", "k4") else None
                plan = wide_plan.card_plan(kern, pts, spec, 2, tier, dev)
                share = b_ms / (dev_ms or ms)
                print(f"  {kern.upper()}-{tier} wide, {spec.sizes[0]}->[{W}]x{spec.n_hidden}->"
                      f"{spec.d_out}, {pts} points: {ms:.4f} ms (CUDA events), device time "
                      f"{fmt_ms(dev_ms)}; plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms by {by}, "
                      f"{share:.1%} of it; {flops / pts:,.0f} FLOP per point; plan: {plan.tiles} "
                      f"tiles of {plan.tile} points on {plan.grid} blocks, {plan.rounds} rounds, "
                      f"{wide_plan.BLOCKS_PER_SM} block per SM, {plan.smem} B of shared memory, "
                      f"{plan.image} B of weight images"
                      f"{'' if kt is None else ', C = %d' % plan.ckpt_every}")
                timed[kern, tier, W] = {f"ms_w{W}": ms, f"device_ms_w{W}": dev_ms,
                                        f"plain_ms_w{W}": plain_ms, f"bound_ms_w{W}": b_ms,
                                        f"bound_by_w{W}": by, f"points_w{W}": pts,
                                        f"tile_w{W}": plan.tile, f"rounds_w{W}": plan.rounds}
    out = {(k, t): {"max_abs_err_wide": err[k, t]} for k, t in err}
    for (kern, tier, _), nums in timed.items():
        out[kern, tier].update(nums)
    for key, nums in padded_or_wide(dev, rng, k1_batch).items():
        out[key].update(nums)
    return out


def padded_or_wide(dev, rng, k1_batch) -> dict:
    """Phase 28's last part: K1 and the K2 epilogue at widths 17 and 24 on
    the 2->[W]x100->3 flagship's 12,516 points, on the route the port takes
    (the narrow body at the next compiled width, the net padded) against the
    wide body at the net's own width, each tier in turns (padded, wide,
    wide, padded) by CUDA events; the wide launch held to the plain version
    at f32 first. Returns per kernel and tier ``{"padded_ms_w17": ...,
    "wide_ms_w17": ..., "padded_ms_w24": ..., "wide_ms_w24": ...}``."""
    import numpy as np
    import torch

    from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
    from pinn_depthestimation_tpu_torch.ops import kernels, kernels_step, widths

    n = 12_516
    x = torch.as_tensor(rng.uniform(-1, 1, (n, 2)).astype(np.float32)).to(dev)
    b = k1_batch(x, n)
    fc = torch.empty(n, device=dev)
    res = {(k, t): {} for k in ("k1", "k2") for t in TIER_NAMES}
    for W in (17, 24):
        spec = MLPSpec(sizes=(2,) + (W,) * 100 + (3,))
        params = params_from_numpy(numpy_params(spec.sizes, "xavier", 30), dev)
        launch = {
            "k1": (lambda t: kernels_step._launch_k1(params, b, spec, precision=t),
                   lambda t: kernels_step._launch_k1_wide(params, b, spec, t)),
            "k2": (lambda t: kernels._launch_k2(params, x, spec, 2, t, epilogue=True, fc=fc),
                   lambda t: kernels._launch_k2_wide(params, x, spec, 2, t, epilogue=True, fc=fc)),
        }
        with torch.no_grad():
            _, _, _, stats, grads = kernels_step._plain_stats_and_grads(params, b, spec, "f32")
            flat = launch["k1"][1]("f32")
            n_g = kernels_step.n_flat(spec)
            compare(f"K1 wide at width {W}: loss statistics", flat[n_g:], stats)
            got = kernels_step.unflatten(flat[:n_g], spec)
            for key in kernels_step.FLAT_KEYS:
                compare(f"K1 wide at width {W}: d{key}", got[key], grads[key])
            launch["k2"][1]("f32")
            compare(f"K2 wide at width {W}: continuity epilogue", fc,
                    kernels.residual_continuity_plain(params, x, spec))
            for kern, (padded, wide) in launch.items():
                for tier in TIER_NAMES:
                    p1 = cuda_ms(lambda: padded(tier), 3, 2)
                    w1 = cuda_ms(lambda: wide(tier), 3, 2)
                    w2 = cuda_ms(lambda: wide(tier), 3, 2)
                    p2 = cuda_ms(lambda: padded(tier), 3, 2)
                    pm, wm = (p1 + p2) / 2, (w1 + w2) / 2
                    res[kern, tier].update({f"padded_ms_w{W}": pm, f"wide_ms_w{W}": wm})
                    print(f"  {kern.upper()}-{tier} 2->[{W}]x100->3, {n} points: narrow body at "
                          f"width {widths.narrow_width(spec)} (padded) {p1:.4f}/{p2:.4f} ms, wide "
                          f"body at width {W} {w1:.4f}/{w2:.4f} ms (CUDA events, in turns); "
                          f"wide/padded {wm / pm:.2f}")
    return res


def run_cli(argv: list[str]) -> tuple[int, str]:
    """``cli.main(argv)`` with its standard output captured (and echoed)."""
    import contextlib
    import io

    from pinn_depthestimation_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    print("\n".join(f"  | {line}" for line in out.strip().splitlines()[-6:]))
    return rc, out


def check_trained_run(run_dir: str, what: str, descent: bool = True) -> tuple[int, list]:
    """The log of a CLI ``train`` run cut as phase 8 cuts it (300 Adam steps,
    L-BFGS on): epochs 1..n, finite totals, ``model.npz`` written, and with
    ``descent`` Adam and L-BFGS lowering the loss. Returns the loss
    evaluations and totals."""
    from pinn_depthestimation_tpu_torch.training.logging_utils import read_log

    epochs, _, _, totals = read_log(run_dir)
    n_evals = len(epochs)
    if epochs != list(range(1, n_evals + 1)) or n_evals < 302:
        fail(f"{what}: log.txt rows are not epochs 1..n with n >= 302")
    if not all(math.isfinite(v) for v in totals):
        fail(f"{what}: log.txt holds a non-finite total")
    if descent and not totals[299] < totals[0]:
        fail(f"{what}: Adam did not lower the loss: {totals[0]} -> {totals[299]}")
    if descent and not min(totals[300:]) <= totals[299]:
        fail(f"{what}: L-BFGS minimum {min(totals[300:])} above the last Adam total")
    if not os.path.exists(os.path.join(run_dir, "model.npz")):
        fail(f"{what}: the run wrote no model.npz")
    return n_evals, totals


def cmb_w128_init() -> dict:
    """Phase 29's weights for the CMB net at width 128: phase 12b's recipe
    (seeded xavier, the eta head's bias shifted by 1)."""
    init = numpy_params((2,) + (128,) * 10 + (6,), "xavier", 6)
    init["b_out"][3] += 1.0
    return init


# K2 + K3 against autograd on the CMB net at width 128: the largest relative
# loss gap over the 20-step prefix (2.27e-7 on an H100 80GB HBM3 at 700 W;
# 1e-5, the iteration-1 tolerance, leaves a 44x margin)
PREFIX_W128_TOL = 1e-5


def wide_path_phase(dev, repo: str) -> dict:
    """Phase 29: the paths at full width through the wide body. CLI
    ``train`` then CLI ``test`` on ``examples/newmethod.json`` with
    ``hidden_width`` 128 and then 64 (100 hidden layers, phase 8's cuts: K1
    launches == log rows, K2 serves the 81x261 grid), on
    ``examples/cmb.json`` with ``hidden_width`` 128 at f32 (K3 == 2 x
    evaluations) and at bf16 (K4-bf16 == 2 x evaluations), phase 12's cuts,
    from :func:`cmb_w128_init`'s weights (``--init-from``): from the
    example's seeded weights at this width cmb.json's Adam amplifies f32
    roundoff some 600 times a step (autograd on the CPU and on the card
    part by 3.2e-3 at the second evaluation and 49 % at the tenth, with no
    kernel in either; ``tools/wide_cmb_trajectory.py``), so a 300-step run
    from them is one sample of a chaotic path that may or may not stay
    finite, on any implementation; from these, kernels and autograd stay
    within 1e-3 over the whole run (PERF.md, section 6);
    then, after the path's launches are read, a K2 + K3 Trainer against an
    autograd one on the CMB config at width 128 (iteration 1 and a 20-step
    prefix as phase 12b runs them, the prefix within
    :data:`PREFIX_W128_TOL`), a K2 + K4 Trainer at bf16 against the plain
    bf16 functions over the same prefix, and a K1 Trainer against an
    autograd Trainer at width 128, iteration 1 as phase 9 checks it. The
    CMB config's Adam (lr 1e-4) need not lower the loss at width 128 in 300
    steps: the prefixes show the paths move alike. Every launch of the path
    must be a wide one. Returns the path's launches per kernel and tier
    (the CLI runs only) and the runs' times."""
    import numpy as np
    import torch
    from scipy.io import loadmat

    from pinn_depthestimation_tpu_torch.config import load_config, parse_config
    from pinn_depthestimation_tpu_torch.ops import kernels, kernels_step, kernels_vjp
    from pinn_depthestimation_tpu_torch.parity import make_cmb_config
    from pinn_depthestimation_tpu_torch.training.driver import Trainer

    phase("29: the flagship at widths 128 and 64 and the CMB net at width 128, "
          "through CLI train and test on the wide body")
    wrappers = (kernels.mlp_fwd_tangents, kernels.fused_residual_continuity,
                kernels_step.fused_loss_and_grad, kernels_vjp.packed_mlp_bwd,
                kernels_vjp.packed_mlp_bwd_rebuild)
    for w in wrappers:
        kernels.reset_launches(w)
    out = {"train_s": {}}
    lbfgs = {"max_it": 20, "max_evaluation": 25, "tolerance_grad": 1e-9, "tolerance_change": 1e-12}
    with tempfile.TemporaryDirectory() as tmp:
        for W in (128, 64):
            cfg_path = newmethod_config(tmp, repo, layers={"hidden_width": W},
                                        adam_optimizer={"max_it": 300}, snapshot_iteration=300,
                                        lbfgs_optimizer=lbfgs)
            k1_before = kernels_step.fused_loss_and_grad.launches_by_body["wide"]
            k2_before = kernels.mlp_fwd_tangents.launches_by_body["wide"]
            run = f"flagship_w{W}"
            t0 = time.perf_counter()
            rc, _ = run_cli(["train", "--config", cfg_path, "--log-root", tmp, "--run-name", run,
                             "--device", "cuda", "--debug"])
            out["train_s"][f"flagship_w{W}"] = time.perf_counter() - t0
            if rc != 0:
                fail(f"CLI train at width {W} exited {rc}")
            run_dir = os.path.join(tmp, run)
            pred = os.path.join(tmp, f"pred_w{W}.mat")
            rc, _ = run_cli(["test", "--config", cfg_path, "--model",
                             os.path.join(run_dir, "model.npz"), "--save", pred, "--device", "cuda",
                             "--debug"])
            if rc != 0:
                fail(f"CLI test at width {W} exited {rc}")
            n_evals, totals = check_trained_run(run_dir, f"flagship at width {W}")
            k1 = kernels_step.fused_loss_and_grad.launches_by_body["wide"] - k1_before
            k2 = kernels.mlp_fwd_tangents.launches_by_body["wide"] - k2_before
            if k1 != n_evals:
                fail(f"width {W}: K1 (wide) launched {k1} times for {n_evals} loss evaluations")
            if k2 < 2:
                fail(f"width {W}: the snapshot and CLI test did not both go through K2 (wide)")
            served = loadmat(pred)
            for key in ("U", "V", "h"):
                arr = served[f"pred_{key}"]
                if arr.shape != (261, 81) or not np.isfinite(arr).all():
                    fail(f"width {W}: served pred_{key} of shape {arr.shape}, not finite")
            print(f"  width {W}: {n_evals} loss evaluations, K1 (wide) {k1}, K2 (wide) {k2}; "
                  f"total {totals[0]:.5e} -> {totals[299]:.5e} (Adam) -> {min(totals[300:]):.5e} "
                  f"(L-BFGS); CLI train wall time {out['train_s'][f'flagship_w{W}']:.2f} s")

        synth = os.path.join(tmp, "synth")
        if run_cli(["synth", "--out", synth])[0] != 0:
            fail("synth failed")
        csv, mat = (os.path.join(synth, f) for f in ("input_fid.csv", "input_res.mat"))
        init_npz = os.path.join(tmp, "cmb_w128_init.npz")
        np.savez(init_npz, **cmb_w128_init())
        for tier, bwd in (("f32", kernels_vjp.packed_mlp_bwd),
                          ("bf16", kernels_vjp.packed_mlp_bwd_rebuild)):
            cfg_path = cmb_config(tmp, repo, csv, mat, layers={"hidden_width": 128},
                                  adam_optimizer={"max_it": 300}, kernel_precision=tier,
                                  data_residual={"interval_x": 1, "interval_y": 1},
                                  lbfgs_optimizer=lbfgs)
            k2_before = kernels.mlp_fwd_tangents.launches_by_tier[tier]
            bwd_before = bwd.launches_by_body["wide"]
            run = f"cmb_w128_{tier}"
            t0 = time.perf_counter()
            rc, _ = run_cli(["train", "--config", cfg_path, "--log-root", tmp, "--run-name", run,
                             "--init-from", init_npz, "--device", "cuda", "--debug"])
            out["train_s"][run] = time.perf_counter() - t0
            if rc != 0:
                fail(f"CLI train on the CMB config at width 128, {tier}, exited {rc}")
            k2_train = kernels.mlp_fwd_tangents.launches_by_tier[tier] - k2_before
            run_dir = os.path.join(tmp, run)
            rc, _ = run_cli(["test", "--config", cfg_path, "--model",
                             os.path.join(run_dir, "model.npz"), "--save",
                             os.path.join(tmp, f"pred_{run}.mat"), "--device", "cuda", "--debug"])
            if rc != 0:
                fail(f"CLI test on the CMB model at width 128, {tier}, exited {rc}")
            n_evals, totals = check_trained_run(run_dir, f"CMB at width 128, {tier}",
                                                descent=False)
            nb = bwd.launches_by_body["wide"] - bwd_before
            name = "K3" if tier == "f32" else "K4"
            if nb != 2 * n_evals or bwd.launches_by_tier[tier] != bwd.launches:
                fail(f"CMB at width 128, {tier}: {name} (wide) launched {nb} times for {n_evals} "
                     "loss evaluations (2 per evaluation)")
            if k2_train != 2 * n_evals:
                fail(f"CMB at width 128, {tier}: K2 launched {k2_train} times in training for "
                     f"{n_evals} evaluations")
            print(f"  CMB net 2->[128]x10->6 at {tier}: {n_evals} loss evaluations, {name} "
                  f"(wide) {nb}, K2 {k2_train} in training; total {totals[0]:.5e} -> "
                  f"{totals[299]:.5e} (Adam) -> {min(totals[300:]):.5e} (L-BFGS); CLI train wall "
                  f"time {out['train_s'][run]:.2f} s")

        # the path's launches: the CLI runs above, and nothing of the checks below
        wide = {w.__name__: dict(w.launches_by_tier) for w in wrappers}
        print(f"  phase 29 path launches by tier {wide}; by body "
              f"{ {w.__name__: dict(w.launches_by_body) for w in wrappers} }")
        if any(w.launches_by_body["narrow"] for w in wrappers):
            fail("a launch of phase 29's wide path went to a narrow body")
        out["launches"] = {
            ("k1", "f32"): kernels_step.fused_loss_and_grad.launches_by_tier["f32"],
            ("k2", "f32"): kernels.mlp_fwd_tangents.launches_by_tier["f32"],
            ("k2", "bf16"): kernels.mlp_fwd_tangents.launches_by_tier["bf16"],
            ("k3", "f32"): kernels_vjp.packed_mlp_bwd.launches_by_tier["f32"],
            ("k4", "bf16"): kernels_vjp.packed_mlp_bwd_rebuild.launches_by_tier["bf16"],
        }

        # iteration 1 and a 20-step prefix on the CMB net at width 128, from
        # the same weights: K2 + K3 against autograd at f32, K2 + K4 at bf16
        # against the plain bf16 functions (PlainFused)
        init = cmb_w128_init()
        prefix = {}
        for run, mode, tier in (("kernels", "auto", "f32"), ("autograd", "off", "f32"),
                                ("kernels bf16", "auto", "bf16"), ("plain bf16", "auto", "bf16")):
            raw = dict(make_cmb_config(csv, mat, 20, 0, interval=1, training_points=200),
                       fused_kernel=mode, kernel_precision=tier)
            raw["layers"] = {**raw["layers"], "hidden_width": 128}
            run_dir = os.path.join(tmp, "cmb_prefix_" + run.replace(" ", "_"))
            os.makedirs(run_dir)
            with PlainFused() if run == "plain bf16" else contextlib.nullcontext():
                tr = Trainer(parse_config(raw), run_dir=run_dir, echo_every=0, initial_params=init,
                             device=dev)
                if tr.kernel_plan.fused != (mode == "auto"):
                    fail(f"fused_kernel={mode!r} on the CMB net at width 128 chose "
                         f"{tr.kernel_plan}")
                prefix[run] = tr._adam_steps(20).cpu().numpy()
        rel = lambda a, b: np.abs(prefix[a] - prefix[b]) / np.abs(prefix[b])  # noqa: E731
        rel1, gap = rel("kernels", "autograd")[0], float(rel("kernels", "autograd").max())
        gap_bf16, tier_gap = float(rel("kernels bf16", "plain bf16").max()), float(
            rel("plain bf16", "autograd").max())
        for run in prefix:
            print(f"  CMB net at width 128, {run}: iteration 1 (fid, res, total) {prefix[run][0]}; "
                  f"total {prefix[run][0, 2]:.5e} -> {prefix[run][-1, 2]:.5e} over 20 Adam steps")
        print(f"  iteration 1: K2+K3 against autograd rel {rel1} (tolerance 1e-5); over the 20 "
              f"steps max relative gap {gap:.3e} (tolerance {PREFIX_W128_TOL:g}); at bf16 K2+K4 "
              f"against the plain bf16 functions {gap_bf16:.3e}, the tier's own gap from f32 "
              f"{tier_gap:.3e} (tolerance: half of it)")
        if not (rel1 <= 1e-5).all():
            fail("iteration-1 CMB losses of K2+K3 and autograd at width 128 differ by more than 1e-5")
        if not gap <= PREFIX_W128_TOL:
            fail("the 20-step Adam prefix of K2+K3 and autograd at width 128 diverged")
        if not gap_bf16 <= 0.5 * tier_gap:
            fail("the 20-step bf16 Adam prefix of K2+K4 strays from the plain bf16 functions' by "
                 "half the tier's own gap or more")

        # iteration 1: a K1 Trainer against an autograd Trainer at width 128
        sizes = (2,) + (128,) * 100 + (3,)
        init = numpy_params(sizes, "xavier", 6)
        losses = {}
        for mode in ("on", "off"):
            path = newmethod_config(tmp, repo, fused_kernel=mode, layers={"hidden_width": 128})
            os.makedirs(os.path.join(tmp, f"it1_{mode}"))
            tr = Trainer(load_config(path), run_dir=os.path.join(tmp, f"it1_{mode}"), echo_every=0,
                         initial_params=init, device=dev)
            if tr.kernel_plan.k1 != (mode == "on"):
                fail(f"fused_kernel={mode!r} at width 128 chose {tr.kernel_plan}")
            losses[mode] = tr._adam_steps(1).cpu().numpy()[0]
        rel1 = np.abs(losses["on"] - losses["off"]) / np.abs(losses["off"])
        print(f"  iteration 1 at width 128 (fid, res, total): K1 {losses['on']} plain "
              f"{losses['off']} rel {rel1}")
        if not (rel1 <= 1e-5).all():
            fail("iteration-1 losses of K1 and the plain path at width 128 differ by more than 1e-5")
    return out


def modules_phase(dev, repo: str) -> dict:
    """Phase 30: the modules of the last slice on the card. CLI ``test``
    serves the committed JAX ``.msgpack`` fixture through K2, bit for bit
    as its ``.npz``; ``train --profile`` writes a trace that names K1's
    kernel; ``Trainer(training_data=)`` runs an Adam step; ``test --plot``,
    ``plot-log`` and ``video`` make their outputs, or give the named error
    where the machine lacks ``matplotlib``/``cv2`` (nothing is installed)."""
    import importlib.util

    import numpy as np
    from scipy.io import loadmat

    from pinn_depthestimation_tpu_torch import data as data_mod
    from pinn_depthestimation_tpu_torch.config import load_config
    from pinn_depthestimation_tpu_torch.ops import kernels, kernels_step
    from pinn_depthestimation_tpu_torch.training.driver import Trainer

    phase("30: .msgpack weights, train --profile, Trainer(training_data=), plots")
    fixture = os.path.join(repo, "tests", "data", "jax_state_w20x3")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = newmethod_config(tmp, repo, layers={"hidden_layers": 3, "hidden_width": 20},
                                    adam_optimizer={"max_it": 5}, snapshot_iteration=10_000,
                                    lbfgs_optimizer={"max_it": 0})
        kernels.reset_launches(kernels.mlp_fwd_tangents)
        preds = {}
        for ext in ("msgpack", "npz"):
            path = os.path.join(tmp, f"pred_{ext}.mat")
            rc, _ = run_cli(["test", "--config", cfg_path, "--model", f"{fixture}.{ext}", "--save",
                             path, "--device", "cuda", "--debug"])
            if rc != 0:
                fail(f"CLI test --model {ext} exited {rc}")
            preds[ext] = loadmat(path)
        if kernels.mlp_fwd_tangents.launches != 2:
            fail(f"K2 served the two grids in {kernels.mlp_fwd_tangents.launches} launches, not 2")
        for key in ("pred_U", "pred_V", "pred_h"):
            if preds["msgpack"][key].shape != (261, 81) or not np.array_equal(
                    preds["msgpack"][key], preds["npz"][key]):
                fail(f"the .msgpack fixture served {key} other than its .npz")
        print("  CLI test on the JAX .msgpack fixture: K2 served the 81x261 grid, bit for bit "
              "the .npz's")

        prof = os.path.join(tmp, "profile")
        kernels.reset_launches(kernels_step.fused_loss_and_grad)
        rc, text = run_cli(["train", "--config", cfg_path, "--log-root", tmp, "--run-name",
                            "profiled", "--device", "cuda", "--profile", prof, "--debug"])
        if rc != 0 or f"Profiler trace -> {prof}" not in text:
            fail(f"CLI train --profile exited {rc} or did not announce its trace")
        with open(os.path.join(prof, "trace.json")) as f:
            trace = f.read()
        if "k1_train_step_kernel" not in trace or kernels_step.fused_loss_and_grad.launches < 5:
            fail("the profiler's trace names no K1 kernel launch")
        out["profile_trace_bytes"] = len(trace)
        print(f"  train --profile: {len(trace)} bytes of Chrome trace naming k1_train_step_kernel "
              f"({kernels_step.fused_loss_and_grad.launches} K1 launches)")

        config = load_config(cfg_path)
        td = data_mod.load_training_data(config)
        os.makedirs(os.path.join(tmp, "given"))
        tr = Trainer(config, run_dir=os.path.join(tmp, "given"), echo_every=0, device=dev,
                     training_data=td)
        before = kernels_step.fused_loss_and_grad.launches
        row = tr._adam_steps(1).cpu().numpy()[0]
        if tr.data is not td or not np.isfinite(row).all() or \
                kernels_step.fused_loss_and_grad.launches != before + 1:
            fail("Trainer(training_data=) did not take one K1 Adam step on the given data")
        print(f"  Trainer(training_data=): one Adam step through K1, losses {row}")

        have = {m: importlib.util.find_spec(m) is not None for m in ("matplotlib", "cv2")}
        out["plot_modules"] = have
        print(f"  plotting modules on this machine: {have} (the port installs neither)")
        plots = os.path.join(tmp, "plots")
        rc, text = run_cli(["test", "--config", cfg_path, "--model", f"{fixture}.npz",
                            "--device", "cuda", "--plot", plots])
        if have["matplotlib"]:
            if rc != 0 or not os.listdir(plots):
                fail("test --plot wrote no plot")
        elif rc != 1 or "Error making plots:" not in text or "'matplotlib'" not in text:
            fail("test --plot without matplotlib did not print the named error")
        rc, text = run_cli(["plot-log", "--run-dir", os.path.join(tmp, "profiled")])
        if have["matplotlib"]:
            if rc != 0 or not os.path.exists(os.path.join(tmp, "profiled", "log.png")):
                fail("plot-log wrote no log.png")
        elif rc != 1 or "'matplotlib'" not in text:
            fail("plot-log without matplotlib did not exit 1 naming it")
        frames = os.path.join(tmp, "frames")
        os.makedirs(frames)
        avi = os.path.join(tmp, "v.avi")
        if have["cv2"]:
            import cv2

            rng = np.random.RandomState(30)
            for i in range(3):
                cv2.imwrite(os.path.join(frames, f"f{i}.png"),
                            (rng.rand(48, 64, 3) * 255).astype(np.uint8))
            rc, text = run_cli(["video", "--dir", frames, "--out", avi])
            cap, n = cv2.VideoCapture(avi), 0
            while cap.read()[0]:
                n += 1
            cap.release()
            if rc != 0 or n != 3:
                fail(f"video exited {rc} with {n} frames of 3")
            print(f"  video: {n} frames in {os.path.getsize(avi)} B of XVID AVI")
        else:  # a frame the video tool lists before it needs cv2
            open(os.path.join(frames, "frame.png"), "wb").close()
            rc, text = run_cli(["video", "--dir", frames, "--out", avi])
            if rc != 1 or "'cv2'" not in text:
                fail("video without cv2 did not exit 1 naming it")
    return out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    try:
        import pinn_depthestimation_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port package is not importable ({e}): run from the repository root")
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
    phase("1: device")
    smi = nvidia_smi("name,power.limit")
    print(smi)
    props = torch.cuda.get_device_properties(dev)
    sm_clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    f32_peak = props.multi_processor_count * 128 * 2 * sm_clock_mhz * 1e6
    # Hopper: 64 f64 FMA lanes per SM (half the f32 lanes); the f64 tensor
    # cores (DMMA) reach twice that
    f64_fma_peak = props.multi_processor_count * 64 * 2 * sm_clock_mhz * 1e6
    print(f"  torch {torch.__version__} cuda {torch.version.cuda}; {props.multi_processor_count} SMs, "
          f"max SM clock {sm_clock_mhz:.0f} MHz -> f32 FMA peak {f32_peak / 1e12:.2f} TFLOP/s, "
          f"f64 FMA peak {f64_fma_peak / 1e12:.2f} TFLOP/s (f64 tensor cores "
          f"{2 * f64_fma_peak / 1e12:.2f})")

    # 2. build --------------------------------------------------------------
    phase("2: build")
    t_build = time.perf_counter()
    cuda_build.build_all()  # K1, K2, K3 and K4, narrow and wide bodies, in one wave
    lib = cuda_build.k2_library()
    lib_k1, lib_k3, lib_k4 = cuda_build.k1_library(), cuda_build.k3_library(), cuda_build.k4_library()
    build_s = time.perf_counter() - t_build
    print(f"  K2, K1, K3 and K4 built in {build_s:.1f} s, one nvcc per (kernel, width, tier) "
          "and per (kernel, tier) of the wide body, all at once")
    cpu_s = 0.0
    for name, built in (("k2", lib), ("k1", lib_k1), ("k3", lib_k3), ("k4", lib_k4)):
        print(f"  {name.upper()}: {len(built.libs)} widths {sorted(built.libs)}; "
              f"log {os.path.relpath(built.log_path, repo)}")
        log = built.log_path.read_text() if built.log_path.exists() else ""
        for block in log.split(f"== {name} variant ")[1:]:
            head = re.match(r"(\d+) tier (\w+) \(exit -?\d+, ended at ([\d.]+) s, "
                            r"([\d.]+) s of CPU\)", block)
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", block)]
            spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", block)]
            cpu_s += float(head.group(4))
            print(f"  ptxas {name.upper()} width {head.group(1)} {head.group(2)}: registers "
                  f"{min(regs, default=0)}..{max(regs, default=0)}, max spill stores "
                  f"{max(spills, default=0)} B over {len(regs)} kernels; nvcc ended at "
                  f"{head.group(3)} s after {head.group(4)} s of CPU")
            if name == "k2" and head.group(2) == "f32":
                k2_f32_ptxas(block, built.libs[int(head.group(1))])
    wide_cpu_s = wide_build_report(repo)
    print(f"  the sixty narrow nvcc took {cpu_s:.1f} s of CPU, the twelve wide ones "
          f"{wide_cpu_s:.1f} s, on {os.cpu_count()} cores")
    for tier in ("f32", "bf16", "f32x3"):  # the cheap tiers on the tensor cores, f32 not
        sass = sass_kernels(str(lib.log_path.parent / f"libk2_20_{tier}.so"))
        hmma = [n for n, _ in sass.values()]
        # the tanh, K=2, epilogue kernel: the residual bench's
        loop = next((lp for name, (_, lp) in sass.items() if "ELi0ELi2ELb1E" in name), None)
        print(f"  SASS of K2 width 20 {tier}: {len(sass)} kernels, HMMA per kernel "
              f"{min(hmma, default=0)}..{max(hmma, default=0)}"
              + (f"; the continuity kernel's hidden-layer loop: {loop[0]} instructions, "
                 f"{loop[1]} HMMA" if loop else ""))
        if not sass or not all((n == 0) == (tier == "f32") for n in hmma):
            fail(f"K2-{tier}: expected {'no' if tier == 'f32' else 'an'} HMMA in every kernel")
    walk_sass_report({"k1": lib_k1, "k3": lib_k3, "k4": lib_k4})
    adam_entry = adam_phase(dev)

    # 3. kernel vs plain ----------------------------------------------------
    phase("3: K2 against its plain version on the card")
    flagship = MLPSpec(sizes=benchmarks.FLAGSHIP_SIZES, init_type="xavier")
    with torch.no_grad():
        for spec, params, x, tangent_counts in k2_cases(dev) + k2_ragged_cases(dev):
            kt = max(tangent_counts)
            print(f" sizes {spec.d_in}->[{spec.width}]x{spec.n_hidden}->{spec.d_out} "
                  f"{spec.init_type}, N={x.shape[0]}; f32 plan at K={kt}: "
                  f"{f32_plan_text(spec, x.shape[0], kt, dev)}")
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
    kernels.reset_launches(kernels.mlp_fwd_tangents)
    kernels.reset_launches(kernels.fused_residual_continuity)
    with tempfile.TemporaryDirectory() as tmp:
        phase("4: serving path (CLI synth + test --save) on the flagship")
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

        phase("5: residual evaluation at 10M points (run_residual_bench)")
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
        phase("6: times (CUDA events; median of reps)")
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
    with torch.no_grad():
        k2_shapes = k2_f32_shapes(dev, repo, bound, (flagship, serve_params, x_grid),
                                  (spec, params, coords))
    # phases 8 and 12 leave their trained models here for phase 24
    keep = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    # 7.-10. the training slice ------------------------------------------
    k1_report = training_phases(dev, repo, bound, keep.name)
    # 11.-13. the CMB slice ------------------------------------------------
    k3_report = cmb_phases(dev, repo, bound, keep.name)

    def bound_bf16(flops, nbytes):
        t_ops, t_bytes = flops / BF16_FLOPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    # 14.-17. the bf16 tier, K4 and the precision schedule -------------------
    bf16_report = bf16_phases(dev, repo, bound, bound_bf16,
                              {"flagship": k1_report["adam_ms_per_iter"],
                               "cmb": k3_report["cmb_adam_ms_per_iter"]})
    # 18.-21. the f32x3 tier, its paths and the bench suite -----------------
    x3_report = f32x3_phases(dev, repo, bound, bound_bf16)
    # 22.-24. the parity harness against the reference's runs, adaptation --
    parity_phases(dev, repo, keep.name)
    keep.cleanup()
    # 25. the legacy pipeline --------------------------------------------------
    legacy = legacy_phases(dev, repo, bound, bound_bf16)
    # 26. the f64 polish; 27. the mesh ------------------------------------------
    polish = polish_phase(dev, repo, f64_fma_peak)
    mesh = mesh_phase(dev, repo)
    # 28.-30. every Pallas shape: the wide body and the padded widths, the
    # paths at full width, the last modules ------------------------------------
    t_wide = time.perf_counter()
    wide = wide_phase(dev, repo, bound, bound_bf16)
    t_path = time.perf_counter()
    wide_path = wide_path_phase(dev, repo)
    t_mod = time.perf_counter()
    modules_phase(dev, repo)
    close_adam_count()
    t_end = time.perf_counter()
    print(f"  phases 28-30: {t_path - t_wide:.1f} s, {t_mod - t_path:.1f} s, {t_end - t_mod:.1f} s")
    print(f"  total {t_end - t_start:.1f} s (build {build_s:.1f} s)")

    # one entry per kernel and tier; K3-bf16 and K4-f32 launched on phase
    # 19's path, which picks the backward
    picked = x3_report["picked"]
    k2_f32 = {"name": "k2_mlp_fwd_tangents[f32]", "route": "cuda", "source": K2_SOURCE,
              "replaces": REPLACES, "library_ms": None,
              "launches": launches["mlp_fwd_tangents"] + launches["fused_residual_continuity"],
              "max_abs_err": max(err_pred, err_res), "ms": ms_res, "plain_ms": plain_res,
              "bound_ms": b_res, "bound_by": by_res, "points": n_res, "ms_1m": ms_res_1m,
              "plain_ms_1m": plain_res_1m, "launches_predict": launches["mlp_fwd_tangents"],
              "launches_continuity": launches["fused_residual_continuity"],
              "ms_predict": ms_pred, "plain_ms_predict": plain_pred, "bound_ms_predict": b_pred,
              "points_predict": n_grid, "build_s": build_s, **k2_shapes}
    k1_report["name"] = "k1_continuity_train_step[f32]"
    k3_report["name"] = "k3_mlp_bwd[f32]"
    k3_bf16 = {**bf16_report["k3_bf16"], "launches": picked[("bf16", "stream")]}
    k4_f32 = {**bf16_report["k4_f32"], "launches": picked[("f32", "rebuild")],
              "plain_ms": k3_report["plain_ms"]}
    entries = {
        ("k2", "f32"): {**k2_f32, **legacy["k2"], **mesh["k2"]},
        ("k2", "bf16"): {**bf16_report["k2_bf16"], **legacy["k2_bf16"]},
        ("k2", "f32x3"): x3_report["k2"],
        ("k1", "f32"): {**k1_report, **polish, **mesh["k1"]},
        ("k1", "bf16"): bf16_report["k1_bf16"], ("k1", "f32x3"): x3_report["k1"],
        ("k3", "f32"): {**k3_report, **legacy["k3"], **mesh["k3"]}, ("k3", "bf16"): k3_bf16,
        ("k3", "f32x3"): x3_report["k3"],
        ("k4", "f32"): k4_f32, ("k4", "bf16"): {**bf16_report["k4"], **legacy["k4_bf16"]},
        ("k4", "f32x3"): x3_report["k4"],
    }
    # the wide body's numbers (phase 28) and its launches on phase 29's path
    report = {"kernels": [
        {**entry, **wide[key], "source_wide": WIDE_SOURCES[key[0]],
         "launches_wide": wide_path["launches"].get(key, 0)}
        for key, entry in entries.items()
    ] + [{**adam_entry, "launches": sum(c["launches"] for c in ADAM_COUNTS.values()),
          "launches_by_phase": {k: c["launches"] for k, c in ADAM_COUNTS.items()}}]}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
