"""Full-schedule parity experiment: the actual reference vs this port.

Port of the JAX package's ``parity.py``. It runs the reference's own entry
script (copied at run time from the reference's sources, never into this
repo) for a full Adam + L-BFGS schedule on synthetic data, then trains this
port's :class:`~pinn_depthestimation_tpu_torch.training.driver.Trainer`
from the reference's exact torch-seeded initial weights, with the same
config and data. ``--pipeline newmethod`` executes ``train_newmethod.py``
(continuity physics, shared point set); ``--pipeline cmb`` executes
``train.py`` (wave_averaged physics, CSV fidelity + strided ``.mat``
residual sets, per-output fidelity weights) with the ``get_min_max`` shim
its checked-in code needs (SURVEY.md §5 quirk 4). The report gives:

* per-iteration loss agreement across the whole run;
* the L-BFGS phase's tracked prefix and terminal minima;
* the final recovered depth-field agreement (the BASELINE.md acceptance
  criterion: h-field RMSE within 1 %).

:func:`compose_report` holds the comparison: it returns the report text
and a dict of every number in it, which scripts read instead of the text.

Usage::

    python -m pinn_depthestimation_tpu_torch.parity [--iters 50000] [--device cuda|cpu]
        [--ref-cache REF.npz] [--fw-cache FW.npz] [--out PARITY_REPORT_TORCH.md]

(or ``python -m pinn_depthestimation_tpu_torch.cli parity``). The cache
formats are the JAX package's, so either package composes the other's
caches. Divergences from the JAX ``main``:

* with a ``--ref-cache`` that exists, the reference's sources are not
  needed; without one they are taken from the directory the environment
  variable ``PINN_REFERENCE_DIR`` names (the JAX package reads a fixed
  mount point), and without either the harness returns 2;
* ``--out`` defaults to ``PARITY_REPORT_TORCH.md``, so a run never
  overwrites the JAX package's ``PARITY_REPORT.md``;
* ``--device`` (default ``cuda``) places the framework phase; a report
  names the device it trained on.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REFERENCE = os.environ.get("PINN_REFERENCE_DIR", "")

# --ref-cache experiment descriptor: every flag that changes the data or the
# reference trajectory. Stored in the cache and validated at compose time so
# a framework run can never be compared against a cached reference phase from
# a different experiment (the mat file is REGENERATED from the CLI flags, so
# a silent mismatch would produce a garbage comparison, not an error).
_CACHE_META_FIELDS = (
    "iters", "lbfgs", "tol_grad", "tol_change",
    "hidden_layers", "width", "nx", "ny", "nan_fraction", "fields", "pipeline",
    "training_points",
)

# --fields / --pipeline choices, encoded as their index in cache metadata.
# Order is append-only (an existing cache's encoding must never change
# meaning), as is _CACHE_META_FIELDS itself (older caches stored a prefix).
_FIELD_CHOICES = ("plane", "structured")
_PIPELINE_CHOICES = ("newmethod", "cmb")
_META_ENCODERS = {
    "fields": _FIELD_CHOICES.index,
    "pipeline": _PIPELINE_CHOICES.index,
}


def _cache_meta(args) -> np.ndarray:
    vals = []
    for f in _CACHE_META_FIELDS:
        v = getattr(args, f)
        vals.append(float(_META_ENCODERS.get(f, float)(v)))
    return np.asarray(vals)


def _check_cache_meta(path: str, z, args, flag: str = "--ref-cache") -> None:
    if "meta" not in z.files:  # cache written by an older parity.py
        print(f"      WARNING: {path} carries no experiment metadata; "
              "cannot verify it matches the requested flags", flush=True)
        return
    want, got = _cache_meta(args), np.asarray(z["meta"])
    if got.ndim == 1 and got.shape[0] < len(_CACHE_META_FIELDS):
        # cache from before later flags existed: those default to encoding 0
        # (plane fields, newmethod pipeline)
        got = np.concatenate([got, np.zeros(len(_CACHE_META_FIELDS) - got.shape[0])])
    if got.shape != want.shape or not np.allclose(got, want):
        detail = ", ".join(
            f"{f}: cached {g:g} != requested {w:g}"
            for f, g, w in zip(_CACHE_META_FIELDS, got, want)
            if not np.isclose(g, w)
        )
        phase = "reference" if flag == "--ref-cache" else "framework"
        raise SystemExit(
            f"{flag} {path} was produced by a different experiment "
            f"({detail}); rerun the {phase} phase or fix the flags"
        )


def _params_fingerprint(params) -> str:
    """Order-stable digest of a parameter dict (raw bytes of every array,
    keys sorted). Binds a ``--fw-cache`` to the exact initial weights its
    framework run trained from, so it can never be recomposed against a
    DIFFERENT reference cache (e.g. one of the ``.soak/ref_cmb_seed*.npz``
    seed-spread runs) into a plausible-looking but meaningless report.
    Hash the arrays as the cache stores them (float32 numpy): the digest
    then equals the one the JAX package stores."""
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(k.encode())
        h.update(np.ascontiguousarray(np.asarray(params[k])).tobytes())
    return h.hexdigest()


def make_config(mat_path: str, adam_iters: int, lbfgs_iters: int,
                tol_grad: float = 1e-5, tol_change: float = 1e-7,
                hidden_layers: int = 3, hidden_width: int = 16,
                weight_res: float = 1.0) -> dict:
    """The reference's config_CMB_h.json recipe as a raw config dict.
    ``weight_res`` scales the continuity term exactly as the reference's
    ``weight_res_loss`` config key (train_newmethod.py loss assembly)."""
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


# CMB pipeline: the reference's train.py as checked in crashes on its stale
# 2-arg get_min_max call (train.py:228 vs operations.py:16 — SURVEY.md §5
# quirk 4). The harness appends this dispatching wrapper to the COPIED
# operations.py (never to the reference's own sources): the dict-wide
# behavior train.py expects, layered over the checked-in 3-arg per-key
# definition. It is the same dual-signature intent ops.get_min_max ships.
_GET_MIN_MAX_SHIM = '''

# --- parity-harness shim (sandbox copy only): serve the stale 2-arg
# dict-wide call train.py:228 makes alongside the 3-arg definition above.
_get_min_max_3arg = get_min_max
def get_min_max(data, key_or_config, config=None):
    if config is None:
        out = {}
        for k in data:
            out.update(_get_min_max_3arg(data, k, key_or_config))
        return out
    return _get_min_max_3arg(data, key_or_config, config)
'''

# Non-uniform per-output fidelity weights so a run exercises the
# reference's weighted fidelity sum (train.py:136-141): a weight-handling
# bug would shift the fidelity loss from iteration 1.
_CMB_OUTPUTS = ("h", "U", "V", "eta_mean", "Hrms", "k")
_CMB_WEIGHTS = (2.0, 1.0, 1.0, 1.0, 0.5, 0.5)


def make_cmb_config(csv_path: str, mat_path: str, adam_iters: int,
                    lbfgs_iters: int, tol_grad: float = 1e-5,
                    tol_change: float = 1e-7, hidden_layers: int = 10,
                    hidden_width: int = 10, nx: int = 81,
                    ny: int = 261, interval: int = 10,
                    training_points: int = 12) -> dict:
    """The reference's own config_CMB.json recipe (2->[10]x10->6 MLP,
    training_points=12, 10x10 residual stride — reference
    ``config_CMB.json:2-56``) with synthetic stand-ins for its private
    ``../data/G1a`` products and non-uniform per-output weights, as a raw
    config dict."""
    return {
        "layers": {"input_features": 2, "hidden_layers": hidden_layers,
                   "hidden_width": hidden_width, "output_features": 6,
                   "dropout_rate": 0.0, "init_type": "xavier"},
        "adam_optimizer": {"max_it": adam_iters, "learning_rate": 1e-4,
                           "scheduler_step_size": 10000, "scheduler_gamma": 0.8},
        "lbfgs_optimizer": {"max_it": lbfgs_iters, "learning_rate": 1,
                            "max_evaluation": round(lbfgs_iters * 1.25),
                            "history_size": 100, "tolerance_grad": tol_grad,
                            "tolerance_change": tol_change,
                            "line_search_fn": "strong_wolfe"},
        "loss": {**{f"weight_{k}_loss": w for k, w in
                    zip(_CMB_OUTPUTS, _CMB_WEIGHTS)},
                 "weight_fid_loss": 1, "weight_res_loss": 1},
        "data_fidelity": {"file": csv_path, "inputs": ["x", "y"],
                          "outputs": list(_CMB_OUTPUTS),
                          "training_points": training_points},
        "data_residual": {"file": mat_path,
                          "inputs": {"x": {"requires_grad": ["true"]},
                                     "y": {"requires_grad": ["true"]}},
                          "outputs": list(_CMB_OUTPUTS), "snapshots": [1],
                          "interval_x": interval, "interval_y": interval},
        "data_test": {"model": "unused", "file": mat_path,
                      "inputs": {"x": {"requires_grad": ["true"]},
                                 "y": {"requires_grad": ["true"]}},
                      "outputs": list(_CMB_OUTPUTS), "nx": nx, "ny": ny,
                      "dx": 0.1, "dy": 0.1, "x_min": 25.0, "x_max": 33.0,
                      "y_min": -13.0, "y_max": 13.0, "dt": 1.0},
        "plot": {"font_size": 14, "x_limits": [25, 33], "y_limits": [-13, 13],
                 "c_limits": [-1, 1], "eta_limits": [-1, 1], "dir": "plots"},
    }


def _read_ref_log(log_root: str) -> tuple[list, list, list]:
    run_name = sorted(os.listdir(log_root))[-1]
    fids, ress, totals = [], [], []
    with open(os.path.join(log_root, run_name, "log.txt")) as f:
        next(f)
        for line in f:
            parts = line.split(", ")
            fids.append(float(parts[1]))
            ress.append(float(parts[2]))
            totals.append(float(parts[3]))
    return fids, ress, totals


def run_reference_cmb(
    workdir: str, cfg: dict, residual_input: np.ndarray, seed: int | None = None
) -> tuple[list, list, list, np.ndarray, float]:
    """Execute the genuine reference train.py (CMB pipeline) with the
    get_min_max shim; return (fids, ress, totals, h_field, wall) where
    ``h_field`` is the final model's h prediction on ``residual_input``
    (the normalized collocation rows the port's loader produced — the
    byte-identical pipeline, proven by first-evaluation loss equality).

    ``seed`` (when given) rewrites the SANDBOX copy's hardcoded 1234 seed
    literals (reference train.py:22,26,30 — np.random / torch / cuda) so
    reference-vs-reference intrinsic spread can be measured at the same
    recipe. The reference's own sources are never touched."""
    for name in ("train.py", "dnn.py", "physics.py", "operations.py", "plots.py"):
        shutil.copy(os.path.join(REFERENCE, name), os.path.join(workdir, name))
    if seed is not None:
        train_path = os.path.join(workdir, "train.py")
        with open(train_path) as f:
            src = f.read()
        # one substring replace covers np.random.seed(1234) AND
        # torch.manual_seed(1234) (train.py:22,30); cuda.manual_seed_all
        # (train.py:26) is a different substring, patched separately
        if src.count("seed(1234)") != 2 or src.count("seed_all(1234)") != 1:
            raise RuntimeError(
                f"seed patch expected the reference's literals at "
                f"train.py:22,26,30; found {src.count('seed(1234)')} "
                f"seed(1234) + {src.count('seed_all(1234)')} seed_all(1234)"
            )
        patched = src.replace("seed(1234)", f"seed({seed})").replace(
            "seed_all(1234)", f"seed_all({seed})"
        )
        with open(train_path, "w") as f:
            f.write(patched)
    with open(os.path.join(workdir, "operations.py"), "a") as f:
        f.write(_GET_MIN_MAX_SHIM)
    with open(os.path.join(workdir, "config_CMB.json"), "w") as f:
        json.dump(cfg, f)

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "train.py"], cwd=workdir, env=env,
        capture_output=True, text=True, timeout=24 * 3600,
    )
    wall = time.time() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"reference failed:\n{proc.stdout}\n{proc.stderr}")

    log_root = os.path.join(os.path.dirname(workdir), "log")
    fids, ress, totals = _read_ref_log(log_root)

    import torch

    sys.path.insert(0, workdir)
    try:
        run_name = sorted(os.listdir(log_root))[-1]
        model = torch.load(
            os.path.join(log_root, run_name, "model.pth"), weights_only=False
        )
        model.eval()
        with torch.no_grad():
            pred = model(torch.tensor(residual_input, dtype=torch.float32)).numpy()
        h_field = pred[:, 0]  # output order h,U,V,... (config_CMB.json:42)
    finally:
        sys.path.pop(0)
    return fids, ress, totals, h_field, wall


def run_reference(workdir: str, mat: str, cfg: dict) -> tuple[list, np.ndarray, float]:
    """Execute the genuine reference script; return (totals, h_field, wall)."""
    for name in ("train_newmethod.py", "dnn.py", "physics.py", "operations.py"):
        shutil.copy(os.path.join(REFERENCE, name), os.path.join(workdir, name))
    with open(os.path.join(workdir, "config_CMB_h.json"), "w") as f:
        json.dump(cfg, f)

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "train_newmethod.py"], cwd=workdir, env=env,
        capture_output=True, text=True, timeout=24 * 3600,
    )
    wall = time.time() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"reference failed:\n{proc.stdout}\n{proc.stderr}")

    log_root = os.path.join(os.path.dirname(workdir), "log")
    run_name = sorted(os.listdir(log_root))[-1]
    totals = []
    with open(os.path.join(log_root, run_name, "log.txt")) as f:
        next(f)
        for line in f:
            totals.append(float(line.split(", ")[3]))

    # final depth field via the reference's own pickled module
    import torch
    from scipy.io import loadmat

    sys.path.insert(0, workdir)
    try:
        model = torch.load(
            os.path.join(log_root, run_name, "model.pth"), weights_only=False
        )
        model.eval()
        d = loadmat(mat)
        x, y, u = d["x"], d["y"], d["U"]
        mask = np.isfinite(u).ravel()
        xn = 2 * (x - 25.0) / 8.0 - 1
        yn = 2 * (y + 13.0) / 26.0 - 1
        inp = torch.tensor(np.hstack([xn, yn])[mask], dtype=torch.float32)
        with torch.no_grad():
            pred = model(inp).numpy()
        h_field = pred[:, 2]
    finally:
        sys.path.pop(0)
    return totals, h_field, wall


def reference_initial_params(workdir: str, hidden_layers: int = 3,
                             hidden_width: int = 16, n_out: int = 3) -> dict:
    """The reference's torch-seeded initial weights (its ``dnn.DNN`` under
    ``torch.manual_seed(1234)``) in the parameter exchange layout, as
    numpy arrays: the cache stores them as they are."""
    import importlib

    import torch

    sys.path.insert(0, workdir)
    try:
        dnn_mod = importlib.import_module("dnn")
        importlib.reload(dnn_mod)
        torch.manual_seed(1234)
        model = dnn_mod.DNN(
            [2] + [hidden_width] * hidden_layers + [n_out], 0.0, "xavier"
        )
    finally:
        sys.path.pop(0)
    linears = [m for m in model.layers if isinstance(m, torch.nn.Linear)]
    return {
        "w_in": linears[0].weight.detach().numpy().T.copy(),
        "b_in": linears[0].bias.detach().numpy().copy(),
        "w_hidden": np.stack([l.weight.detach().numpy().T for l in linears[1:-1]]),
        "b_hidden": np.stack([l.bias.detach().numpy() for l in linears[1:-1]]),
        "w_out": linears[-1].weight.detach().numpy().T.copy(),
        "b_out": linears[-1].bias.detach().numpy().copy(),
    }


def device_description(device) -> str:
    """The device a framework phase trained on, for the report: a card's
    name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them, or ``CPU``."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return "CPU"
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(index)} (power limit not read)"


def _shape(args) -> str:
    n_out = 6 if args.pipeline == "cmb" else 3
    return (f"2->[{args.width}]x{args.hidden_layers}->{n_out}, "
            f"{args.nx}x{args.ny} grid, nan {args.nan_fraction:.0%}, "
            f"{args.fields} fields, {args.pipeline} pipeline")


def compose_report(ref: dict, fw: dict, args, mat: str, *, physics: str,
                   device: str) -> tuple[str, dict]:
    """The comparison and the report (JAX ``parity.py:609-815``).

    ``ref``: the reference phase, ``totals``, ``h``, ``wall`` and, for the
    CMB pipeline, ``fids`` and ``ress``. ``fw``: the framework phase,
    ``totals``, ``fids``, ``ress``, ``h``, ``wall``. ``args``: the flags;
    ``mat``: the regenerated ``.mat`` (the truth depth scale);
    ``physics``: the config's equation; ``device``: the line naming the
    framework's device (:func:`device_description`).

    Returns ``(text, numbers)``, ``numbers`` holding every number of the
    text unrounded and the verdict (``"PASS"`` or ``"CHECK"``)."""
    from scipy.io import loadmat

    is_cmb = args.pipeline == "cmb"
    ref_totals, our_totals = list(ref["totals"]), list(fw["totals"])
    ref_h, our_h = np.asarray(ref["h"]), np.asarray(fw["h"])
    ref_wall, our_wall = float(ref["wall"]), float(fw["wall"])
    num: dict = {
        "ref_evals": len(ref_totals), "fw_evals": len(our_totals),
        "ref_wall": ref_wall, "fw_wall": our_wall,
        "ref_evals_per_s": len(ref_totals) / max(ref_wall, 1e-9),
        "fw_evals_per_s": len(our_totals) / max(our_wall, 1e-9),
        "wall_ratio": ref_wall / max(our_wall, 1e-9),
    }

    n = min(len(ref_totals), len(our_totals), args.iters)
    rt, ot = np.asarray(ref_totals[:n]), np.asarray(our_totals[:n])
    rel = np.abs(ot - rt) / np.maximum(np.abs(rt), 1e-12)
    if n == 0:  # --iters 0: pure L-BFGS experiment, no Adam section
        rel = np.asarray([0.0])
    num.update(n_compared=n, iter1_rel=float(rel[0]), adam_median_rel=float(np.median(rel)),
               adam_max_rel=float(np.max(rel)))

    # Per-component tracking (CMB: the weighted fidelity sum of
    # reference train.py:136-141 and the wave_averaged residual separately —
    # a weight-handling bug on either side shifts the fidelity column from
    # iteration 1 even when totals happen to agree).
    component_section = ""
    ref_fids, ref_ress = ref.get("fids"), ref.get("ress")
    if ref_fids is not None and n > 0:
        our_fids, our_ress = fw["fids"], fw["ress"]
        rf = np.abs(np.asarray(our_fids[:n]) - np.asarray(ref_fids[:n])) / \
            np.maximum(np.abs(np.asarray(ref_fids[:n])), 1e-12)
        rr = np.abs(np.asarray(our_ress[:n]) - np.asarray(ref_ress[:n])) / \
            np.maximum(np.abs(np.asarray(ref_ress[:n])), 1e-12)
        num.update(fid_first_rel=float(rf[0]), fid_median_rel=float(np.median(rf)),
                   res_first_rel=float(rr[0]), res_median_rel=float(np.median(rr)))
        component_section = f"""
## Per-component tracking (weighted fidelity / physics residual)

* fidelity loss (per-output weights {dict(zip(_CMB_OUTPUTS, _CMB_WEIGHTS))}):
  first {rf[0]:.2e}, median {np.median(rf):.2e} relative
* physics residual loss ({physics}): first {rr[0]:.2e},
  median {np.median(rr):.2e} relative

Mid-schedule medians do NOT measure implementation fidelity on this
pipeline: the wave_averaged ``1/(rho*(eta+h))`` pole makes the training
dynamics chaotic at the f32 noise floor — a single 1e-12-scale kick decays,
but a 1e-7 kick applied to a PURE-f64 run forks its trajectory exactly like
f32-vs-f64 forks (median ~0.4 relative; measured, ``.soak/cmb_f32_conv.py``),
so cross-backend f32 ULP differences fork any two implementations the same
way. Implementation fidelity is measured by the iteration-1 equality above,
the CPU golden test (``tests/test_golden_cmb.py``: 40 Adam iterations within
5e-3 of the executed reference), and the terminal basin/field criteria.
"""

    # L-BFGS-phase per-eval tracking (rows after the Adam schedule): how many
    # consecutive evaluations agree to 5e-3 before f32 roundoff forks the
    # line search, and do both runs land in the same basin?
    lb_ref = np.asarray(ref_totals[args.iters:])
    lb_our = np.asarray(our_totals[args.iters:])
    m = min(len(lb_ref), len(lb_our))
    tracked, gap = 0, float("inf")
    num.update(lbfgs_evals_ref=len(lb_ref), lbfgs_evals_fw=len(lb_our),
               lbfgs_budget=round(args.lbfgs * 1.25), lbfgs_compared=m)
    lbfgs_section = "\n## L-BFGS phase (per-evaluation tracking)\n\n(no L-BFGS rows)\n"
    if m:
        lrel = np.abs(lb_our[:m] - lb_ref[:m]) / np.maximum(np.abs(lb_ref[:m]), 1e-12)
        while tracked < m and lrel[tracked] <= 5e-3:
            tracked += 1
        gap = float(abs(
            np.log10(max(lb_our.min(), 1e-300)) - np.log10(max(lb_ref.min(), 1e-300))
        ))
        num.update(tracked=tracked, lbfgs_median_rel=float(np.median(lrel)),
                   ref_min=float(lb_ref.min()), fw_min=float(lb_our.min()), log10_gap=gap)
        # Which acceptance criteria apply depends on the physics: on the
        # chaotic wave_averaged pipeline the Adam phase has already forked
        # the warm points before L-BFGS starts, so a tracked-prefix
        # criterion is structurally inapplicable to a full-schedule report.
        if is_cmb:
            criteria_note = """The warm points are already forked by the chaotic Adam phase (see the
per-component section above), so a tracked-prefix criterion does not apply
to this full-schedule report; the applicable criteria here are the
iteration-1 equality and the same-basin terminal minima. Per-evaluation
L-BFGS tracking for this physics is validated from a SHARED warm point in
PARITY_CMB_LBFGS.md (and asserted in CI by tests/test_golden_cmb.py:
first-L-BFGS-eval equality + same-basin terminal)."""
        else:
            criteria_note = """The trajectories are expected to fork eventually: strong-Wolfe bracketing
makes discrete decisions on f32-roundoff-scale differences, after which the
two optimizers explore different (equally valid) paths. The acceptance
criteria are the tracked prefix and same-basin terminal minima, mirrored by
the CI assertion in tests/test_parity.py (prefix >= 20, gap < 0.1)."""
        polish_note = (
            f"\n* framework rows include its f64 polish phase "
            f"(--f64-polish {args.f64_polish}; a capability the torch "
            f"reference lacks — its terminal minimum reflects f64 descent "
            f"below the shared f32 noise floor)"
            if args.f64_polish
            else ""
        )
        lbfgs_section = f"""
## L-BFGS phase (per-evaluation tracking)

* evaluations executed: reference {len(lb_ref)}, framework {len(lb_our)}
  (budget: {round(args.lbfgs * 1.25)}){polish_note}
* tracked prefix (consecutive evals within 5e-3 relative): **{tracked}** of {m}
* median relative diff over the phase: {np.median(lrel):.2e}
* terminal minima: reference {lb_ref.min():.6e}, framework {lb_our.min():.6e}
  (log10 gap {gap:.3f})

{criteria_note}
"""
    h_rmse = float(np.sqrt(np.mean((our_h - ref_h) ** 2)))
    h_scale = float(np.max(ref_h) - np.min(ref_h) + 1e-12)
    # Two denominators, both reported: (a) the reference's PREDICTED-field
    # range, the strict reading of BASELINE's "within 1% of reference"; and
    # (b) the synthetic TRUTH depth range, the physically meaningful scale.
    # Either within 1% passes; the report shows which governed.
    d = loadmat(mat)
    if is_cmb:
        # collocation rows = strided grid minus NaN-x rows (train.py:257-277);
        # make_cmb_config's stride
        ix = iy = 10
        mask = np.isfinite(d["x"][::ix, ::iy]).ravel()
        h_truth_scale = float(np.ptp(d["h"][::ix, ::iy].ravel()[mask]) + 1e-12)
    else:
        mask = np.isfinite(d["U"]).ravel()
        h_truth_scale = float(np.ptp(d["h"].ravel()[mask]) + 1e-12)
    h_note = (
        "  (BASELINE criterion: within 1% on either scale)"
        if args.iters > 0
        else "  (informational for the L-BFGS-only experiment; basin criteria govern)"
    )
    ref_pred_range = float(np.ptp(ref_h))
    our_pred_range = float(np.ptp(our_h))
    structure_frac = ref_pred_range / h_truth_scale
    num.update(h_rmse=h_rmse, h_pred_scale=h_scale, h_truth_scale=h_truth_scale,
               rmse_pred_frac=h_rmse / h_scale, rmse_truth_frac=h_rmse / h_truth_scale,
               ref_pred_range=ref_pred_range, fw_pred_range=our_pred_range,
               ref_structure_frac=structure_frac,
               fw_structure_frac=our_pred_range / h_truth_scale)
    structure_section = f"""
## Field structure (is the criterion discriminating?)

* truth h range over observed points: {h_truth_scale:.4f} m
* reference predicted h range: {ref_pred_range:.4f} m ({structure_frac:.1%} of truth)
* framework predicted h range: {our_pred_range:.4f} m ({our_pred_range / h_truth_scale:.1%} of truth)
"""
    if args.fields == "structured":
        structure_section += (
            "* structured-problem criterion (predicted range >= 10% of truth "
            f"scale): {'PASS' if structure_frac >= 0.10 else 'FAIL'}\n"
        )
    else:
        structure_section += (
            "* (plane problem: near-flat predictions are the known optimum — "
            "PARITY_LBFGS_WARM.md; use --fields structured for the "
            "discriminating criterion)\n"
        )
    checkpoints = sorted({i for i in (0, 9, 99, 999, 9_999, n - 1) if 0 <= i < n})
    num["rows"] = [(i + 1, float(rt[i]), float(ot[i]), float(rel[i])) for i in checkpoints]
    rows = "\n".join(f"| {i + 1} | {rt[i]:.6e} | {ot[i]:.6e} | {rel[i]:.2e} |"
                     for i in checkpoints)
    n_points = int(ref_h.shape[0])
    num["n_points"] = n_points
    if n_points < 2000:
        wall_note = f"""  (framework device: {device};
  this experiment's toy problem is dispatch-bound and its wall-clock varies
  run to run — the report's purpose is the NUMERICS; performance figures
  live in PERF.md and are measured at real problem sizes)"""
    else:
        wall_note = f"""  (framework device: {device};
  the framework wall-clock includes loading or building the kernels and
  writing the log and checkpoints)"""
    report = f"""# PARITY REPORT — actual reference vs pinn_depthestimation_tpu_torch

Full-schedule run on identical synthetic data with the reference's exact
torch-seeded initial weights. Reference executed from its own sources
(a sandbox copy); framework = the port's `Trainer` as shipped.

* problem shape: {_shape(args)} -> {n_points} observed points
* schedule: {args.iters} Adam + up to {args.lbfgs} L-BFGS evaluations
* reference wall-clock (torch CPU): {ref_wall:.0f} s
  ({num['ref_evals_per_s']:.1f} evals/s)
* framework wall-clock: {our_wall:.0f} s ({num['wall_ratio']:.1f}x;
  {num['fw_evals_per_s']:.1f} evals/s)
{wall_note}

## Per-iteration total loss

| iteration | reference | framework | rel. diff |
|---|---|---|---|
{rows}

* median relative loss difference over {n} iterations: {np.median(rel):.2e}
* max relative loss difference: {np.max(rel):.2e}
{component_section}{lbfgs_section}
## Recovered depth field (h) at end of training

* RMSE(framework, reference): {h_rmse:.3e} m
* reference h-field range: {h_scale:.3e} m (predicted; truth depth range
  {h_truth_scale:.3e} m — a near-flat prediction means the range-relative
  number amplifies micrometre disagreement, see PARITY_LBFGS_WARM.md)
* relative field RMSE: {h_rmse / h_scale:.2%} of predicted range,
  {h_rmse / h_truth_scale:.2%} of truth depth scale{h_note}
{structure_section}"""
    if args.iters > 0:
        ok = min(h_rmse / h_scale, h_rmse / h_truth_scale) <= 0.01
        if args.fields == "structured":
            # discriminating form: the field must be non-degenerate AND agree
            ok = ok and structure_frac >= 0.10
    else:
        ok = bool(m) and tracked >= 20 and gap < 0.1
    num["verdict"] = "PASS" if ok else "CHECK"
    return report, num


def build_parser(add_help: bool = True) -> argparse.ArgumentParser:
    """The harness's flags: the JAX package's and ``--device``. The CLI's
    ``parity`` verb takes them as they are (``add_help=False``)."""
    ap = argparse.ArgumentParser(prog="python -m pinn_depthestimation_tpu_torch.parity",
                                 add_help=add_help)
    ap.add_argument("--iters", type=int, default=50_000)
    ap.add_argument("--lbfgs", type=int, default=500)
    ap.add_argument("--tol-grad", type=float, default=1e-5,
                    help="L-BFGS tolerance_grad (reference config value 1e-5; "
                         "tighten for a deep cold-start L-BFGS horizon)")
    ap.add_argument("--tol-change", type=float, default=1e-7)
    ap.add_argument("--hidden-layers", type=int, default=3,
                    help="hidden layer count (flagship: 100, reference "
                         "config_CMB_h.json:4)")
    ap.add_argument("--width", type=int, default=16,
                    help="hidden width (flagship: 20)")
    ap.add_argument("--nx", type=int, default=16,
                    help="grid columns (flagship: 81, config_CMB_h.json:51)")
    ap.add_argument("--ny", type=int, default=14,
                    help="grid rows (flagship: 261)")
    ap.add_argument("--nan-fraction", type=float, default=0.05,
                    help="fraction of NaN observation rows; the real flagship "
                         "dataset keeps 12,514 of 21,141 grid points, i.e. "
                         "nan-fraction 0.408")
    ap.add_argument("--fields", choices=_FIELD_CHOICES, default="plane",
                    help="synthetic field family: 'plane' (admits a near-flat "
                         "h optimum) or 'structured' (continuity-constrained "
                         "bathymetry: the recovered h must carry O(truth-scale) "
                         "structure, making the field-RMSE criterion "
                         "discriminating)")
    ap.add_argument("--training-points", type=int, default=0,
                    help="CMB fidelity subsample size; 0 = the reference "
                         "recipe's 12 (config_CMB.json:44)")
    ap.add_argument("--pipeline", choices=_PIPELINE_CHOICES, default="newmethod",
                    help="which reference pipeline to execute and track: "
                         "'newmethod' (train_newmethod.py + continuity_only) "
                         "or 'cmb' (train.py + wave_averaged physics, CSV "
                         "fidelity + .mat residual sets, per-output weights; "
                         "the reference's own recipe is --hidden-layers 10 "
                         "--width 10)")
    ap.add_argument("--f64-polish", type=int, default=0, metavar="MAX_IT",
                    help="append the framework's float64 polish phase (config "
                         "f64_polish with this max_it) after its f32 L-BFGS "
                         "phase; the reference phase is unchanged")
    ap.add_argument("--out", default="PARITY_REPORT_TORCH.md")
    ap.add_argument("--fw-cache", default=None,
                    help="cache the FRAMEWORK phase (loss log + h-field) to "
                         "this .npz; when present and matching the requested "
                         "experiment, the framework phase loads from it "
                         "instead of re-running, so a report recomposes "
                         "without training (the JAX package's format)")
    ap.add_argument("--ref-cache", default=None,
                    help="npz path caching the reference phase (totals, "
                         "h-field, wall, initial params); with an existing "
                         "cache the reference's sources are not needed")
    ap.add_argument("--ref-only", action="store_true",
                    help="stop after the reference phase (requires --ref-cache)")
    ap.add_argument("--device", default="cuda",
                    help="where the framework phase trains: cuda (default) or cpu")
    return ap


def run(argv=None) -> tuple[int, dict | None]:
    """:func:`main`, returning ``(exit code, numbers)``: the numbers dict of
    :func:`compose_report`, or None where no report was composed."""
    return run_args(build_parser().parse_args(argv))


def run_args(args) -> tuple[int, dict | None]:
    """:func:`run` for flags already parsed (:func:`build_parser`'s)."""
    if args.ref_only and not args.ref_cache:
        # Without a cache path the (potentially multi-hour) reference run
        # would complete and then be discarded with the mkdtemp sandbox.
        build_parser().error("--ref-only requires --ref-cache (the reference phase "
                             "would run for hours and then be thrown away)")
    have_ref_cache = bool(args.ref_cache) and os.path.exists(args.ref_cache)
    if not have_ref_cache and not (REFERENCE and os.path.isdir(REFERENCE)):
        print(f"reference sources not available (PINN_REFERENCE_DIR={REFERENCE!r}) "
              "and no --ref-cache to compose from")
        return 2, None

    from pinn_depthestimation_tpu_torch.config import parse_config
    from pinn_depthestimation_tpu_torch.utils import synthetic

    is_cmb = args.pipeline == "cmb"
    n_out = 6 if is_cmb else 3
    h_col = 0 if is_cmb else 2  # h,U,V,... vs trues-then-unknowns [U,V,h]
    with tempfile.TemporaryDirectory() as tmp:
        workdir = os.path.join(tmp, "ref")
        os.makedirs(workdir)
        mat = os.path.join(tmp, "input_res.mat" if is_cmb else "data.mat")
        if is_cmb:
            csv = os.path.join(tmp, "input_fid.csv")
            synthetic.make_cmb_dataset(
                csv, mat, nx=args.nx, ny=args.ny, nan_fraction=args.nan_fraction,
                seed=21, fields=args.fields,
                # the subsample (reference train.py:237-240) needs a strictly
                # larger CSV population; keep the historical 400 when it suffices
                n_csv=max(400, 2 * (args.training_points or 12)),
            )
            cfg_raw = make_cmb_config(
                csv, mat, args.iters, args.lbfgs,
                tol_grad=args.tol_grad, tol_change=args.tol_change,
                hidden_layers=args.hidden_layers, hidden_width=args.width,
                nx=args.nx, ny=args.ny,
                training_points=args.training_points or 12,
            )
        else:
            synthetic.make_newmethod_mat(
                mat, nx=args.nx, ny=args.ny, nan_fraction=args.nan_fraction,
                seed=21, fields=args.fields,
            )
            cfg_raw = make_config(mat, args.iters, args.lbfgs,
                                  tol_grad=args.tol_grad, tol_change=args.tol_change,
                                  hidden_layers=args.hidden_layers,
                                  hidden_width=args.width)

        ref: dict = {}
        if have_ref_cache:
            print(f"[1/3] reference phase loaded from cache {args.ref_cache}", flush=True)
            with np.load(args.ref_cache) as z:
                _check_cache_meta(args.ref_cache, z, args)
                ref = {"totals": z["totals"].tolist(), "h": z["h"], "wall": float(z["wall"])}
                if "fids" in z.files:
                    ref.update(fids=z["fids"].tolist(), ress=z["ress"].tolist())
                # as stored (float32 numpy): the fingerprint hashes these bytes
                params = {k[2:]: z[k] for k in z.files if k.startswith("p_")}
        else:
            print(f"[1/3] reference run ({args.iters} Adam + {args.lbfgs} L-BFGS, "
                  f"{_shape(args)})...", flush=True)
            if is_cmb:
                from pinn_depthestimation_tpu_torch.data import load_cmb_training_data

                res_rows = load_cmb_training_data(parse_config(cfg_raw)).residual_input
                fids, ress, totals, h, wall = run_reference_cmb(workdir, cfg_raw, res_rows)
                ref = {"totals": totals, "h": h, "wall": wall, "fids": fids, "ress": ress}
            else:
                totals, h, wall = run_reference(workdir, mat, cfg_raw)
                ref = {"totals": totals, "h": h, "wall": wall}
            print(f"      reference: {len(ref['totals'])} evals in {ref['wall']:.0f}s",
                  flush=True)
            params = reference_initial_params(workdir, args.hidden_layers, args.width,
                                              n_out=n_out)
            if args.ref_cache:
                extra = ({"fids": np.asarray(ref["fids"]), "ress": np.asarray(ref["ress"])}
                         if "fids" in ref else {})
                np.savez(
                    args.ref_cache,
                    totals=np.asarray(ref["totals"]),
                    h=ref["h"],
                    wall=ref["wall"],
                    meta=_cache_meta(args),
                    **extra,
                    **{f"p_{k}": np.asarray(v) for k, v in params.items()},
                )
                print(f"      cached to {args.ref_cache}", flush=True)
        if args.ref_only:
            return 0, None

        if args.f64_polish:
            # the framework side only, after the reference phase: the JSON the
            # reference runs stays its own schema
            cfg_raw["f64_polish"] = {"max_it": args.f64_polish}
        cfg = parse_config(cfg_raw)
        if args.fw_cache and os.path.exists(args.fw_cache):
            print(f"[2/3] framework phase loaded from cache {args.fw_cache}", flush=True)
            fw = _load_fw_cache(args, params)
            device = "not recorded (framework phase loaded from --fw-cache)"
        else:
            print("[2/3] framework run with identical initial weights...", flush=True)
            fw, device = _run_framework(args, cfg, params, os.path.join(tmp, "ours"), h_col,
                                        n_points=len(ref["h"]))

        print("[3/3] comparing...", flush=True)
        report, numbers = compose_report(ref, fw, args, mat, physics=cfg.physics, device=device)
    with open(args.out, "w") as f:
        f.write(report)
    print(report)
    print("PARITY:", numbers["verdict"], flush=True)
    return (0 if numbers["verdict"] == "PASS" else 1), numbers


def _load_fw_cache(args, params) -> dict:
    """The framework phase from ``--fw-cache``, checked against the flags,
    ``--f64-polish`` and the reference phase's initial weights."""
    with np.load(args.fw_cache) as zf:
        _check_cache_meta(args.fw_cache, zf, args, flag="--fw-cache")
        # f64_polish shapes the FRAMEWORK trajectory (but not the reference
        # one), so it is validated here rather than in the shared meta vector
        cached_polish = int(zf["f64_polish"]) if "f64_polish" in zf.files else 0
        if cached_polish != args.f64_polish:
            raise SystemExit(
                f"--fw-cache {args.fw_cache} was produced with --f64-polish "
                f"{cached_polish}, requested {args.f64_polish}; rerun the "
                f"framework phase or fix the flag"
            )
        # bind the cached framework run to the reference initial weights it
        # actually trained from — flags alone cannot catch a ref-cache swap
        if "init_fingerprint" in zf.files:
            want_fp = _params_fingerprint(params)
            got_fp = str(zf["init_fingerprint"])
            if got_fp != want_fp:
                raise SystemExit(
                    f"--fw-cache {args.fw_cache} was trained from different "
                    f"initial weights than the loaded reference phase "
                    f"provides (fingerprint {got_fp[:12]}... != "
                    f"{want_fp[:12]}...); the pair would compose a "
                    f"meaningless report — rerun the framework phase"
                )
        else:
            print(f"      WARNING: {args.fw_cache} carries no initial-weight "
                  "fingerprint; cannot verify it matches the reference phase", flush=True)
        return {"totals": zf["totals"].tolist(), "fids": zf["fids"].tolist(),
                "ress": zf["ress"].tolist(), "h": zf["h"], "wall": float(zf["wall"])}


def _run_framework(args, cfg, params, run_dir: str, h_col: int, *,
                   n_points: int) -> tuple[dict, str]:
    """Train the port's Trainer from ``params`` on ``args.device``; returns
    the framework phase (and writes ``--fw-cache``) and the device line."""
    import torch

    from pinn_depthestimation_tpu_torch.device import resolve_device
    from pinn_depthestimation_tpu_torch.ops import kernels, kernels_step, kernels_vjp
    from pinn_depthestimation_tpu_torch.training.driver import Trainer
    from pinn_depthestimation_tpu_torch.training.logging_utils import read_log

    device = resolve_device(args.device)
    os.makedirs(run_dir)
    wrappers = {"K1": kernels_step.fused_loss_and_grad, "K2": kernels.mlp_fwd_tangents,
                "K3": kernels_vjp.packed_mlp_bwd, "K4": kernels_vjp.packed_mlp_bwd_rebuild}
    before = {name: w.launches for name, w in wrappers.items()}
    t0 = time.time()
    tr = Trainer(cfg, run_dir=run_dir, echo_every=0, initial_params=params, device=device)
    tr.train()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0
    _, fids, ress, totals = read_log(run_dir)
    h = tr.predict(tr.data.residual_input)[:, h_col]
    if h.shape[0] != n_points:
        raise SystemExit(
            f"the framework's h-field has {h.shape[0]} points, the reference's "
            f"{n_points}: the regenerated data do not line up with the cache"
        )
    print(f"      framework: {len(totals)} evals in {wall:.0f}s; kernel launches "
          + ", ".join(f"{name} {w.launches - before[name]}" for name, w in wrappers.items()),
          flush=True)
    fw = {"totals": totals, "fids": fids, "ress": ress, "h": h, "wall": wall}
    if args.fw_cache:
        np.savez(
            args.fw_cache,
            totals=np.asarray(totals),
            fids=np.asarray(fids),
            ress=np.asarray(ress),
            h=np.asarray(h),
            wall=wall,
            f64_polish=args.f64_polish,
            init_fingerprint=_params_fingerprint(params),
            meta=_cache_meta(args),
        )
        print(f"      cached to {args.fw_cache}", flush=True)
    return fw, device_description(device)


def main(argv=None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main())
