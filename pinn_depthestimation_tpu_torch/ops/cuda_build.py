"""Build and bind the port's CUDA kernels.

Each kernel source under ``csrc/`` is compiled by ``nvcc`` into shared
libraries with a plain C interface and loaded with ``ctypes``. The build
runs at first use, from the sources in the package only, into
``_build/<name>-<hash>/`` beside ``csrc/`` (listed in ``.gitignore``); the
hash covers the source, the headers of ``csrc/``, the flags and the
variants, so a second process reuses the libraries and an edited source
builds anew. Two sets of libraries, each built in one wave at the first use
of any of its kernels, as many ``nvcc`` at once as the machine has cores,
the costliest first, so that none is left running alone at the end:

* the narrow bodies, one variant per hidden width and tier (``-DTIER_ONLY``,
  ``csrc/tier.cuh``): K1, K2, K3 and K4 x 5 widths x 3 tiers, sixty ``nvcc``
  (the bf16 and f32x3 variants of K2 and of the walk run on the tensor
  cores: ``csrc/mlp_fwd_tangents_mma.cuh``, ``csrc/mlp_bwd_mma.cuh``). The
  libraries of one width answer together (:class:`WidthLibrary`): the f32
  entry ``<name>``, the bf16 entry ``<name>_bf16`` and the f32x3 entry
  ``<name>_f32x3``, with the same arguments;
* the wide body (``csrc/mlp_wide.cuh``, the width at run time), one variant
  per tier: K1, K2, K3 and K4 x 3 tiers, twelve ``nvcc``, built only when a
  net the narrow bodies do not take first asks for them (``ops/widths.py``),
  so a narrow run never pays for them. Their single :class:`WidthLibrary`
  sits under the key 0. :func:`build_all` builds both sets in one wave.

Adam's update (``csrc/adam_step.cu``, :func:`adam_library`) is one more
``nvcc`` of the narrow wave: it has no width or tier, and a Trainer on the
card needs it beside whichever narrow kernel it runs.

``build.log`` records each variant's compiler output, when it ended and the
CPU time it took.

Nothing here runs at import: this module is imported on machines without
``nvcc`` or a GPU, where only the kernels' plain versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, into build.log
)

K2_SOURCE = "mlp_fwd_tangents.cu"
K1_SOURCE = "continuity_train_step.cu"
K3_SOURCE = "mlp_bwd.cu"  # with K1 and K4, the walk of mlp_bwd_common.cuh
K4_SOURCE = "mlp_bwd_rebuild.cu"
K2_WIDE_SOURCE = "mlp_fwd_tangents_wide.cu"
K1_WIDE_SOURCE = "continuity_train_step_wide.cu"
K34_WIDE_SOURCE = "mlp_bwd_wide.cu"  # K3 with -DWIDE_REBUILD=0, K4 with 1
ADAM_SOURCE = "adam_step.cu"
# Hidden widths the kernels are compiled for: the repo's configs use 10
# (CMB) and 20 (flagship); the rest cover the narrow test nets and a wider
# option.
K2_WIDTHS = (8, 10, 16, 20, 32)
K1_WIDTHS = K2_WIDTHS
K3_WIDTHS = K2_WIDTHS
K4_WIDTHS = K2_WIDTHS
TIERS = ("f32", "bf16", "f32x3")  # -DTIER_ONLY=0, 1, 2


class WidthLibrary:
    """The libraries of one kernel at one width, one per tier: an entry is
    looked up in each of them."""

    def __init__(self, libs: list[ctypes.CDLL]):
        self._libs = libs

    def __getattr__(self, entry: str):
        for lib in self._libs:
            if hasattr(lib, entry):
                return getattr(lib, entry)
        raise AttributeError(f"no kernel library of this width has {entry!r}")


@dataclass
class KernelLibrary:
    """The loaded variants of one kernel source."""

    name: str
    libs: dict[int, WidthLibrary]  # by width; the wide body's under 0
    build_seconds: float   # wall time of this process's build; 0 if reused
    log_path: Path


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on ``PATH``, or
    the toolkit's default prefix."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for cand in candidates:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels are built from csrc/ at first use"
    )


def _variants(macro: str, widths) -> dict[tuple[int, str], tuple[str, ...]]:
    """One variant per (width, tier)."""
    return {(w, t): (f"-D{macro}={w}", f"-DTIER_ONLY={i}")
            for w in widths for i, t in enumerate(TIERS)}


def _wide_variants(*flags: str) -> dict[tuple[int, str], tuple[str, ...]]:
    """One variant per tier of the wide body, under the width key 0."""
    return {(0, t): (*flags, f"-DTIER_ONLY={i}") for i, t in enumerate(TIERS)}


def _plan(name: str, source: str, variants: dict[tuple, tuple[str, ...]]) -> dict:
    """One ``nvcc`` command per variant that is not built yet, its output
    into a log file of its own; returns what :func:`_run` and
    :func:`_finish` need."""
    src = CSRC_DIR / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    key = hashlib.sha256(
        src.read_bytes() + headers + repr((NVCC_FLAGS, sorted(variants.items()))).encode()
    ).hexdigest()[:16]
    out_dir = BUILD_DIR / f"{name}-{key}"
    tag = lambda v: "_".join(str(x) for x in v)  # noqa: E731
    targets = {v: out_dir / f"lib{name}_{tag(v)}.so" for v in variants}
    job = {"name": name, "targets": targets, "log_path": out_dir / "build.log",
           "todo": {}, "procs": {}, "ended": {}, "cpu": {}}
    if not all(p.exists() for p in targets.values()):
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        for v, extra in variants.items():
            tmp = out_dir / f".{targets[v].name}.{os.getpid()}.tmp"
            log = out_dir / f".{targets[v].name}.{os.getpid()}.log"
            job["todo"][v] = ([nvcc, *NVCC_FLAGS, *extra, "-o", str(tmp), str(src)], tmp, log)
    return job


# Relative compile cost, for the order of the build: the walks (K4 holds the
# forward replay twice) over K2 and K1, f32x3's three FMAs per product over
# the others, and the unrolled W x W products (measured on the card's host,
# PERF.md); Adam's update, a few lines, last.
_KERNEL_COST = {"k4": 1.0, "k3": 0.7, "k2": 0.45, "k1": 0.27, "adam": 0.001}
_TIER_COST = {"f32": 1.0, "bf16": 1.2, "f32x3": 3.0}
_WIDE_COST_WIDTH = 32  # the wide body (no unrolled W x W) ranks as a width-32 build


def _cost(name: str, variant: tuple[int, str]) -> float:
    width = variant[0] or _WIDE_COST_WIDTH
    return _KERNEL_COST[name.rstrip("w")] * _TIER_COST[variant[1]] * width ** 2.5


def _run(jobs: list[dict], t0: float) -> None:
    """Run every planned ``nvcc`` of ``jobs``, at most one per core at once,
    the costliest first; note when each ended and the CPU time it took."""
    queue = sorted(((job, v) for job in jobs for v in job["todo"]),
                   key=lambda jv: _cost(jv[0]["name"], jv[1]), reverse=True)
    slots = os.cpu_count() or 8
    running: list = []
    while queue or running:
        while queue and len(running) < slots:
            job, v = queue.pop(0)
            cmd, tmp, log = job["todo"][v]
            with open(log, "w") as f:
                proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
            job["procs"][v] = (cmd, proc, tmp, log)
            running.append((job, v, proc))
        for job, v, proc in list(running):
            pid, status, usage = os.wait4(proc.pid, os.WNOHANG)
            if pid:
                proc.returncode = os.waitstatus_to_exitcode(status)  # reaped here
                job["ended"][v] = time.perf_counter() - t0
                job["cpu"][v] = usage.ru_utime + usage.ru_stime
                running.remove((job, v, proc))
        time.sleep(0.05)


def _finish(job: dict, bind, seconds: float) -> KernelLibrary:
    """Move the built variants into place, write ``build.log`` and load the
    libraries; ``seconds``: the build's wall time (0 when none ran)."""
    name, targets, log_path = job["name"], job["targets"], job["log_path"]
    if job["procs"]:
        logs, failed = [], []
        for v, (cmd, proc, tmp, log) in job["procs"].items():
            out = log.read_text()
            log.unlink()
            logs.append(f"== {name} variant {v[0]} tier {v[1]} (exit {proc.returncode}, "
                        f"ended at {job['ended'][v]:.1f} s, {job['cpu'][v]:.1f} s of CPU): "
                        f"{' '.join(cmd)}\n{out}")
            if proc.returncode == 0:
                os.replace(tmp, targets[v])  # atomic: a concurrent build is safe
            else:
                failed.append(v)
        log_path.write_text("\n".join(logs))
        if failed:
            raise RuntimeError(
                f"nvcc failed for {name} variants {failed}; full log in {log_path}\n"
                + "\n".join(logs)[-4000:]
            )
    bound = {v: bind(ctypes.CDLL(str(p))) for v, p in targets.items()}
    widths = sorted({w for w, _ in targets})
    libs = {w: WidthLibrary([bound[(w, t)] for t in TIERS if (w, t) in bound])
            for w in widths}
    return KernelLibrary(name=name, libs=libs, build_seconds=seconds, log_path=log_path)


def _bind(lib: ctypes.CDLL, name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """Set ``argtypes`` and an ``int`` ``restype`` on the entries of each
    ``fn`` in ``signatures`` that the library has: ``<name>_<fn>`` (f32, or
    a function of no tier), ``<name>_<fn>_bf16`` and ``<name>_<fn>_f32x3``;
    plus ``<name>_error_string``."""
    for fn, argtypes in signatures.items():
        for entry in (f"{name}_{fn}", f"{name}_{fn}_bf16", f"{name}_{fn}_f32x3"):
            if not hasattr(lib, entry):
                continue
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
    getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
    getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
    return lib


_P, _I = ctypes.c_void_p, ctypes.c_int


def _bind_k2(lib: ctypes.CDLL) -> ctypes.CDLL:
    """K2's entries. Each launch takes the pointers, the shapes and mode
    (n, d_in, d_out, n_stack, K, act, epilogue) and then its plan
    (``ops/k2_plan.py``): the f32 body its grid, threads, lanes and chunk,
    the bf16 and f32x3 launches (the tensor-core body) their grid and
    chunk."""
    _bind(lib, "k2", {"mlp_fwd_tangents": [_P] * 10 + [_I] * 9 + [_P], "width": [],
                      "f32_threads": [_I, _I], "f32_smem": [_I] * 3,
                      "mma_rows": [], "mma_warps": [], "mma_smem": [_I]})
    if hasattr(lib, "k2_mlp_fwd_tangents"):
        lib.k2_mlp_fwd_tangents.argtypes = [_P] * 10 + [_I] * 11 + [_P]
    return lib


def _bind_k1(lib: ctypes.CDLL) -> ctypes.CDLL:
    """K1's entries; the bf16 and f32x3 libraries (the tensor-core walk,
    ``csrc/mlp_bwd_mma.cuh``) also answer their plan's image regions and
    shared-memory bytes (``ops/walk_mma_plan.py``)."""
    return _bind(lib, "k1", {"train_step": [_P] * 14 + [_I] * 8 + [_P],
                             "width": [], "lanes": [], "max_tile": [],
                             "chunk_layers": [_I, _I], "mma_regions": [_I, _I],
                             "mma_smem": [_I, _I]})


def _bind_k3(lib: ctypes.CDLL) -> ctypes.CDLL:
    return _bind(lib, "k3", {"mlp_bwd": [_P] * 12 + [_I] * 8 + [_P],
                             "width": [], "lanes": [], "max_tile": [],
                             "chunk_layers": [_I] * 3, "mma_regions": [_I] * 3,
                             "mma_smem": [_I] * 3})


def _bind_k4(lib: ctypes.CDLL) -> ctypes.CDLL:
    return _bind(lib, "k4", {"mlp_bwd": [_P] * 12 + [_I] * 9 + [_P],
                             "width": [], "lanes": [], "max_tile": [],
                             "ckpt_every": [_I] * 4, "chunk_layers": [_I] * 4,
                             "mma_regions": [_I] * 4, "mma_smem": [_I] * 4})


def _bind_k2w(lib: ctypes.CDLL) -> ctypes.CDLL:
    return _bind(lib, "k2w", {"mlp_fwd_tangents": [_P] * 11 + [_I] * 10 + [_P],
                              "smem": [_I] * 5, "image_bytes": [_I] * 4, "threads": []})


def _bind_k1w(lib: ctypes.CDLL) -> ctypes.CDLL:
    return _bind(lib, "k1w", {"train_step": [_P] * 15 + [_I] * 9 + [_P],
                              "smem": [_I] * 3, "image_bytes": [_I] * 3, "threads": []})


def _bind_k34w(name: str):
    def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
        return _bind(lib, name, {"mlp_bwd": [_P] * 13 + [_I] * 10 + [_P],
                                 "smem": [_I] * 5, "image_bytes": [_I] * 4, "threads": [],
                                 "state_slots": [_I, _I]})
    return bind


def _bind_adam(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Adam's entries: ``adam_step(leaves, grads, steps, lr, beta1, beta2,
    eps, device, stream)``, its capturable form ``adam_step_table(leaves,
    grads, table, counter, beta1, beta2, eps, device, stream)``, the most
    leaves a launch takes and the size of its argument block
    (``optim/adam.py``)."""
    _D = ctypes.c_double
    return _bind(lib, "adam", {"step": [_P] * 3 + [_D] * 4 + [_I, _P],
                               "step_table": [_P] * 4 + [_D] * 3 + [_I, _P],
                               "max_leaves": [], "leaves_bytes": []})


# name -> (source, variants, binder); the narrow bodies, then the wide one
_SPECS = {
    "k2": (K2_SOURCE, lambda: _variants("K2_WIDTH", K2_WIDTHS), _bind_k2),
    "k1": (K1_SOURCE, lambda: _variants("K1_WIDTH", K1_WIDTHS), _bind_k1),
    "k3": (K3_SOURCE, lambda: _variants("K3_WIDTH", K3_WIDTHS), _bind_k3),
    "k4": (K4_SOURCE, lambda: _variants("K4_WIDTH", K4_WIDTHS), _bind_k4),
    "k2w": (K2_WIDE_SOURCE, _wide_variants, _bind_k2w),
    "k1w": (K1_WIDE_SOURCE, _wide_variants, _bind_k1w),
    "k3w": (K34_WIDE_SOURCE, lambda: _wide_variants("-DWIDE_REBUILD=0"), _bind_k34w("k3w")),
    "k4w": (K34_WIDE_SOURCE, lambda: _wide_variants("-DWIDE_REBUILD=1"), _bind_k34w("k4w")),
    "adam": (ADAM_SOURCE, lambda: {(0, "f32"): ()}, _bind_adam),
}
NARROW = ("k2", "k1", "k3", "k4", "adam")
WIDE = ("k2w", "k1w", "k3w", "k4w")
_BUILT: dict[str, KernelLibrary] = {}


def _ensure(names) -> dict[str, KernelLibrary]:
    """The libraries of ``names``, building those not yet loaded in this
    process together: one ``nvcc`` per (kernel, width, tier), one per core
    at once. Set-up spans (:mod:`tracing`): ``library#load`` over the
    whole, its self time the hashing, loading and binding; its child
    ``library#build`` the ``nvcc`` wave, about nothing when every variant
    was built before."""
    missing = [n for n in names if n not in _BUILT]
    if missing:
        # imported here: tracing imports ops.widths, which imports this module
        from pinn_depthestimation_tpu_torch import tracing

        with tracing.setup_span("library#load"):
            jobs = [(_plan(n, _SPECS[n][0], _SPECS[n][1]()), _SPECS[n][2]) for n in missing]
            t0 = time.perf_counter()
            try:
                with tracing.setup_span("library#build"):
                    _run([job for job, _ in jobs], t0)
                seconds = (time.perf_counter() - t0 if any(job["procs"] for job, _ in jobs)
                           else 0.0)
                for job, bind in jobs:
                    _BUILT[job["name"]] = _finish(job, bind, seconds)
            finally:  # a failed build leaves no compiler running behind it
                for job, _ in jobs:
                    for _, proc, _, _ in job["procs"].values():
                        if proc.returncode is None:
                            proc.kill()
                            proc.wait()
    return {n: _BUILT[n] for n in names}


def build_all() -> dict[str, KernelLibrary]:
    """Both sets of libraries, built in one wave (``chip_smoke.py``)."""
    return _ensure(NARROW + WIDE)


def k2_library() -> KernelLibrary:
    """K2 (``csrc/mlp_fwd_tangents.cu``), one library per width in
    :data:`K2_WIDTHS`."""
    return _ensure(NARROW)["k2"]


def k1_library() -> KernelLibrary:
    """K1 (``csrc/continuity_train_step.cu``), one library per width in
    :data:`K1_WIDTHS`."""
    return _ensure(NARROW)["k1"]


def k3_library() -> KernelLibrary:
    """K3 (``csrc/mlp_bwd.cu``), one library per width in
    :data:`K3_WIDTHS`, each holding K = 0..3."""
    return _ensure(NARROW)["k3"]


def k4_library() -> KernelLibrary:
    """K4 (``csrc/mlp_bwd_rebuild.cu``), one library per width in
    :data:`K4_WIDTHS`, each holding K = 0..3."""
    return _ensure(NARROW)["k4"]


def adam_library() -> WidthLibrary:
    """Adam's update (``csrc/adam_step.cu``), built and loaded with the
    narrow bodies."""
    return _ensure(NARROW)["adam"].libs[0]


def wide_library(kernel: str) -> WidthLibrary:
    """The wide body of ``kernel`` (``'k1'``, ``'k2'``, ``'k3'`` or
    ``'k4'``; ``csrc/mlp_wide.cuh``), its three tiers' entries
    ``<kernel>w_*``."""
    return _ensure(WIDE)[kernel + "w"].libs[0]
