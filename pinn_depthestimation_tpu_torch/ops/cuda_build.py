"""Build and bind the port's CUDA kernels.

Each kernel source under ``csrc/`` is compiled by ``nvcc`` into shared
libraries with a plain C interface and loaded with ``ctypes``. The build
runs at first use, from the sources in the package only, into
``_build/<name>-<hash>/`` beside ``csrc/`` (listed in ``.gitignore``); the
hash covers the source, the headers of ``csrc/``, the flags and the
variants, so a second process reuses the libraries and an edited source
builds anew. Each source is compiled in several variants (one per hidden
width), and every ``nvcc`` of every kernel (K1, K2, K3 and K4: twenty) is
started together, at the first use of any kernel. Each library holds both
tiers: the f32 entry ``<name>`` and the bf16 entry ``<name>_bf16``, with
the same arguments.

Nothing here runs at import: this module is imported on machines without
``nvcc`` or a GPU, where only the kernels' plain versions run.
"""

from __future__ import annotations

import ctypes
import functools
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
# Hidden widths the kernels are compiled for: the repo's configs use 10
# (CMB) and 20 (flagship); the rest cover the narrow test nets and a wider
# option.
K2_WIDTHS = (8, 10, 16, 20, 32)
K1_WIDTHS = K2_WIDTHS
K3_WIDTHS = K2_WIDTHS
K4_WIDTHS = K2_WIDTHS


@dataclass
class KernelLibrary:
    """The loaded variants of one kernel source."""

    name: str
    libs: dict[int, ctypes.CDLL]
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


def _start(name: str, source: str, variants: dict[int, tuple[str, ...]]) -> dict:
    """Start one ``nvcc`` per variant that is not built yet; returns what
    :func:`_finish` needs."""
    src = CSRC_DIR / source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    key = hashlib.sha256(
        src.read_bytes() + headers + repr((NVCC_FLAGS, sorted(variants.items()))).encode()
    ).hexdigest()[:16]
    out_dir = BUILD_DIR / f"{name}-{key}"
    targets = {v: out_dir / f"lib{name}_{v}.so" for v in variants}
    job = {"name": name, "targets": targets, "log_path": out_dir / "build.log",
           "procs": {}, "t0": time.perf_counter()}
    if not all(p.exists() for p in targets.values()):
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        for v, extra in variants.items():
            tmp = out_dir / f".{targets[v].name}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            job["procs"][v] = (cmd, proc, tmp)
    return job


def _finish(job: dict, bind) -> KernelLibrary:
    name, targets, log_path = job["name"], job["targets"], job["log_path"]
    seconds = 0.0
    if job["procs"]:
        logs, failed = [], []
        for v, (cmd, proc, tmp) in job["procs"].items():
            out, _ = proc.communicate()
            logs.append(f"== {name} variant {v} (exit {proc.returncode}): {' '.join(cmd)}\n{out}")
            if proc.returncode == 0:
                os.replace(tmp, targets[v])  # atomic: a concurrent build is safe
            else:
                failed.append(v)
        seconds = time.perf_counter() - job["t0"]
        log_path.write_text("\n".join(logs))
        if failed:
            raise RuntimeError(
                f"nvcc failed for {name} variants {failed}; full log in {log_path}\n"
                + "\n".join(logs)[-4000:]
            )
    libs = {v: bind(ctypes.CDLL(str(p))) for v, p in targets.items()}
    return KernelLibrary(name=name, libs=libs, build_seconds=seconds, log_path=log_path)


def _bind(lib: ctypes.CDLL, name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """Set ``argtypes`` and an ``int`` ``restype`` on ``<name>_<fn>`` for each
    ``fn`` in ``signatures``, and on its bf16 entry ``<name>_<fn>_bf16``
    where the library has one; plus ``<name>_error_string``."""
    for fn, argtypes in signatures.items():
        for entry in (f"{name}_{fn}", f"{name}_{fn}_bf16"):
            if entry.endswith("_bf16") and not hasattr(lib, entry):
                continue
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
    getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
    getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
    return lib


_P, _I = ctypes.c_void_p, ctypes.c_int


def _bind_k2(lib: ctypes.CDLL) -> ctypes.CDLL:
    return _bind(lib, "k2", {"mlp_fwd_tangents": [_P] * 10 + [_I] * 7 + [_P],
                             "width": [], "chunk_layers": [_I]})


def _bind_k1(lib: ctypes.CDLL) -> ctypes.CDLL:
    return _bind(lib, "k1", {"train_step": [_P] * 14 + [_I] * 7 + [_P],
                             "width": [], "threads": [], "chunk_layers": [_I]})


def _bind_k3(lib: ctypes.CDLL) -> ctypes.CDLL:
    return _bind(lib, "k3", {"mlp_bwd": [_P] * 12 + [_I] * 7 + [_P],
                             "width": [], "threads": [], "chunk_layers": [_I, _I]})


def _bind_k4(lib: ctypes.CDLL) -> ctypes.CDLL:
    return _bind(lib, "k4", {"mlp_bwd": [_P] * 12 + [_I] * 8 + [_P],
                             "width": [], "threads": [], "ckpt_every": [_I] * 3,
                             "chunk_layers": [_I] * 3})


@functools.cache
def _libraries() -> dict[str, KernelLibrary]:
    """Every kernel's libraries, built together on the first call in a
    process: one ``nvcc`` per (kernel, width), all running at once."""
    jobs = [
        (_start("k2", K2_SOURCE, {w: (f"-DK2_WIDTH={w}",) for w in K2_WIDTHS}), _bind_k2),
        (_start("k1", K1_SOURCE, {w: (f"-DK1_WIDTH={w}",) for w in K1_WIDTHS}), _bind_k1),
        (_start("k3", K3_SOURCE, {w: (f"-DK3_WIDTH={w}",) for w in K3_WIDTHS}), _bind_k3),
        (_start("k4", K4_SOURCE, {w: (f"-DK4_WIDTH={w}",) for w in K4_WIDTHS}), _bind_k4),
    ]
    try:
        return {job["name"]: _finish(job, bind) for job, bind in jobs}
    finally:  # a failed build leaves no compiler running behind it
        for job, _ in jobs:
            for _, proc, _ in job["procs"].values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def k2_library() -> KernelLibrary:
    """K2 (``csrc/mlp_fwd_tangents.cu``), one library per width in
    :data:`K2_WIDTHS`."""
    return _libraries()["k2"]


def k1_library() -> KernelLibrary:
    """K1 (``csrc/continuity_train_step.cu``), one library per width in
    :data:`K1_WIDTHS`."""
    return _libraries()["k1"]


def k3_library() -> KernelLibrary:
    """K3 (``csrc/mlp_bwd.cu``), one library per width in
    :data:`K3_WIDTHS`, each holding K = 0..3."""
    return _libraries()["k3"]


def k4_library() -> KernelLibrary:
    """K4 (``csrc/mlp_bwd_rebuild.cu``), one library per width in
    :data:`K4_WIDTHS`, each holding K = 0..3."""
    return _libraries()["k4"]
