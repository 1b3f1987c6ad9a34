"""Patched copies of the K2 f32 body for timing experiments (never on a path
of the system): name -> [(old, new)] applied to mlp_fwd_tangents.cu.

The patches are written against the f32 body as it stood while the
redesign still took 1, 2 or 4 lanes a point by `__shfl_sync` and points a
thread (PERF.md, section 6): `rmajor` puts a point's lanes 32/G apart,
`regs` raises the register estimate of `max_threads`. They do not apply
to the final body, which `tools/walk_breakdown.py --k2` splits."""
import os
import shutil

RMAJOR = [
    ("const int r = lane % G;\n  const int group = lane / G;",
     "const int r = lane / GROUPS;\n  const int group = lane % GROUPS;"),
    ("return __shfl_sync(kFullMask, v, src, G);",
     "return __shfl_sync(kFullMask, v, src * (32 / G) + (threadIdx.x & 31) % (32 / G));"),
]
REGS = [("const int regs = (2 * (1 + K) * cols(W, lanes) * points + 48 + 7) / 8 * 8;",
         "const int regs = (2 * (1 + K) * cols(W, lanes) * points + 80 + 7) / 8 * 8;")]
VARIANTS = {"new": [], "rmajor": RMAJOR, "regs": REGS, "rmajor_regs": RMAJOR + REGS}


def make(src_dir: str, out_dir: str, name: str) -> str:
    d = os.path.join(out_dir, name)
    shutil.copytree(src_dir, d, dirs_exist_ok=True)
    p = os.path.join(d, "mlp_fwd_tangents.cu")
    s = open(p).read()
    for old, new in VARIANTS[name]:
        assert old in s, (name, old)
        s = s.replace(old, new)
    open(p, "w").write(s)
    return d
