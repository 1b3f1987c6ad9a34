"""Run from the repository root with one CUDA card and nvcc:
    python3 .soak/walk_mma_sum_variants.py OTHER_CSRC

Diagnostic: how far K3-bf16 sits from the plain tier on the 100-layer flagship
(tests/test_torch_cuda.py::test_cuda_k3_bf16_and_k4_match_plain_tier's case), for
several builds: the parent's lane-pair walk (OTHER_CSRC), the tensor-core walk, and variants of the
MMA sum (each k-step from zero, summed in f32; one m16n8k8 per half k-tile).
The variants patch mma_frag.cuh's product, which every product of the
tensor-core walk used when this ran (its first build); the walk now keeps
it for the cotangent product only (mlp_bwd_mma.cuh tier_product)."""
import ctypes, os, re, shutil, subprocess, sys, tempfile

OTHER = sys.argv[1] if len(sys.argv) > 1 else ".soak/parent_csrc"  # OTHER_CSRC: the parent's csrc/
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
from pinn_depthestimation_tpu_torch.ops import cuda_build, kernels_step, kernels_vjp

B_PRODUCT = r'''template <bool SPLIT, int NT, int KT>
__device__ __forceinline__ void product(float (&z)[NT][4], const Half (&a)[KT],
                                        const BWord (&b)[NT][KT], const float (&init)[NT][2]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (MODE == 2) {
#pragma unroll
      for (int h = 0; h < KT; ++h) {
        float m[4] = {0.f, 0.f, 0.f, 0.f};
        mma1688(m, a[h].hi[0], a[h].hi[1], b[j][h].hi);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[e] += m[e];
      }
    } else {
#pragma unroll
      for (int h = 0; h + 1 < KT; h += 2) {
        float m[4] = {0.f, 0.f, 0.f, 0.f};
        mma16816(m, a[h].hi[0], a[h].hi[1], a[h + 1].hi[0], a[h + 1].hi[1], b[j][h].hi,
                 b[j][h + 1].hi);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[e] += m[e];
      }
      if constexpr (KT % 2 == 1) {
        float m[4] = {0.f, 0.f, 0.f, 0.f};
        mma1688(m, a[KT - 1].hi[0], a[KT - 1].hi[1], b[j][KT - 1].hi);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[e] += m[e];
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) z[j][e] = s[e] + init[j][e & 1];
  }
}
'''

def variant_src(tmp, name, mode):
    d = os.path.join(tmp, name)
    shutil.copytree("pinn_depthestimation_tpu_torch/csrc", d)
    if mode:
        p = os.path.join(d, "mma_frag.cuh")
        t = open(p).read()
        a = t.index("template <bool SPLIT, int NT, int KT>\n__device__ __forceinline__ void product(")
        b = t.index("// The value a tier's products see of one staged input weight")
        t = t[:a] + f"constexpr int MODE = {mode};\n" + B_PRODUCT + "\n" + t[b:]
        open(p, "w").write(t)
    return d

def build(src, out, kind="k3", width=20, tier=1):
    macro = {"k3": "K3_WIDTH", "k4": "K4_WIDTH", "k1": "K1_WIDTH"}[kind]
    source = {"k3": cuda_build.K3_SOURCE, "k4": cuda_build.K4_SOURCE, "k1": cuda_build.K1_SOURCE}[kind]
    cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, f"-D{macro}={width}", f"-DTIER_ONLY={tier}",
           "-o", out, os.path.join(src, source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

def numpy_params(sizes, init_type="xavier", seed=0):
    rng = np.random.RandomState(seed)
    d_in, W, d_out, n_stack = sizes[0], sizes[1], sizes[-1], len(sizes) - 3
    scale = np.sqrt(3.0 / W)
    return {"w_in": rng.uniform(-1, 1, (d_in, W)).astype(np.float32),
            "b_in": rng.uniform(-0.1, 0.1, W).astype(np.float32),
            "w_hidden": (rng.uniform(-1, 1, (n_stack, W, W)) * scale).astype(np.float32),
            "b_hidden": rng.uniform(-0.1, 0.1, (n_stack, W)).astype(np.float32),
            "w_out": (rng.uniform(-1, 1, (W, d_out)) * scale).astype(np.float32),
            "b_out": rng.uniform(-0.2, 0.2, d_out).astype(np.float32)}

def main():
    dev = torch.device("cuda")
    tmp = tempfile.mkdtemp()
    srcs = {"new": variant_src(tmp, "new", 0), "B": variant_src(tmp, "B", 1), "E": variant_src(tmp, "E", 2),
            "old": OTHER}
    procs = {n: build(s, os.path.join(tmp, f"lib_{n}.so")) for n, s in srcs.items()}
    libs = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(n, "BUILD FAILED", log[-3000:]); continue
        libs[n] = cuda_build._bind_k3(ctypes.CDLL(os.path.join(tmp, f"lib_{n}.so")))
    for sizes, kt, n, seed in (((2,) + (20,) * 100 + (3,), 2, 1003, 8), ((2,) + (20,) * 100 + (3,), 2, 12516, 8),
                               ((2,) + (20,) * 11 + (3,), 1, 129, 8)):
        spec = MLPSpec(sizes=sizes)
        params = params_from_numpy(numpy_params(sizes, "xavier", seed=seed), dev)
        rs = np.random.RandomState(9)
        x = torch.from_numpy(rs.uniform(-1, 1, (n, sizes[0])).astype(np.float32)).to(dev)
        ybar = torch.from_numpy(rs.randn(n, sizes[-1]).astype(np.float32)).to(dev)
        dybar = torch.from_numpy(rs.randn(kt, n, sizes[-1]).astype(np.float32)).to(dev)
        g_t = kernels_vjp.packed_mlp_bwd_plain(params, x, ybar, dybar, spec, kt, "bf16")
        g_f = kernels_vjp.packed_mlp_bwd_plain(params, x, ybar, dybar, spec, kt, "f32")
        g_6 = kernels_vjp.packed_mlp_bwd_plain({k: v.double() for k, v in params.items()}, x.double(),
                                               ybar.double(), dybar.double(), spec, kt, "bf16")
        l2 = lambda d: float(d.double().norm())
        for name, lib in libs.items():
            flat = kernels_vjp._launch_k3(params, x, ybar, dybar, spec, kt, "bf16", lib=lib)
            g = kernels_step.unflatten(flat, spec)
            cells = []
            for k in g:
                tier, spread = l2(g_t[k] - g_f[k]), l2(g_t[k].double() - g_6[k])
                floor = 1e-4 * l2(g_t[k]) + 1e-7
                err, off = l2(g[k] - g_t[k]), l2(g[k] - g_f[k])
                lim = max(0.25 * tier, 4 * spread) + floor
                cells.append(f"{k}: gap/lim {err / lim:.2f} (gap {err:.2e}, tier {tier:.2e}, spread {spread:.2e}, off/tier {off / max(tier, 1e-30):.2f})")
            print(f"{len(sizes) - 2} layers N={n} K={kt} {name}: " + "; ".join(cells), flush=True)

main()
