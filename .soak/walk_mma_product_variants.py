"""Run from the repository root with one CUDA card and nvcc:
    python3 .soak/walk_mma_product_variants.py OTHER_CSRC

Diagnostic 2: the bf16 walk's product variants, precision (K3-bf16 on the 100-layer
flagship, N=1003, against the plain tier) and device time (K1-bf16 flagship, K3-bf16
cmb grid, K4-bf16 legacy), beside another build of the sources (OTHER_CSRC).
It patches the tree it ran on, where every product site of mlp_bwd_mma.cuh
called tier_product (m16n8k8 partials at bf16): "Efwd" (those partials in
the forward only) is what the walk keeps; on that tree the patterns of the
sites the walk now gives to product no longer match."""
import ctypes, os, re, shutil, subprocess, sys, tempfile

OTHER = sys.argv[1] if len(sys.argv) > 1 else ".soak/parent_csrc"  # OTHER_CSRC: the parent's csrc/
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import chip_smoke
from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
from pinn_depthestimation_tpu_torch.ops import cuda_build, kernels_step, kernels_vjp
from tools.k1_refactor_check import launch_k1, launch_k3, launch_k4, legacy_case

FWD = [r"tier_product<SP, T, T>\(sa, a, bw, bias\);", r"tier_product<SP, T, T>\(su\[k\], t\[k\], bw, zero\);",
       r"tier_product<SP, 1, T>\(yo, a, bo, init\);", r"tier_product<SP, 1, T>\(d, t\[k\], bo, zero\);"]
BWD = [r"tier_product<SPLIT, T, T>\(out, in, bw, zero\);", r"tier_product<SP, T, 1>\(ca, yh, bo, zero\);",
       r"tier_product<SP, T, 1>\(ct\[k\], th, bo, zero\);"]

def variant(tmp, name, chained):
    d = os.path.join(tmp, name)
    shutil.copytree("pinn_depthestimation_tpu_torch/csrc", d)
    p = os.path.join(d, "mlp_bwd_mma.cuh")
    t = open(p).read()
    for pat in chained:
        t, n = re.subn(pat, lambda m: m.group(0).replace("tier_product<", "product<"), t)
        assert n == 1, pat
    open(p, "w").write(t)
    return d

SRC = {"k1": (cuda_build.K1_SOURCE, "K1_WIDTH"), "k3": (cuda_build.K3_SOURCE, "K3_WIDTH"),
       "k4": (cuda_build.K4_SOURCE, "K4_WIDTH")}
BIND = {"k1": cuda_build._bind_k1, "k3": cuda_build._bind_k3, "k4": cuda_build._bind_k4}

def main():
    dev = torch.device("cuda")
    print(chip_smoke.nvidia_smi("name,power.limit"))
    tmp = tempfile.mkdtemp()
    srcs = {"E": variant(tmp, "E", []), "Efwd": variant(tmp, "Efwd", BWD),
            "Ebwd": variant(tmp, "Ebwd", FWD), "K2chain": variant(tmp, "K2chain", FWD + BWD),
            "old": OTHER}
    jobs = {}
    for n, s in srcs.items():
        for kind, w in (("k1", 20), ("k3", 10), ("k3", 20), ("k4", 20)):
            out = os.path.join(tmp, f"lib_{n}_{kind}_{w}.so")
            source, macro = SRC[kind]
            cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, f"-D{macro}={w}", "-DTIER_ONLY=1",
                   "-o", out, os.path.join(s, source)]
            jobs[(n, kind, w)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for key, (p, out) in jobs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(key, "BUILD FAILED", log[-2000:]); continue
        libs[key] = BIND[key[1]](ctypes.CDLL(out))
    l2 = lambda d: float(d.double().norm())
    # precision: K3-bf16, 100 layers, N = 1003 and 12516
    for n in (1003, 12516):
        sizes = (2,) + (20,) * 100 + (3,)
        spec = MLPSpec(sizes=sizes)
        params = params_from_numpy(chip_smoke.numpy_params(sizes, "xavier", 8), dev) if False else None
        rng = np.random.RandomState(0)
        W, d_out, ns = 20, 3, 98 + 1
        scale = np.sqrt(3.0 / W)
        r = np.random.RandomState(8)
        arr = {"w_in": r.uniform(-1, 1, (2, W)).astype(np.float32), "b_in": r.uniform(-0.1, 0.1, W).astype(np.float32),
               "w_hidden": (r.uniform(-1, 1, (99, W, W)) * scale).astype(np.float32),
               "b_hidden": r.uniform(-0.1, 0.1, (99, W)).astype(np.float32),
               "w_out": (r.uniform(-1, 1, (W, 3)) * scale).astype(np.float32), "b_out": r.uniform(-0.2, 0.2, 3).astype(np.float32)}
        params = params_from_numpy(arr, dev)
        rs = np.random.RandomState(9)
        x = torch.from_numpy(rs.uniform(-1, 1, (n, 2)).astype(np.float32)).to(dev)
        ybar = torch.from_numpy(rs.randn(n, 3).astype(np.float32)).to(dev)
        dybar = torch.from_numpy(rs.randn(2, n, 3).astype(np.float32)).to(dev)
        g_t = kernels_vjp.packed_mlp_bwd_plain(params, x, ybar, dybar, spec, 2, "bf16")
        g_f = kernels_vjp.packed_mlp_bwd_plain(params, x, ybar, dybar, spec, 2, "f32")
        g_6 = kernels_vjp.packed_mlp_bwd_plain({k: v.double() for k, v in params.items()}, x.double(),
                                               ybar.double(), dybar.double(), spec, 2, "bf16")
        for name in srcs:
            if (name, "k3", 20) not in libs:
                continue
            g = kernels_step.unflatten(launch_k3(libs[(name, "k3", 20)], params, x, ybar, dybar, spec, 2, "bf16"), spec)
            worst = max((l2(g[k] - g_t[k]) / (max(0.25 * l2(g_t[k] - g_f[k]), 4 * l2(g_t[k].double() - g_6[k]))
                         + 1e-4 * l2(g_t[k]) + 1e-7), k) for k in g)
            print(f"precision N={n} {name}: worst gap/limit {worst[0]:.2f} ({worst[1]})", flush=True)
    # timing
    with tempfile.TemporaryDirectory() as t2:
        cases, n_grid, _ = chip_smoke.k1_cases(dev, os.getcwd(), t2)
        _, k1_spec, k1_params, k1_batch = cases[0]
        _, _, res_pts, fid_pts = chip_smoke.cmb_bench_points(dev, t2)
        k3c = chip_smoke.k3_cases(dev, os.getcwd(), t2, res_pts, fid_pts)[0]
        leg = legacy_case(dev, t2)
        calls = {"K1-bf16 flagship": ("k1", 20, lambda lib: launch_k1(lib, k1_params, k1_batch, k1_spec, "bf16")),
                 "K3-bf16 cmb": ("k3", 10, lambda lib: launch_k3(lib, *k3c[2:6], k3c[1], k3c[6], "bf16")),
                 "K4-bf16 legacy": ("k4", 20, lambda lib: launch_k4(lib, *leg[2:6], leg[1], leg[6], "bf16"))}
        for label, (kind, w, fn) in calls.items():
            row = []
            for name in ("old", "E", "Efwd", "Ebwd", "K2chain", "E", "old"):
                lib = libs.get((name, kind, w))
                if lib is None:
                    continue
                d = chip_smoke.device_ms(lambda: fn(lib), 20, chip_smoke.WALK_KERNEL[kind])
                row.append(f"{name} {d if d is None else round(d, 4)}")
            print(f"time {label} (device ms, in turns): " + ", ".join(row), flush=True)

main()
