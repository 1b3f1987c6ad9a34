"""Run from the repository root with one CUDA card and nvcc:
    python3 .soak/walk_cmb_kernel_split.py OTHER_CSRC

Diagnostic 3: where K3's time goes on the cmb grid (W=10, K=2): the walk kernel
and the reduction kernel apart (torch.profiler), bf16 and f32, this tree against
another build of the sources (OTHER_CSRC) and against this tree without the warp fold."""
import ctypes, os, re, shutil, subprocess, sys, tempfile

OTHER = sys.argv[1] if len(sys.argv) > 1 else ".soak/parent_csrc"  # OTHER_CSRC: the parent's csrc/
sys.path.insert(0, os.getcwd())
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
import chip_smoke
from pinn_depthestimation_tpu_torch.ops import cuda_build
from tools.k1_refactor_check import launch_k3

def variant(tmp, name, subs):
    d = os.path.join(tmp, name)
    shutil.copytree("pinn_depthestimation_tpu_torch/csrc", d)
    for fname, pat, rep in subs:
        p = os.path.join(d, fname)
        t = open(p).read()
        t, n = re.subn(pat, rep, t)
        assert n >= 1, pat
        open(p, "w").write(t)
    return d

def split_ms(fn, calls):
    fn(); torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            key = "reduce" if "reduce_kernel" in e.name else ("walk" if "walk" in e.name else e.name[:30])
            out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    return {k: round(v, 4) for k, v in out.items()}

def main():
    dev = torch.device("cuda")
    print(chip_smoke.nvidia_smi("name,power.limit"))
    tmp = tempfile.mkdtemp()
    srcs = {"cur": variant(tmp, "cur", []),
            "nofold": variant(tmp, "nofold", [("mlp_bwd_mma.cuh", r"accum_square<Tier, W, S, true>", "accum_square<Tier, W, S>")]),
            "old": OTHER}
    jobs = {}
    for n, s in srcs.items():
        for tier in (0, 1):
            out = os.path.join(tmp, f"lib_{n}_{tier}.so")
            cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-DK3_WIDTH=10", f"-DTIER_ONLY={tier}",
                   "-o", out, os.path.join(s, cuda_build.K3_SOURCE)]
            jobs[(n, tier)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for key, (p, out) in jobs.items():
        log, _ = p.communicate()
        if p.returncode:
            print(key, "BUILD FAILED", log[-2000:]); continue
        libs[key] = cuda_build._bind_k3(ctypes.CDLL(out))
    with tempfile.TemporaryDirectory() as t2:
        _, _, res_pts, fid_pts = chip_smoke.cmb_bench_points(dev, t2)
        c = chip_smoke.k3_cases(dev, os.getcwd(), t2, res_pts, fid_pts)[0]
        for tier, tname in ((1, "bf16"), (0, "f32")):
            outs = {}
            for name in ("old", "cur", "nofold", "cur", "old"):
                lib = libs.get((name, tier))
                if lib is None:
                    continue
                fn = lambda: launch_k3(lib, *c[2:6], c[1], c[6], tname)
                outs[name] = fn()
                print(f"K3-{tname} cmb {name}: {split_ms(fn, 20)}", flush=True)
            if tname == "f32":
                print("f32 cur == old bit for bit:", torch.equal(outs["cur"], outs["old"]))

main()
