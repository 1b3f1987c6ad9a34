"""Experiment (on no path of the system): build variants of the K2 f32 body
(.soak/k2f32_variants.py) and the parent's at widths 20 and 10, read the
SASS of the hidden-layer loop, and time each at the path shapes in turns,
every launch shape of the body forced through the plan.

    python3 .soak/k2f32_probe.py PARENT_CSRC variant[,variant...]

Written for the f32 body of the lanes-a-point redesign while it still
took 1, 2 or 4 lanes and points a thread (see .soak/k2f32_variants.py);
it does not run against the final body."""
import collections
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, ".soak"))


def loop_ops(so: str, pattern: str):
    from pinn_depthestimation_tpu_torch.ops import cuda_build
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], check=True, capture_output=True, text=True).stdout
    out = {}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split("\n")[0].strip()
        if not re.search(pattern, name):
            continue
        code = [(int(m.group(1), 16), line) for line in fn.split("\n")
                if (m := re.search(r"/\*([0-9a-f]{4,})\*/", line))]
        best = None
        for at, line in code:
            t = re.search(r"BRA\s.*?0x([0-9a-f]+)", line)
            if t and int(t.group(1), 16) < at:
                body = [ln for a, ln in code if int(t.group(1), 16) <= a <= at]
                nf = sum(" FFMA " in ln for ln in body)
                # the innermost loop with the hidden layer's FMAs
                if nf >= 40 and (best is None or len(body) < len(best[1])):
                    best = (nf, body)
        total = collections.Counter()
        for _, line in code:
            m = re.search(r"\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if m:
                total[m.group(2).split(".")[0]] += 1
        ops = collections.Counter()
        for line in (best[1] if best else []):
            m = re.search(r"\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if m:
                ops[m.group(2).split(".")[0]] += 1
        out[name[:90]] = (sum(ops.values()), dict(ops.most_common(14)),
                          {k: total[k] for k in ("LDL", "STL")})
    return out


def main():
    import torch

    import chip_smoke
    import k2f32_variants
    from pinn_depthestimation_tpu_torch import benchmarks
    from pinn_depthestimation_tpu_torch.config import load_config
    from pinn_depthestimation_tpu_torch.data import load_test_data
    from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
    from tools.k1_refactor_check import finish_build, launch_k2, start_build

    parent, names = sys.argv[1], sys.argv[2].split(",")
    dev = torch.device("cuda", 0)
    print(chip_smoke.nvidia_smi("name,power.limit"), flush=True)
    csrc = os.path.join(REPO, "pinn_depthestimation_tpu_torch", "csrc")
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {"parent": parent}
        for n in names:
            dirs[n] = k2f32_variants.make(csrc, os.path.join(tmp, "src"), n)
        procs = {n: start_build(d, os.path.join(tmp, "b_" + n), {"k2": {20, 10}}, ["f32"])
                 for n, d in dirs.items()}
        libs = {n: finish_build(p) for n, p in procs.items()}
        for n, p in procs.items():
            for key, (proc, so) in p.items():
                if key[1] != 20:
                    continue
                pat = (r"ILi20ELi(\d)ELi(\d)ELi0ELi(0|3)ELb0E" if n != "parent"
                       else r"ILi20ELi0ELi(0|3)ELb0E")
                for fn, (count, ops, spills) in loop_ops(so, pat).items():
                    print(f"SASS {n} {fn}: hidden loop {count} instructions {ops}; "
                          f"whole kernel {spills}", flush=True)
        flag = MLPSpec(sizes=benchmarks.FLAGSHIP_SIZES, init_type="xavier")
        x_serve = torch.as_tensor(load_test_data(load_config(
            chip_smoke.newmethod_config(tmp, REPO))).inputs).to(dev)
        serve_p = params_from_numpy(chip_smoke.numpy_params(flag.sizes, "xavier", 3), dev)
        _, _, res_pts, fid_pts = chip_smoke.cmb_bench_points(dev, tmp)
        cmb = MLPSpec(sizes=(2,) + (10,) * 10 + (6,), init_type="xavier")
        cmb_p = params_from_numpy(chip_smoke.numpy_params(cmb.sizes, "xavier", 8), dev)
        leg = MLPSpec(sizes=(5,) + (20,) * 20 + (4,), init_type="xavier")
        leg_x = chip_smoke.legacy_points(dev, tmp, REPO)
        leg_p = params_from_numpy(chip_smoke.numpy_params(leg.sizes, "xavier", 25), dev)
        spec10, p10, c10 = benchmarks.flagship_bench_inputs(10_000_000, dev)
        shapes = {"serve": (flag, serve_p, x_serve, 0, False), "legacy": (leg, leg_p, leg_x, 3, False),
                  "cmb": (cmb, cmb_p, res_pts, 2, False), "fid": (cmb, cmb_p, fid_pts, 0, False),
                  "10m": (spec10, p10, c10, 2, True)}
        from pinn_depthestimation_tpu_torch.ops import k2_plan
        lane_opts = [None] + list(k2_plan.F32_SHAPES)
        for key, (spec, params, x, kt, epi) in shapes.items():
            n = x.shape[0]
            out = ({"fc": torch.empty(n, device=dev)} if epi else
                   {"y": torch.empty(n, spec.d_out, device=dev),
                    "dy": torch.empty(kt, n, spec.d_out, device=dev) if kt else None})
            runs = [("parent", None)] + [(v, g) for v in names for g in
                                         (lane_opts if key != "10m" else [None, (2, 2)])]
            res = collections.defaultdict(list)
            calls = 2 if key == "10m" else 20
            for order in (runs, runs[::-1]):
                for v, g in order:
                    lib = libs[v][("k2", spec.width)]
                    fn = (lambda lib=lib, g=g: launch_k2(lib, params, x, spec, kt, "f32",
                                                          epilogue=epi, shape=g, **out))
                    with torch.no_grad():
                        d = chip_smoke.device_ms(fn, calls, "k2_")
                    res[(v, g)].append(d)
            print(f"== {key} ({n} points, K={kt}): device ms, mean of two turns", flush=True)
            base = sum(res[("parent", None)]) / 2
            for (v, g), ds in res.items():
                m = sum(ds) / 2 if None not in ds else float("nan")
                print(f"  {v:12s} lanes {g}: {m:.4f} ({m / base:.3f} of parent) {ds}", flush=True)


if __name__ == "__main__":
    main()
