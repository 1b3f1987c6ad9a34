#!/usr/bin/env python3
"""How K2's tensor-core body rounds, and where its single points stand.

    python3 tools/k2_mma_rounding.py [--out RESULTS.json]

Needs one CUDA card and nvcc. K2 at bf16 and f32x3 sums each ``mma.sync``
product on the tensor core, whose f32 accumulation is not a sequential
round-to-nearest sum. This tool replays the body's data flow
(``csrc/mlp_fwd_tangents_mma.cuh``: the input layer's FMAs, the hidden and
output layers as one sum per MMA instruction over 16 (or, for an odd last
half k-tile, 8) products, the act' FMA, the bf16 roundings and hi/lo splits
between layers) in float64 with explicit roundings, under several models
of one MMA's sum ``d = c + sum_k a_k b_k``:

* ``rn``      the exact sum rounded to nearest f32 (an ideal tensor core);
* ``rz``      the exact sum truncated toward zero to f32;
* ``trunc<e>`` every term (c and each exact product) truncated toward zero
              to ``23 + e`` bits below the largest term's leading bit, then
              summed and truncated toward zero to f32 (alignment with ``e``
              extra bits);
* ``seq``     c + a_0 b_0 + a_1 b_1 + ... in f32, each sum rounded to
              nearest (the plain tier's kind of sum).

1. Probe: nets whose layers the replay follows bit for bit except for the
   MMA's sum (LeakyReLU, so no tanhf; then tanh), K=2, 4,096 points; the
   share of the kernel's outputs each model reproduces exactly names the
   hardware's rule.
2. The ragged-tile card test's net (2->[20]x6->3, tanh, seed 21, its
   inputs) at f32x3 and bf16: the single point N=1 against the plain tier
   (``kernels.mlp_fwd_tangents_plain``), the plain tier with f64 sums, plain
   f32, and each model's replay; and over all the launch's points, how many
   miss ``compare_tier``'s rule applied to one point (max(1/4 x that
   point's tier error, 4 x its spread) + floor), for the kernel and for the
   ``rn`` replay (a second valid order with exact sums); the replays also
   with act' rounded twice (``_unfused``), as the plain tier computes it.

Prints one line per result and, with ``--out``, writes them all there as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

MODELS = ("rn", "rz", "trunc0", "trunc1", "trunc2", "trunc3", "seq")
LEAK = 0.009999999776482582  # 0.01f, LeakyReLU's slope in f32


def f32(x):
    """Round float64 values to the nearest f32 (kept as float64)."""
    return x.float().double()


def bf16(x):
    """Round f32-valued float64 values to the nearest bf16 (even on ties)."""
    return x.to(__import__("torch").bfloat16).double()


def fma32(a, b, c):
    """fmaf on f32-valued float64 tensors: the product is exact in float64;
    the sum rounds there and again to f32, which differs from one rounding
    only when float64's result sits on an f32 tie (about 2^-29 of cases)."""
    return f32(a * b + c)


def toward_zero(s):
    """Float64 values truncated toward zero to f32."""
    import torch

    r = s.float()
    over = r.double().abs() > s.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r).double()


def mma(c, a, b, model: str):
    """One MMA per row of ``c`` (n, N): ``c + a @ b`` with ``a`` (n, k) and
    ``b`` (k, N) bf16-valued, summed as ``model`` says."""
    import torch

    p = a[:, :, None] * b[None, :, :]  # exact products, (n, k, N)
    if model == "seq":
        s = c
        for k in range(p.shape[1]):
            s = f32(s + p[:, k, :])
        return s
    if model in ("rn", "rz"):
        s = c + p.sum(1)
        return f32(s) if model == "rn" else toward_zero(s)
    extra = int(model[len("trunc"):])
    terms = torch.cat([c[:, None, :], p], 1)
    _, exp = torch.frexp(terms.abs().amax(1, keepdim=True))
    quantum = torch.ldexp(torch.ones_like(terms[:, :1]), exp - 24 - extra)
    return toward_zero((torch.trunc(terms / quantum) * quantum).sum(1))


def split(x, tier: str):
    """A tier's operand of f32-valued x: (hi, lo); lo is 0 at bf16."""
    hi = bf16(x)
    return hi, (bf16(x - hi) if tier == "f32x3" else hi * 0)


def product(a, w, init, tier: str, model: str):
    """``init + a @ w`` the way the body's ``product`` sums it: one MMA per
    16-row group of w's rows (8 for an odd last half k-tile), at f32x3 the
    cross terms (a_lo w_hi, then a_hi w_lo) and the main term (a_hi w_hi,
    from ``init``) in separate accumulators added at the end."""
    (a_hi, a_lo), (w_hi, w_lo) = a, w
    m = init
    c = init * 0
    for g0 in range(0, w_hi.shape[0], 16):
        g = slice(g0, g0 + 16)
        if tier == "f32x3":
            c = mma(c, a_lo[:, g], w_hi[g], model)
            c = mma(c, a_hi[:, g], w_lo[g], model)
        m = mma(m, a_hi[:, g], w_hi[g], model)
    return f32(c + m) if tier == "f32x3" else m


def act(z, leaky: bool, fused: bool = True):
    """(a, act') of f32-valued z: tanhf (torch's f32 tanh on the same
    device) and 1 - a*a as one FMA (nvcc contracts it; ``fused=False``: two
    roundings, as the plain tier computes it), or LeakyReLU(0.01)."""
    import torch

    if leaky:
        return (torch.where(z >= 0, z, f32(LEAK * z)),
                torch.where(z >= 0, torch.ones_like(z), torch.full_like(z, LEAK)))
    a = torch.tanh(z.float()).double()
    return a, (fma32(-a, a, torch.ones_like(a)) if fused else f32(1 - f32(a * a)))


def replay(params, x, n_tangents: int, tier: str, model: str, leaky: bool,
           fused: bool = True):
    """``(y, dy)`` of K2's tensor-core body at ``tier`` with MMA sums per
    ``model``, from f32 ``params`` and ``x`` (any device); ``fused``: act'
    as the body computes it (see :func:`act`)."""
    import torch

    p = {k: v.double() for k, v in params.items()}
    X = x.double()
    W = p["b_in"].shape[0]
    w_in = split(p["w_in"], tier)
    seeds = w_in[0] + w_in[1]  # hi + lo, exact in f32
    xs = split(X, tier)
    z = p["b_in"][None, :].expand(X.shape[0], W)
    cross = z * 0
    for c in range(X.shape[1]):  # Tier::mac over the inputs, in order
        if tier == "f32x3":
            cross = fma32(xs[1][:, c:c + 1], w_in[0][c][None, :], cross)
            cross = fma32(xs[0][:, c:c + 1], w_in[1][c][None, :], cross)
        z = fma32(xs[0][:, c:c + 1], w_in[0][c][None, :], z)
    if tier == "f32x3":
        z = f32(cross + z)
    a, d = act(z, leaky, fused)
    t = [f32(seeds[k][None, :] * d) for k in range(n_tangents)]
    for layer in range(p["w_hidden"].shape[0]):
        w = split(p["w_hidden"][layer], tier)
        z = product(split(a, tier), w, p["b_hidden"][layer][None, :].expand_as(a), tier, model)
        zt = [product(split(tk, tier), w, torch.zeros_like(a), tier, model) for tk in t]
        a, d = act(z, leaky, fused)
        t = [f32(v * d) for v in zt]
    w = split(p["w_out"], tier)
    y = product(split(a, tier), w, p["b_out"][None, :].expand(a.shape[0], -1), tier, model)
    dy = [product(split(tk, tier), w, torch.zeros_like(y), tier, model) for tk in t]
    return y.float(), (torch.stack(dy).float() if dy else y.new_zeros((0,) + y.shape).float())


def continuity(y, dy):
    """fc = (h_x U + h U_x) + (h_y V + h V_y) in f32, heads (U, V, h)."""
    U, V, h = y[:, 0], y[:, 1], y[:, 2]
    return (dy[0][:, 2] * U + h * dy[0][:, 0]) + (dy[1][:, 2] * V + h * dy[1][:, 1])


def numpy_params(sizes, seed):
    """The card tests' seeded weights (``tests/test_torch_cuda.py``)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    d_in, W, d_out, n_stack = sizes[0], sizes[1], sizes[-1], len(sizes) - 3
    scale = np.sqrt(3.0 / W)
    return {"w_in": rng.uniform(-1, 1, (d_in, W)).astype(np.float32),
            "b_in": rng.uniform(-0.1, 0.1, W).astype(np.float32),
            "w_hidden": (rng.uniform(-1, 1, (n_stack, W, W)) * scale).astype(np.float32),
            "b_hidden": rng.uniform(-0.1, 0.1, (n_stack, W)).astype(np.float32),
            "w_out": (rng.uniform(-1, 1, (W, d_out)) * scale).astype(np.float32),
            "b_out": rng.uniform(-0.2, 0.2, d_out).astype(np.float32)}


def probe(dev, results):
    import numpy as np
    import torch

    from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
    from pinn_depthestimation_tpu_torch.ops import kernels

    nets = [((2, 20, 8), "kaiming"), ((2, 20, 20, 20, 20, 3), "kaiming"),
            ((2, 16, 16, 16, 3), "kaiming"), ((2, 20, 8), "xavier"),
            ((2, 20, 20, 20, 20, 3), "xavier")]
    for sizes, init in nets:
        spec = MLPSpec(sizes=sizes, init_type=init)
        params = params_from_numpy(numpy_params(sizes, 5), dev)
        x = torch.as_tensor(np.random.RandomState(6).uniform(-1, 1, (4096, 2))
                            .astype(np.float32)).to(dev)
        for tier in ("bf16", "f32x3"):
            y, dy = kernels.mlp_fwd_tangents(params, x, spec, 2, precision=tier)
            got = torch.cat([y.flatten(), dy.flatten()])
            row = {"net": f"{sizes} {init}", "tier": tier}
            for model in MODELS:
                ye, dye = replay(params, x, 2, tier, model, leaky=init == "kaiming")
                want = torch.cat([ye.flatten(), dye.flatten()])
                row[model] = float((got == want).double().mean())
            results["probe"].append(row)
            print(f"  probe {row['net']} {tier}: share of outputs bit-identical to the "
                  + ", ".join(f"{m} {row[m]:.4f}" for m in MODELS), flush=True)


def ragged(dev, results, best: str):
    import numpy as np
    import torch

    from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
    from pinn_depthestimation_tpu_torch.ops import kernels
    from pinn_depthestimation_tpu_torch.ops.kernels import entry

    sizes = (2,) + (20,) * 6 + (3,)
    spec = MLPSpec(sizes=sizes)
    params = params_from_numpy(numpy_params(sizes, 21), dev)
    lib = kernels.k2_library().libs[20]
    p64 = {k: v.double() for k, v in params.items()}
    for tier in ("f32x3", "bf16"):
        wave = (torch.cuda.get_device_properties(0).multi_processor_count * lib.k2_mma_rows()
                * entry(lib, "k2_mma_warps", tier)())
        x = torch.from_numpy(np.random.RandomState(22).uniform(-1, 1, (wave + 33, 2))
                             .astype(np.float32)).to(dev)
        fc = kernels.fused_residual_continuity(params, x, spec, precision=tier)
        fc1 = kernels.fused_residual_continuity(params, x[:1], spec, precision=tier)
        plain = kernels.residual_continuity_plain(params, x, spec, tier)
        plain_f32 = kernels.residual_continuity_plain(params, x, spec, "f32")
        plain64 = kernels.residual_continuity_plain(p64, x.double(), spec, tier)
        reps = {m: continuity(*replay(params, x, 2, tier, m, leaky=False)) for m in ("rn", best)}
        for m in ("rn", "seq"):  # act' rounded twice, as the plain tier does
            reps[f"{m}_unfused"] = continuity(*replay(params, x, 2, tier, m, leaky=False,
                                                      fused=False))
        tier_err = (plain - plain_f32).double().abs()
        spread = (plain.double() - plain64).abs()
        limit = torch.maximum(0.25 * tier_err, 4 * spread) + 2e-6 * plain.double().abs() + 1e-7
        gap = lambda v: (v.double() - plain.double()).abs()  # noqa: E731
        row = {"tier": tier, "points": int(x.shape[0]),
               "n1": {"fc": float(fc1[0]), "bits_as_long_launch": bool(fc1[0] == fc[0]),
                      "gap_plain": float(gap(fc)[0]), "tier_err": float(tier_err[0]),
                      "spread": float(spread[0]), "limit": float(limit[0]),
                      **{f"gap_plain_{m}": float(gap(r)[0]) for m, r in reps.items()},
                      **{f"gap_kernel_{m}": float((r[0] - fc[0]).abs()) for m, r in reps.items()}},
               "kernel_over_limit": int((gap(fc) > limit).sum()),
               **{f"{m}_over_limit": int((gap(r) > limit).sum()) for m, r in reps.items()},
               "max_gap_kernel": float(gap(fc).max()), "max_tier_err": float(tier_err.max()),
               **{f"max_gap_{m}": float(gap(r).max()) for m, r in reps.items()},
               **{f"max_kernel_minus_{m}": float((r - fc).abs().max()) for m, r in reps.items()},
               "max_abs_fc": float(plain.abs().max())}
        results["ragged"].append(row)
        print(f"  ragged net {tier}: {json.dumps(row)}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="a JSON file for every result")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k2_mma_rounding: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    results = {"probe": [], "ragged": []}
    with torch.no_grad():
        probe(dev, results)
        leaky = [r for r in results["probe"] if "kaiming" in r["net"]]
        best = max(MODELS, key=lambda m: sum(r[m] for r in leaky))
        print(f"  the model that reproduces most LeakyReLU outputs: {best}", flush=True)
        results["best"] = best
        ragged(dev, results, best)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
