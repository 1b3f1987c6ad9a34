#!/usr/bin/env python3
"""Where and why the flagship's L-BFGS phase stops, through K1 and through
the plain path, at several ``tolerance_change`` values.

    python3 tools/lbfgs_stop_witness.py [--tolerances 1e-12,0] [--repeat 2]

Needs one CUDA card and nvcc. Runs the L-BFGS phase that ``chip_smoke.py``
phase 10 times (``examples/newmethod.json`` on the synthetic 81x261 grid,
12,516 training points, 500 iterations / 625 evaluations, ``tolerance_grad``
1e-9, no Adam) from phase 9's seeded flagship weights, on the card, once
through K1 (``fused_kernel`` on) and once on the plain autograd path
(``fused_kernel`` off, no kernel), at each ``tolerance_change``; the K1 run
``--repeat`` times. The two paths sum the same function in different orders.

Every stall (a step, loss-change or descent stop, after which the optimizer
clears its history and goes on, up to ``max_restarts`` times, or ends) is
printed with the evaluation it came at, the loss change ``|f - f_prev|``,
the largest parameter change and ``max|g|``; each run ends with its
evaluations, its stop reason and K1's launches.

Where the first K1 run stopped before its evaluation budget, the tool then
probes the point it stopped at: K1's loss and gradient against the plain
path's (f32, on the card); the loss along the restart's direction ``-g``
at steps ``t`` = 1 ... 1e-7 through K1, the plain f32 loss and the plain
loss in f64, beside the first-order change ``-t |g|^2``; and the plain
path's own L-BFGS phase from that point (at most 100 evaluations). Exits 1
if K1's launches differ from the evaluations, or the plain path launched
K1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tolerances", default="1e-12,0",
                        help="comma-separated tolerance_change values")
    parser.add_argument("--repeat", type=int, default=2, help="runs through K1 at each value")
    args = parser.parse_args()

    import torch

    import chip_smoke
    from pinn_depthestimation_tpu_torch import benchmarks
    from pinn_depthestimation_tpu_torch.config import load_config
    from pinn_depthestimation_tpu_torch.ops import kernels, kernels_step
    from pinn_depthestimation_tpu_torch.optim import lbfgs as lbfgs_mod
    from pinn_depthestimation_tpu_torch.training import loss as loss_mod
    from pinn_depthestimation_tpu_torch.training.driver import Trainer

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.nvidia_smi("name,power.limit"))
    dev = torch.device("cuda")

    stalls: list[dict] = []
    real_step = lbfgs_mod.LBFGSRunner._step

    def recording_step(self, state):
        x0, restarts = state.x, state.restarts
        real_step(self, state)
        stalled = (state.restarts > restarts or state.reason in
                   (lbfgs_mod.CONVERGED_STEP, lbfgs_mod.CONVERGED_LOSS, lbfgs_mod.NOT_DESCENT))
        if stalled:
            stalls.append({"evaluation": int(state.func_evals), "restart": state.restarts > restarts,
                           "loss": float(state.f),
                           "loss_change": float(abs(state.f - state.prev_f)),
                           "max_param_change": float((state.x - x0).abs().max()),
                           "max_grad": float(state.g.abs().max())})

    lbfgs_mod.LBFGSRunner._step = recording_step
    flagship = benchmarks.FLAGSHIP_SIZES
    init = chip_smoke.numpy_params(flagship, "xavier", 6)
    results = []
    stopped_at = None
    with tempfile.TemporaryDirectory() as tmp:

        def trainer(mode, tol, start, max_it=500, max_eval=625):
            path = chip_smoke.newmethod_config(
                tmp, REPO, fused_kernel=mode, adam_optimizer={"max_it": 0},
                lbfgs_optimizer={"max_it": max_it, "max_evaluation": max_eval,
                                 "tolerance_grad": 1e-9, "tolerance_change": tol})
            run = os.path.join(tmp, f"run_{len(os.listdir(tmp))}")
            os.makedirs(run)
            return Trainer(load_config(path), run_dir=run, echo_every=0, initial_params=start,
                           device=dev)

        def lbfgs_run(tr, path_name, tol):
            kernels.reset_launches(kernels_step.fused_loss_and_grad)
            stalls.clear()
            tr.train_lbfgs()
            torch.cuda.synchronize()
            k1 = kernels_step.fused_loss_and_grad.launches
            res = {"path": path_name, "tolerance_change": tol,
                   "evaluations": tr.state.iteration, "stop": tr.lbfgs_stop_reason,
                   "k1_launches": k1, "stalls": list(stalls)}
            results.append(res)
            print(f"{path_name} at tolerance_change {tol:g}: {res['evaluations']} evaluations, "
                  f"stop {res['stop']!r}, K1 launches {k1}, {len(stalls)} stalls")
            for s in stalls:
                print(f"  stall at evaluation {s['evaluation']} ({'restart' if s['restart'] else 'end'}): "
                      f"loss {s['loss']!r}, |f - f_prev| {s['loss_change']!r}, "
                      f"max|dx| {s['max_param_change']!r}, max|g| {s['max_grad']!r}")
            return k1 == (res["evaluations"] if path_name == "K1" else 0)

        for tol in (float(t) for t in args.tolerances.split(",")):
            for mode in ["on"] * args.repeat + ["off"]:
                tr = trainer(mode, tol, init)
                if not lbfgs_run(tr, "K1" if mode == "on" else "plain", tol):
                    print("K1's launches differ from the evaluations, or the plain path "
                          "launched K1", file=sys.stderr)
                    return 1
                if mode == "on" and stopped_at is None and tr.state.iteration < 625:
                    stopped_at = (tol, {k: v.detach().cpu().numpy().copy()
                                        for k, v in tr.state.params.items()})

        if stopped_at is not None:
            tol, x = stopped_at
            on, off = trainer("on", tol, x), trainer("off", tol, x)
            params = {k: torch.as_tensor(v, device=dev) for k, v in x.items()}
            (f_k1, _), g = on.value_and_grad_fn(params, on.batch)
            (f_pl, _), g_pl = off.value_and_grad_fn(params, off.batch)
            diff = max(float((g[k] - g_pl[k]).abs().max()) for k in g)
            scale = max(float(g_pl[k].abs().max()) for k in g)
            flat = torch.cat([g[k].double().flatten() for k in sorted(g)])
            flat_pl = torch.cat([g_pl[k].double().flatten() for k in sorted(g)])
            gg = float(flat @ flat)
            cos = float(flat @ flat_pl) / (gg * float(flat_pl @ flat_pl)) ** 0.5
            print(f"probe at K1's stop (tolerance_change {tol:g}): loss K1 {float(f_k1)!r}, plain "
                  f"{float(f_pl)!r}; max|g_K1 - g_plain| {diff!r} of max|g_plain| {scale!r}, "
                  f"cos {cos!r}; |g|^2 {gg!r}")
            b32 = loss_mod._step_batch_fn(off.config, off.data.input_min_max)(off.batch)
            b64 = dataclasses.replace(b32, **{f.name: getattr(b32, f.name).double()
                                              for f in dataclasses.fields(b32)
                                              if isinstance(getattr(b32, f.name), torch.Tensor)})

            def losses(t):
                step = {k: params[k] - t * g[k] for k in params}
                step64 = {k: params[k].double() - t * g[k].double() for k in params}
                with torch.no_grad():
                    return (float(on.value_and_grad_fn(step, on.batch)[0][0]),
                            float(off.loss_fn(step, off.batch)[0]),
                            float(kernels_step.shared_forward_loss_plain(step64, b64, off.spec)[0]))

            base = losses(0.0)
            line = []
            for t in [10.0 ** -e for e in range(8)]:
                ft = losses(t)
                line.append({"t": t, "first_order": -t * gg,
                             "k1": ft[0] - base[0], "plain32": ft[1] - base[1],
                             "plain64": ft[2] - base[2]})
                print(f"  t {t:g}: first order {-t * gg:.6e}; loss change K1 {ft[0] - base[0]:.6e}, "
                      f"plain f32 {ft[1] - base[1]:.6e}, plain f64 {ft[2] - base[2]:.6e}")
            lbfgs_run(trainer("off", tol, x, max_it=80, max_eval=100), "plain from K1's stop", tol)
            results.append({"probe": {"tolerance_change": tol, "loss_k1": float(f_k1),
                                      "loss_plain": float(f_pl), "max_grad_diff": diff,
                                      "max_grad_plain": scale, "cos": cos, "grad_sq": gg,
                                      "line": line}})
    print(json.dumps({"lbfgs_stop_witness": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
