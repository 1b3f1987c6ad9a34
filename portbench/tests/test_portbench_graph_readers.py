"""The readers of the metrics of the graphed CMB step (``graphed_pct.train``,
``k3_roofline``, ``step_other_device_ms.cmb``, ``device_busy_ms.cmb``):
nothing where there is nothing to read (no count, no K3, no fidelity rows),
the right number from a synthetic trace, and a reading in a traced
``cmb-adam`` run on the CPU where the CPU has one."""

import pytest

from portbench import opcount_k3, run, tracing as bench_tracing

from pinn_depthestimation_tpu_torch import tracing

CMB_SIZES = [2] + [10] * 10 + [6]
WORK = {"steps": 4, "replays": 3, "points": 20_507, "rows": 200, "sizes": CMB_SIZES}
PEAKS = {"f32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}
WALK = "void mlp_bwd::cotangent_walk_kernel<tier::TierF32, mlp_bwd::StoreAll>(float const*)"
REDUCE = "void mlp_bwd::(anonymous namespace)::reduce_kernel(float const*, int, int)"


def reader(name):
    return run.load_module(run.BENCH_DIR / "metrics" / f"{name}.py",
                           f"portbench_metric_{name.replace('.', '_')}").read


def view(work, device=(), window_s=1.0):
    return bench_tracing.TraceView(window_s=window_s, device=list(device), work=work,
                                   peaks=PEAKS)


def step_trace(steps=2):
    """``steps`` steps of the CMB step's kernels on a synthetic timeline, a
    step 100 us long: K2 at K=2 (5 us) and K=0 (2 us), physics (8 us), K3's
    walks (10 us, 4 us) each with its reduction (1 us), an autograd
    reduction whose name holds ``mlp_bwd`` nowhere (3 us), Adam (2 us), a
    copy (1 us); the physics overlaps K2's second kernel by 1 us."""
    ops = []
    for i in range(steps):
        t = i * 100e-6
        for name, start, length in (
                ("void k2_f32_kernel<10, 2, 0, 2, false>(float const*)", 0, 5),
                ("void k2_f32_kernel<10, 2, 0, 0, false>(float const*)", 6, 2),
                ("void at::native::vectorized_elementwise_kernel<4, mul>()", 7, 8),
                (WALK, 20, 10), (REDUCE, 31, 1), (WALK, 33, 4), (REDUCE, 38, 1),
                ("void at::native::reduce_kernel<512, 1>(float)", 40, 3),
                ("void optim::(anonymous namespace)::adam_kernel(Leaves)", 45, 2),
                ("Memcpy DtoD (Device -> Device)", 50, 1)):
            ops.append((name, t + start * 1e-6, t + (start + length) * 1e-6))
    return ops


def test_the_step_s_device_time_outside_the_hand_written_kernels():
    """Physics 8 us, the autograd reduction 3 us and the copy 1 us a step."""
    ops = step_trace()
    got = reader("step_other_device_ms.cmb")(view(dict(WORK, steps=2), ops))
    assert got == pytest.approx(12e-3)
    assert reader("step_other_device_ms.cmb")(view(dict(WORK, steps=2))) is None
    no_rows = {k: v for k, v in WORK.items() if k != "rows"}
    assert reader("step_other_device_ms.cmb")(view(no_rows, ops)) is None
    bf16 = [(n.replace("TierF32", "TierBF16"), s, e) for n, s, e in ops]
    assert reader("step_other_device_ms.cmb")(view(dict(WORK, steps=2), bf16)) is None


def test_the_graphed_share_of_the_steps():
    assert reader("graphed_pct.train")(view(WORK)) == pytest.approx(75.0)
    assert reader("graphed_pct.train")(view(dict(WORK, replays=0))) == 0.0
    assert reader("graphed_pct.train")(view({k: v for k, v in WORK.items()
                                             if k != "replays"})) is None
    assert reader("graphed_pct.train")(view(dict(WORK, steps=0))) is None


def test_k3_roofline_from_a_synthetic_trace():
    """Two steps, each K3 on the points (10 us) and on the rows (4 us), one
    reduction each (1 us): the two launches' bound over 16 us a step."""
    ops, t = [], 0.0
    for _ in range(2):
        for walk_s in (10e-6, 4e-6):
            ops += [(WALK, t, t + walk_s), (REDUCE, t + walk_s, t + walk_s + 1e-6)]
            t += walk_s + 2e-6
    ops.append(("void at::native::reduce_kernel<512, 1>(float)", t, t + 50e-6))
    bound = sum(max(opcount_k3.k3_flops(CMB_SIZES, n, k) / PEAKS["f32_flops_per_s"],
                    opcount_k3.k3_bytes(CMB_SIZES, n, k) / PEAKS["hbm_bytes_per_s"])
                for n, k in ((20_507, 2), (200, 0)))
    got = reader("k3_roofline")(view(WORK, ops))
    assert got == pytest.approx(100.0 * bound / 16e-6)
    assert 0 < got <= 100
    bf16 = [(WALK.replace("TierF32", "TierBF16"), 0.0, 1e-5)]
    assert reader("k3_roofline")(view(WORK, bf16)) is None
    assert reader("k3_roofline")(view({"steps": 4}, ops)) is None


def test_the_device_s_busy_time_a_cmb_step():
    """The union of a step's operations: 36 us of 37 summed, the physics's
    overlap with K2 counted once."""
    ops = step_trace(3)
    got = reader("device_busy_ms.cmb")(view(dict(WORK, steps=3), ops))
    assert got == pytest.approx(36e-3)
    assert reader("device_busy_ms.cmb")(view(dict(WORK, steps=3))) is None
    assert reader("device_busy_ms.cmb")(view(dict(WORK, steps=0), ops)) is None


def test_a_traced_cmb_run_on_the_cpu_reads_what_the_cpu_has():
    """On the CPU every step runs op by op: ``graphed_pct.train`` reads 0,
    the device's metrics read nothing."""
    from portbench.tests.test_portbench_control_graph import SMALL

    tracing.reset()
    out = run.run_cell("cmb-adam", 2**40 + 1, 0.05, True, device="cpu",
                       overrides=SMALL["cmb-adam"])
    metrics, notes = out["result"]["metrics"], out["notes"]
    assert metrics["graphed_pct.train"]["value"] == 0.0
    assert {"k3_roofline", "step_other_device_ms.cmb",
            "device_busy_ms.cmb"} <= set(notes["read_nothing"])
    assert metrics["block_flush_ms"]["value"] > 0
    assert notes["window_replays"] == 0 and notes["k3_launches_window"] == 0
