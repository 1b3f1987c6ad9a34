"""The reader of ``adam_fused_pct.train``: 100 where every step of the
window launched the port's Adam kernel, less where launches are missing,
nothing without steps or without the kernel (torch's own Adam)."""

import pytest

from portbench import run, tracing

ADAM = "(anonymous namespace)::adam_kernel((anonymous namespace)::Leaves)"
K1 = ("void (anonymous namespace)::k1_train_step_kernel<tier::TierF32, 20, 0>"
      "((anonymous namespace)::Args)")
FOREACH = ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::"
           "(anonymous namespace)::TensorListMetadata<2>, ...>")


def read(view):
    return run.load_module(run.BENCH_DIR / "metrics" / "adam_fused_pct.train.py",
                           "portbench_metric_adam_fused_pct_train").read(view)


def window(steps, adam_every=1, update=ADAM):
    ops, t = [], 0.0
    for i in range(steps):
        ops.append((K1, t, t + 7e-4))
        if i % adam_every == 0:
            ops.append((update, t + 7.1e-4, t + 7.13e-4))
        t += 8e-4
    return tracing.TraceView(window_s=t, device=ops, work={"steps": steps})


def test_one_launch_a_step_reads_100():
    assert read(window(40)) == pytest.approx(100.0)


def test_missing_launches_read_less():
    assert read(window(40, adam_every=4)) == pytest.approx(25.0)


def test_nothing_without_steps_or_without_the_kernel():
    assert read(window(40, update=FOREACH)) is None
    empty = window(0)
    assert empty.device == [] and read(empty) is None
    no_count = window(5)
    no_count.work = {}
    assert read(no_count) is None
