"""``k1_host_us``: the host's time in one call of the K1 wrapper, in us:
the program's ``step#k1`` spans (the whole of
``ops/kernels_step.py::fused_loss_and_grad``: the parameters to each shard,
the plan, the launch, the statistics, ``unflatten``) over their count.
Nothing where the program records no such span."""


def read(view):
    if "steps" not in view.work:
        return None
    try:
        from pinn_depthestimation_tpu_torch.tracing import summary
    except ImportError:  # a program without spans of its own
        return None
    s = summary().get("step#k1")
    if s is None:
        return None
    return 1e6 * s["total_s"] / s["count"]
