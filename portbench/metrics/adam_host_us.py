"""``adam_host_us``: the host's time in Adam's update a step, in us: the
program's ``step#adam`` spans (``optimizer.step()`` and
``scheduler.step()`` in ``Trainer._adam_steps``) over the traced window's
steps. Nothing where the program records no such span."""


def read(view):
    steps = view.work.get("steps")
    try:
        from pinn_depthestimation_tpu_torch.tracing import summary
    except ImportError:  # a program without spans of its own
        return None
    s = summary().get("step#adam")
    if not steps or s is None:
        return None
    return 1e6 * s["total_s"] / steps
