"""``host_step_ms.train``: the host's time to issue one training step, in
ms: the program's ``trainer#dispatch`` spans (``Trainer.train_adam``
issuing a block's steps, no wait for the device) over the traced window's
steps. Beside the device's busy time a step it says which of the two
paces the step. Nothing where the program records no such span."""


def read(view):
    steps = view.work.get("steps")
    try:
        from pinn_depthestimation_tpu_torch.tracing import summary
    except ImportError:  # a program without spans of its own
        return None
    s = summary().get("trainer#dispatch")
    if not steps or s is None:
        return None
    return 1e3 * s["total_s"] / steps
