"""``step_other_device_ms``: the device time of a training step outside K1,
in ms: every device operation of the traced window but K1's walk kernel and
its reduction (the statistics, the loss terms, Adam's update, the log's
copy), over the window's steps."""

KERNEL = r"k1_train_step_kernel"
REDUCTION = r"mlp_bwd::.*reduce_kernel"


def read(view):
    if "steps" not in view.work or not view.ops(KERNEL):
        return None
    k1 = view.seconds(view.ops(KERNEL, REDUCTION))
    return (view.seconds(view.device) - k1) / view.work["steps"] * 1e3
