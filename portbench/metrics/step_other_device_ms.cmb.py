"""``step_other_device_ms.cmb``: the device time of a CMB training step
outside its hand-written kernels, in ms: every device operation of the
traced window but K2's f32 kernel, K3's f32 walk and the reduction of its
partial rows, and Adam's update, matched by name, over the window's steps.
What is left is the wave-averaged physics, the loss and their autograd
backward in PyTorch's own kernels, with the copies and fills. Nothing when
the trace holds no f32 K3 or the cell has no fidelity rows of its own."""

K3 = r"cotangent_walk_kernel<.*TierF32"
OURS = (r"k2_f32_kernel", K3, r"mlp_bwd::.*reduce_kernel", r"::adam_kernel\(")


def read(view):
    if "rows" not in view.work or not view.work.get("steps") or not view.ops(K3):
        return None
    ours = view.seconds(view.ops(*OURS))
    return (view.seconds(view.device) - ours) / view.work["steps"] * 1e3
