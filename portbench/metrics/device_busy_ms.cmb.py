"""``device_busy_ms.cmb``: the device's busy time a CMB training step, in
ms: the union of the traced window's device operations
(``portbench/tracing.py``) over its steps. The untraced ``train_step_ms``
less this is the step's idle time: the gaps between the graph's kernels
and the block's end. Nothing when the trace holds no f32 K3 or the cell
has no fidelity rows of its own."""

K3 = r"cotangent_walk_kernel<.*TierF32"


def read(view):
    if "rows" not in view.work or not view.work.get("steps") or not view.ops(K3):
        return None
    return view.busy_s() / view.work["steps"] * 1e3
