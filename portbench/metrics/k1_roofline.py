"""``k1_roofline``: K1's share of its roofline, in %.

The least time the card could take for one launch of K1 on the cell's
points (the larger of its operations over the f32 peak outside the tensor
cores and its bytes over the HBM bandwidth, ``portbench/opcount.py``), over
K1's mean device time a launch: its f32 walk kernel and the reduction of
its partial rows, matched by name in the trace. Nothing when the trace
holds no f32 K1 (the cheap tiers' kernels run on the tensor cores, whose
peak this bound does not use)."""

from portbench import opcount

KERNEL = r"k1_train_step_kernel<"
REDUCTION = r"mlp_bwd::.*reduce_kernel"


def read(view):
    launches = view.ops(KERNEL)
    if not launches or "points" not in view.work:
        return None
    sizes, n = view.work["sizes"], view.work["points"]
    bound = max(opcount.k1_flops(sizes, n) / view.peaks["f32_flops_per_s"],
                opcount.k1_bytes(sizes, n) / view.peaks["hbm_bytes_per_s"])
    per_launch = view.seconds(launches + view.ops(REDUCTION)) / len(launches)
    return 100.0 * bound / per_launch
