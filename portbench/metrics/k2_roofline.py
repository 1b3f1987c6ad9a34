"""``k2_roofline``: K2's share of its roofline, in %, with the continuity
epilogue (one output a point).

The least time the card could take for one call on the cell's points (the
larger of K2's operations over the f32 peak outside the tensor cores and
its bytes over the HBM bandwidth, ``portbench/opcount.py``), over K2's mean
device time a launch, matched by name in the trace. Nothing when the trace
holds no f32 K2 (the cheap tiers' kernels run on the tensor cores, whose
peak this bound does not use) or the cell makes no residual calls."""

from portbench import opcount

KERNEL = "k2_f32_kernel"


def read(view):
    launches = view.ops(KERNEL)
    if not launches or "calls" not in view.work:
        return None
    sizes, n = view.work["sizes"], view.work["points"]
    bound = max(opcount.k2_flops(sizes, n, 2, True) / view.peaks["f32_flops_per_s"],
                opcount.k2_bytes(sizes, n, 1) / view.peaks["hbm_bytes_per_s"])
    return 100.0 * bound / (view.seconds(launches) / len(launches))
