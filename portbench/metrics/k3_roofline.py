"""``k3_roofline``: K3's share of its roofline, in %, in a step of the CMB
pipeline, whose backward runs K3 twice: on the residual points with two
coordinate tangents and on the fidelity rows with none.

The least time the card could take for the two launches (for each, the
larger of its operations over the f32 peak outside the tensor cores and its
bytes over the HBM bandwidth, ``portbench/opcount_k3.py``), over K3's mean
device time a pair of launches: its f32 walk kernel and the reduction of its
partial rows, matched by name in the trace. Nothing when the trace holds no
f32 K3 or the cell has no fidelity rows of its own."""

from portbench import opcount_k3

KERNEL = r"cotangent_walk_kernel<.*TierF32"
REDUCTION = r"mlp_bwd::.*reduce_kernel"


def read(view):
    launches = view.ops(KERNEL)
    if not launches or "rows" not in view.work:
        return None
    sizes, peaks = view.work["sizes"], view.peaks
    bound = sum(max(opcount_k3.k3_flops(sizes, n, k) / peaks["f32_flops_per_s"],
                    opcount_k3.k3_bytes(sizes, n, k) / peaks["hbm_bytes_per_s"])
                for n, k in ((view.work["points"], 2), (view.work["rows"], 0)))
    per_pair = view.seconds(launches + view.ops(REDUCTION)) / (len(launches) / 2)
    return 100.0 * bound / per_pair
