"""``mfu_pct.train``: the training step's share of the card's f32 peak, in
%: K1's operations on every point of every step of the traced window
(``portbench/opcount.py``: 714,200 a point on the flagship) over the
window's length times the f32 peak outside the tensor cores."""

from portbench import opcount


def read(view):
    if "steps" not in view.work or not view.device:
        return None
    flops = opcount.k1_flops(view.work["sizes"], view.work["points"]) * view.work["steps"]
    return 100.0 * flops / (view.window_s * view.peaks["f32_flops_per_s"])
