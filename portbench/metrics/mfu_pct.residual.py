"""``mfu_pct.residual``: residual evaluation's share of the card's f32 peak,
in %: K2's operations with the continuity epilogue on every point of every
call of the traced window (``portbench/opcount.py``: 238,207 a point on
the flagship net) over the window's length times the f32 peak outside the
tensor cores."""

from portbench import opcount


def read(view):
    if "calls" not in view.work or not view.device:
        return None
    flops = opcount.k2_flops(view.work["sizes"], view.work["points"], 2, True) * view.work["calls"]
    return 100.0 * flops / (view.window_s * view.peaks["f32_flops_per_s"])
