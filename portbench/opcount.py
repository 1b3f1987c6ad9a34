"""Operations and bytes of the port's kernels, computed from shapes.

Copied from the arithmetic of ``chip_smoke.py`` (``k1_flops``,
``k1_bytes``, ``k2_flops``, ``k2_bytes``), so that the yardstick lives
with the benchmark. ``sizes`` is the net's ``[d_in, W, ..., W, d_out]``.
tanh is not counted; each input byte is read once and each output byte
written once.
"""

from __future__ import annotations


def _shape(sizes):
    d_in, d_out = sizes[0], sizes[-1]
    width, n_stack = sizes[1], len(sizes) - 3
    return d_in, width, n_stack, d_out


def n_params(sizes) -> int:
    return sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))


def k1_flops(sizes, n_points: int) -> float:
    """K1, the one-kernel training step: the forward with two tangents,
    ``2*(d_in*W + (L-1)*W^2 + W*d_out)*3`` a point, and the backward,
    ``2*2*3*((L-1)*W^2 + W*d_out) + 2*d_in*W`` a point. 714,200 a point
    on 2->[20]x100->3."""
    d_in, W, n_stack, d_out = _shape(sizes)
    fwd = 2 * (d_in * W + n_stack * W * W + W * d_out) * 3
    bwd = 2 * 2 * 3 * (n_stack * W * W + W * d_out) + 2 * d_in * W
    return float(n_points) * (fwd + bwd)


def k1_bytes(sizes, n_points: int, n_true: int = 2) -> float:
    """K1 reads the points, the trues, the selector, the mask and the
    weights, and writes the gradients and eight statistics."""
    d_in = sizes[0]
    return float(2 * n_params(sizes) * 4 + 8 * 4 + n_points * (d_in + n_true + 2) * 4)


def k2_flops(sizes, n_points: int, n_tangents: int, epilogue: bool) -> float:
    """K2, the forward with ``n_tangents`` coordinate tangents:
    ``2*(d_in*W + (L-1)*W^2 + W*d_out)*(1+K)`` a point, and 7 more for the
    continuity epilogue. 238,207 a point on 2->[20]x100->3 at K=2 with the
    epilogue."""
    d_in, W, n_stack, d_out = _shape(sizes)
    per_point = 2 * (d_in * W + n_stack * W * W + W * d_out) * (1 + n_tangents)
    return float(n_points) * (per_point + (7 if epilogue else 0))


def k2_bytes(sizes, n_points: int, out_floats_per_point: int) -> float:
    """K2 reads the points and the weights and writes its outputs."""
    return float(n_params(sizes) * 4 + n_points * (sizes[0] + out_floats_per_point) * 4)
