"""Operations and bytes of K3, the fused MLP backward, computed from shapes.

Copied from the arithmetic of ``chip_smoke.py`` (``k3_flops``,
``k3_bytes``) beside ``portbench/opcount.py``. ``sizes`` is the net's
``[d_in, W, ..., W, d_out]``; tanh is not counted; each input byte is read
once and each output byte written once.
"""

from __future__ import annotations

from portbench.opcount import _shape, n_params


def k3_flops(sizes, n_points: int, n_tangents: int) -> float:
    """K3 on ``n_points`` points with ``n_tangents`` coordinate tangents:
    the forward replay, ``2*(d_in*W + (L-1)*W^2 + W*d_out)*(1+K)`` a point,
    and the backward, ``2*2*(1+K)*((L-1)*W^2 + W*d_out) + 2*d_in*W`` a
    point. 17,440 a point on 2->[10]x10->6 at K=2."""
    d_in, W, n_stack, d_out = _shape(sizes)
    fwd = 2 * (d_in * W + n_stack * W * W + W * d_out) * (1 + n_tangents)
    bwd = 2 * 2 * (1 + n_tangents) * (n_stack * W * W + W * d_out) + 2 * d_in * W
    return float(n_points) * (fwd + bwd)


def k3_bytes(sizes, n_points: int, n_tangents: int) -> float:
    """K3 reads the points, the output cotangents and the weights, and
    writes the gradients."""
    d_in, d_out = sizes[0], sizes[-1]
    return float(2 * n_params(sizes) * 4 + n_points * (d_in + (1 + n_tangents) * d_out) * 4)
