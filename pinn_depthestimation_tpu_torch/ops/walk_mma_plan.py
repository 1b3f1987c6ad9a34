"""The plan of the backward walk's tensor-core body (K1, K3 and K4 at the
bf16 and f32x3 tiers, ``csrc/mlp_bwd_mma.cuh``).

The body keeps the lane-pair walk's launch (``ops/walk_plan.py``: a tile of
``tile`` points on ``2 * tile`` threads, i.e. ``tile / 16`` warps of 16
points, the m16 of ``mma.sync``) and its state scratch (a warp's 16 points
take ``S * W * 16`` floats of a state, :func:`state_f4`). What it sizes on
its own is its shared memory: the staging rows of the weight gradient, the
reduction buffer, K4's segment buffer and the hidden layers' weight images
in fragment order, ``T^2 * 128`` bytes a layer and direction (``T =
ceil(W / 8)``; twice that at f32x3). :func:`plan` keeps both directions of
the whole stack resident where they fit (two regions), else (StoreAll) one
region of the most layers that fit, staged forward then backward; a
Rebuild walk (K4) keeps two regions of a multiple of its segment length C.

This module is a copy of the C side's plan (``mlp_bwd::mma::plan``,
``smem_bytes``); the libraries answer their own chunk, regions and bytes
(``<kernel>_chunk_layers_<tier>``, ``<kernel>_mma_regions_<tier>``,
``<kernel>_mma_smem_<tier>``, ``k4_ckpt_every_<tier>``) and a card test
holds them to this module. It needs no torch, so the CPU tests check the
plan (``tests/test_torch_walk_mma_plan.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

LANES = 2                 # mlp_bwd::kLanes: threads per point of a tile
ROWS = 16                 # mlp_bwd::mma::kRows: points per warp
MAX_IN = 8                # mlp_bwd::kMaxIn
SQUARE_RED = 3456         # mlp_bwd::kSquareRed
MAX_AUTO_CKPT = 8         # mlp_bwd::mma::kMaxAutoCkpt
SMEM_LIMIT = 232_448      # an H100 block's opt-in shared memory
MAX_OUT = {"k1": 3, "k3": 8, "k4": 8}  # the epilogues' kMaxOut
TIERS = ("bf16", "f32x3")


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def tiles8(width: int) -> int:
    """The 8-neuron column tiles of a padded layer."""
    return -(-width // 8)


def unit_bytes(precision: str) -> int:
    """Bytes of one fragment word: a bf16x2, a (hi, lo) pair at f32x3."""
    return 8 if precision == "f32x3" else 4


def layer_bytes(width: int, precision: str) -> int:
    """One hidden layer's image in one direction: ``T^2 * 128`` bytes,
    twice that at f32x3."""
    return tiles8(width) ** 2 * 32 * unit_bytes(precision)


def stage_ld(tile: int) -> int:
    """``mlp_bwd::stage_ld``: floats between two staging rows, 4 mod 32."""
    return tile + 4 if tile % 32 == 0 else tile + 20


def max_tile(width: int, precision: str) -> int:
    """``mlp_bwd::max_tile``: the most points of a tile."""
    return 160 if width <= 10 and precision != "f32x3" else 128


def _square_ri(w: int) -> int:
    return 4 if w % 4 == 0 else (5 if w % 5 == 0 else 2)


def _square_rj(w: int) -> int:
    return 5 if w % 5 == 0 else (4 if w % 4 == 0 else 2)


def _splits(items: int, threads: int) -> int:
    return threads // items if items < threads else 1


def square_splits(width: int, streams: int, tile: int) -> int:
    """``mlp_bwd::square_splits``: the ranges of the bf16 tier's weight
    gradient (``accum_square``) on ``2 * tile`` threads."""
    threads = LANES * tile
    tiles = (width // _square_ri(width)) * (width // _square_rj(width))
    steps = streams * (tile // 4)
    fit = SQUARE_RED // (width * width + width)
    by_threads = _splits(tiles, threads)
    most = by_threads if by_threads < fit else (fit if fit > 0 else 1)
    q = -(-steps // most)
    return -(-steps // q)


def red_floats(width: int, streams: int, tile: int, max_out: int, precision: str) -> int:
    """Floats of the reduction buffer: the bound of ``accum_rect``'s ranges
    and, at bf16, ``accum_square``'s, the larger. The f32x3 hidden layers'
    slots (one ``W*W + W`` per warp, :func:`f32x3_slot_floats`) take the
    staging blocks instead."""
    rect = max(2 * LANES * tile, (MAX_IN + 1) * width, (max_out + 1) * width)
    square = 0 if precision == "f32x3" else square_splits(width, streams, tile)
    return max(square * (width * width + width), rect)


def f32x3_slot_floats(width: int, tile: int) -> int:
    """The f32x3 weight gradient's slots: one ``W*W + W`` per warp."""
    return tile // ROWS * (width * width + width)


def staging_floats(width: int, streams: int, tile: int) -> int:
    """The two staging blocks, ``S * W`` rows each, contiguous."""
    return 2 * streams * width * stage_ld(tile)


def smem_bytes(width: int, streams: int, max_out: int, chunk: int, regions: int,
               precision: str, seg: int, tile: int) -> int:
    """``mlp_bwd::mma::smem_bytes``: two staging blocks of ``S * W`` rows,
    the reduction buffer, ``seg`` states of K4's segment buffer, ``regions``
    regions of ``chunk`` layers' images, w_in at the tier and the output
    layer's two images; each region 16-byte aligned."""
    u, t = unit_bytes(precision), tiles8(width)
    return (2 * _align16(streams * width * stage_ld(tile) * 4)
            + _align16(red_floats(width, streams, tile, max_out, precision) * 4)
            + _align16(seg * streams * width * tile * 4)
            + _align16(regions * chunk * layer_bytes(width, precision))
            + _align16(MAX_IN * 8 * t * u) + 2 * _align16(t * 32 * u))


def fit_layers(width: int, streams: int, max_out: int, n_stack: int, regions: int,
               precision: str, seg: int, tile: int, limit: int = SMEM_LIMIT) -> int:
    """The most layers (at most ``n_stack``) each of ``regions`` regions
    holds beside the rest; 0 when not one does."""
    rest = smem_bytes(width, streams, max_out, 0, regions, precision, seg, tile)
    if rest > limit:
        return 0
    return min(n_stack, (limit - rest) // (regions * layer_bytes(width, precision)))


@dataclass(frozen=True)
class Plan:
    """One launch: K4's segment length (0 for K1, K3), the layers of an
    image region, the regions (2: a forward and a backward one) and the
    shared-memory bytes."""

    ckpt: int
    chunk: int
    regions: int
    smem: int

    def chunks(self, n_stack: int) -> int:
        return -(-n_stack // self.chunk) if n_stack else 0


def _rebuild_chunk(width, streams, max_out, n_stack, precision, c, tile, limit) -> int:
    f = fit_layers(width, streams, max_out, n_stack, 2, precision, c, tile, limit)
    return n_stack if f >= n_stack else f - f % c


def plan(kernel: str, width: int, n_stack: int, n_tangents: int, precision: str, tile: int,
         ckpt: int = 0, limit: int = SMEM_LIMIT) -> Plan | None:
    """``mlp_bwd::mma::plan`` for ``kernel`` (``'k1'``, ``'k3'`` or
    ``'k4'``): K1 and K3 keep both directions of the whole stack where they
    fit, else one region of the most layers that fit; K4 takes two regions
    and ``ckpt`` (cut to the stack) or, with 0, the largest C <= 8 that
    leaves the whole stack in them, else half of it, else one layer, its
    regions a multiple of C. None when nothing fits."""
    if precision not in TIERS:
        raise ValueError(f"the tensor-core walk runs bf16 and f32x3, not {precision!r}")
    streams, max_out = 1 + n_tangents, MAX_OUT[kernel]
    args = (width, streams, max_out)

    def made(c: int, chunk: int, regions: int) -> Plan:
        return Plan(c, chunk, regions,
                    smem_bytes(*args, chunk, regions, precision, c, tile))

    if kernel != "k4":
        if n_stack <= 0:
            p = made(0, 0, 1)
            return p if p.smem <= limit else None
        regions = 2 if fit_layers(*args, n_stack, 2, precision, 0, tile, limit) >= n_stack else 1
        chunk = fit_layers(*args, n_stack, regions, precision, 0, tile, limit)
        return made(0, chunk, regions) if chunk >= 1 else None
    if n_stack <= 0:
        p = made(1, 0, 2)
        return p if p.smem <= limit else None
    if ckpt > 0:
        c = min(ckpt, n_stack)
        chunk = _rebuild_chunk(*args, n_stack, precision, c, tile, limit)
        return made(c, chunk, 2) if chunk >= 1 else None
    top = min(MAX_AUTO_CKPT, n_stack)
    for need in (n_stack, (n_stack + 1) // 2, 1):
        for c in range(top, 0, -1):
            chunk = _rebuild_chunk(*args, n_stack, precision, c, tile, limit)
            if chunk >= need:
                return made(c, chunk, 2)
    return None


def state_f4(width: int, stream: int, tile_j: int, lane: int) -> int | None:
    """``mlp_bwd::mma::state_f4``: where lane ``(g, q) = (lane // 4, lane
    % 4)`` keeps its float4 (rows g, g + 8 of neurons 8j + 2q, 8j + 2q + 1)
    of column tile ``tile_j`` of stream ``stream`` in its warp's ``S * W *
    16`` floats of a state, in float4 units; None for a padded pair."""
    g, q = lane // 4, lane % 4
    qj = min(4, width // 2 - 4 * tile_j)
    return stream * 4 * width + 32 * tile_j + g * qj + q if q < qj else None
