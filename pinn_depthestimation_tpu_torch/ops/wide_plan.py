"""The launch plan of the kernels' wide body (``csrc/mlp_wide.cuh``).

The wide body runs K1, K2, K3 and K4 for any hidden width ``W <= 128`` and
``d_in, d_out <= 128`` (``ops/widths.py`` routes a net to it). A block of
:data:`THREADS` threads takes a tile of ``tile`` points and walks the tiles
``b, b + grid, ...`` of a fixed grid. Its shared memory holds one layer's
weights at the tier's type (``max(Wp*Wp, Ip*Wp, Wp*Op)`` of them, the sizes
rounded up to 4), the layer's bias (``R = max(Wp, Ip, Op)`` floats), the
stream buffers (two for K2, three for the walk: ``(1 + K) * R`` rows of
``tile + PAD`` floats each) and :data:`EXTRA_ROWS` rows for the epilogue.
:func:`wide_plan` takes the largest tile (a multiple of 4, at most
:data:`MAX_TILE`) that fits the block's shared memory and no larger than one
call's points spread over the SMs, so that one call fills the card where it
can. The walk's scratch is sized here: a partial row of ``n_ent`` floats per
block, and per block ``slots`` layer states of ``(1 + K) * Wp * tile``
floats: every state for K1 and K3 (``n_stack + 1``), the checkpoints, the
last state and a segment for K4 (``ceil(n_stack / C) + C``).

The plan itself needs no torch (only :meth:`WidePlan.scratch` and
:func:`card_plan` import it), so the CPU tests check that every shape the
gate takes fits, and that the wrappers pass what it says; the libraries
compute the same bytes (``<kernel>w_smem``, held to :func:`smem_bytes` by a
card test).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

THREADS = 256            # wide::kThreads
PAD = 4                  # wide::kPad: floats past a row's points
MAX_DIM = 128            # wide::kMaxDim
MAX_TILE = 256           # wide::kMaxTile
EXTRA_ROWS = 8           # wide::kExtraRows
SMEM_LIMIT = 232_448     # an H100 block's opt-in shared memory
WEIGHT_BYTES = {"f32": 4, "bf16": 2, "f32x3": 4}  # sizeof(Tier::WT)
BUFFERS = {"k2": 2, "k1": 3, "k3": 3, "k4": 3}
DEFAULT_CKPT = 8         # K4's segment length C unless asked otherwise
KERNELS = tuple(BUFFERS)


def round4(n: int) -> int:
    return (n + 3) // 4 * 4


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def smem_bytes(kernel: str, width: int, d_in: int, d_out: int, n_tangents: int, tile: int,
               precision: str) -> int:
    """``wide::smem_bytes``: the weights, the bias, the stream buffers and
    the extra rows of a tile of ``tile`` points."""
    wp, ip, op = round4(width), round4(d_in), round4(d_out)
    r, ld = max(wp, ip, op), tile + PAD
    weights = max(wp * wp, ip * wp, wp * op) * WEIGHT_BYTES[precision]
    return (_align16(weights) + _align16(r * 4) + BUFFERS[kernel] * (1 + n_tangents) * r * ld * 4
            + EXTRA_ROWS * ld * 4)


def max_tile(kernel: str, width: int, d_in: int, d_out: int, n_tangents: int, precision: str,
             smem_limit: int = SMEM_LIMIT) -> int:
    """The largest tile (a multiple of 4, at most :data:`MAX_TILE`) whose
    shared memory fits ``smem_limit``; 0 when not even 4 points fit."""
    for tile in range(MAX_TILE, 0, -4):
        if smem_bytes(kernel, width, d_in, d_out, n_tangents, tile, precision) <= smem_limit:
            return tile
    return 0


def ckpt_every(n_stack: int, requested: int = 0) -> int:
    """K4's segment length C: ``requested`` (or :data:`DEFAULT_CKPT`) cut to
    the stack depth, at least 1."""
    if requested < 0:
        raise ValueError(f"ckpt_every must be >= 0, got {requested}")
    return max(1, min(requested or DEFAULT_CKPT, n_stack))


def state_slots(kernel: str, n_stack: int, ckpt: int = 1) -> int:
    """Layer states one block keeps in the scratch (``Policy::slots``)."""
    if kernel == "k2":
        return 0
    if kernel == "k4":
        return -(-n_stack // ckpt) + ckpt
    return n_stack + 1


@dataclass(frozen=True)
class WidePlan:
    """One launch: ``grid`` blocks of :data:`THREADS` threads over ``tiles``
    tiles of ``tile`` points (the last one ragged), ``smem`` bytes of shared
    memory a block, ``slots`` states of scratch a block (segments of
    ``ckpt_every`` layers for K4)."""

    kernel: str
    n: int
    width: int
    d_in: int
    d_out: int
    n_stack: int
    n_tangents: int
    precision: str
    tile: int
    tiles: int
    grid: int
    smem: int
    ckpt_every: int
    slots: int

    def state_numel(self) -> int:
        """Floats of the state scratch."""
        return self.grid * self.slots * (1 + self.n_tangents) * round4(self.width) * self.tile

    def scratch(self, n_ent: int, device):
        """The walk's float32 buffers on ``device``: the partial rows, the
        state scratch and the output of ``n_ent`` floats."""
        import torch

        f32 = torch.float32
        return (torch.empty((self.grid, n_ent), dtype=f32, device=device),
                torch.empty((self.state_numel(),), dtype=f32, device=device),
                torch.empty((n_ent,), dtype=f32, device=device))


def wide_plan(kernel: str, n: int, width: int, d_in: int, d_out: int, n_stack: int,
              n_tangents: int, precision: str, sms: int, *, smem_limit: int = SMEM_LIMIT,
              ckpt: int = 0) -> WidePlan:
    """The plan of one launch of ``kernel`` (``'k1'``, ``'k2'``, ``'k3'`` or
    ``'k4'``) on ``n >= 1`` points; ``ckpt``: K4's requested segment length
    (0: :data:`DEFAULT_CKPT`)."""
    if (kernel not in BUFFERS or precision not in WEIGHT_BYTES or n < 1 or sms < 1
            or not 1 <= width <= MAX_DIM or not 1 <= d_in <= MAX_DIM
            or not 1 <= d_out <= MAX_DIM or n_stack < 0
            or not 0 <= n_tangents <= min(3, d_in)):
        raise ValueError(f"no wide plan for {kernel} at n={n}, sizes W={width} d_in={d_in} "
                         f"d_out={d_out} n_stack={n_stack}, K={n_tangents}, {precision!r}, "
                         f"sms={sms}")
    top = max_tile(kernel, width, d_in, d_out, n_tangents, precision, smem_limit)
    if top < 4:
        raise ValueError(f"{kernel}: not 4 points of width {width} fit {smem_limit} B of "
                         "shared memory")
    tile = max(4, min(top, round4(-(-n // sms))))
    tiles = -(-n // tile)
    c = ckpt_every(n_stack, ckpt) if kernel == "k4" else 1
    return WidePlan(kernel=kernel, n=n, width=width, d_in=d_in, d_out=d_out, n_stack=n_stack,
                    n_tangents=n_tangents, precision=precision, tile=tile, tiles=tiles,
                    grid=min(tiles, sms),
                    smem=smem_bytes(kernel, width, d_in, d_out, n_tangents, tile, precision),
                    ckpt_every=c, slots=state_slots(kernel, n_stack, c))


@functools.lru_cache(maxsize=256)
def _card_plan(kernel, n, width, d_in, d_out, n_stack, n_tangents, precision, ckpt,
               device_index) -> WidePlan:
    import torch

    props = torch.cuda.get_device_properties(device_index)
    return wide_plan(kernel, n, width, d_in, d_out, n_stack, n_tangents, precision,
                     props.multi_processor_count, ckpt=ckpt,
                     smem_limit=getattr(props, "shared_memory_per_block_optin", SMEM_LIMIT))


def card_plan(kernel: str, n: int, spec, n_tangents: int, precision: str, device,
              ckpt: int = 0) -> WidePlan:
    """The plan of one launch on the CUDA ``device`` for the net ``spec``:
    the card's SMs and shared memory. Cached: a training loop launches the
    same shapes again."""
    index = getattr(device, "index", None)
    if index is None:
        import torch

        index = torch.cuda.current_device()
    return _card_plan(kernel, n, spec.width, spec.d_in, spec.d_out, spec.n_hidden - 1,
                      n_tangents, precision, ckpt, index)
