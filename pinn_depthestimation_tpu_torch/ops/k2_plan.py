"""The launch plans of K2's narrow body: at f32 (:func:`f32_plan`, the
CUDA-core body of ``csrc/mlp_fwd_tangents.cu``) and at bf16 and f32x3
(:func:`k2_plan`, the tensor-core body).

The f32 body lets a point take ``lanes`` lanes (1 or 2), each owning
``ceil(W / lanes)`` of a layer's output neurons, and runs a persistent grid
of at most one block per SM walking warp tiles of ``32 / lanes`` points
warp-major, as below. :func:`f32_lanes` takes two lanes where one would
leave fewer than :data:`FILL_WARPS` warps on an SM (one where the points
fill the card anyway), the block's warps make the rounds even, and a stack
that does not fit one block's shared memory is staged in chunks into two
slots.
The library answers the most threads a block takes (``k2_f32_threads``)
and the bytes of a plan (``k2_f32_smem``); a card test holds them to
:func:`f32_max_threads` and :func:`f32_smem_bytes`.

The tensor-core body (``csrc/mlp_fwd_tangents_mma.cuh``) gives each warp a tile of
:data:`ROWS` points (the m16 of an ``mma.sync`` product) and runs a
persistent grid: one block of ``warps`` warps per SM, each block staging the
hidden stack once into shared memory; warp ``w`` of block ``b`` walks the
tiles ``w * grid + b``, then one round of ``grid * warps`` tiles later, and
so on (warp-major, so fewer tiles than warps still reach every SM). The hidden width W is padded to ``n_pad = 8 *
ceil(W / 8)`` neurons; a layer's B fragments take one 32-bit word per lane
per (column tile, half k-tile), two at f32x3, so a stack of L layers needs
``L * (n_pad / 8)**2 * 128`` bytes (twice that at f32x3). Where that does
not fit the block's shared memory the stack is staged in chunks of whole
layers. :func:`k2_plan` decides the grid, the threads, the shared-memory
bytes and the chunk; the K2 wrapper passes its grid and chunk to the
library, and the library computes the same bytes from the chunk
(``k2_mma_smem_<tier>``; a card test holds the two together).

The plans themselves need no torch (only :func:`card_plan` and
:func:`card_f32_plan` import it), so the CPU tests check them and that the
wrapper passes what they say.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

ROWS = 16                 # points per warp tile: k2mma::kRows
MAX_IN = 8                # k2mma::kMaxIn: rows of w_in staged
SMEM_LIMIT = 232_448      # an H100 block's opt-in shared memory
TIERS = ("bf16", "f32x3")


def block_warps(precision: str, width: int) -> int:
    """``k2mma::warps<Tier, W>()``: 16 warps a block at bf16, 12 at f32x3,
    four fewer at widths above 20 (their registers)."""
    return (12 if precision == "f32x3" else 16) - (4 if width > 20 else 0)


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def tiles8(width: int) -> int:
    """The 8-neuron column tiles of a width."""
    return -(-width // 8)


def n_pad(width: int) -> int:
    """The padded neurons of a layer: a multiple of 8 (the MMA's n)."""
    return 8 * tiles8(width)


def smem_bytes(width: int, chunk: int, precision: str) -> int:
    """``k2mma::smem_bytes``: ``chunk`` hidden layers of B fragments, w_in at
    the tier and the output layer's B fragments, each 16-byte aligned."""
    unit = 8 if precision == "f32x3" else 4
    t = tiles8(width)
    return (_align16(chunk * t * t * 32 * unit) + _align16(MAX_IN * 8 * t * unit)
            + _align16(t * 32 * unit))


def chunk_layers(width: int, n_stack: int, precision: str, smem_limit: int = SMEM_LIMIT) -> int:
    """The most hidden layers (at most ``n_stack``) one chunk holds within
    ``smem_limit`` bytes; 0 when not even one fits. A layer's bytes are a
    multiple of 128, so the chunk's region needs no alignment."""
    layer = smem_bytes(width, 1, precision) - smem_bytes(width, 0, precision)
    return max(0, min(n_stack, (smem_limit - smem_bytes(width, 0, precision)) // layer))


@dataclass(frozen=True)
class K2Plan:
    """One launch: ``grid`` blocks of ``threads`` threads over ``tiles``
    tiles of :data:`ROWS` points (the last one ragged), the hidden stack
    staged ``chunk`` layers at a time in ``smem`` bytes."""

    n: int
    width: int
    n_stack: int
    precision: str
    warps: int
    tiles: int
    grid: int
    chunk: int
    smem: int

    @property
    def threads(self) -> int:
        return 32 * self.warps

    @property
    def chunks(self) -> int:
        return -(-self.n_stack // self.chunk) if self.n_stack else 0


def k2_plan(n: int, width: int, n_stack: int, precision: str, sms: int, *,
            rows: int = ROWS, warps: int | None = None,
            smem_limit: int = SMEM_LIMIT) -> K2Plan:
    """The plan for ``n >= 1`` points: ``ceil(n / 16)`` tiles on
    ``min(tiles, sms)`` blocks (a persistent grid: every SM holds at most
    one block, since the stack fills its shared memory), the whole stack in
    one chunk where it fits. ``rows`` and ``warps``: what the
    library reports (by default this module's)."""
    if precision in TIERS and warps is None:
        warps = block_warps(precision, width)
    if (n < 1 or sms < 1 or precision not in TIERS or rows != ROWS or not warps
            or width % 2 or n_stack < 0):
        raise ValueError(f"no K2 plan for n={n}, width={width}, n_stack={n_stack}, "
                         f"precision={precision!r}, sms={sms}, rows={rows}, warps={warps}")
    chunk = chunk_layers(width, n_stack, precision, smem_limit)
    if n_stack and chunk < 1:
        raise ValueError(f"K2 at {precision}: not one hidden layer of width {width} fits "
                         f"{smem_limit} B of shared memory")
    tiles = -(-n // ROWS)
    return K2Plan(n=n, width=width, n_stack=n_stack, precision=precision, warps=warps,
                  tiles=tiles, grid=min(tiles, sms), chunk=chunk,
                  smem=smem_bytes(width, chunk, precision))


@functools.lru_cache(maxsize=256)
def _card_plan(lib, n: int, width: int, n_stack: int, precision: str,
               device_index: int) -> K2Plan:
    import torch

    from pinn_depthestimation_tpu_torch.ops.kernels import entry

    props = torch.cuda.get_device_properties(device_index)
    return k2_plan(n, width, n_stack, precision, props.multi_processor_count,
                   rows=lib.k2_mma_rows(), warps=entry(lib, "k2_mma_warps", precision)(),
                   smem_limit=getattr(props, "shared_memory_per_block_optin", SMEM_LIMIT))


def card_plan(lib, n: int, width: int, n_stack: int, precision: str, device) -> K2Plan:
    """The plan of one launch from the width's library ``lib`` on the CUDA
    ``device``: the library's tile and warps, the card's SMs and shared
    memory. Cached: a training loop launches the same shapes again."""
    index = getattr(device, "index", None)
    if index is None:
        import torch

        index = torch.cuda.current_device()
    return _card_plan(lib, n, width, n_stack, precision, index)


# ------------------------------------------------------------ the f32 body

F32_LANES = (1, 2)        # lanes a point may take: k2f32::lanes_ok
FILL_WARPS = 8            # warps per SM below which the f32 plan takes two lanes a point
MAX_OUT = 8               # k2f32::kMaxOut
MAX_TANGENTS = 3
MAX_WIDTH = 32            # the narrow body's widest compiled width


def _ceil4(n: int) -> int:
    return (n + 3) // 4 * 4


def f32_cols(width: int, lanes: int) -> int:
    """``k2f32::cols``: the output neurons a lane owns (the compiled widths
    are even)."""
    return width // lanes


def f32_block_floats(width: int, lanes: int) -> int:
    """``k2f32::block_floats``: a lane's columns of every row, padded to 16 B
    and, for ``lanes > 1``, to an odd number of 16-byte words (the group's
    lanes read the same word of their blocks at once: distinct banks)."""
    n = _ceil4(width * f32_cols(width, lanes))
    return n if lanes == 1 or (n // 4) % 2 else n + 4


def f32_layer_floats(width: int, lanes: int) -> int:
    """``k2f32::layer_floats``: a hidden layer's lane blocks, then its biases."""
    return lanes * f32_block_floats(width, lanes) + _ceil4(width)


def f32_max_threads(width: int, lanes: int, n_tangents: int) -> int:
    """``k2f32::max_threads``: the block's ``__launch_bounds__`` at an
    estimate of ``(2 or 3) * (1 + K) * cols + 48`` registers a thread (3 at
    two lanes: the partner's inputs), rounded up to 8: four schedulers of
    16,384 registers each hold ``4 * (512 // regs)`` warps; between 256 and
    1,024 threads."""
    regs = ((3 if lanes > 1 else 2) * (1 + n_tangents) * f32_cols(width, lanes) + 48 + 7) // 8 * 8
    return min(1024, max(256, 128 * (512 // regs)))


def f32_smem_bytes(width: int, lanes: int, chunk: int, slots: int) -> int:
    """``k2f32::smem_bytes``: w_in, b_in, w_out and b_out, each 16-byte
    aligned, then ``slots`` slots of ``chunk`` hidden layers."""
    fixed = (_align16(MAX_IN * width * 4) + _align16(width * 4)
             + _align16(width * MAX_OUT * 4) + _align16(MAX_OUT * 4))
    return fixed + slots * chunk * f32_layer_floats(width, lanes) * 4


def f32_lanes(n: int, n_tangents: int, sms: int) -> int:
    """Two lanes a point where one lane a point leaves fewer than
    :data:`FILL_WARPS` warps (two a scheduler) on each of ``sms`` SMs, at
    K <= 2; one otherwise. At K = 3 the exchange of four streams costs more
    than the extra warps buy (the legacy shape: ``PERF.md``)."""
    return 2 if n < FILL_WARPS * 32 * sms and n_tangents < 3 else 1


def f32_chunk(width: int, lanes: int, n_stack: int,
              smem_limit: int = SMEM_LIMIT) -> tuple[int, int]:
    """``(chunk, slots)``: the whole stack in one slot where it fits, else
    the most layers two slots of equal size hold; ``(0, ...)`` when not one
    layer fits two slots."""
    if f32_smem_bytes(width, lanes, n_stack, 1) <= smem_limit:
        return n_stack, 1
    layer = f32_layer_floats(width, lanes) * 4
    return max(0, (smem_limit - f32_smem_bytes(width, lanes, 0, 0)) // (2 * layer)), 2


@dataclass(frozen=True)
class F32Plan:
    """One f32 launch: ``grid`` blocks of ``warps`` warps over ``tiles``
    warp tiles of ``32 / lanes`` points (the last one ragged), walked in
    ``rounds`` rounds warp-major; the hidden stack in ``slots`` slots of
    ``chunk`` layers, ``smem`` bytes."""

    n: int
    width: int
    n_stack: int
    n_tangents: int
    lanes: int
    tiles: int
    grid: int
    warps: int
    rounds: int
    chunk: int
    slots: int
    smem: int

    @property
    def threads(self) -> int:
        return 32 * self.warps

    @property
    def points_per_tile(self) -> int:
        return 32 // self.lanes

    @property
    def chunks(self) -> int:
        return -(-self.n_stack // self.chunk) if self.n_stack else 0


def f32_plan(n: int, width: int, n_stack: int, n_tangents: int, sms: int, *,
             lanes: int | None = None, max_threads: int | None = None,
             smem_limit: int = SMEM_LIMIT) -> F32Plan:
    """The plan for ``n >= 1`` points at ``n_tangents`` tangents (2 for the
    epilogue): ``lanes`` by :func:`f32_lanes` unless given (the card tests
    force each), ``ceil(n / (32 / lanes))`` tiles on ``min(tiles, sms)``
    blocks, the fewest rounds the block's ``max_threads`` allow (the
    library's, by default this module's) with the warps that make them even,
    and the stack's chunks (:func:`f32_chunk`)."""
    if lanes is None and n >= 1 and sms >= 1:
        lanes = f32_lanes(n, n_tangents, sms)
    if (n < 1 or sms < 1 or lanes not in F32_LANES or not 2 <= width <= MAX_WIDTH or width % 2
            or n_stack < 0 or not 0 <= n_tangents <= MAX_TANGENTS):
        raise ValueError(f"no K2 f32 plan for n={n}, width={width}, n_stack={n_stack}, "
                         f"n_tangents={n_tangents}, sms={sms}, lanes={lanes}")
    if max_threads is None:
        max_threads = f32_max_threads(width, lanes, n_tangents)
    if max_threads < 32:
        raise ValueError(f"K2 at f32: the library takes no block of {lanes} lanes a point")
    chunk, slots = f32_chunk(width, lanes, n_stack, smem_limit)
    if n_stack and chunk < 1:
        raise ValueError(f"K2 at f32: not one hidden layer of width {width} fits two slots of "
                         f"{smem_limit} B of shared memory")
    tiles = -(-n // (32 // lanes))
    grid = min(tiles, sms)
    rounds = -(-tiles // (grid * (max_threads // 32)))
    warps = -(-tiles // (grid * rounds))
    return F32Plan(n=n, width=width, n_stack=n_stack, n_tangents=n_tangents, lanes=lanes,
                   tiles=tiles, grid=grid, warps=warps, rounds=-(-tiles // (grid * warps)),
                   chunk=chunk, slots=slots, smem=f32_smem_bytes(width, lanes, chunk, slots))


@functools.lru_cache(maxsize=256)
def _card_f32_plan(lib, n: int, width: int, n_stack: int, n_tangents: int,
                   lanes: int | None, device_index: int) -> F32Plan:
    import torch

    props = torch.cuda.get_device_properties(device_index)
    sms = props.multi_processor_count
    lanes = f32_lanes(n, n_tangents, sms) if lanes is None else lanes
    return f32_plan(n, width, n_stack, n_tangents, sms, lanes=lanes,
                    max_threads=lib.k2_f32_threads(lanes, n_tangents),
                    smem_limit=getattr(props, "shared_memory_per_block_optin", SMEM_LIMIT))


def card_f32_plan(lib, n: int, width: int, n_stack: int, n_tangents: int, device,
                  lanes: int | None = None) -> F32Plan:
    """The f32 plan of one launch from the width's library ``lib`` on the
    CUDA ``device``: the library's threads a block, the card's SMs and
    shared memory; ``lanes`` forces the lanes a point. Cached, as
    :func:`card_plan`."""
    index = getattr(device, "index", None)
    if index is None:
        import torch

        index = torch.cuda.current_device()
    return _card_f32_plan(lib, n, width, n_stack, n_tangents, lanes, index)
