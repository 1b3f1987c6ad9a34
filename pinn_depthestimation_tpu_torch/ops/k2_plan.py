"""The launch plan of K2 at the bf16 and f32x3 tiers (the tensor-core body).

The body (``csrc/mlp_fwd_tangents_mma.cuh``) gives each warp a tile of
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

The plan itself needs no torch (only :func:`card_plan` imports it), so the
CPU tests check it and that the wrapper passes what it says.
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
