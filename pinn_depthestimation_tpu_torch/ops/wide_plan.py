"""The launch plan of the kernels' wide body (``csrc/mlp_wide.cuh``).

The wide body runs K1, K2, K3 and K4 for any hidden width ``W <= 128`` and
``d_in, d_out <= 128`` (``ops/widths.py`` routes a net to it). A block of
:data:`THREADS` threads (8 warps) takes a tile of ``tile`` points (a
multiple of :data:`QUANTUM`) and walks the tiles ``b, b + grid, ...`` of a
fixed grid, one block per SM. The sizes round up to 16 (``Wp``, ``Ip``,
``Op``; ``R`` their largest), a buffer row holds ``tile + PAD`` floats (an
odd number of 16-byte words, so that the loads of 4 or 8 consecutive rows
meet distinct banks: ``tests/test_torch_wide_plan.py`` counts them), and the shared memory
holds two weight slots (the larger k-half of any layer's image at the
tier's type, :func:`slot_bytes`), the staged bias (``R`` floats) and the
stream buffers (two for K2, three for the walk: ``(1 + K) * R`` rows each).

The weights reach the kernel as images, one per layer and direction at the
tier's type, made once per launch into a scratch of :func:`image_bytes`
(forward images only for K2).

:func:`wide_plan` chooses the tile for balance: among the tiles that fit
the shared memory and let one product's work spread over the block in one
round (``(R / 4) * (tile / 4) <= 256`` thread tiles of the f32 product,
``ceil(R / 32) * (tile / 16) <= 8`` warp tiles of the tensor-core one), the
one with the least ``rounds * (tile + QUANTUM)``, ``rounds`` the tiles per
SM rounded up (a tile's fixed costs count as 16 more points); ties go to
the larger tile. The walk's scratch is sized here: a partial row of
``n_ent`` floats per block, and per block ``slots`` layer states of ``(1 +
K) * Wp * tile`` floats: every state for K1 and K3 (``n_stack + 1``), the
checkpoints, the last state and a segment for K4 (``ceil(n_stack / C) +
C``).

The plan itself needs no torch (only :meth:`WidePlan.scratch` and
:func:`card_plan` import it), so the CPU tests check that every shape the
gate takes fits, the balance, the banks and that the wrappers pass what it
says; the libraries compute the same bytes (``<kernel>w_smem``,
``<kernel>w_image_bytes``, held to :func:`smem_bytes` and
:func:`image_bytes` by a card test).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

THREADS = 256            # wide::kThreads
WARPS = THREADS // 32
PAD = 4                  # wide::kPad: floats past a row's points
QUANTUM = 16             # wide::kRound: rows and tiles round to this
MAX_DIM = 128            # wide::kMaxDim
MAX_TILE = 256           # wide::kMaxTile
SMEM_LIMIT = 232_448     # an H100 block's opt-in shared memory
WEIGHT_BYTES = {"f32": 4, "bf16": 2, "f32x3": 4}  # sizeof(Tier::WT)
BUFFERS = {"k2": 2, "k1": 3, "k3": 3, "k4": 3}
BLOCKS_PER_SM = 1        # __launch_bounds__(kThreads, 1): up to 255 registers a thread
DEFAULT_CKPT = 8         # K4's segment length C unless asked otherwise
KERNELS = tuple(BUFFERS)


def round16(n: int) -> int:
    """``n`` rounded up to 16 (a size, or bytes to a 16-byte boundary)."""
    return (n + 15) // 16 * 16


def padded(width: int, d_in: int, d_out: int) -> tuple[int, int, int, int]:
    """``(Wp, Ip, Op, R)``: the sizes rounded up to 16 and their largest."""
    wp, ip, op = round16(width), round16(d_in), round16(d_out)
    return wp, ip, op, max(wp, ip, op)


def _chunk0_ktiles(kp: int) -> int:
    return (kp // 16 + 1) // 2


def slot_bytes(width: int, d_in: int, d_out: int, precision: str) -> int:
    """``wide::slot_elems`` at the tier: the larger k-half (chunk 0) of any
    layer image (input, hidden, output and its transpose)."""
    wp, ip, op, _ = padded(width, d_in, d_out)
    shapes = ((ip, wp), (wp, wp), (wp, op), (op, wp))  # (Kp, Mp)
    return max(16 * _chunk0_ktiles(kp) * mp for kp, mp in shapes) * WEIGHT_BYTES[precision]


def smem_bytes(kernel: str, width: int, d_in: int, d_out: int, n_tangents: int, tile: int,
               precision: str) -> int:
    """``wide::smem_bytes``: two weight slots, the bias, the stream buffers
    of a tile of ``tile`` points."""
    *_, r = padded(width, d_in, d_out)
    return (2 * round16(slot_bytes(width, d_in, d_out, precision)) + round16(r * 4)
            + BUFFERS[kernel] * (1 + n_tangents) * r * (tile + PAD) * 4)


def image_bytes(kernel: str, width: int, d_in: int, d_out: int, n_stack: int,
                precision: str) -> int:
    """``wide::image_bytes``: the layers' weight images of one launch (the
    forward ones, and for a walk the transposed ones), each the largest
    layer's weights at the tier and ``R`` floats of bias."""
    wp, ip, op, r = padded(width, d_in, d_out)
    stride = (round16(max(wp * wp, ip * wp, wp * op) * WEIGHT_BYTES[precision])
              + round16(r * 4))
    images = n_stack + 2 if kernel == "k2" else 2 * n_stack + 3
    return images * stride


def one_round(width: int, d_in: int, d_out: int, tile: int) -> bool:
    """Whether a product's work at this tile takes one round of the block:
    the f32 product's thread tiles (4 rows x 4 points) and the tensor-core
    product's warp tiles (32 rows x 16 points) of the largest layer."""
    *_, r = padded(width, d_in, d_out)
    return (r // 4) * (tile // 4) <= THREADS and -(-r // 32) * (tile // 16) <= WARPS


def tiles_that_fit(kernel: str, width: int, d_in: int, d_out: int, n_tangents: int,
                   precision: str, smem_limit: int = SMEM_LIMIT) -> list[int]:
    """The tiles a launch may take: multiples of 16 up to :data:`MAX_TILE`
    whose shared memory fits and whose products take one round."""
    return [t for t in range(QUANTUM, MAX_TILE + 1, QUANTUM)
            if smem_bytes(kernel, width, d_in, d_out, n_tangents, t, precision) <= smem_limit
            and one_round(width, d_in, d_out, t)]


def max_tile(kernel: str, width: int, d_in: int, d_out: int, n_tangents: int, precision: str,
             smem_limit: int = SMEM_LIMIT) -> int:
    """The largest tile :func:`tiles_that_fit` allows; 0 when none does."""
    fit = tiles_that_fit(kernel, width, d_in, d_out, n_tangents, precision, smem_limit)
    return max(fit, default=0)


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
    """One launch: ``grid`` blocks of :data:`THREADS` threads, one a SM
    (:data:`BLOCKS_PER_SM`), over ``tiles`` tiles of ``tile`` points (the last
    one ragged) in ``rounds`` rounds, ``smem`` bytes of shared memory a
    block, ``slots`` states of scratch a block (segments of ``ckpt_every``
    layers for K4), ``image`` bytes of weight images."""

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
    rounds: int
    smem: int
    image: int
    ckpt_every: int
    slots: int

    def state_numel(self) -> int:
        """Floats of the state scratch."""
        return self.grid * self.slots * (1 + self.n_tangents) * round16(self.width) * self.tile

    def scratch(self, n_ent: int, device):
        """The launch's buffers on ``device``: the weight images (bytes),
        and for a walk (``n_ent`` > 0) the float32 partial rows, the state
        scratch and the output of ``n_ent`` floats."""
        import torch

        image = torch.empty((self.image,), dtype=torch.uint8, device=device)
        if not n_ent:
            return image
        f32 = torch.float32
        return (image, torch.empty((self.grid, n_ent), dtype=f32, device=device),
                torch.empty((self.state_numel(),), dtype=f32, device=device),
                torch.empty((n_ent,), dtype=f32, device=device))


def choose_tile(n: int, sms: int, fit: list[int]) -> int:
    """The balanced tile of :func:`wide_plan` among the tiles ``fit``."""
    def cost(t):
        return (-(-(-(-n // t)) // sms) * (t + QUANTUM), -t)

    return min(fit, key=cost)


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
    fit = tiles_that_fit(kernel, width, d_in, d_out, n_tangents, precision, smem_limit)
    if not fit:
        raise ValueError(f"{kernel}: not 16 points of width {width} fit {smem_limit} B of "
                         "shared memory")
    tile = choose_tile(n, sms, fit)
    tiles = -(-n // tile)
    grid = min(tiles, sms)
    c = ckpt_every(n_stack, ckpt) if kernel == "k4" else 1
    return WidePlan(kernel=kernel, n=n, width=width, d_in=d_in, d_out=d_out, n_stack=n_stack,
                    n_tangents=n_tangents, precision=precision, tile=tile, tiles=tiles,
                    grid=grid, rounds=-(-tiles // grid),
                    smem=smem_bytes(kernel, width, d_in, d_out, n_tangents, tile, precision),
                    image=image_bytes(kernel, width, d_in, d_out, n_stack, precision),
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
