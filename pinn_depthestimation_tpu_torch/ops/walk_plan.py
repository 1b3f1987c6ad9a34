"""The launch plan of the shared backward walk (K1, K3 and K4).

The walk (``csrc/mlp_bwd_common.cuh``) runs a tile of ``tile`` points on one
block of ``lanes * tile`` threads (a lane pair per point) and walks the
tiles ``b, b + grid, b + 2 * grid, ...`` on block ``b`` of a fixed grid,
keeping its partial sums in row ``b`` of the partial buffer and its layer
states in its own slice of the state scratch. :func:`walk_plan` sizes the
tile from the point count, the width's largest tile and the card's SM
count, so that one call's tiles fill the SMs in one wave where they can
(12,516 flagship points: 131 tiles of 96 on 132 SMs; the 20,507-point CMB
grid: 129 tiles of 160). The K1, K3 and K4 wrappers take their grid, tile
and scratch sizes from it, and nothing else decides them.

The plan itself needs no torch (only :meth:`WalkPlan.scratch` and
:func:`card_plan` import it), so the CPU tests check its tiling and that
the wrappers allocate and pass what it says; the card tests of ragged
point counts (``tests/test_torch_cuda.py``) witness that the kernel
indexes these buffers so.
"""

from __future__ import annotations

from dataclasses import dataclass

TILE_STEP = 16  # mlp_bwd::kTileStep: a tile's point count is a multiple of this


@dataclass(frozen=True)
class WalkPlan:
    """One launch of the walk: ``grid`` blocks of ``threads`` threads over
    ``tiles`` tiles of ``tile`` points (the last one ragged)."""

    n: int
    tile: int
    lanes: int
    tiles: int
    grid: int

    @property
    def threads(self) -> int:
        return self.lanes * self.tile

    def partial_shape(self, n_ent: int) -> tuple[int, int]:
        """The partial-sum rows: one per block of ``n_ent`` floats."""
        return (self.grid, n_ent)

    def state_numel(self, states_per_block: int, streams: int, width: int) -> int:
        """Floats of the state scratch: per block ``states_per_block``
        states of ``streams * width`` components of ``tile`` points."""
        return self.grid * states_per_block * streams * width * self.tile

    def scratch(self, n_ent: int, states_per_block: int, streams: int, width: int, device):
        """The launch's float32 buffers on ``device``: the partial rows, the
        state scratch and the output of ``n_ent`` floats."""
        import torch

        f32 = torch.float32
        return (torch.empty(self.partial_shape(n_ent), dtype=f32, device=device),
                torch.empty((self.state_numel(states_per_block, streams, width),), dtype=f32,
                            device=device),
                torch.empty((n_ent,), dtype=f32, device=device))


def walk_plan(n: int, lanes: int, max_tile: int, sms: int) -> WalkPlan:
    """The plan for ``n >= 1`` points: the smallest multiple of
    :data:`TILE_STEP` that covers ``n`` in ``sms`` tiles, at most
    ``max_tile``; then ``ceil(n / tile)`` tiles on ``min(tiles, sms)``
    blocks."""
    if n < 1 or lanes < 1 or sms < 1 or max_tile < TILE_STEP or max_tile % TILE_STEP:
        raise ValueError(f"no walk plan for n={n}, lanes={lanes}, max_tile={max_tile}, sms={sms}")
    per_sm = -(-n // sms)
    tile = min(max_tile, -(-per_sm // TILE_STEP) * TILE_STEP)
    tiles = -(-n // tile)
    return WalkPlan(n=n, tile=tile, lanes=lanes, tiles=tiles, grid=min(tiles, sms))


def card_plan(lib, kernel: str, precision: str, n: int, device) -> WalkPlan:
    """The plan of one launch of ``kernel`` (``'k1'``, ``'k3'`` or ``'k4'``)
    from the width's library ``lib`` on the CUDA ``device``: the library's
    lanes per point and largest tile at ``precision``, the card's SM
    count."""
    import torch

    from pinn_depthestimation_tpu_torch.ops.kernels import entry

    lanes = getattr(lib, f"{kernel}_lanes")()
    max_tile = entry(lib, f"{kernel}_max_tile", precision)()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return walk_plan(n, lanes, max_tile, sms)
