"""The wide body's launch plan (``ops/wide_plan.py``) on the CPU: the tiles
it may take, their balance over the SMs, the shared-memory banks of the
walk's loads at every row pitch it plans, and the weight images' bytes.

``csrc/mlp_wide.cuh`` computes the same bytes (a card test holds them to
these); what is checked here is the arithmetic the kernels' design rests
on: a buffer row is ``tile + 4`` floats, an odd number of 16-byte words, so
that a warp's 16-byte loads of the same points from 4 (the weight
gradient's A operand) or 8 (its B operand) consecutive rows meet distinct
banks, and the tensor-core product's B fragments (rows 2q, 2q + 1, 2q + 8,
2q + 9 at column g of lane 4g + q) meet all 32 banks once.
"""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from pinn_depthestimation_tpu_torch.ops import wide_plan

TIERS = ("f32", "bf16", "f32x3")
SMS = 132


def banks_of(ld: int, rows: int) -> set[int]:
    """The 4-bank groups (16-byte words mod 8) that a 16-byte load of the
    same points from ``rows`` consecutive rows of pitch ``ld`` floats meets."""
    return {(r * ld // 4) % 8 for r in range(rows)}


def planned_tiles():
    """Every tile the plan may take, over kernels, tiers and widths, with
    the path's d_in = 2, d_out = 3 and K = 2 and the gate's worst case."""
    tiles = set()
    for kernel in wide_plan.KERNELS:
        for tier in TIERS:
            for W in range(1, 129):
                for d_in, d_out, k in ((2, 3, 2), (2, 6, 2), (128, 128, 3), (12, 16, 3)):
                    tiles.update(wide_plan.tiles_that_fit(kernel, W, d_in, d_out, k, tier))
    return sorted(tiles)


@pytest.mark.parametrize("rows", [4, 8])
def test_weight_gradient_loads_meet_distinct_banks_at_every_planned_pitch(rows):
    """The weight gradient's 16-byte loads of one point quad from ``rows``
    consecutive buffer rows (4 for A, 8 for B) fall in ``rows`` distinct
    4-bank groups at every planned row pitch; the first wide body's
    28-point tile (pitch 32) put all 8 in one group (8-way conflict per
    group of lanes)."""
    tiles = planned_tiles()
    assert tiles and all(t % wide_plan.QUANTUM == 0 for t in tiles)
    for tile in tiles:
        ld = tile + wide_plan.PAD
        assert (ld // 4) % 2 == 1, tile
        assert len(banks_of(ld, rows)) == rows, (tile, ld)
    assert len(banks_of(28 + 4, rows)) == 1


def test_tensor_core_b_fragments_meet_every_bank_once():
    """Lane 4g + q of a warp reads rows 2q (+1, +8, +9) at column g of a
    buffer for its B fragment: at every planned pitch the 32 lanes' words
    are 32 distinct banks, for each of the four rows."""
    for tile in planned_tiles():
        ld = tile + wide_plan.PAD
        for dk in (0, 1, 8, 9):
            banks = {((2 * q + dk) * ld + g) % 32 for g in range(8) for q in range(4)}
            assert len(banks) == 32, (tile, dk)


def test_plan_balances_the_path_shapes():
    """Phase 28's path shapes: the flagship's 12,516 points take 32-point
    tiles in 3 rounds at W = 128 (the first wide body: 28-point tiles in 4)
    and 48-point tiles in 2 full rounds at W = 64 (the first: 88-point
    tiles, 143 of them on 132 SMs); the 20,507-point CMB grid 32-point tiles at W = 128 and 64-point
    ones at W = 64; one block a SM, its smem within the card's."""
    want = {("k1", 128, 12_516, 99, 3): (32, 392, 3), ("k1", 64, 12_516, 99, 3): (48, 261, 2),
            ("k3", 128, 20_507, 9, 6): (32, 641, 5), ("k4", 128, 20_507, 9, 6): (32, 641, 5),
            ("k3", 64, 20_507, 9, 6): (64, 321, 3), ("k2", 128, 12_516, 99, 3): (32, 392, 3)}
    for (kernel, W, n, n_stack, d_out), (tile, tiles, rounds) in want.items():
        for tier in TIERS:
            p = wide_plan.wide_plan(kernel, n, W, 2, d_out, n_stack, 2, tier, SMS)
            assert (p.tile, p.tiles, p.rounds, p.grid) == (tile, tiles, rounds, SMS), \
                (kernel, W, tier)
            assert p.smem <= wide_plan.SMEM_LIMIT


@settings(max_examples=300, deadline=None)
@given(kernel=st.sampled_from(wide_plan.KERNELS), tier=st.sampled_from(TIERS),
       width=st.integers(1, 128), d_in=st.integers(1, 128), d_out=st.integers(1, 128),
       k=st.integers(0, 3), n=st.integers(1, 400_000), sms=st.integers(1, 132))
def test_plan_takes_the_cheapest_tile_that_fits(kernel, tier, width, d_in, d_out, k, n, sms):
    """The chosen tile fits, takes one round of the block's products, and
    costs least among those that do: rounds x (tile + 16), ties to the
    larger tile."""
    k = min(k, d_in)
    p = wide_plan.wide_plan(kernel, n, width, d_in, d_out, 3, k, tier, sms)
    fit = wide_plan.tiles_that_fit(kernel, width, d_in, d_out, k, tier)
    assert p.tile in fit and wide_plan.one_round(width, d_in, d_out, p.tile)
    cost = lambda t: -(-(-(-n // t)) // sms) * (t + wide_plan.QUANTUM)  # noqa: E731
    assert cost(p.tile) == min(cost(t) for t in fit)
    assert all(t <= p.tile for t in fit if cost(t) == cost(p.tile))
    *_, r = wide_plan.padded(width, d_in, d_out)
    assert (r // 4) * (p.tile // 4) <= wide_plan.THREADS
    assert -(-r // 32) * (p.tile // 16) <= wide_plan.WARPS


def test_image_and_slot_bytes_by_hand():
    """The weight images of the flagship at W = 128 (99 stacked layers): the
    walk's 2 x 99 + 3 images of 128 x 128 weights and 128 floats of bias;
    K2's 99 + 2; the two shared-memory slots hold half a layer's k-tiles."""
    layer = {"f32": 128 * 128 * 4, "bf16": 128 * 128 * 2, "f32x3": 128 * 128 * 4}
    for tier, nbytes in layer.items():
        assert wide_plan.image_bytes("k1", 128, 2, 3, 99, tier) == 201 * (nbytes + 512)
        assert wide_plan.image_bytes("k4", 128, 2, 3, 99, tier) == 201 * (nbytes + 512)
        assert wide_plan.image_bytes("k2", 128, 2, 3, 99, tier) == 101 * (nbytes + 512)
        assert wide_plan.slot_bytes(128, 2, 3, tier) == nbytes // 2
    # a 33-wide net rounds to 48: its hidden layer has 3 k-tiles, chunk 0 two
    assert wide_plan.padded(33, 2, 2) == (48, 16, 16, 48)
    assert wide_plan.slot_bytes(33, 2, 2, "f32") == 32 * 48 * 4
    assert wide_plan.smem_bytes("k1", 128, 2, 3, 2, 32, "f32") == \
        2 * 32_768 + 512 + 3 * 3 * 128 * 36 * 4


def test_bf16_bound_counts_the_weight_gradient_at_the_f32_rate():
    """``chip_smoke.py``'s bf16 bound of a walk: its tier-typed products on
    the tensor cores (989 TFLOP/s) and its f32 weight-gradient products on
    the CUDA cores (132 SMs x 128 FMAs x 1,980 MHz = 66.9 TFLOP/s), the
    slower of the two: 1.821 ms for the wide K1 at W = 128 on the flagship's
    12,516 points, 0.273 ms for the wide K3 and K4 on the CMB grid at W =
    128, 0.0445 ms for the narrow K1 (PERF.md, section 6)."""
    import chip_smoke
    from pinn_depthestimation_tpu_torch.models import MLPSpec

    f32_peak = 132 * 128 * 2 * 1980e6

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / f32_peak * 1e3, nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    def bound_bf16(flops, nbytes):
        t_ops = flops / chip_smoke.BF16_FLOPS_PER_S * 1e3
        t_bytes = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    cases = (
        (MLPSpec(sizes=(2,) + (128,) * 100 + (3,)), 12_516, chip_smoke.k1_flops, 1.821),
        (MLPSpec(sizes=(2,) + (128,) * 10 + (6,)), 20_507,
         lambda s, n: chip_smoke.k3_flops(s, n, 2), 0.273),
        (MLPSpec(sizes=(2,) + (128,) * 10 + (6,)), 20_507,
         lambda s, n: chip_smoke.k4_flops(s, n, 2), 0.273),
        (MLPSpec(sizes=(2,) + (20,) * 100 + (3,)), 12_516, chip_smoke.k1_flops, 0.0445),
    )
    for spec, n, flops, want in cases:
        got, by = chip_smoke.bf16_bound(bound, bound_bf16, flops(spec, n), 0.0,
                                        chip_smoke.wg_flops(spec, n, 2))
        assert by == "operations" and abs(got - want) <= 0.01 * want, (spec.sizes[:2], got)
        assert got > 3 * bound_bf16(flops(spec, n), 0.0)[0]  # the uncorrected bound
