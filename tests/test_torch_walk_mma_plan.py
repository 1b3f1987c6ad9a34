"""The plan of the backward walk's tensor-core body (K1, K3 and K4 at the
bf16 and f32x3 tiers; ``csrc/mlp_bwd_mma.cuh``, mirrored by
``ops/walk_mma_plan.py``). Runs on the CPU: that the plan fits the card's
opt-in shared memory at the tile ``ops/walk_plan.py`` picks for every
kernel, compiled width, tier, tangent count and K4 segment length; that its
image regions cover the stack; that the images have the fragment layout's
size; and, on a numpy model of the lanes' addresses, that the staging rows,
the bf16 weight gradient's loads and the state words meet no shared-memory
bank twice. A card test (``tests/test_torch_cuda.py``) holds the libraries'
own answers to this module.
"""

import itertools

import numpy as np
import pytest

from pinn_depthestimation_tpu_torch.ops import walk_mma_plan as mp
from pinn_depthestimation_tpu_torch.ops.walk_plan import walk_plan

SMS = 132  # the H100's SM count
WIDTHS = (8, 10, 16, 20, 32)
POINTS = (1, 17, 1_003, 12_516, 20_507, 26_691, 10_000_000)
STACKS = (0, 1, 9, 19, 22, 99, 119)
KERNELS = {"k1": (2,), "k3": (0, 1, 2, 3), "k4": (0, 1, 2, 3)}


def tiles(width: int, precision: str):
    """The tiles the launch plan picks for :data:`POINTS`."""
    return sorted({walk_plan(n, mp.LANES, mp.max_tile(width, precision), SMS).tile
                   for n in POINTS})


def every_shape():
    for kernel, kts in KERNELS.items():
        for width, precision, kt in itertools.product(WIDTHS, mp.TIERS, kts):
            yield kernel, width, precision, kt


def check_plan(p, kernel, width, n_stack, kt, precision, tile):
    assert p.smem <= mp.SMEM_LIMIT
    assert p.smem == mp.smem_bytes(width, 1 + kt, mp.MAX_OUT[kernel], p.chunk, p.regions,
                                   precision, p.ckpt, tile)
    assert p.regions in (1, 2)
    if n_stack:
        assert 1 <= p.chunk <= n_stack
        assert p.chunk * p.chunks(n_stack) >= n_stack > p.chunk * (p.chunks(n_stack) - 1)
    else:
        assert p.chunk == 0
    if kernel == "k4":
        assert p.regions == 2 and 1 <= p.ckpt <= max(1, min(mp.MAX_AUTO_CKPT, n_stack))
        # a segment lies in one chunk of each direction
        assert p.chunk == n_stack or p.chunk % p.ckpt == 0
    else:
        assert p.ckpt == 0
        both = mp.fit_layers(width, 1 + kt, mp.MAX_OUT[kernel], n_stack, 2, precision, 0,
                             tile) >= n_stack
        assert (p.regions == 2) == (both and n_stack > 0)
        if p.regions == 2:
            assert p.chunk == n_stack


@pytest.mark.parametrize("kernel,width,precision,kt", list(every_shape()))
def test_the_plan_fits_the_opt_in_memory_and_covers_the_stack(kernel, width, precision, kt):
    for tile, n_stack in itertools.product(tiles(width, precision), STACKS):
        p = mp.plan(kernel, width, n_stack, kt, precision, tile)
        assert p is not None, (tile, n_stack)
        check_plan(p, kernel, width, n_stack, kt, precision, tile)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("precision", mp.TIERS)
@pytest.mark.parametrize("kt", (0, 1, 2, 3))
def test_every_k4_segment_length_that_fits_is_planned_whole(width, precision, kt):
    """K4 with an asked segment length C: cut to the stack, and either a
    plan that fits with regions of a multiple of C, or nothing (the wrapper
    then raises) exactly when C states do not fit beside C layers a
    direction."""
    for tile, n_stack, c in itertools.product(tiles(width, precision), (1, 19, 99),
                                              range(1, 9)):
        p = mp.plan("k4", width, n_stack, kt, precision, tile, ckpt=c)
        cut = min(c, n_stack)
        fits = mp.fit_layers(width, 1 + kt, 8, n_stack, 2, precision, cut, tile) >= cut
        assert (p is not None) == fits, (tile, n_stack, c)
        if p is not None:
            assert p.ckpt == cut
            check_plan(p, "k4", width, n_stack, kt, precision, tile)


def test_the_paths_shapes():
    """The flagship at bf16 keeps its 99 layers in one region (both
    directions do not fit), at f32x3 in chunks; the cmb grid and the legacy
    shape keep both directions resident; K4 takes the largest C that leaves
    the whole stack (legacy bf16: C = 2) or half of it (the flagship)."""
    flag = walk_plan(12_516, 2, 128, SMS).tile
    assert flag == 96
    p = mp.plan("k1", 20, 99, 2, "bf16", flag)
    assert (p.regions, p.chunk) == (1, 99)
    p = mp.plan("k1", 20, 99, 2, "f32x3", flag)
    assert p.regions == 1 and p.chunks(99) == 2
    cmb = walk_plan(20_507, 2, 160, SMS).tile
    for kernel, precision in itertools.product(("k3", "k4"), mp.TIERS):
        tile = cmb if precision == "bf16" else walk_plan(20_507, 2, 128, SMS).tile
        assert mp.plan(kernel, 10, 9, 2, precision, tile).regions == 2
    legacy = walk_plan(26_691, 2, 128, SMS).tile
    assert legacy == 128
    p = mp.plan("k4", 20, 19, 3, "bf16", legacy)
    assert (p.ckpt, p.chunk, p.regions) == (2, 19, 2)
    p = mp.plan("k4", 20, 99, 2, "bf16", flag)
    assert p.chunk < 99 and p.chunks(99) == 2 and p.chunk % p.ckpt == 0


@pytest.mark.parametrize("width", WIDTHS)
def test_a_layers_images_take_the_fragment_layouts_bytes(width):
    t = -(-width // 8)
    assert mp.layer_bytes(width, "bf16") == t * t * 128
    assert mp.layer_bytes(width, "f32x3") == 2 * t * t * 128
    for precision, regions in itertools.product(mp.TIERS, (1, 2)):
        grow = (mp.smem_bytes(width, 3, 8, 5, regions, precision, 1, 32)
                - mp.smem_bytes(width, 3, 8, 4, regions, precision, 1, 32))
        assert grow == regions * mp.layer_bytes(width, precision)


@pytest.mark.parametrize("width", WIDTHS)
def test_the_f32x3_slots_fit_in_the_staging_blocks(width):
    for tile in range(16, mp.max_tile(width, "bf16") + 1, 16):
        assert mp.f32x3_slot_floats(width, tile) <= mp.staging_floats(width, 1, tile)


def fold_groups(width: int, streams: int, tile: int):
    """``accum_square<..., kFold>``'s partials (one a warp with items), or
    None where its tiles do not divide a warp."""
    ri, rj = mp._square_ri(width), mp._square_rj(width)
    nt = (width // ri) * (width // rj)
    if 32 % nt:
        return None
    threads, steps = mp.LANES * tile, streams * (tile // 4)
    n_fold = min(steps, threads // nt)
    qf = -(-steps // n_fold)
    return -(-nt * -(-steps // qf) // 32)


@pytest.mark.parametrize("width", WIDTHS)
def test_the_bf16_weight_gradients_folded_partials_fit_the_reduction_buffer(width):
    """At widths 8, 10 and 16 the bf16 weight gradient folds each warp's
    ranges into one partial: at most one a warp, within the buffer."""
    for tile, streams, kernel in itertools.product(range(16, mp.max_tile(width, "bf16") + 1, 16),
                                                   (1, 2, 3, 4), ("k1", "k3")):
        groups = fold_groups(width, streams, tile)
        if groups is None:
            assert width in (20, 32)
            continue
        assert 1 <= groups <= tile // 16
        assert groups * (width * width + width) <= mp.red_floats(
            width, streams, tile, mp.MAX_OUT[kernel], "bf16")


# ------------------------------------------------------------ bank models

def bank_conflict_free(addresses, width_floats: int) -> bool:
    """Whether one shared-memory access of ``width_floats`` floats per lane
    (1, 2 or 4) by 32 lanes meets no bank twice: the hardware serves 128
    bytes a wavefront (32, 16 or 8 lanes), and within one, two distinct
    addresses in one bank conflict (equal addresses are a broadcast)."""
    addresses = [a for a in addresses if a is not None]
    per = 32 // width_floats
    for w0 in range(0, 32, per):
        group = {a for i, a in enumerate(addresses) if w0 <= i < w0 + per}
        banks = [(a // width_floats) % (32 // width_floats) for a in group]
        if len(banks) != len(set(banks)):
            return False
    return True


def lane_gq(lane: int):
    return lane // 4, lane % 4


@pytest.mark.parametrize("width", WIDTHS)
def test_staging_stores_from_the_fragment_layout_meet_no_bank_twice(width):
    """A staging store: lane (g, q) writes neuron 8j + 2q + (e & 1) of point
    g + 8 (e >> 1) of its warp's 16 (row (s*W + n) * ld, ld = stage_ld(P))."""
    for tile in range(16, 161, 16):
        ld = mp.stage_ld(tile)
        assert ld % 32 == 4
        for warp, s, j, e in itertools.product(range(tile // 16), range(4),
                                               range(mp.tiles8(width)), range(4)):
            addrs = []
            for lane in range(32):
                g, q = lane_gq(lane)
                n = 8 * j + 2 * q + (e & 1)
                addrs.append((s * width + n) * ld + 16 * warp + g + 8 * (e >> 1)
                             if n < width else None)
            assert bank_conflict_free(addrs, 1), (tile, warp, s, j, e)


def _square_tiles(width: int):
    ri, rj = mp._square_ri(width), mp._square_rj(width)
    return ri, rj, width // ri, width // rj


@pytest.mark.parametrize("width", WIDTHS)
def test_the_bf16_weight_gradients_loads_meet_no_bank_twice(width):
    """``accum_square`` on the staged rows: thread `item` = (range s, tile
    (it, jt)) loads float4s of rows it + NI*a of s_A and jt + NJ*b of s_B at
    the same four points as every thread of its range; the pitch puts a
    quarter-warp's distinct rows of one range in distinct 16-byte bank
    groups. (Two ranges in one quarter-warp read other points; where their
    groups meet, the split of the ranges, unchanged since the lane-pair
    walk, costs a second wavefront.)"""
    ri, rj, ni, nj = _square_tiles(width)
    nt = ni * nj
    for tile, streams in itertools.product(range(16, 161, 16), (1, 2, 3, 4)):
        ld = mp.stage_ld(tile)
        threads = mp.LANES * tile
        n_split = mp.square_splits(width, streams, tile)
        chunks = tile // 4
        steps = streams * chunks
        q = -(-steps // n_split)
        items = list(range(min(threads, nt * n_split)))
        for lane0 in range(0, len(items), 8):  # a quarter-warp of float4 loads
            quarter = items[lane0:lane0 + 8]
            for s_range in {item // nt for item in quarter}:
                for step in range(q):  # the same iteration of every lane's range
                    k = s_range * q + step
                    if k >= min(steps, (s_range + 1) * q):
                        continue
                    c, p = k // chunks, 4 * (k % chunks)
                    for a in range(max(ri, rj)):
                        for is_a in (True, False):
                            if a >= (ri if is_a else rj):
                                continue
                            rows = {c * width + ((item % nt) // nj + ni * a if is_a
                                                 else (item % nt) % nj + nj * a)
                                    for item in quarter if item // nt == s_range}
                            groups = [((row * ld + p) // 4) % 8 for row in rows]
                            assert len(groups) == len(set(groups)), (tile, streams, k, a)


@pytest.mark.parametrize("width", WIDTHS)
def test_the_state_layout_is_one_word_per_lane_and_contiguous(width):
    """state_f4: a warp's S * W * 16 floats of a state hold every real
    (stream, neuron pair, lane) once, and each store of the 32 lanes is one
    run of 16-byte words (no bank conflict in the segment buffer)."""
    for streams in (1, 2, 3, 4):
        seen = []
        for s, j in itertools.product(range(streams), range(mp.tiles8(width))):
            offs = [mp.state_f4(width, s, j, lane) for lane in range(32)]
            real = [o for o in offs if o is not None]
            assert real == sorted(real) and real == list(range(real[0], real[0] + len(real)))
            assert bank_conflict_free([4 * o if o is not None else None for o in offs], 4)
            seen += real
        assert sorted(seen) == list(range(streams * 4 * width))
        # the real neuron pairs: lane (g, q) of tile j holds neurons 8j + 2q < W
        for j in range(mp.tiles8(width)):
            for lane in range(32):
                real = 8 * j + 2 * (lane % 4) < width
                assert (mp.state_f4(width, 0, j, lane) is not None) == real


def test_the_fragment_words_of_a_layer_are_loaded_without_conflict():
    """A lane's B registers of one column tile: one uint2 (bf16) or uint4
    (f32x3) per pair of half k-tiles at consecutive lanes (mma_frag.cuh
    half_word), one word or uint2 for an odd last half."""
    for width, split in itertools.product(WIDTHS, (False, True)):
        t = mp.tiles8(width)
        u = 2 if split else 1
        for h in range(0, t - 1, 2):
            words = [(h // 2) * 64 * u + lane * 2 * u for lane in range(32)]
            assert bank_conflict_free(words, 2 * u)
        if t % 2:
            words = [(t // 2) * 64 * u + lane * u for lane in range(32)]
            assert bank_conflict_free(words, u)


def test_plan_refuses_the_f32_tier():
    with pytest.raises(ValueError, match="bf16 and f32x3"):
        mp.plan("k1", 20, 99, 2, "f32", 96)


def test_nothing_fits_is_none():
    assert mp.plan("k4", 32, 99, 3, "f32x3", 128, ckpt=8) is None
    assert np.all([mp.plan("k3", w, 99, 3, "f32x3", 128) is not None for w in WIDTHS])
