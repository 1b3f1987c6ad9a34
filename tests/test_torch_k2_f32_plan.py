"""The launch plan of K2's f32 body (``ops/k2_plan.py::f32_plan``). Runs on
the CPU: the lanes a point, the persistent grid, the warps that make the
rounds even, the shared-memory layout and chunks, at the path's sizes for
every compiled width; and, with a stand-in for the kernel library that
records its arguments, that the K2 wrapper passes the plan to the f32
entry and that the binder's ``argtypes`` match the entry's parameters.

The helpers below state the kernel's walk as ``csrc/mlp_fwd_tangents.cu``
writes it (warp ``w`` of block ``b`` takes tile ``r * grid * warps + w *
grid + b`` in round ``r``; lane ``l`` of a tile of ``32 / lanes`` points
works on point ``l // lanes`` of it); they are copies, so the witness that
the kernel walks its tiles so is the card's ragged-point test
(``tests/test_torch_cuda.py::test_cuda_k2_f32_ragged_points``), and
``test_cuda_k2_f32_library_reports_the_plan`` holds the library's threads
and bytes to this plan.
"""

import ctypes
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
from pinn_depthestimation_tpu_torch.ops import cuda_build, k2_plan, kernels
from pinn_depthestimation_tpu_torch.ops.cuda_build import K2_WIDTHS
from test_torch_walk_plan import SMS, card_stand_in  # noqa: F401 - a fixture

SMEM = 232_448  # an H100 block's opt-in shared memory
# name -> (points, K, hidden layers stacked after the first); the epilogue is K=2
SIZES = {"serve": (21_141, 0, 99), "legacy": (26_691, 3, 19), "cmb-grid": (20_507, 2, 9),
         "fidelity-rows": (200, 0, 9), "residual-10M": (10_000_000, 2, 99)}
LANES = {"serve": 2, "legacy": 1, "cmb-grid": 2, "fidelity-rows": 2, "residual-10M": 1}
RAGGED = (1, 17, 255, 257, 21_141, 26_691, 10_000_000)
MODES = ("K=0", "K=1", "K=2", "K=3", "epilogue")
NETS = {"flagship": (100, 3), "cmb": (10, 6)}  # hidden layers, heads


def walked_tiles(plan) -> np.ndarray:
    """Every tile index the warps of the plan take, ``(rounds, warps, grid)``."""
    r = np.arange(plan.rounds)[:, None, None]
    w = np.arange(plan.warps)[None, :, None]
    b = np.arange(plan.grid)[None, None, :]
    return r * plan.grid * plan.warps + w * plan.grid + b


@pytest.mark.parametrize("width", K2_WIDTHS)
@pytest.mark.parametrize("size", SIZES)
def test_f32_plan_fills_the_card_and_fits(size, width):
    n, kt, n_stack = SIZES[size]
    plan = k2_plan.f32_plan(n, width, n_stack, kt, SMS)
    assert plan.lanes == LANES[size] == k2_plan.f32_lanes(n, kt, SMS)
    assert plan.points_per_tile == 32 // plan.lanes
    assert plan.tiles == -(-n // plan.points_per_tile)
    assert plan.grid == min(SMS, plan.tiles)  # every SM the tiles can reach, one block each
    most = k2_plan.f32_max_threads(width, plan.lanes, kt) // 32
    assert 1 <= plan.warps <= most
    assert plan.rounds == -(-plan.tiles // (plan.grid * most))  # the fewest rounds
    assert plan.warps * plan.grid * plan.rounds >= plan.tiles
    assert (plan.warps - 1) * plan.grid * plan.rounds < plan.tiles  # the rounds come out even
    assert plan.smem <= SMEM
    assert plan.smem == k2_plan.f32_smem_bytes(width, plan.lanes, plan.chunk, plan.slots)
    assert 1 <= plan.chunk <= n_stack
    if plan.chunk < n_stack:  # two slots of the most layers that fit
        assert plan.slots == 2
        assert k2_plan.f32_smem_bytes(width, plan.lanes, plan.chunk + 1, 2) > SMEM
        assert k2_plan.f32_smem_bytes(width, plan.lanes, n_stack, 1) > SMEM
    else:
        assert plan.slots == 1


def test_f32_plan_at_the_path_shapes():
    """The plans the path runs (``PERF.md``): two lanes a point and 10 warps
    on all 132 SMs at the serving grid, one lane a point in 12-warp blocks
    at 10M points (198 rounds), one lane and 7 warps at the legacy shape."""
    serve = k2_plan.f32_plan(21_141, 20, 99, 0, SMS)
    assert (serve.lanes, serve.grid, serve.warps, serve.rounds) == (2, 132, 11, 1)
    assert serve.tiles == 1_322 and serve.chunk == 99 and serve.slots == 1
    res = k2_plan.f32_plan(10_000_000, 20, 99, 2, SMS)
    assert (res.lanes, res.grid, res.warps, res.rounds) == (1, 132, 12, 198)
    legacy = k2_plan.f32_plan(26_691, 20, 19, 3, SMS)
    assert (legacy.lanes, legacy.grid, legacy.warps, legacy.rounds) == (1, 132, 7, 1)


@pytest.mark.parametrize("lanes", k2_plan.F32_LANES)
@pytest.mark.parametrize("width", K2_WIDTHS)
def test_f32_layer_layout(width, lanes):
    """A lane's block holds its columns of every row and is 16-byte aligned;
    with two lanes a point its 16-byte words are odd in number, so the two
    lanes reading the same word of their blocks meet distinct banks; the
    biases follow the blocks."""
    cols = k2_plan.f32_cols(width, lanes)
    block = k2_plan.f32_block_floats(width, lanes)
    assert cols * lanes == width
    assert block >= width * cols and block % 4 == 0 and block - width * cols < 8
    if lanes > 1:
        assert (block // 4) % 2 == 1
        banks = {(r * block + f) % 32 for r in range(lanes) for f in range(4)}
        assert len(banks) == 4 * lanes
    layer = k2_plan.f32_layer_floats(width, lanes)
    assert layer % 4 == 0 and layer - lanes * block - width < 4


@pytest.mark.parametrize("lanes,layer,smem,wide_chunk", [(1, 1_680, 167_712, 27),
                                                         (2, 1_712, 170_880, 27)])
def test_the_flagship_stack_fits_one_slot(lanes, layer, smem, wide_chunk):
    """2->[20]x100->3: 1,680 B a layer at one lane a point (1,712 at two: a
    lane's 200 floats padded to 51 words), the 99 stacked layers in one slot
    with the input and output layers; 2->[32]x100->3 takes two slots of
    27 layers, four chunks."""
    assert k2_plan.f32_layer_floats(20, lanes) * 4 == layer
    plan = k2_plan.f32_plan(12_516, 20, 99, 2, SMS, lanes=lanes)
    assert (plan.chunk, plan.slots, plan.smem) == (99, 1, smem)
    wide = k2_plan.f32_plan(5_003, 32, 99, 2, SMS, lanes=lanes)
    assert (wide.chunk, wide.slots, wide.chunks) == (wide_chunk, 2, 4)


@pytest.mark.parametrize("lanes", k2_plan.F32_LANES)
@pytest.mark.parametrize("n", RAGGED)
def test_every_point_is_walked_exactly_once(n, lanes):
    plan = k2_plan.f32_plan(n, 20, 99, 2, SMS, lanes=lanes)
    tiles = walked_tiles(plan)
    live = tiles[tiles < plan.tiles]
    assert np.array_equal(np.sort(live), np.arange(plan.tiles))  # each tile once
    assert (tiles[0, 0, :] < plan.tiles).all()  # no block idles
    p = plan.points_per_tile
    assert (plan.tiles - 1) * p < n <= plan.tiles * p
    lane_point = np.arange(32) // lanes  # the point of a tile each lane works on
    assert np.array_equal(np.bincount(lane_point), np.full(p, lanes))
    if n <= 30_000:  # the points themselves
        seen = np.zeros(n, dtype=np.int64)
        for t in live:
            q = np.arange(t * p, min(n, (t + 1) * p))
            seen[q] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("bad", [dict(n=0), dict(sms=0), dict(lanes=3), dict(lanes=4),
                                 dict(width=0), dict(width=33), dict(width=7),
                                 dict(n_tangents=4),
                                 dict(n_stack=-1), dict(max_threads=16),
                                 dict(width=32, smem_limit=10_000)])
def test_f32_plan_refuses_what_the_body_does_not_take(bad):
    args = dict(n=10, width=20, n_stack=9, n_tangents=2, sms=SMS) | bad
    with pytest.raises(ValueError, match="K2"):
        k2_plan.f32_plan(**args)


class RecordingLibrary:
    """Stands in for a width's K2 library at f32: the most threads a block
    takes, and the f32 entry, which records the arguments of each launch."""

    def __init__(self, width: int):
        self.calls = []
        self.k2_f32_threads = lambda lanes, kt: k2_plan.f32_max_threads(width, lanes, kt)
        self.k2_mlp_fwd_tangents = lambda *args: self.calls.append(args) or 0


def _net(width: int, hidden: int, d_out: int, d_in: int):
    spec = MLPSpec(sizes=(d_in,) + (width,) * hidden + (d_out,))
    rng = np.random.RandomState(0)
    arrays = {"w_in": rng.randn(d_in, width), "b_in": rng.randn(width),
              "w_hidden": rng.randn(hidden - 1, width, width),
              "b_hidden": rng.randn(hidden - 1, width),
              "w_out": rng.randn(width, d_out), "b_out": rng.randn(d_out)}
    return spec, params_from_numpy({k: v.astype(np.float32) for k, v in arrays.items()},
                                   torch.device("cpu"))


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("width", K2_WIDTHS)
def test_k2_wrapper_passes_the_f32_plan(card_stand_in, width, mode, net):  # noqa: F811
    hidden, d_out = NETS[net]
    epilogue = mode == "epilogue"
    kt = 2 if epilogue else int(mode[-1])
    if epilogue:
        d_out = 3
    spec, params = _net(width, hidden, d_out, d_in=max(2, kt))
    lib = RecordingLibrary(width)
    for n, lanes in ((21_141, None), (200, None), (200, 1), (100_000, 2)):
        x = torch.zeros((n, spec.d_in))
        out = dict(fc=torch.empty(n)) if epilogue else dict(
            y=torch.empty((n, d_out)), dy=torch.empty((kt, n, d_out)) if kt else None)
        if lanes is None:
            kernels._launch_k2(params, x, spec, kt, "f32", epilogue=epilogue, lib=lib, **out)
        else:
            kernels._launch_k2_narrow(params, x, spec, kt, "f32", epilogue=epilogue, lib=lib,
                                      lanes=lanes, **out)
        plan = k2_plan.f32_plan(n, width, hidden - 1, kt, SMS, lanes=lanes)
        args = lib.calls[-1]
        assert args[10:17] == (n, spec.d_in, d_out, hidden - 1, kt, 0, int(epilogue))
        assert args[17:21] == (plan.grid, plan.threads, plan.lanes, plan.chunk)
        assert plan.lanes == (lanes or k2_plan.f32_lanes(n, kt, SMS))
    assert len(lib.calls) == 4


def _c_parameters(source: str, entry: str) -> list[str]:
    """The parameter types of a C entry of ``source``, in order."""
    text = Path(cuda_build.CSRC_DIR / source).read_text()
    sig = re.search(rf"\bint {entry}\(([^)]*)\)", text)
    assert sig, entry
    params = [" ".join(p.split()[:-1]) for p in sig.group(1).split(",") if p.strip()]
    return ["ptr" if "*" in p else p for p in params]


def test_binder_argtypes_match_the_f32_entry():
    names = ("k2_mlp_fwd_tangents", "k2_f32_threads", "k2_f32_smem", "k2_error_string")
    lib = types.SimpleNamespace(**{name: types.SimpleNamespace() for name in names})
    cuda_build._bind_k2(lib)
    want = {"ptr": ctypes.c_void_p, "int": ctypes.c_int}
    for name in names[:3]:
        params = _c_parameters(cuda_build.K2_SOURCE, name)
        assert getattr(lib, name).argtypes == [want[p] for p in params], name
        assert getattr(lib, name).restype is ctypes.c_int
    # the f32 entry: the pointers, then n .. epilogue, then the plan, then the stream
    assert _c_parameters(cuda_build.K2_SOURCE, "k2_mlp_fwd_tangents") == (
        ["ptr"] * 10 + ["int"] * 11 + ["ptr"])
