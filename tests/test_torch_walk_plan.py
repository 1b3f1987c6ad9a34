"""The launch plan of the shared backward walk (``ops/walk_plan.py``), which
the K1, K3 and K4 wrappers share. Runs on the CPU: the plan's tiling and
grid, and, with a stand-in for the kernel library that records its
arguments, that the wrappers allocate and pass what the plan says.

The helpers below state the kernel's layout as ``csrc/mlp_bwd_common.cuh``
writes it (block ``b`` of the grid walks tiles ``b, b + grid, ...`` of
``tile`` points, writes partial row ``b``, and keeps component ``c`` of
state ``s`` of point ``q`` of its tile at ``((b * states_per_block + s) *
streams * W + c) * tile + q`` of the state scratch), and ``max_tile`` its
largest tile per width; they are copies, so the witness that the kernel
indexes its buffers so is the card's ragged-tile tests
(``tests/test_torch_cuda.py``), which also hold ``max_tile`` to the
libraries.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
from pinn_depthestimation_tpu_torch.ops import kernels_step, kernels_vjp
from pinn_depthestimation_tpu_torch.ops.walk_plan import TILE_STEP, walk_plan

SMS = 132  # the H100's SM count
LANES = 2  # mlp_bwd::kLanes
POINTS = (1, 127, 128, 129, 12_516, 20_507)
WIDTHS = (8, 10, 16, 20, 32)


def max_tile(width: int, precision: str = "f32") -> int:
    """``mlp_bwd::max_tile``: 160 points for widths <= 10 at f32 and bf16,
    else 128."""
    return 160 if width <= 10 and precision != "f32x3" else 128


def tiles_of_block(plan, b: int) -> range:
    """The tiles block ``b`` walks, in its order."""
    return range(b, plan.tiles, plan.grid)


def points_of_tile(plan, t: int) -> range:
    return range(t * plan.tile, min(plan.n, (t + 1) * plan.tile))


def state_index(plan, b: int, state: int, component: int, q: int, states_per_block: int,
                streams: int, width: int) -> int:
    """Where block ``b`` keeps component ``component`` of state ``state`` of
    point ``q`` of its tile."""
    state_floats = streams * width * plan.tile
    return (b * states_per_block + state) * state_floats + component * plan.tile + q


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("n", POINTS)
def test_every_point_falls_in_exactly_one_tile(n, width):
    plan = walk_plan(n, LANES, max_tile(width), SMS)
    assert plan.tile % TILE_STEP == 0 and TILE_STEP <= plan.tile <= max_tile(width)
    seen = np.zeros(n, dtype=np.int64)
    for b in range(plan.grid):
        for t in tiles_of_block(plan, b):
            pts = points_of_tile(plan, t)
            assert 0 < len(pts) <= plan.tile
            seen[pts.start:pts.stop] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("n", POINTS)
def test_grid_never_exceeds_the_tiles(n, width):
    plan = walk_plan(n, LANES, max_tile(width), SMS)
    assert 1 <= plan.grid <= plan.tiles and plan.grid <= SMS
    assert plan.tiles == -(-n // plan.tile)
    assert all(len(tiles_of_block(plan, b)) >= 1 for b in range(plan.grid))
    assert plan.threads == LANES * plan.tile and plan.threads % 32 == 0
    if n <= SMS * max_tile(width):  # one wave: every tile on its own block
        assert plan.grid == plan.tiles


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("n", POINTS)
def test_scratch_matches_what_the_kernel_indexes(n, width):
    plan = walk_plan(n, LANES, max_tile(width), SMS)
    for states_per_block, streams in ((101, 3), (1, 1), (13, 4)):  # StoreAll, n_stack 0, Rebuild
        numel = plan.state_numel(states_per_block, streams, width)
        last = state_index(plan, plan.grid - 1, states_per_block - 1, streams * width - 1,
                                plan.tile - 1, states_per_block, streams, width)
        assert last == numel - 1  # the scratch is exactly what the last block reaches
        first_of_next = state_index(plan, 1, 0, 0, 0, states_per_block, streams, width)
        assert first_of_next == states_per_block * streams * width * plan.tile
    assert plan.partial_shape(57) == (plan.grid, 57)  # one row per block


def test_state_indices_are_distinct():
    plan = walk_plan(45, LANES, 128, 2)  # tiles of 32 points on 2 blocks
    idx = {state_index(plan, b, s, c, q, 3, 2, 8)
           for b in range(plan.grid) for s in range(3) for c in range(16) for q in range(plan.tile)}
    assert len(idx) == plan.state_numel(3, 2, 8) == max(idx) + 1


def test_flagship_and_cmb_grids_fill_the_card_in_one_wave():
    flag = walk_plan(12_516, LANES, max_tile(20), SMS)
    assert (flag.tile, flag.tiles, flag.grid, flag.threads) == (96, 131, 131, 192)
    cmb = walk_plan(20_507, LANES, max_tile(10), SMS)
    assert (cmb.tile, cmb.tiles, cmb.grid, cmb.threads) == (160, 129, 129, 320)
    big = walk_plan(10_000_000, LANES, 128, SMS)  # more tiles than SMs: blocks walk many
    assert big.tile == 128 and big.grid == SMS and big.tiles == 78_125


@pytest.mark.parametrize("bad", [dict(n=0), dict(lanes=0), dict(sms=0), dict(max_tile=8),
                                 dict(max_tile=100)])
def test_plan_refuses_what_the_kernel_does_not_take(bad):
    args = dict(n=10, lanes=LANES, max_tile=128, sms=SMS) | bad
    with pytest.raises(ValueError, match="no walk plan"):
        walk_plan(**args)


class RecordingLibrary:
    """Stands in for a width's kernel library: its lanes and largest tile,
    and an entry that records the arguments of each launch."""

    def __init__(self, kernel: str, width: int):
        self.calls = []
        setattr(self, f"{kernel}_lanes", lambda: LANES)
        setattr(self, f"{kernel}_max_tile", lambda: max_tile(width))
        setattr(self, "k4_ckpt_every", lambda n_stack, kt, ckpt, tile: ckpt or 4)
        record = lambda *args: self.calls.append(args) or 0  # noqa: E731
        setattr(self, {"k1": "k1_train_step", "k3": "k3_mlp_bwd", "k4": "k4_mlp_bwd"}[kernel],
                record)


@pytest.fixture
def card_stand_in(monkeypatch):
    """The wrappers' CUDA queries answered as on a 132-SM card, and
    ``torch.empty`` recording what they allocate; no kernel runs."""
    allocated = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **{k: v for k, v in kw.items() if k != "device"})
        allocated.append(tuple(t.shape))
        return t

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(multi_processor_count=SMS))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch, "empty", empty)
    return allocated


def _net(width: int, n_stack: int, d_out: int = 3):
    spec = MLPSpec(sizes=(2,) + (width,) * (n_stack + 1) + (d_out,))
    rng = np.random.RandomState(0)
    arrays = {"w_in": rng.randn(2, width), "b_in": rng.randn(width),
              "w_hidden": rng.randn(n_stack, width, width), "b_hidden": rng.randn(n_stack, width),
              "w_out": rng.randn(width, d_out), "b_out": rng.randn(d_out)}
    return spec, params_from_numpy({k: v.astype(np.float32) for k, v in arrays.items()},
                                   torch.device("cpu"))


@pytest.mark.parametrize("n", [129, 12_516])
def test_k1_wrapper_allocates_the_plan(card_stand_in, n):
    spec, params = _net(20, 4)
    x = torch.zeros((n, 2))
    b = kernels_step.make_step_batch(x, torch.zeros((n, 2)), torch.ones(n), torch.ones(n),
                                     [1.0, 1.0], 2, 1.0, 1.0)
    lib = RecordingLibrary("k1", 20)
    kernels_step._launch_k1(params, b, spec, lib=lib)
    plan = walk_plan(n, LANES, max_tile(20), SMS)
    n_ent = kernels_step.n_flat(spec) + kernels_step.N_STATS
    assert card_stand_in == [plan.partial_shape(n_ent), (plan.state_numel(5, 3, 20),), (n_ent,)]
    (args,) = lib.calls
    assert args[-3:-1] == (plan.grid, plan.tile)


@pytest.mark.parametrize("kernel", ["k3", "k4"])
@pytest.mark.parametrize("n", [129, 20_507])
def test_k3_and_k4_wrappers_allocate_the_plan(card_stand_in, kernel, n):
    spec, params = _net(10, 9, d_out=6)
    x, ybar, dybar = torch.zeros((n, 2)), torch.zeros((n, 6)), torch.zeros((2, n, 6))
    lib = RecordingLibrary(kernel, 10)
    launch = kernels_vjp._launch_k3 if kernel == "k3" else kernels_vjp._launch_k4
    launch(params, x, ybar, dybar, spec, 2, "f32", lib=lib)
    plan = walk_plan(n, LANES, max_tile(10), SMS)
    states_per_block = 10 if kernel == "k3" else -(-9 // 4)  # every state, or C=4 checkpoints
    n_ent = kernels_step.n_flat(spec)
    assert card_stand_in == [plan.partial_shape(n_ent), (plan.state_numel(states_per_block, 3, 10),),
                             (n_ent,)]
    (args,) = lib.calls
    assert args[-3:-1] == (plan.grid, plan.tile)
