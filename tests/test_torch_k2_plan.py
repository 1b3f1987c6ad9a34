"""The launch plan of K2's tensor-core body at bf16 and f32x3
(``ops/k2_plan.py``). Runs on the CPU: the padding, the shared-memory
budget, the persistent grid and the chunks of the hidden stack for every
compiled width, and, with a stand-in for the kernel library that records
its arguments, that the K2 wrapper passes the plan's grid and chunk.

The helper below states the kernel's tile walk as
``csrc/mlp_fwd_tangents_mma.cuh`` writes it (warp ``w`` of block ``b`` takes
tile ``r * grid * warps + w * grid + b`` in round ``r``); it is a copy, so
the witness that the kernel walks its tiles so is the card's ragged-tile
test (``tests/test_torch_cuda.py::test_cuda_k2_cheap_tiers_ragged_tiles``),
and ``test_cuda_k2_libraries_report_the_mma_tile`` holds the libraries'
tile, warps and shared-memory bytes to this plan.
"""

import numpy as np
import pytest
import torch

from pinn_depthestimation_tpu_torch.models import MLPSpec, params_from_numpy
from pinn_depthestimation_tpu_torch.ops import k2_plan, kernels
from pinn_depthestimation_tpu_torch.ops.cuda_build import K2_WIDTHS
from test_torch_k2_padding import k_pad
from test_torch_walk_plan import SMS, card_stand_in  # noqa: F401 - a fixture

TIERS = ("bf16", "f32x3")
SMEM = 232_448  # an H100 block's opt-in shared memory
MODES = ("K=0", "K=1", "K=2", "K=3", "epilogue")
NETS = {"flagship": (100, 3), "cmb": (10, 6)}  # hidden layers, heads


def tile_of(plan, r: int, b: int, w: int) -> int:
    """The tile warp ``w`` of block ``b`` takes in round ``r``."""
    return r * plan.grid * plan.warps + w * plan.grid + b


def rounds(plan) -> int:
    return -(-plan.tiles // (plan.grid * plan.warps))


@pytest.mark.parametrize("net", NETS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("precision", TIERS)
@pytest.mark.parametrize("width", K2_WIDTHS)
def test_plan_pads_fits_and_fills_the_card(width, precision, mode, net):
    n_stack = NETS[net][0] - 1
    assert k_pad(width) % 16 == 0 and k_pad(width) >= width
    assert k2_plan.n_pad(width) % 8 == 0 and k2_plan.n_pad(width) >= width
    assert k_pad(width) - 16 < width and k2_plan.n_pad(width) - 8 < width  # no spare tile
    plan = k2_plan.k2_plan(10_000_000, width, n_stack, precision, SMS)
    assert plan.smem <= SMEM and plan.smem == k2_plan.smem_bytes(width, plan.chunk, precision)
    assert 1 <= plan.chunk <= n_stack
    if plan.chunk < n_stack:  # the largest chunk that fits
        assert k2_plan.smem_bytes(width, plan.chunk + 1, precision) > SMEM
    assert plan.grid == SMS and plan.tiles == 625_000  # every SM, one block each
    assert plan.threads == 32 * k2_plan.block_warps(precision, width)
    assert plan.threads == {("bf16", False): 512, ("f32x3", False): 384, ("bf16", True): 384,
                            ("f32x3", True): 256}[precision, width > 20]


@pytest.mark.parametrize("precision", TIERS)
@pytest.mark.parametrize("width", K2_WIDTHS)
def test_the_flagship_stack_fits_one_chunk_except_wide_f32x3(width, precision):
    """99 stacked layers: one chunk at every width but 32 at f32x3, whose
    4,096 B a layer take two more chunks (the card's width-32 cases)."""
    plan = k2_plan.k2_plan(12_516, width, 99, precision, SMS)
    assert plan.chunks == (2 if (width, precision) == (32, "f32x3") else 1)


def test_flagship_bytes():
    """W=20: 3 column tiles x 3 half k-tiles x 128 B a layer at bf16 (the
    zero upper half of k-tile 1 is neither stored nor multiplied), twice
    that at f32x3; the flagship's 99 layers in 114,048 and 228,096 B."""
    assert (k_pad(20), k2_plan.n_pad(20)) == (32, 24)
    assert (k_pad(10), k2_plan.n_pad(10)) == (16, 16)
    assert k2_plan.smem_bytes(20, 99, "bf16") == 99 * 1_152 + 8 * 24 * 4 + 3 * 128
    assert k2_plan.smem_bytes(20, 99, "f32x3") == 99 * 2_304 + 8 * 24 * 8 + 3 * 256
    assert k2_plan.k2_plan(12_516, 20, 99, "f32x3", SMS).smem == 230_400
    assert k2_plan.k2_plan(12_516, 32, 119, "f32x3", SMS).chunks == 3  # the 120-layer stack
    assert k2_plan.k2_plan(12_516, 32, 119, "bf16", SMS).chunks == 2


@pytest.mark.parametrize("precision", TIERS)
@pytest.mark.parametrize("n", [1, 15, 16, 17, 200, 20_507, 21_141, 25_343, 25_345, 10_000_000])
def test_every_tile_is_walked_exactly_once(n, precision):
    plan = k2_plan.k2_plan(n, 20, 99, precision, SMS)
    assert plan.tiles == -(-n // k2_plan.ROWS) and 1 <= plan.grid <= SMS
    assert plan.grid == min(SMS, plan.tiles)
    if n > 100_000:
        return  # the count below walks every tile
    seen = np.zeros(plan.tiles, dtype=np.int64)
    for r in range(rounds(plan)):
        for b in range(plan.grid):
            for w in range(plan.warps):
                t = tile_of(plan, r, b, w)
                if t < plan.tiles:
                    seen[t] += 1
    assert (seen == 1).all()
    assert all(tile_of(plan, 0, b, 0) < plan.tiles for b in range(plan.grid))  # no idle block
    busy = [sum(tile_of(plan, r, b, w) < plan.tiles for r in range(rounds(plan))
                for w in range(plan.warps)) for b in range(plan.grid)]
    assert max(busy) - min(busy) <= 1  # the tiles spread evenly over the SMs


@pytest.mark.parametrize("bad", [dict(n=0), dict(sms=0), dict(precision="f32"), dict(width=7),
                                 dict(rows=32), dict(smem_limit=1_000)])
def test_plan_refuses_what_the_kernel_does_not_take(bad):
    args = dict(n=10, width=20, n_stack=9, precision="bf16", sms=SMS) | bad
    with pytest.raises(ValueError, match="K2"):
        k2_plan.k2_plan(**args)


class RecordingLibrary:
    """Stands in for a width's K2 library: its tile and warps, and the
    cheap tiers' entries, which record the arguments of each launch."""

    def __init__(self, width: int):
        self.calls = []
        self.k2_mma_rows = lambda: k2_plan.ROWS
        for tier in TIERS:
            setattr(self, f"k2_mma_warps_{tier}", lambda t=tier: k2_plan.block_warps(t, width))
            setattr(self, f"k2_mlp_fwd_tangents_{tier}",
                    lambda *args: self.calls.append(args) or 0)


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
@pytest.mark.parametrize("precision", TIERS)
@pytest.mark.parametrize("width", K2_WIDTHS)
def test_k2_wrapper_passes_the_plan(card_stand_in, width, precision, mode, net):  # noqa: F811
    hidden, d_out = NETS[net]
    epilogue = mode == "epilogue"
    kt = 2 if epilogue else int(mode[-1])
    if epilogue:
        d_out = 3
    spec, params = _net(width, hidden, d_out, d_in=max(2, kt))
    n = 21_141
    x = torch.zeros((n, spec.d_in))
    lib = RecordingLibrary(width)
    out = dict(fc=torch.empty(n)) if epilogue else dict(
        y=torch.empty((n, d_out)), dy=torch.empty((kt, n, d_out)) if kt else None)
    kernels._launch_k2(params, x, spec, kt, precision, epilogue=epilogue, lib=lib, **out)
    plan = k2_plan.k2_plan(n, width, hidden - 1, precision, SMS)
    (args,) = lib.calls
    assert args[-3:-1] == (plan.grid, plan.chunk)
    assert args[10:17] == (n, spec.d_in, d_out, hidden - 1, kt, 0, int(epilogue))
    assert plan.grid == min(SMS, plan.tiles)
