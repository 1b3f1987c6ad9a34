"""The port reads the JAX package's ``.msgpack`` checkpoints
(``training.checkpoint.restore_params_any`` through ``utils.msgpack_lite``),
held against the JAX package's own writer and reader.

Exactness: a checkpoint's parameters load bit for bit (the same float32
bytes); the decoder's tree equals ``flax.serialization.msgpack_restore``'s
value for value (arrays by dtype, shape and bytes).
"""

import json
import pathlib

import jax
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from pinn_depthestimation_tpu.models import MLPSpec as JSpec
from pinn_depthestimation_tpu.models import init_mlp_params as j_init
from pinn_depthestimation_tpu.training import checkpoint as jckpt
from pinn_depthestimation_tpu_torch import cli
from pinn_depthestimation_tpu_torch.config import parse_config
from pinn_depthestimation_tpu_torch.inference import Predictor
from pinn_depthestimation_tpu_torch.models import PARAM_KEYS, MLPSpec
from pinn_depthestimation_tpu_torch.training.checkpoint import restore_params_any
from pinn_depthestimation_tpu_torch.utils import msgpack_lite, synthetic

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "data" / "jax_state_w20x3"  # .msgpack and .npz
SIZES = (2, 24, 24, 3)


def jax_params(sizes, seed=3):
    params = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(seed), JSpec(sizes=sizes)))
    params["b_hidden"] = np.random.RandomState(seed).uniform(
        -0.1, 0.1, params["b_hidden"].shape).astype(np.float32)
    return params


@pytest.mark.parametrize("form", ["full_state", "bare_params"])
def test_jax_checkpoint_loads_bit_for_bit(tmp_path, form):
    params = jax_params(SIZES)
    state = ({"params": params, "opt_state": optax.adam(1e-3).init(params), "iteration": 42}
             if form == "full_state" else params)
    path = jckpt.save_checkpoint(str(tmp_path / "ckpt"), state)
    got = restore_params_any(path, spec=MLPSpec(sizes=SIZES), device="cpu")
    want = jckpt.restore_params(path, params)
    for k in PARAM_KEYS:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert got[k].numpy().tobytes() == np.asarray(params[k], np.float32).tobytes()


def test_committed_fixture_equals_its_npz_and_the_jax_reader():
    """The fixture chip_smoke.py phase 30 serves on the card: written by the
    JAX package's save_checkpoint (a full training state), beside the same
    weights as .npz."""
    spec = MLPSpec(sizes=(2, 20, 20, 20, 3))
    got = restore_params_any(str(FIXTURE) + ".msgpack", spec=spec, device="cpu")
    npz = restore_params_any(str(FIXTURE) + ".npz", spec=spec, device="cpu")
    with np.load(str(FIXTURE) + ".npz") as f:
        template = {k: f[k] for k in PARAM_KEYS}
    want = jckpt.restore_params(str(FIXTURE) + ".msgpack", template)
    for k in PARAM_KEYS:
        assert torch.equal(got[k], npz[k])
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    raw = msgpack_lite.read(str(FIXTURE) + ".msgpack")
    assert set(raw) == {"params", "opt_state", "iteration"} and raw["iteration"] == 1000


def test_wrong_architecture_raises_as_for_npz(tmp_path):
    params = jax_params(SIZES)
    path = jckpt.save_checkpoint(str(tmp_path / "ckpt"), {"params": params, "iteration": 1})
    np.savez(tmp_path / "same.npz", **params)
    other = MLPSpec(sizes=(2, 24, 24, 24, 3))
    with pytest.raises(ValueError, match="architecture") as from_msgpack:
        restore_params_any(path, spec=other, device="cpu")
    with pytest.raises(ValueError, match="architecture") as from_npz:
        restore_params_any(str(tmp_path / "same.npz"), spec=other, device="cpu")
    assert str(from_msgpack.value).split("'", 2)[2] == str(from_npz.value).split("'", 2)[2]
    bad = jckpt.save_checkpoint(str(tmp_path / "bad"), {"params": {"w_in": params["w_in"]}})
    with pytest.raises(KeyError, match="lacks parameter arrays"):
        restore_params_any(bad, device="cpu")
    with pytest.raises(ValueError, match="orbax"):
        restore_params_any(str(tmp_path / "x.orbax"), device="cpu")


def test_chunked_arrays_are_put_back_together(tmp_path, monkeypatch):
    """flax splits an array over MAX_CHUNK_SIZE bytes into chunks; the
    decoder joins them as flax's reader does (a small limit forces it)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    params = jax_params(SIZES)
    blob = serialization.to_bytes({"params": params, "iteration": 5})
    assert b"__msgpack_chunked_array__" in blob
    got = msgpack_lite.unpackb(blob)
    want = serialization.msgpack_restore(blob)
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(got["params"][k], want["params"][k])
        np.testing.assert_array_equal(got["params"][k], params[k])


def _same(a, b):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b)
        for k in b:
            _same(a[k], b[k])
    elif isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    elif isinstance(b, float) and np.isnan(b):
        assert isinstance(a, float) and np.isnan(a)
    else:
        assert type(a) is type(b) and a == b


_DTYPES = ("float32", "float64", "int32", "int64", "uint8", "int8", "bool", "float16", "uint32")


@st.composite
def arrays(draw):
    dtype = np.dtype(draw(st.sampled_from(_DTYPES)))
    shape = tuple(draw(st.lists(st.integers(0, 4), max_size=3)))
    size = int(np.prod(shape)) if shape else 1
    raw = draw(st.binary(min_size=size * dtype.itemsize, max_size=size * dtype.itemsize))
    return np.frombuffer(raw, dtype=np.uint8).view(dtype).reshape(shape).copy()


_leaves = st.one_of(
    st.none(), st.booleans(), st.integers(-2**63, 2**64 - 1),
    st.floats(allow_nan=True, allow_infinity=True), st.text(max_size=40),
    st.binary(max_size=300), arrays(),
    st.builds(np.float32, st.floats(width=32, allow_nan=False)),
    st.builds(np.int64, st.integers(-2**63, 2**63 - 1)),
    st.complex_numbers(allow_nan=False, allow_infinity=False),
)
_trees = st.recursive(
    _leaves,
    lambda kids: st.one_of(st.lists(kids, max_size=5),
                           st.dictionaries(st.text(max_size=12), kids, max_size=5)),
    max_leaves=25,
)


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(tree=st.dictionaries(st.text(max_size=12), _trees, max_size=5))
def test_decoder_equals_flax_on_drawn_trees(tree):
    blob = serialization.msgpack_serialize(tree)
    _same(msgpack_lite.unpackb(blob), serialization.msgpack_restore(blob))


def test_truncated_data_raises():
    blob = serialization.to_bytes({"params": jax_params(SIZES)})
    with pytest.raises(ValueError, match="ends inside"):
        msgpack_lite.unpackb(blob[:-7])


def test_predictor_and_cli_serve_a_msgpack_as_its_npz(tmp_path):
    """``test --model`` and ``Predictor`` take the .msgpack and predict the
    .npz's grid bit for bit; ``--init-from`` trains from it."""
    mat = str(tmp_path / "grid.mat")
    synthetic.make_newmethod_mat(mat, nx=12, ny=10, nan_fraction=0.1, seed=3)
    with open(REPO / "examples" / "newmethod.json") as f:
        raw = json.load(f)
    raw["layers"].update(hidden_layers=3, hidden_width=20)
    raw["data"]["file"] = mat
    raw["data_test"].update(file=mat, nx=12, ny=10)
    raw["adam_optimizer"]["max_it"] = 2
    raw["lbfgs_optimizer"]["max_it"] = 0
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(raw, f)
    cfg = parse_config(raw)
    a = Predictor(cfg, str(FIXTURE) + ".msgpack", device="cpu").run()
    b = Predictor(cfg, str(FIXTURE) + ".npz", device="cpu").run()
    for k in b.pred:
        np.testing.assert_array_equal(a.pred[k], b.pred[k])
    outs = []
    for ext in ("msgpack", "npz"):
        out = str(tmp_path / f"pred_{ext}.mat")
        assert cli.main(["test", "--config", cfg_path, "--model", f"{FIXTURE}.{ext}",
                         "--save", out, "--device", "cpu"]) == 0
        from scipy.io import loadmat

        outs.append(loadmat(out))
    for k in ("pred_U", "pred_V", "pred_h"):
        np.testing.assert_array_equal(outs[0][k], outs[1][k])
    assert cli.main(["train", "--config", cfg_path, "--init-from", f"{FIXTURE}.msgpack",
                     "--log-root", str(tmp_path), "--run-name", "warm", "--device", "cpu"]) == 0
