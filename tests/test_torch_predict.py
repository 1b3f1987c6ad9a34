"""The port's serving path on the CPU, held against the JAX package:
test-grid loading, weights files, ``Predictor.run``, the CLI, the bench, and
the rules the port keeps (no JAX/flax/pandas, no CPU fallback).

Tolerance for predictions: 1e-5 relative plus 1e-6 absolute — f32 against
f32 with ``Precision.HIGHEST``, summed in other orders.
"""

import json
import os
import pathlib
import re
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
from scipy.io import loadmat

from pinn_depthestimation_tpu import config as jconfig
from pinn_depthestimation_tpu import data as jdata
from pinn_depthestimation_tpu.inference import Predictor as JPredictor
from pinn_depthestimation_tpu.models import MLPSpec as JSpec
from pinn_depthestimation_tpu.models import init_mlp_params as j_init
from pinn_depthestimation_tpu.utils import synthetic as jsynthetic
from pinn_depthestimation_tpu.utils import torch_interop as jinterop
from pinn_depthestimation_tpu_torch import benchmarks, cli, data
from pinn_depthestimation_tpu_torch.config import parse_config
from pinn_depthestimation_tpu_torch.inference import Predictor
from pinn_depthestimation_tpu_torch.models import PARAM_KEYS, MLPSpec, params_to_numpy
from pinn_depthestimation_tpu_torch.training.checkpoint import restore_params_any
from pinn_depthestimation_tpu_torch.utils import synthetic, torch_interop

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "pinn_depthestimation_tpu_torch"
SIZES = (2, 12, 12, 12, 3)
NX, NY = 12, 10


def raw_config(mat, **extra):
    with open(REPO / "examples" / "newmethod.json") as f:
        raw = json.load(f)
    raw["layers"].update(hidden_layers=len(SIZES) - 2, hidden_width=SIZES[1])
    raw["data"]["file"] = mat
    raw["data_test"].update(file=mat, nx=NX, ny=NY)
    raw.update(extra)
    return raw


@pytest.fixture
def served(tmp_path):
    """A synthetic grid (with NaN rows in the trues), a reference-layout
    .pth of JAX-initialized weights, and the config pointing at both."""
    mat = str(tmp_path / "grid.mat")
    jsynthetic.make_newmethod_mat(mat, nx=NX, ny=NY, nan_fraction=0.1, seed=3)
    params = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(7), JSpec(sizes=SIZES)))
    params["b_hidden"] = np.random.RandomState(0).uniform(-0.1, 0.1, params["b_hidden"].shape
                                                          ).astype(np.float32)
    pth = str(tmp_path / "model_1000.pth")
    torch.save(jinterop.torch_state_dict_from_params(params), pth)
    raw = raw_config(mat)
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(raw, f)
    return types.SimpleNamespace(mat=mat, params=params, pth=pth, raw=raw, cfg_path=cfg_path)


def test_synthetic_grid_matches_jax(tmp_path):
    a, b = str(tmp_path / "a.mat"), str(tmp_path / "b.mat")
    cols = synthetic.make_newmethod_mat(a, nx=9, ny=7, nan_fraction=0.2, seed=5, fields="structured")
    jcols = jsynthetic.make_newmethod_mat(b, nx=9, ny=7, nan_fraction=0.2, seed=5, fields="structured")
    for k in jcols:
        np.testing.assert_array_equal(cols[k], jcols[k])
        np.testing.assert_array_equal(loadmat(a)[k], loadmat(b)[k])


def test_load_test_data_matches_jax(served):
    t = data.load_test_data(parse_config(served.raw))
    j = jdata.load_test_data(jconfig.parse_config(served.raw))
    np.testing.assert_array_equal(t.inputs, j.inputs)
    assert t.inputs.dtype == np.float32 and t.inputs.shape == (NX * NY, 2)
    assert t.input_min_max == j.input_min_max == {"x": (25.0, 33.0), "y": (-13.0, 13.0)}
    assert set(t.trues) == {"U", "V", "h"}
    for k in t.trues:
        np.testing.assert_array_equal(t.trues[k], j.trues[k])
    arr = np.arange(12.0).reshape(3, 4)
    np.testing.assert_array_equal(data._fortran_column(arr), jdata._fortran_column(arr))
    with pytest.raises(KeyError, match="nope"):
        data.load_mat_var(served.mat, "nope")


def test_pth_round_trip_through_jax_export(served, tmp_path):
    """JAX export -> port load is exact; port export -> JAX load is exact."""
    loaded = torch_interop.params_from_torch_file(served.pth, spec=MLPSpec(sizes=SIZES))
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(loaded[k], served.params[k])
    sd = torch_interop.torch_state_dict_from_params(loaded)
    jsd = jinterop.torch_state_dict_from_params(served.params)
    assert list(sd) == list(jsd)
    for k in sd:
        assert torch.equal(sd[k], jsd[k])
    back = str(tmp_path / "port.pth")
    torch.save(sd, back)
    again = jinterop.params_from_torch_file(back, spec=JSpec(sizes=SIZES))
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(again[k], served.params[k])


def test_whole_module_pickle_loads_without_reference_source(served, tmp_path):
    """A reference-style whole-module pickle of class dnn.DNN loads through
    the stub unpickler, and the stub is gone afterwards."""
    mod = types.ModuleType("dnn")

    class DNN(torch.nn.Module):
        pass

    DNN.__module__, DNN.__qualname__ = "dnn", "DNN"
    mod.DNN = DNN
    sys.modules["dnn"] = mod
    try:
        net = DNN()
        layers = []
        sd = jinterop.torch_state_dict_from_params(served.params)
        for i in range(len(SIZES) - 1):
            lin = torch.nn.Linear(SIZES[i], SIZES[i + 1])
            lin.load_state_dict({"weight": sd[f"layers.layer_{i}.weight"],
                                 "bias": sd[f"layers.layer_{i}.bias"]})
            layers += [lin, torch.nn.Tanh()]
        net.layers = torch.nn.Sequential(*layers[:-1])
        path = str(tmp_path / "whole.pth")
        torch.save(net, path)
    finally:
        sys.modules.pop("dnn", None)
    loaded = torch_interop.params_from_torch_file(path, spec=MLPSpec(sizes=SIZES))
    assert "dnn" not in sys.modules
    for k in PARAM_KEYS:
        np.testing.assert_array_equal(loaded[k], served.params[k])


def test_weights_files_npz_and_refusals(served, tmp_path):
    spec = MLPSpec(sizes=SIZES)
    npz = str(tmp_path / "w.npz")
    np.savez(npz, **served.params)
    p = restore_params_any(npz, spec, device="cpu")
    assert all(np.array_equal(params_to_numpy(p)[k], served.params[k]) for k in PARAM_KEYS)
    with pytest.raises(ValueError, match="does not match"):
        restore_params_any(npz, MLPSpec(sizes=(2, 12, 12, 3)), device="cpu")
    with pytest.raises(ValueError, match="torch_state_dict_from_params"):
        restore_params_any(str(tmp_path / "model_5.orbax"), spec, device="cpu")
    with pytest.raises(FileNotFoundError):  # .msgpack is read (tests/test_torch_msgpack.py)
        restore_params_any(str(tmp_path / "model_5.msgpack"), spec, device="cpu")
    with pytest.raises(ValueError, match="unknown weights format"):
        restore_params_any(str(tmp_path / "w.bin"), spec, device="cpu")
    np.savez(npz, w_in=served.params["w_in"])
    with pytest.raises(KeyError, match="w_out"):
        restore_params_any(npz, spec, device="cpu")


def test_predictor_run_matches_jax(served):
    got = Predictor(parse_config(served.raw), served.pth, device="cpu").run()
    want = JPredictor(jconfig.parse_config(served.raw), served.pth).run()
    assert set(got.pred) == set(want.pred) == {"U", "V", "h"}
    for k in want.pred:
        assert got.pred[k].shape == (NY, NX)
        np.testing.assert_allclose(got.pred[k], want.pred[k], rtol=1e-5, atol=1e-6)
    for k in want.inputs:
        np.testing.assert_allclose(got.inputs[k], want.inputs[k], rtol=1e-12)
    for k in want.true:
        np.testing.assert_array_equal(got.true[k], want.true[k])
    assert got.adapted is want.adapted is False


def test_predictor_flagship_depth_matches_jax(tmp_path):
    """The 2->[20]x100->3 flagship on a small grid, weights handed over as .npz."""
    mat = str(tmp_path / "g.mat")
    jsynthetic.make_newmethod_mat(mat, nx=8, ny=8, nan_fraction=0.0, seed=1)
    raw = raw_config(mat)
    raw["layers"].update(hidden_layers=100, hidden_width=20)
    raw["data_test"].update(nx=8, ny=8)
    params = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(2), JSpec(sizes=(2,) + (20,) * 100 + (3,))))
    npz = str(tmp_path / "flagship.npz")
    np.savez(npz, **params)
    want_y = JPredictor(jconfig.parse_config(raw), None)
    raw["data_test"]["model"] = npz  # the port's default weights path
    got = Predictor(parse_config(raw), device="cpu")
    want_y.params = jax.tree.map(jax.numpy.asarray, params)
    td = jdata.load_test_data(jconfig.parse_config(raw))
    np.testing.assert_allclose(got.predict(td.inputs), want_y.predict(td.inputs), rtol=1e-4, atol=1e-6)


def test_predictor_seeded_init_is_deterministic(served):
    raw = dict(served.raw, seed=11)
    a = Predictor(parse_config(raw), device="cpu")
    b = Predictor(parse_config(raw), device="cpu")
    assert all(torch.equal(a.params[k], b.params[k]) for k in PARAM_KEYS)
    assert not a.use_kernel  # the CPU never takes the CUDA kernel


def test_adaptation_raises_not_implemented(served):
    """Test-time adaptation is ported (``tests/test_torch_adapt.py`` holds it
    to the JAX package), its legacy equation ``navier_stokes`` too
    (``tests/test_torch_legacy.py``): nothing raises ``NotImplementedError``;
    an ``(x, y)`` grid cannot feed ``navier_stokes`` and says which
    coordinate it lacks."""
    raw = dict(served.raw, perform_optimization=True)
    pred = Predictor(parse_config(raw), served.pth, device="cpu")
    assert pred.run().adapted
    with pytest.raises(ValueError, match=r"needs input coordinates .*missing \['t'\]"):
        pred.adapt(np.zeros((4, 2), np.float32), equation="navier_stokes")


def test_cli_test_save_keys_and_synth(served, tmp_path, capsys):
    out = str(tmp_path / "pred.mat")
    rc = cli.main(["test", "--config", served.cfg_path, "--model", served.pth,
                   "--save", out, "--device", "cpu"])
    assert rc == 0
    saved = loadmat(out)
    assert sorted(k for k in saved if not k.startswith("__")) == ["pred_U", "pred_V", "pred_h"]
    want = JPredictor(jconfig.parse_config(served.raw), served.pth).run()
    for k in ("U", "V", "h"):
        np.testing.assert_allclose(saved[f"pred_{k}"], want.pred[k], rtol=1e-5, atol=1e-6)
    assert "Prediction done!" in capsys.readouterr().out
    assert cli.main(["test", "--config", str(tmp_path / "missing.json"), "--device", "cpu"]) == 1
    assert cli.main(["synth", "--out", str(tmp_path / "s"), "--nx", "5", "--ny", "4"]) == 0
    # the newmethod grid and the CMB pair, as the JAX synth verb writes them
    assert sorted(os.listdir(tmp_path / "s")) == ["data_synth.mat", "input_fid.csv",
                                                  "input_res.mat"]
    assert loadmat(str(tmp_path / "s" / "data_synth.mat"))["x"].shape == (20, 1)


def test_bench_on_cpu_is_tagged_and_kernel_equals_plain():
    rec = benchmarks.run_residual_bench(n_points=300, reps=1, device="cpu")
    assert rec["metric"] == "residual_evals_per_sec[cpu-plain]"
    assert rec["value"] > 0 and rec["vs_baseline"] is None
    spec, params, coords = benchmarks.flagship_bench_inputs(50, torch.device("cpu"))
    assert spec.sizes == (2,) + (20,) * 100 + (3,)
    k_fn, k_name = benchmarks.residual_eval_fn(spec, "kernel")
    p_fn, p_name = benchmarks.residual_eval_fn(spec, "plain")
    assert (k_name, p_name) == ("k2-f32", "plain")
    torch.testing.assert_close(k_fn(params, coords), p_fn(params, coords), rtol=1e-6, atol=1e-9)
    with pytest.raises(ValueError, match="backend"):
        benchmarks.residual_eval_fn(spec, "xla")


def test_entry_points_need_cuda_unless_cpu_is_asked_for(served, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = parse_config(served.raw)
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(cfg, served.pth)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["test", "--config", served.cfg_path, "--model", served.pth])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["bench", "--points", "10"])
    with pytest.raises(RuntimeError, match="CUDA"):
        benchmarks.run_residual_bench(n_points=10)
    assert Predictor(cfg, served.pth, device="cpu").device.type == "cpu"


def test_kernel_precision_tier_refused_on_the_kernel_path(served, monkeypatch):
    """On CUDA the Predictor takes K2 at the config's tier: f32x3 serves
    through K2-f32x3, bf16 through K2-bf16; an unknown tier raises at
    construction instead of serving another."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(
        "pinn_depthestimation_tpu_torch.inference.restore_params_any",
        lambda *a, **k: {},
    )
    raw = dict(served.raw, kernel_precision="f32x3")
    raw["layers"] = dict(raw["layers"], hidden_width=20)  # a width K2 takes
    cfg = parse_config(raw)
    f32x3 = Predictor(cfg, served.pth)
    assert f32x3.use_kernel and f32x3.precision == "f32x3"
    cfg.kernel_precision = "fp8"
    with pytest.raises(ValueError, match="precision"):
        Predictor(cfg, served.pth)
    bf16 = Predictor(parse_config(dict(raw, kernel_precision="bf16")), served.pth)
    assert bf16.use_kernel and bf16.precision == "bf16"


def _port_files():
    files = sorted(p for p in PORT.rglob("*") if p.suffix in (".py", ".cu", ".cuh"))
    return files + [REPO / "chip_smoke.py"]


def test_port_never_names_the_jax_package_or_imports_jax():
    assert len(_port_files()) > 15
    banned_import = re.compile(r"^\s*(import|from)\s+(jax|flax|pandas|optax|orbax)\b", re.M)
    for path in _port_files():
        text = path.read_text()
        assert "pinn_depthestimation_tpu." not in text, path
        assert not banned_import.search(text), path


def test_importing_the_port_loads_no_jax_flax_or_pandas():
    """A fresh interpreter (this one has JAX loaded by conftest.py) imports
    every module of the port (``plotting`` and ``utils.msgpack_lite``
    among them) and chip_smoke.py, and loads no JAX, flax or pandas, nor
    matplotlib, cv2 or msgpack: the plots import theirs when they run."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import pinn_depthestimation_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'pandas', 'optax', 'orbax', 'pinn_depthestimation_tpu', "
        "'matplotlib', 'cv2', 'msgpack'))\n"
        "assert not bad, bad\n"
        "assert 'pinn_depthestimation_tpu_torch.plotting' in names, names\n"
        "assert 'pinn_depthestimation_tpu_torch.utils.msgpack_lite' in names, names\n"
        "assert len(names) >= 15, names\n"
        "import torch\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "assert torch.backends.cudnn.allow_tf32 is False\n"
        "print('ok', len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
