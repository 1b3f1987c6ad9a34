"""The port's plots and video (``plotting.py``) and their CLI verbs
(``test --plot``, ``plot-log``, ``video``), held against the JAX package's
``plotting.py``: the same files under the same names, the same pixels
(``matplotlib.image.imread``), the same frame count. And the named error
where ``matplotlib`` or ``cv2`` is missing, as on the card's machine.
"""

import json
import os
import pathlib
import sys

import cv2
import matplotlib.image as mpimg
import numpy as np
import pytest

from pinn_depthestimation_tpu import plotting as jplotting
from pinn_depthestimation_tpu.inference import InferenceResult as JResult
from pinn_depthestimation_tpu_torch import cli, plotting
from pinn_depthestimation_tpu_torch.inference import InferenceResult
from pinn_depthestimation_tpu_torch.training.logging_utils import LossLog
from pinn_depthestimation_tpu_torch.utils import synthetic

REPO = pathlib.Path(__file__).resolve().parent.parent


def grids(ny=8, nx=11, seed=0):
    rng = np.random.RandomState(seed)
    x, y = np.meshgrid(np.linspace(20, 40, nx), np.linspace(-15, 15, ny))
    fields = {k: rng.uniform(-1, 1, (ny, nx)) for k in ("U", "V", "h", "eta_mean", "z")}
    pred = {k: v + 0.05 * rng.randn(ny, nx) for k, v in fields.items()}
    t = np.full((ny, nx), 7.0)
    return {"x": x, "y": y, "t": t}, fields, pred


def pixels_equal(a: str, b: str) -> None:
    assert os.path.basename(a) == os.path.basename(b)
    np.testing.assert_array_equal(mpimg.imread(a), mpimg.imread(b))


def test_result_plots_match_the_jax_package(tmp_path):
    inputs, true, pred = grids()
    cfg = {"plot": {"font_size": 12, "x_limits": [22, 38], "y_limits": [-12, 12]}}
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jpaths = jplotting.make_result_plots(
        JResult(pred=pred, true=true, inputs=inputs), {"plot": {**cfg["plot"], "dir": str(jdir)}},
        cross_section=3)
    ppaths = plotting.make_result_plots(
        InferenceResult(pred=pred, true=true, inputs=inputs),
        {"plot": {**cfg["plot"], "dir": str(pdir)}}, cross_section=3)
    assert [os.path.basename(p) for p in ppaths] == [os.path.basename(p) for p in jpaths]
    assert {os.path.basename(p) for p in ppaths} == {
        "quiver_07.0sec.png", "depth_07.0sec.png", "eta_07.0sec.png",
        "eta_CS3_7.000sec.png", "depth_CS3_7.000sec.png"}
    for a, b in zip(ppaths, jpaths):
        pixels_equal(a, b)
    with pytest.raises(ValueError, match="cross_section row 8"):
        plotting.make_result_plots(InferenceResult(pred=pred, true=true, inputs=inputs),
                                   {"plot": {"dir": str(pdir)}}, cross_section=8)
    with pytest.raises(ValueError, match="2-D x/y"):
        plotting.make_result_plots(InferenceResult(pred=pred, true=true, inputs={}), {})


def test_single_plots_match_the_jax_package(tmp_path):
    inputs, true, pred = grids(seed=1)
    x, y, t = inputs["x"], inputs["y"], inputs["t"]
    for name, args in (
        ("plot_cmap", (t, x, y, pred["h"])),
        ("plot_2lines", (t[2], x[2], y[2], true["z"][2], pred["z"][2])),
    ):
        outs = []
        for mod, sub in ((jplotting, "jax"), (plotting, "port")):
            cfg = {"plot": {"dir": str(tmp_path / sub)}}
            extra = ("h", -2, 1) if name == "plot_cmap" else ("eta", -0.5, 1.5, 2)
            outs.append(getattr(mod, name)(*args, cfg, *extra))
        pixels_equal(outs[1], outs[0])


def write_log(run_dir: str, rows: int = 40) -> None:
    fid, res = np.geomspace(1.0, 0.01, rows), np.geomspace(2.0, 0.05, rows)
    LossLog(run_dir).append((i + 1, f, r, f + r) for i, (f, r) in enumerate(zip(fid, res)))


def test_plot_log_matches_the_jax_package(tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    write_log(str(run))
    a = plotting.plot_log(str(run), str(tmp_path / "port"), x_max=50)
    b = jplotting.plot_log(str(run), str(tmp_path / "jax"), x_max=50)
    assert os.path.basename(a) == "log.png"
    pixels_equal(a, b)


def frames(path: str) -> int:
    cap = cv2.VideoCapture(path)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def test_video_has_the_jax_frame_count(tmp_path):
    src = tmp_path / "pngs"
    src.mkdir()
    rng = np.random.RandomState(2)
    for i in range(4):
        cv2.imwrite(str(src / f"f{i:02d}.png"), (rng.rand(32, 48, 3) * 255).astype(np.uint8))
    a = plotting.images_to_video(str(src), str(tmp_path / "port.avi"), frame_rate=3)
    b = jplotting.images_to_video(str(src), str(tmp_path / "jax.avi"), frame_rate=3)
    assert frames(a) == frames(b) == 4
    with pytest.raises(ValueError, match="no .png images"):
        plotting.images_to_video(str(tmp_path), str(tmp_path / "none.avi"))


@pytest.fixture
def served(tmp_path):
    mat = str(tmp_path / "grid.mat")
    synthetic.make_newmethod_mat(mat, nx=12, ny=10, nan_fraction=0.1, seed=3)
    with open(REPO / "examples" / "newmethod.json") as f:
        raw = json.load(f)
    raw["layers"].update(hidden_layers=3, hidden_width=20)
    raw["data"]["file"] = mat
    raw["data_test"].update(file=mat, nx=12, ny=10)
    raw["plot"]["dir"] = str(tmp_path / "cfg_plots")
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(raw, f)
    return cfg_path, str(REPO / "tests" / "data" / "jax_state_w20x3.npz")


def test_cli_verbs_on_the_cpu(tmp_path, served, capsys):
    cfg_path, model = served
    out = tmp_path / "plots"
    assert cli.main(["test", "--config", cfg_path, "--model", model, "--device", "cpu",
                     "--plot", str(out), "--cross-section", "4"]) == 0
    written = sorted(os.listdir(out))
    assert written == ["depth_00.0sec.png", "depth_CS4_0.000sec.png", "quiver_00.0sec.png"]
    assert "Wrote " in capsys.readouterr().out
    assert cli.main(["test", "--config", cfg_path, "--model", model, "--device", "cpu",
                     "--plot"]) == 0
    assert sorted(os.listdir(tmp_path / "cfg_plots")) == [  # the config's dir, the mid row
        "depth_00.0sec.png", "depth_CS5_0.000sec.png", "quiver_00.0sec.png"]
    assert cli.main(["test", "--config", cfg_path, "--model", model, "--device", "cpu",
                     "--plot", str(out), "--cross-section", "99"]) == 1
    assert "Error making plots: cross_section row 99" in capsys.readouterr().out
    run = tmp_path / "run"
    run.mkdir()
    write_log(str(run))
    assert cli.main(["plot-log", "--run-dir", str(run)]) == 0
    assert os.path.exists(run / "log.png")
    assert cli.main(["plot-log", "--run-dir", str(run), "--out", str(tmp_path / "lp")]) == 0
    assert os.path.exists(tmp_path / "lp" / "log.png")
    avi = tmp_path / "v.avi"
    assert cli.main(["video", "--dir", str(out), "--out", str(avi), "--fps", "2"]) == 0
    # OpenCV drops frames of another size than the first, in both packages
    javi = jplotting.images_to_video(str(out), str(tmp_path / "j.avi"), frame_rate=2)
    assert frames(str(avi)) == frames(javi) >= 1


def test_missing_libraries_give_the_named_error(tmp_path, served, capsys, monkeypatch):
    """As on the card's machine: no matplotlib, no cv2. ``test --plot``
    prints the JAX CLI's ``Error making plots:`` line; ``video`` and
    ``plot-log`` exit 1 naming the module; nothing is installed."""
    cfg_path, model = served
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert cli.main(["test", "--config", cfg_path, "--model", model, "--device", "cpu",
                     "--plot", str(tmp_path / "p")]) == 1
    out = capsys.readouterr().out
    assert "Error making plots:" in out and "'matplotlib'" in out and "does not install" in out
    run = tmp_path / "run"
    run.mkdir()
    write_log(str(run))
    assert cli.main(["plot-log", "--run-dir", str(run)]) == 1
    assert "'matplotlib'" in capsys.readouterr().out
    src = tmp_path / "pngs"
    src.mkdir()
    (src / "a.png").write_bytes(b"")
    assert cli.main(["video", "--dir", str(src), "--out", str(tmp_path / "v.avi")]) == 1
    assert "'cv2'" in capsys.readouterr().out
    with pytest.raises(ImportError, match="'matplotlib'"):
        plotting.plot_cmap(np.zeros(1), np.zeros((2, 2)), np.zeros((2, 2)), np.zeros((2, 2)),
                           {}, "h", 0, 1)


def test_train_profile_writes_a_trace(tmp_path, served, capsys):
    """``train --profile DIR`` (JAX ``cli.py:148-156``): announces the trace
    and writes a Chrome trace of the training to ``DIR/trace.json``."""
    cfg_path, _ = served
    with open(cfg_path) as f:
        raw = json.load(f)
    raw["adam_optimizer"]["max_it"] = 3
    raw["lbfgs_optimizer"]["max_it"] = 0
    with open(cfg_path, "w") as f:
        json.dump(raw, f)
    prof = tmp_path / "prof"
    assert cli.main(["train", "--config", cfg_path, "--log-root", str(tmp_path), "--run-name",
                     "p", "--device", "cpu", "--profile", str(prof)]) == 0
    assert f"Profiler trace -> {prof}" in capsys.readouterr().out
    with open(prof / "trace.json") as f:
        trace = json.load(f)
    assert trace["traceEvents"]
