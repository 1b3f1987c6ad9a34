"""Host-side plots and the PNG-to-video tool (port of the JAX package's
``plotting.py``; capability parity with the reference ``plots.py`` and
``utilities/imgtovid.py``).

The same five plot products with the same file names, limits and
timestamp suffixes, reading the ``log.txt`` schema the trainer writes:

* :func:`plot_quiver`        — exact-vs-predicted current overlay, every
  10th grid point (``quiver_<t>sec.png``);
* :func:`plot_cmap`          — one pcolor field map (``<var>_<t>sec.png``);
* :func:`plot_cmap_2column`  — true/pred maps side by side;
* :func:`plot_2lines`        — a 1-D cross-shore exact-vs-pred profile
  (``<var>_CS<row>_<t>sec.png``);
* :func:`plot_log`           — loss curves from ``log.txt``, log-scale y
  (``log.png``);

:func:`make_result_plots` wires an ``inference.InferenceResult`` into them
and :func:`images_to_video` turns a PNG sequence into an XVID AVI.

Every function takes host numpy arrays. ``matplotlib`` (its Agg backend)
and ``cv2`` are imported inside the functions that need them, never when
this module is imported: the port does not install either, and the card's
machine has neither. Where one is missing the call raises an
``ImportError`` that names it.
"""

from __future__ import annotations

import glob
import os

import numpy as np


def _require(module: str, what: str):
    """Import ``module`` for ``what``, or raise an ImportError naming it."""
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError as e:
        package = {"matplotlib": "matplotlib", "cv2": "opencv-python"}[module]
        raise ImportError(
            f"{what} needs the {module!r} module ({package}), which is not installed; "
            "the port does not install it"
        ) from e


def _plt():
    matplotlib = _require("matplotlib", "plotting")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _raw(config) -> dict:
    return config.raw if hasattr(config, "raw") else config


def _plot_dir(config) -> str:
    folder = _raw(config).get("plot", {}).get("dir", ".")
    os.makedirs(folder, exist_ok=True)
    return folder


def _limits(config):
    p = _raw(config).get("plot", {})
    return p.get("font_size", 14), p.get("x_limits"), p.get("y_limits")


def _timestamp_suffix(t) -> str:
    t = np.asarray(t)
    while t.ndim > 0:
        t = t[0]
    return str(t).zfill(4)


def _axes_limits(ax, x_limits, y_limits) -> None:
    if x_limits:
        ax.set_xlim(x_limits)
    if y_limits:
        ax.set_ylim(y_limits)


def plot_quiver(t, x, y, u_true, v_true, u_pred, v_pred, config, *, stride=10, scale=25):
    plt = _plt()
    font_size, x_limits, y_limits = _limits(config)
    s = slice(None, None, stride)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.quiver(x[s, s], y[s, s], u_true[s, s], v_true[s, s], color="black", alpha=0.5, scale=scale)
    ax.quiver(x[s, s], y[s, s], u_pred[s, s], v_pred[s, s], color="red", alpha=0.5, scale=scale)
    ax.set_xlabel("X (m)", fontsize=font_size)
    ax.set_ylabel("Y (m)", fontsize=font_size)
    _axes_limits(ax, x_limits, y_limits)
    path = os.path.join(_plot_dir(config), f"quiver_{_timestamp_suffix(t)}sec.png")
    plt.savefig(path, dpi=300)
    plt.tight_layout()
    plt.close(fig)
    return path


def plot_cmap(t, x, y, field, config, var_name, v_min, v_max):
    plt = _plt()
    font_size, x_limits, y_limits = _limits(config)
    fig, ax = plt.subplots(figsize=(6, 6))
    pc = ax.pcolor(x, y, field, shading="auto", vmin=v_min, vmax=v_max)
    cbar = fig.colorbar(pc, ax=ax)
    cbar.set_label(f"{var_name} (m)")
    ax.set_xlabel("X (m)", fontsize=font_size)
    ax.set_ylabel("Y (m)", fontsize=font_size)
    _axes_limits(ax, x_limits, y_limits)
    path = os.path.join(_plot_dir(config), f"{var_name}_{_timestamp_suffix(t)}sec.png")
    plt.savefig(path, dpi=300)
    plt.tight_layout()
    plt.close(fig)
    return path


def plot_cmap_2column(t, x, y, field_true, field_pred, config, var_name, v_min, v_max):
    plt = _plt()
    font_size, x_limits, y_limits = _limits(config)
    fig, axs = plt.subplots(1, 2, figsize=(12, 6))
    for ax, field, label_cbar in ((axs[0], field_true, False), (axs[1], field_pred, True)):
        pc = ax.pcolor(x, y, field, shading="auto")
        cbar = fig.colorbar(pc, ax=ax)
        if label_cbar:
            cbar.set_label(f"{var_name} (m)")
        ax.set_xlabel("X (m)", fontsize=font_size)
        _axes_limits(ax, x_limits, y_limits)
    axs[0].set_ylabel("Y (m)", fontsize=font_size)
    path = os.path.join(_plot_dir(config), f"{var_name}_{_timestamp_suffix(t)}sec.png")
    plt.savefig(path, dpi=300, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_2lines(t, x, y, line_true, line_pred, config, var_name, v_min, v_max, cross_section):
    plt = _plt()
    _, x_limits, _ = _limits(config)
    t0 = np.asarray(t).reshape(-1)[0]
    plt.figure(figsize=(10, 6))
    plt.plot(x, line_true, label="exact")
    plt.plot(x, line_pred, label="Predicted")
    plt.xlabel("Cross-Shore (m)")
    plt.ylabel(f"{var_name}, m")
    if x_limits:
        plt.xlim([x_limits[0], x_limits[1]])
    plt.ylim([v_min, v_max])
    plt.title(f"{var_name}")
    plt.legend()
    path = os.path.join(_plot_dir(config), f"{var_name}_CS{cross_section}_{t0:.3f}sec.png")
    plt.savefig(path, dpi=300, bbox_inches="tight")
    plt.close()
    return path


def plot_log(log_path, plot_path, *, x_max=50_000, y_limits=(0.001, 10)):
    """Loss curves of a run directory's (or a file's) ``log.txt`` into
    ``plot_path/log.png``."""
    from pinn_depthestimation_tpu_torch.training.logging_utils import read_log

    plt = _plt()
    iterations, fid, res, total = read_log(log_path)
    plt.figure(figsize=(10, 6))
    plt.plot(iterations, fid, label="Fidelity Loss")
    plt.plot(iterations, res, label="Residual Loss")
    plt.plot(iterations, total, label="Total Loss")
    plt.xlabel("Iteration")
    plt.ylabel("Loss")
    plt.xlim([0, x_max])
    plt.ylim(list(y_limits))
    plt.title("Loss Values Over Iterations")
    plt.yscale("log")
    plt.legend()
    os.makedirs(plot_path, exist_ok=True)
    path = os.path.join(plot_path, "log.png")
    plt.savefig(path, dpi=300, bbox_inches="tight")
    plt.close()
    return path


def make_result_plots(result, config, *, cross_section: int | None = None) -> list:
    """An ``inference.InferenceResult`` as the reference's plot products
    (reference ``test.py:110-130``, shipped commented out there): the
    exact-vs-predicted currents, the predicted depth map, the true/pred
    eta maps and the cross-shore profiles at row ``cross_section`` (default:
    the mid row; the reference hardcodes 131). A product fires where its
    variables are in ``result.pred`` and ``result.true`` (the depth map:
    ``result.pred`` alone). Returns the paths written."""
    paths: list = []
    x, y = result.inputs.get("x"), result.inputs.get("y")
    if x is None or y is None or np.ndim(x) != 2:
        raise ValueError("plotting needs 2-D x/y input grids — set nx/ny in data_test")
    t = result.inputs.get("t")
    if t is None or np.ndim(t) != 2:
        t = np.zeros_like(x)

    def grid(arr):
        arr = np.asarray(arr, np.float64)
        if arr.shape == x.shape:
            return arr
        if arr.size == x.size:
            return arr.reshape(x.shape)
        return None

    def paired(key):
        if key in result.pred and key in result.true:
            tr, pr = grid(result.true[key]), grid(result.pred[key])
            if tr is not None and pr is not None:
                return tr, pr
        return None

    for ukey, vkey in (("U", "V"), ("u", "v")):  # reference test.py:111
        uu, vv = paired(ukey), paired(vkey)
        if uu and vv:
            paths.append(plot_quiver(t, x, y, uu[0], vv[0], uu[1], vv[1], config))
            break
    if "h" in result.pred:  # reference test.py:114
        h_pred = grid(result.pred["h"])
        if h_pred is not None:
            paths.append(plot_cmap(t, x, y, h_pred, config, "depth", -2, 1))
    for key in ("eta_mean", "eta", "z"):  # reference test.py:117
        pair = paired(key)
        if pair:
            paths.append(plot_cmap_2column(t, x, y, pair[0], pair[1], config, "eta", -1, 1))
            break
    cs = cross_section if cross_section is not None else x.shape[0] // 2
    if not 0 <= cs < x.shape[0]:
        raise ValueError(
            f"cross_section row {cs} out of range for the data_test grid "
            f"(ny={x.shape[0]} rows; the reference's hardcoded 131 only fits "
            f"grids with ny > 131)"
        )
    profile_specs = (  # reference test.py:120-130
        ("z", "eta", 1.0, (-0.5, 1.5)),
        ("u", "u", 1.0, (-3, 3)),
        ("v", "v", 1.0, (-3, 3)),
        ("h", "depth", -1.0, (-1, 0)),  # depth plotted negative-down
    )
    for key, var_name, sign, (v_min, v_max) in profile_specs:
        pair = paired(key)
        if pair:
            paths.append(plot_2lines(t[cs, :], x[cs, :], y[cs, :], sign * pair[0][cs, :],
                                     sign * pair[1][cs, :], config, var_name, v_min, v_max, cs))
    return paths


def images_to_video(image_folder: str, output_path: str, *, frame_rate: int = 5) -> str:
    """The folder's ``*.png`` files, in name order, as an XVID AVI
    (reference ``utilities/imgtovid.py``)."""
    files = sorted(glob.glob(os.path.join(image_folder, "*.png")))
    if not files:
        raise ValueError(f"no .png images found in {image_folder!r}")
    cv2 = _require("cv2", "images_to_video")
    frame = cv2.imread(files[0])
    height, width, _ = frame.shape
    writer = cv2.VideoWriter(output_path, cv2.VideoWriter_fourcc(*"XVID"), frame_rate,
                             (width, height))
    for name in files:
        writer.write(cv2.imread(name))
    writer.release()
    return output_path
