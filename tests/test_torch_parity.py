"""The port's parity harness (``parity.py``, CLI ``parity``) held against the
JAX package's on the CPU.

* The cache descriptor, the meta check, the weights fingerprint and the
  config recipes give the JAX functions' results on the same inputs, for
  every committed ``.soak/`` cache and its flags (exact: they are numpy and
  Python, no arithmetic to round).
* The regenerated data are the JAX generator's, bit for bit, so the
  12,516 flagship rows line up with the cached reference h-field.
* ``PARITY_CMB.md`` recomposes from the committed caches with no training:
  every number it prints, at the precision it prints it.
* A whole small run on the CPU: the JAX ``Trainer`` stands in for the
  reference from seeded numpy weights, and the port's framework phase is
  held to it as ``tests/test_parity.py`` holds the JAX package to the
  reference: iteration 1 within 1e-5 relative, the first 10 losses within
  2e-4 and all 30 within 2e-3.
"""

import argparse
import os
import pathlib
import re

import numpy as np
import pytest
from scipy.io import loadmat

from pinn_depthestimation_tpu import cli as jcli
from pinn_depthestimation_tpu import parity as jparity
from pinn_depthestimation_tpu.config import parse_config as jparse
from pinn_depthestimation_tpu.training import Trainer as JTrainer
from pinn_depthestimation_tpu.training.logging_utils import read_log as jread_log
from pinn_depthestimation_tpu.utils import synthetic as jsynthetic
from pinn_depthestimation_tpu_torch import cli, parity
from pinn_depthestimation_tpu_torch.config import parse_config
from pinn_depthestimation_tpu_torch.data import load_newmethod_training_data, read_csv_columns
from pinn_depthestimation_tpu_torch.utils import synthetic

REPO = pathlib.Path(__file__).resolve().parent.parent
SOAK = REPO / ".soak"

BASE = dict(iters=50_000, lbfgs=500, tol_grad=1e-5, tol_change=1e-7, hidden_layers=100,
            width=20, nx=81, ny=261, nan_fraction=0.408, fields="plane",
            pipeline="newmethod", training_points=0)
CMB = dict(BASE, hidden_layers=10, width=10, nan_fraction=0.05, pipeline="cmb")
TIGHT = dict(CMB, lbfgs=3000, tol_grad=1e-9, tol_change=1e-12)
# every committed cache that carries a descriptor, with its own flags
CACHES = {
    "ref_25k": dict(BASE, iters=25_000),
    "ref_50k": BASE,
    "ref_50k_structured": dict(BASE, fields="structured"),
    "ref_50k_cmb": CMB,
    "ref_50k_cmb_tight": TIGHT,
    "ref_50k_cmb_t200": dict(TIGHT, training_points=200),
    "ref_50k_cmb_t500": dict(TIGHT, training_points=500),
    "fw_cmb_tight": TIGHT,
}
# the flags of .soak/recompose_cmb_r5.sh
RECOMPOSE = ["--pipeline", "cmb", "--iters", "50000", "--lbfgs", "3000", "--tol-grad", "1e-9",
             "--tol-change", "1e-12", "--hidden-layers", "10", "--width", "10", "--nx", "81",
             "--ny", "261", "--nan-fraction", "0.05"]
# the JAX package's test flags (tests/test_parity.py) for a whole small run
SMALL = ["--iters", "30", "--lbfgs", "5", "--hidden-layers", "3", "--width", "16",
         "--nx", "16", "--ny", "14"]


def changed(flags: dict, field: str) -> dict:
    """``flags`` with ``field`` moved to another valid value."""
    value = flags[field]
    if field == "fields":
        return dict(flags, fields="structured" if value == "plane" else "plane")
    if field == "pipeline":
        return dict(flags, pipeline="cmb" if value == "newmethod" else "newmethod")
    return dict(flags, **{field: value * 2 + 1})


def refusal(module, path, z, args, flag):
    with pytest.raises(SystemExit) as e:
        module._check_cache_meta(path, z, args, flag=flag)
    return str(e.value)


@pytest.mark.parametrize("name", sorted(CACHES))
def test_cache_meta_matches_jax_on_every_committed_cache(name):
    path = str(SOAK / f"{name}.npz")
    flag = "--fw-cache" if name.startswith("fw_") else "--ref-cache"
    args = argparse.Namespace(**CACHES[name])
    np.testing.assert_array_equal(parity._cache_meta(args), jparity._cache_meta(args))
    assert parity._CACHE_META_FIELDS == jparity._CACHE_META_FIELDS
    assert parity._FIELD_CHOICES == jparity._FIELD_CHOICES
    assert parity._PIPELINE_CHOICES == jparity._PIPELINE_CHOICES
    with np.load(path) as z:
        parity._check_cache_meta(path, z, args, flag=flag)  # its own flags: accepted
        for field in parity._CACHE_META_FIELDS:
            other = argparse.Namespace(**changed(CACHES[name], field))
            got = refusal(parity, path, z, other, flag)
            assert got == refusal(jparity, path, z, other, flag)
            assert f"{field}: cached" in got


def test_cache_meta_pads_short_vectors_and_warns_without_one(tmp_path, capsys):
    """A 9-field descriptor (``ref_50k.npz``) reads as plane/newmethod, and a
    cache without one only warns, as in the JAX package."""
    with np.load(SOAK / "ref_50k.npz") as z:
        assert z["meta"].shape == (9,)
    with np.load(SOAK / "ref_50k_cmb_tight.npz") as z:
        assert z["meta"].shape == (11,)
    args = argparse.Namespace(**BASE)
    short = str(tmp_path / "short.npz")
    np.savez(short, meta=parity._cache_meta(args)[:9])
    with np.load(short) as z:
        parity._check_cache_meta(short, z, args)
        other = argparse.Namespace(**dict(BASE, fields="structured"))
        assert refusal(parity, short, z, other, "--ref-cache") == \
            refusal(jparity, short, z, other, "--ref-cache")
    legacy = str(tmp_path / "old.npz")
    np.savez(legacy, totals=np.zeros(3))
    with np.load(legacy) as z:
        parity._check_cache_meta(legacy, z, args)
    assert "no experiment metadata" in capsys.readouterr().out


def test_fingerprint_binds_to_the_stored_one():
    """The port's fingerprint of the reference weights equals the JAX
    package's stored ``init_fingerprint``, from the float32 arrays as the
    cache stores them."""
    with np.load(SOAK / "ref_50k_cmb_tight.npz") as z:
        params = {k[2:]: z[k] for k in z.files if k.startswith("p_")}
    assert all(v.dtype == np.float32 for v in params.values())
    with np.load(SOAK / "fw_cmb_tight.npz") as zf:
        stored = str(zf["init_fingerprint"])
    assert parity._params_fingerprint(params) == stored == jparity._params_fingerprint(params)
    # a float64 copy of the same values hashes otherwise
    assert parity._params_fingerprint({k: v.astype(np.float64) for k, v in params.items()}) != stored
    for name in ("ref_50k", "ref_50k_structured", "ref_cmb_seed777"):
        with np.load(SOAK / f"{name}.npz") as z:
            other = {k[2:]: z[k] for k in z.files if k.startswith("p_")} or {"totals": z["totals"]}
        assert parity._params_fingerprint(other) == jparity._params_fingerprint(other)
        assert parity._params_fingerprint(other) != stored


@pytest.mark.parametrize("kw", [
    dict(adam_iters=50_000, lbfgs_iters=500),
    dict(adam_iters=30, lbfgs_iters=5, tol_grad=1e-9, tol_change=1e-12, hidden_layers=100,
         hidden_width=20),
    dict(adam_iters=0, lbfgs_iters=3000, weight_res=0.25),
])
def test_make_config_matches_jax(kw):
    assert parity.make_config("d.mat", **kw) == jparity.make_config("d.mat", **kw)
    assert parse_config(parity.make_config("d.mat", **kw)).physics == "continuity_only"


@pytest.mark.parametrize("kw", [
    dict(adam_iters=50_000, lbfgs_iters=3000, tol_grad=1e-9, tol_change=1e-12),
    dict(adam_iters=50_000, lbfgs_iters=500, training_points=200),
    dict(adam_iters=20, lbfgs_iters=0, hidden_layers=3, hidden_width=16, nx=21, ny=31,
         interval=2, training_points=40),
])
def test_make_cmb_config_matches_jax(kw):
    assert parity.make_cmb_config("f.csv", "r.mat", **kw) == \
        jparity.make_cmb_config("f.csv", "r.mat", **kw)
    assert parity._GET_MIN_MAX_SHIM == jparity._GET_MIN_MAX_SHIM
    assert parity._CMB_WEIGHTS == jparity._CMB_WEIGHTS


@pytest.mark.parametrize("fields", ["plane", "structured"])
def test_flagship_data_match_jax_bit_for_bit(tmp_path, fields):
    a, b = str(tmp_path / "port.mat"), str(tmp_path / "jax.mat")
    synthetic.make_newmethod_mat(a, nx=81, ny=261, nan_fraction=0.408, seed=21, fields=fields)
    jsynthetic.make_newmethod_mat(b, nx=81, ny=261, nan_fraction=0.408, seed=21, fields=fields)
    got, want = loadmat(a), loadmat(b)
    for k in ("x", "y", "U", "V", "h"):
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
    rows = load_newmethod_training_data(parse_config(parity.make_config(a, 1, 1))).residual_input
    with np.load(SOAK / ("ref_50k.npz" if fields == "plane" else "ref_50k_structured.npz")) as z:
        assert rows.shape[0] == z["h"].shape[0] == 12_516


def test_cmb_data_match_jax_bit_for_bit(tmp_path):
    files = {}
    for who, gen in (("port", synthetic), ("jax", jsynthetic)):
        csv, mat = str(tmp_path / f"{who}.csv"), str(tmp_path / f"{who}.mat")
        gen.make_cmb_dataset(csv, mat, nx=81, ny=261, nan_fraction=0.05, seed=21,
                             fields="plane", n_csv=400)
        files[who] = (read_csv_columns(csv), loadmat(mat))
    (pcsv, pmat), (jcsv, jmat) = files["port"], files["jax"]
    assert list(pcsv) == list(jcsv)
    for k in jcsv:
        assert pcsv[k].tobytes() == jcsv[k].tobytes(), k
    for k in ("x", "y", "h", "U", "V", "eta_mean", "Hrms", "k"):
        assert pmat[k].tobytes() == jmat[k].tobytes(), k


def report_numbers(text: str) -> dict:
    """Every number ``PARITY_CMB.md``'s sections print, as printed."""
    flat = " ".join(text.split())

    def find(pattern):
        m = re.search(pattern, flat)
        assert m, pattern
        return m.groups()

    return {
        "rows": re.findall(r"\| (\d+) \| (\S+) \| (\S+) \| (\S+) \|", text),
        "median_max": find(r"median relative loss difference over (\d+) iterations: (\S+) "
                           r"\* max relative loss difference: (\S+)"),
        "fidelity": find(r"fidelity loss \(per-output weights .*?\): first (\S+), median (\S+)"),
        "residual": find(r"physics residual loss \(wave_averaged\): first (\S+), median (\S+)"),
        "evals": find(r"evaluations executed: reference (\d+), framework (\d+) \(budget: (\d+)\)"),
        "tracked": find(r"within 5e-3 relative\): \*\*(\d+)\*\* of (\d+)"),
        "lbfgs_median": find(r"median relative diff over the phase: (\S+)"),
        "minima": find(r"terminal minima: reference (\S+), framework (\S+) \(log10 gap (\S+)\)"),
        "rmse": find(r"RMSE\(framework, reference\): (\S+) m"),
        "scales": find(r"reference h-field range: (\S+) m \(predicted; truth depth range (\S+) m"),
        "fractions": find(r"relative field RMSE: (\S+) of predicted range, (\S+) of truth"),
        "ranges": find(r"truth h range over observed points: (\S+) m \* reference predicted h "
                       r"range: (\S+) m \((\S+) of truth\) \* framework predicted h range: "
                       r"(\S+) m \((\S+) of truth\)"),
    }


def numbers_as_printed(num: dict) -> dict:
    e2, e6 = "{:.2e}".format, "{:.6e}".format
    return {
        "rows": [(str(i), e6(r), e6(f), e2(d)) for i, r, f, d in num["rows"]],
        "median_max": (str(num["n_compared"]), e2(num["adam_median_rel"]), e2(num["adam_max_rel"])),
        "fidelity": (e2(num["fid_first_rel"]), e2(num["fid_median_rel"])),
        "residual": (e2(num["res_first_rel"]), e2(num["res_median_rel"])),
        "evals": (str(num["lbfgs_evals_ref"]), str(num["lbfgs_evals_fw"]), str(num["lbfgs_budget"])),
        "tracked": (str(num["tracked"]), str(num["lbfgs_compared"])),
        "lbfgs_median": (e2(num["lbfgs_median_rel"]),),
        "minima": (e6(num["ref_min"]), e6(num["fw_min"]), f"{num['log10_gap']:.3f}"),
        "rmse": (f"{num['h_rmse']:.3e}",),
        "scales": (f"{num['h_pred_scale']:.3e}", f"{num['h_truth_scale']:.3e}"),
        "fractions": (f"{num['rmse_pred_frac']:.2%}", f"{num['rmse_truth_frac']:.2%}"),
        "ranges": (f"{num['h_truth_scale']:.4f}", f"{num['ref_pred_range']:.4f}",
                   f"{num['ref_structure_frac']:.1%}", f"{num['fw_pred_range']:.4f}",
                   f"{num['fw_structure_frac']:.1%}"),
    }


def test_recompose_parity_cmb_without_training(tmp_path):
    """``.soak/recompose_cmb_r5.sh``'s flags on the committed caches: every
    number of ``PARITY_CMB.md``, with no training and no card."""
    out = str(tmp_path / "PARITY_CMB.md")
    rc, num = parity.run(RECOMPOSE + ["--ref-cache", str(SOAK / "ref_50k_cmb_tight.npz"),
                                      "--fw-cache", str(SOAK / "fw_cmb_tight.npz"),
                                      "--out", out, "--device", "cpu"])
    assert rc == 1 and num["verdict"] == "CHECK"  # the 12-row recipe's field: 2.12 % > 1 %
    committed = (REPO / "PARITY_CMB.md").read_text()
    want = report_numbers(committed)
    assert numbers_as_printed(num) == want
    assert report_numbers(open(out).read()) == want
    # the figures the JAX package's report is known by
    assert want["rows"][0] == ("1", "1.783840e+01", "1.783910e+01", "3.92e-05")
    assert want["median_max"][1:] == ("4.34e-01", "6.90e+00")
    assert want["fidelity"][0] == "1.26e-05" and want["residual"][0] == "4.31e-05"
    assert (want["median_max"][1], want["fidelity"][1], want["residual"][1]) == \
        ("4.34e-01", "4.54e-01", "4.90e-01")
    assert want["tracked"] == ("0", "8") and want["evals"][1] == "49"
    assert want["minima"][2] == "0.034"
    assert want["rmse"] == ("3.386e-03",) and want["fractions"] == ("2.44%", "2.12%")
    assert (want["ranges"][0], want["ranges"][1], want["ranges"][3]) == ("0.1600", "0.1388", "0.1574")
    assert "framework device: not recorded" in open(out).read()


def test_recompose_structured_polish_run_without_training(tmp_path):
    """The recorded structured-fields run with ``--f64-polish 300`` (the
    port's framework phase on an H100, ``.soak/fw_50k_structured_polish300
    .npz``, beside the reference's ``ref_50k_structured.npz``) recomposes
    on the CPU with no training: PASS, and the numbers of
    ``PARITY_STRUCTURED_POLISH_TORCH.md`` as it prints them."""
    out = str(tmp_path / "R.md")
    flags = ["--iters", "50000", "--lbfgs", "500", "--hidden-layers", "100", "--width", "20",
             "--nx", "81", "--ny", "261", "--nan-fraction", "0.408", "--fields", "structured",
             "--f64-polish", "300", "--ref-cache", str(SOAK / "ref_50k_structured.npz"),
             "--fw-cache", str(SOAK / "fw_50k_structured_polish300.npz"), "--out", out,
             "--device", "cpu"]
    rc, num = parity.run(flags)
    assert rc == 0 and num["verdict"] == "PASS"
    assert num["lbfgs_evals_fw"] == 330 and num["log10_gap"] < 0.1
    committed = " ".join((REPO / "PARITY_STRUCTURED_POLISH_TORCH.md").read_text().split())
    again = " ".join(open(out).read().split())
    for line in ("evaluations executed: reference 3, framework 330 (budget: 625) * framework rows "
                 "include its f64 polish phase (--f64-polish 300;",
                 f"terminal minima: reference 2.804690e-03, framework {num['fw_min']:.6e} "
                 f"(log10 gap {num['log10_gap']:.3f})",
                 f"relative field RMSE: {num['rmse_pred_frac']:.2%} of predicted range, "
                 f"{num['rmse_truth_frac']:.2%} of truth depth scale"):
        assert line in committed and line in again, line
    assert f"{num['rmse_truth_frac']:.2%}" == "0.69%"


def small_reference_cache(tmp_path, seed: int, name: str) -> str:
    """A reference cache at the small flags, the JAX Trainer standing in for
    the reference from seeded numpy weights."""
    args = parity.build_parser().parse_args(SMALL)
    mat = str(tmp_path / f"{name}.mat")
    jsynthetic.make_newmethod_mat(mat, nx=args.nx, ny=args.ny, nan_fraction=args.nan_fraction,
                                  seed=21, fields=args.fields)
    raw = jparity.make_config(mat, args.iters, args.lbfgs, hidden_layers=args.hidden_layers,
                              hidden_width=args.width)
    rng = np.random.RandomState(seed)
    W, L = args.width, args.hidden_layers
    params = {
        "w_in": rng.uniform(-0.8, 0.8, (2, W)).astype(np.float32),
        "b_in": rng.uniform(-0.1, 0.1, W).astype(np.float32),
        "w_hidden": rng.uniform(-0.4, 0.4, (L - 1, W, W)).astype(np.float32),
        "b_hidden": rng.uniform(-0.1, 0.1, (L - 1, W)).astype(np.float32),
        "w_out": rng.uniform(-0.5, 0.5, (W, 3)).astype(np.float32),
        "b_out": rng.uniform(-0.1, 0.1, 3).astype(np.float32),
    }
    run_dir = str(tmp_path / f"{name}_run")
    os.makedirs(run_dir)
    tr = JTrainer(jparse(raw), run_dir=run_dir, echo_every=0, initial_params=params)
    tr.train()
    _, _, _, totals = jread_log(run_dir)
    path = str(tmp_path / f"{name}.npz")
    np.savez(path, totals=np.asarray(totals), h=np.asarray(tr.predict(tr.data.residual_input))[:, 2],
             wall=1.0, meta=jparity._cache_meta(args),
             **{f"p_{k}": v for k, v in params.items()})
    return path


def test_whole_small_run_on_the_cpu(tmp_path):
    ref = small_reference_cache(tmp_path, 8, "ref")
    fw, out = str(tmp_path / "fw.npz"), str(tmp_path / "report.md")
    flags = SMALL + ["--ref-cache", ref, "--fw-cache", fw, "--out", out, "--device", "cpu"]
    rc, num = parity.run(flags)
    assert rc == 0 and num["verdict"] == "PASS"
    assert num["iter1_rel"] <= 1e-5
    with np.load(ref) as z, np.load(fw) as zf:
        rt, ot = z["totals"], zf["totals"]
        assert set(zf.files) == {"totals", "fids", "ress", "h", "wall", "f64_polish",
                                 "init_fingerprint", "meta"}
        np.testing.assert_array_equal(zf["meta"], z["meta"])
    assert len(rt) >= 31 and len(ot) >= 31
    np.testing.assert_allclose(ot[:10], rt[:10], rtol=2e-4)
    np.testing.assert_allclose(ot[:30], rt[:30], rtol=2e-3)
    assert "framework device: CPU" in open(out).read()

    # recompose from the fw-cache: no training, the same numbers
    rc2, again = parity.run(flags)
    assert rc2 == 0 and again == num

    # the same fw-cache beside a reference phase of other weights: refused
    other = small_reference_cache(tmp_path, 9, "other")
    with pytest.raises(SystemExit, match="fingerprint"):
        parity.run(SMALL + ["--ref-cache", other, "--fw-cache", fw, "--out", out,
                            "--device", "cpu"])


def test_without_sources_or_cache_returns_2(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(parity, "REFERENCE", str(tmp_path / "absent"))
    out = str(tmp_path / "R.md")
    assert parity.main(SMALL + ["--out", out, "--device", "cpu"]) == 2
    assert parity.main(SMALL + ["--ref-cache", str(tmp_path / "missing.npz"), "--out", out,
                                "--device", "cpu"]) == 2
    assert "reference sources not available" in capsys.readouterr().out
    assert not os.path.exists(out)
    monkeypatch.setattr(parity, "REFERENCE", "")
    assert parity.main(SMALL + ["--out", out, "--device", "cpu"]) == 2


def test_ref_only_requires_ref_cache():
    with pytest.raises(SystemExit) as e:
        parity.main(["--iters", "5", "--ref-only", "--out", "x.md"])
    assert e.value.code == 2  # argparse usage error, before any work


def test_f64_polish_raises_the_trainers_message(tmp_path):
    """``--f64-polish`` is ported (it raised the Trainer's "not ported yet"
    error before): the harness runs it at the small flags on the CPU, the
    framework's rows include the polish (the reference phase is unchanged),
    the report says so, and its fw-cache refuses another budget."""
    ref = small_reference_cache(tmp_path, 8, "ref")
    out = str(tmp_path / "R.md")
    runs = {}
    for polish in (0, 5):
        fw = str(tmp_path / f"fw{polish}.npz")
        flags = SMALL + ["--ref-cache", ref, "--fw-cache", fw, "--out", out, "--device", "cpu",
                         "--f64-polish", str(polish)]
        rc, num = parity.run(flags)
        assert rc in (0, 1) and num["iter1_rel"] <= 1e-5
        with np.load(fw) as zf:
            assert int(zf["f64_polish"]) == polish
            runs[polish] = (zf["totals"].tolist(), num, open(out).read())
    (plain, num0, text0), (polished, num5, text5) = runs[0], runs[5]
    assert "f64 polish" not in text0
    assert "framework rows include its f64 polish phase (--f64-polish 5;" in text5
    # the polish only appends rows, and descends below the f32 phases
    assert polished[: len(plain)] == plain and len(polished) > len(plain)
    assert min(polished[len(plain):]) < min(plain)
    assert num5["lbfgs_evals_fw"] > num0["lbfgs_evals_fw"]
    assert num5["lbfgs_evals_ref"] == num0["lbfgs_evals_ref"]  # the reference phase unchanged
    with pytest.raises(SystemExit, match="--f64-polish 5, requested 0"):
        parity.run(SMALL + ["--ref-cache", ref, "--fw-cache", str(tmp_path / "fw5.npz"),
                            "--out", out, "--device", "cpu"])


def test_cli_parity_passes_every_flag(monkeypatch):
    seen = []
    monkeypatch.setattr(parity, "run_args", lambda args: seen.append(args) or (7, None))
    argv = ["parity", "--iters", "11", "--lbfgs", "3", "--out", "o.md", "--hidden-layers", "4",
            "--width", "8", "--nx", "9", "--ny", "10", "--nan-fraction", "0.25",
            "--tol-grad", "1e-09", "--tol-change", "1e-12", "--fields", "structured",
            "--pipeline", "cmb", "--training-points", "200", "--f64-polish", "2",
            "--ref-cache", "r.npz", "--fw-cache", "f.npz", "--ref-only", "--device", "cpu"]

    def harness_flags(args):
        return {k: v for k, v in vars(args).items() if k not in ("fn", "command")}

    assert cli.main(argv) == 7
    want = vars(parity.build_parser().parse_args(argv[1:]))
    assert harness_flags(seen[0]) == want
    assert want["device"] == "cpu" and want["fw_cache"] == "f.npz"
    # the defaults are the harness's own
    cli.main(["parity"])
    defaults = vars(parity.build_parser().parse_args([]))
    assert harness_flags(seen[1]) == defaults
    assert defaults["out"] == "PARITY_REPORT_TORCH.md" and defaults["device"] == "cuda"
    # every flag of the JAX verb is taken, and the harness's defaults are the JAX verb's
    jverb = jcli.build_parser()._subparsers._group_actions[0].choices["parity"]
    jdefaults = vars(jverb.parse_args([]))
    assert set(jverb._option_string_actions) <= set(parity.build_parser()._option_string_actions)
    assert {k: v for k, v in defaults.items() if k in jdefaults and k != "out"} == \
        {k: v for k, v in jdefaults.items() if k not in ("fn", "out")}
