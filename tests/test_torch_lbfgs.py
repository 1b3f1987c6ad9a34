"""The port's L-BFGS (``pinn_depthestimation_tpu_torch.optim.lbfgs``), held
against the JAX package's ``LBFGSRunner`` on the oracles of
``tests/test_lbfgs.py``, and against ``torch.optim.LBFGS`` with the
extensions off (``max_restarts=0``, ``curvature_guard=0``).

Both runners take the same branches on the same problem; their f32 sums
differ in the last bits, and a long line-search trajectory amplifies that
(tests/test_lbfgs.py compares with torch the same way), so trajectories are
compared at their start exactly in structure and at their end by the
optimum reached.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinn_depthestimation_tpu.optim import LBFGSOptions as JOptions
from pinn_depthestimation_tpu.optim import LBFGSRunner as JRunner
from pinn_depthestimation_tpu.optim import lbfgs_minimize as jax_minimize
from pinn_depthestimation_tpu_torch.optim import LBFGSOptions, LBFGSRunner, lbfgs_minimize
from pinn_depthestimation_tpu_torch.optim.lbfgs import MAX_LS

STRICT = dict(lr=1.0, max_iter=200, max_eval=250, history_size=100, tolerance_grad=1e-7,
              tolerance_change=1e-9, line_search="strong_wolfe", max_restarts=0,
              curvature_guard=0.0)


def rosen_t(v):
    return (1 - v[0]) ** 2 + 100 * (v[1] - v[0] ** 2) ** 2


def both_minimize(fun, x0, **opts):
    xj, ij = jax_minimize(fun, jnp.asarray(x0), JOptions(**opts))
    xt, it = lbfgs_minimize(fun, torch.tensor(x0), LBFGSOptions(**opts))
    return (np.asarray(xj), ij), (xt.numpy(), it)


def test_rosenbrock_matches_jax_and_torch():
    x0 = np.array([-1.2, 1.0], np.float32)
    (xj, ij), (xt, it) = both_minimize(rosen_t, x0, **STRICT)
    np.testing.assert_allclose(xt, [1.0, 1.0], atol=1e-3)
    assert it["fun"] < 1e-8 and it["reason"] == ij["reason"]
    assert abs(it["nfev"] - ij["nfev"]) <= 10
    # the first line searches take the same steps in both packages
    np.testing.assert_allclose(it["history"][:8], ij["history"][:8], rtol=1e-5)
    x = torch.tensor(x0, requires_grad=True)
    opt = torch.optim.LBFGS([x], lr=1.0, max_iter=200, max_eval=250, history_size=100,
                            tolerance_grad=1e-7, tolerance_change=1e-9,
                            line_search_fn="strong_wolfe")
    evals = [0]

    def closure():
        opt.zero_grad()
        loss = rosen_t(x)
        loss.backward()
        evals[0] += 1
        return loss

    opt.step(closure)
    np.testing.assert_allclose(xt, x.detach().numpy(), atol=1e-3)
    assert it["nfev"] <= 2 * evals[0] + 10


def test_quadratic_matches_jax_and_torch():
    rs = np.random.RandomState(0)
    A = rs.randn(8, 8).astype(np.float32)
    A = A @ A.T + 8 * np.eye(8, dtype=np.float32)
    b = rs.randn(8).astype(np.float32)
    At, bt = torch.tensor(A), torch.tensor(b)
    xt, it = lbfgs_minimize(lambda v: 0.5 * v @ At @ v - bt @ v, torch.zeros(8),
                            LBFGSOptions(**STRICT))
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    xj, ij = jax_minimize(lambda v: 0.5 * v @ Aj @ v - bj @ v, jnp.zeros(8), JOptions(**STRICT))
    x = torch.zeros(8, requires_grad=True)
    opt = torch.optim.LBFGS([x], lr=1.0, max_iter=200, max_eval=250, history_size=100,
                            tolerance_grad=1e-7, tolerance_change=1e-9,
                            line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        loss = 0.5 * x @ At @ x - bt @ x
        loss.backward()
        return loss

    opt.step(closure)
    x_star = np.linalg.solve(A.astype(np.float64), b.astype(np.float64))
    np.testing.assert_allclose(xt.numpy(), x_star, atol=1e-4)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=5e-4)
    np.testing.assert_allclose(xt.numpy(), x.detach().numpy(), atol=5e-4)
    # the same steps until roundoff decides the last tolerance stop
    np.testing.assert_allclose(it["history"][:6], ij["history"][:6], rtol=1e-5)
    assert abs(it["nfev"] - ij["nfev"]) <= 3


@pytest.mark.parametrize("opts,reason", [
    (dict(max_iter=1000, max_eval=7), "max_eval"),
    (dict(max_iter=3, max_eval=10_000), "max_iter"),
    (dict(max_iter=100), "tolerance_grad"),
])
def test_stops_match_jax(opts, reason):
    fun = rosen_t if reason != "tolerance_grad" else (lambda v: (v ** 2).sum())
    x0 = np.array([-1.2, 1.0] if reason != "tolerance_grad" else [0.0] * 4, np.float32)
    (xj, ij), (xt, it) = both_minimize(fun, x0, **opts)
    assert it["reason"] == ij["reason"] == reason
    assert (it["nit"], it["nfev"]) == (ij["nit"], ij["nfev"])
    assert it["history"].shape == (it["nfev"], 3)
    np.testing.assert_allclose(xt, xj, rtol=1e-5, atol=1e-6)


def test_no_line_search_mode():
    xt, it = lbfgs_minimize(lambda v: ((v - 2.0) ** 2).sum(), torch.zeros(3),
                            LBFGSOptions(lr=0.5, max_iter=50, line_search="none",
                                         tolerance_grad=1e-6))
    np.testing.assert_allclose(xt.numpy(), 2.0, atol=1e-4)


def test_records_capture_every_evaluation():
    _, info = lbfgs_minimize(rosen_t, torch.tensor([-1.2, 1.0]),
                             LBFGSOptions(max_iter=20, max_eval=100))
    hist = info["history"]
    assert hist.shape == (info["nfev"], 3) and np.isfinite(hist).all()
    np.testing.assert_allclose(hist[:, 0], hist[:, 2], rtol=1e-6)
    np.testing.assert_allclose(hist[0, 2], 24.2, rtol=1e-5)


def quad_loss(params, _batch):
    x = params["x"]
    return 0.5 * torch.sum(x * x), (torch.zeros(()), torch.zeros(()))


def test_stall_restart_recovers_from_poisoned_history():
    """The JAX package's test: a degenerate curvature pair stalls strict
    torch semantics; restarts clear the history and continue."""
    x0 = {"x": torch.tensor([1.0, -2.0, 0.5])}

    def run(max_restarts):
        opts = LBFGSOptions(max_iter=100, max_eval=300, history_size=4, tolerance_grad=1e-7,
                            tolerance_change=1e-9, max_restarts=max_restarts)
        runner = LBFGSRunner(quad_loss, x0, opts, record_capacity=64)
        state = runner.init(x0, None)
        state.s_hist[0] = torch.tensor([1e-5, 1e-5, 1e-5])
        state.y_hist[0] = torch.tensor([-1e-15, -1e-15, -1e-15])
        state.rho[0] = -1e10
        state.num, state.h_diag, state.n_iter = 1, np.float32(1e10), 1
        while not runner.finished(state):
            state, _ = runner.run_chunk(state, None)
        return state

    wedged, recovered = run(0), run(8)
    assert wedged.restarts == 0 and recovered.restarts >= 1
    assert float(recovered.f) < max(float(wedged.f) * 1e-2, 1e-8)


def test_restart_cannot_override_exhausted_budget():
    def rosen(p):
        return torch.sum(100.0 * (p[1:] - p[:-1] ** 2) ** 2 + (1 - p[:-1]) ** 2)

    for max_eval in (3, 7, 15):
        _, info = lbfgs_minimize(rosen, torch.zeros(6), LBFGSOptions(
            max_iter=1000, max_eval=max_eval, history_size=10, tolerance_grad=1e-12,
            tolerance_change=1e-16, max_restarts=8))
        assert info["nfev"] <= max_eval + MAX_LS + 1, (max_eval, info)


def test_chunked_runner_equals_single_run_and_clamps_capacity():
    def loss_fn(p, _batch):
        v = rosen_t(p)
        return v, (v, torch.zeros_like(v))

    opts = LBFGSOptions(max_iter=60, max_eval=200)
    finals = []
    for cap in (8192, 40, 4):
        runner = LBFGSRunner(loss_fn, torch.tensor([-1.2, 1.0]), opts, record_capacity=cap)
        s = runner.init(torch.tensor([-1.2, 1.0]), None)
        chunks = 0
        while not runner.finished(s):
            s, _ = runner.run_chunk(s, None)
            chunks += 1
        finals.append((s.x.numpy().copy(), float(s.f), s.func_evals, chunks))
    assert LBFGSRunner(loss_fn, torch.zeros(2), opts, record_capacity=4)._record_capacity == MAX_LS + 3
    assert finals[1][3] > finals[0][3]
    for x, f, evals, _ in finals[1:]:
        np.testing.assert_array_equal(x, finals[0][0])
        assert f == finals[0][1] and evals == finals[0][2]


def test_export_restore_matches_jax_layout_and_continues_exactly():
    """The exported state has the JAX runner's fields, shapes and dtypes; a
    restored state continues the trajectory bit for bit."""
    x0 = {"b": torch.tensor([0.5, -0.2]), "a": torch.tensor([[1.0, -2.0], [0.3, 0.7]])}

    def loss_fn(p, _batch):
        v = torch.sum((p["a"] - 1.5) ** 4) + torch.sum((p["b"] + 0.5) ** 2)
        return v, (v, torch.zeros_like(v))

    opts = LBFGSOptions(max_iter=12, history_size=5, tolerance_grad=1e-12, tolerance_change=1e-14)
    runner = LBFGSRunner(loss_fn, x0, opts, record_capacity=MAX_LS + 3)
    s = runner.init(x0, None)
    s, _ = runner.run_chunk(s, None)
    assert not runner.finished(s)
    raw = runner.export_state(s)

    def jloss(p, _batch):
        v = jnp.sum((p["a"] - 1.5) ** 4) + jnp.sum((p["b"] + 0.5) ** 2)
        return v, (v, jnp.zeros_like(v))

    jx0 = {k: jnp.asarray(v.numpy()) for k, v in x0.items()}
    jrunner = JRunner(jloss, jx0, JOptions(max_iter=12, history_size=5))
    jraw = jrunner.export_state(jrunner.init(jx0, None))
    assert set(raw) == set(jraw)
    for k in jraw:
        assert raw[k].shape == np.shape(jraw[k]) and raw[k].dtype == np.asarray(jraw[k]).dtype, k
    # flat order: sorted keys, as ravel_pytree
    np.testing.assert_array_equal(runner.flatten(x0).numpy(), np.float32([1.0, -2.0, 0.3, 0.7, 0.5, -0.2]))

    def finish(runner, state):
        while not runner.finished(state):
            state, _ = runner.run_chunk(state, None)
        return state

    done = finish(runner, s)
    again = LBFGSRunner(loss_fn, x0, opts, record_capacity=MAX_LS + 3)
    restored = finish(again, again.restore_state(raw))
    np.testing.assert_array_equal(done.x.numpy(), restored.x.numpy())
    assert done.func_evals == restored.func_evals and float(done.f) == float(restored.f)
    del raw["restarts"]  # a checkpoint from before the stall-restart feature
    assert again.restore_state(raw).restarts == 0
    with pytest.raises(ValueError, match="history_size"):
        LBFGSRunner(loss_fn, x0, LBFGSOptions(history_size=7)).restore_state(jraw)
