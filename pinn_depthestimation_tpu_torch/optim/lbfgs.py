"""L-BFGS with strong-Wolfe line search: a host loop over device tensors.

Port of the JAX package's ``optim/lbfgs.py``. There the whole optimizer is
a ``lax.while_loop`` on the device; here the control flow is Python and the
vectors (iterate, gradient, direction, the ``(m, n)`` s/y history) are
tensors on the parameters' device. Each evaluation brings four numbers to
the host — ``(fidelity, residual, total, g·d)`` — in one copy; every other
scalar decision is taken on the host in the iterate's own float type
(``numpy.float32`` for f32), so the arithmetic of the line search is the
JAX package's, operation for operation.

Semantics follow ``torch.optim.LBFGS`` (the reference's optimizer):

* first iteration: steepest descent, step ``t = min(1, 1/sum|g|) * lr``;
  later ones: two-loop recursion over up to ``history_size`` (s, y) pairs
  with ``H0 = (s.y / y.y) I``, step ``t = lr``;
* pairs are stored only when ``s.y > 1e-10``;
* strong-Wolfe line search with cubic interpolation, bracketing + zoom,
  ``c1=1e-4, c2=0.9, max_ls=25``, internal tolerance ``1e-9``;
* stop conditions, in order: ``gtd > -tolerance_change`` | iteration and
  evaluation budgets | ``max|g| <= tolerance_grad`` |
  ``max|t*d| <= tolerance_change`` | ``|f - f_prev| < tolerance_change``;
* beyond torch (as in the JAX package): a step/loss/descent stop that fires
  while ``max|g|`` is above ``tolerance_grad`` clears the history and
  continues, up to ``max_restarts`` times; and a pair is stored only when
  ``s.y > max(1e-10, curvature_guard*|s|*|y|)``. With ``max_restarts=0``
  and ``curvature_guard=0`` the semantics are torch's.

Every evaluation appends ``(fid, res, total)`` to the record rows that
become ``log.txt`` (reference ``train.py:162-173``). Parameters are
flattened in JAX's ``ravel_pytree`` order — the dict's keys sorted — so
flat vectors and exported states compare element for element with the
JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Callable

import numpy as np
import torch

# Stop-reason codes (LBFGSState.reason)
RUNNING = 0
CONVERGED_GRAD = 1       # max|g| <= tolerance_grad
MAX_ITER = 2
MAX_EVAL = 3
CONVERGED_STEP = 4       # max|t*d| <= tolerance_change
CONVERGED_LOSS = 5       # |f - f_prev| < tolerance_change
NOT_DESCENT = 6          # gtd > -tolerance_change

C1 = 1e-4
C2 = 0.9
LS_TOLERANCE = 1e-9      # torch hardcodes this inside _strong_wolfe
MAX_LS = 25

_REASONS = {
    RUNNING: "running",
    CONVERGED_GRAD: "tolerance_grad",
    MAX_ITER: "max_iter",
    MAX_EVAL: "max_eval",
    CONVERGED_STEP: "tolerance_change (step)",
    CONVERGED_LOSS: "tolerance_change (loss)",
    NOT_DESCENT: "direction not descent",
}


@dataclass(frozen=True)
class LBFGSOptions:
    lr: float = 1.0
    max_iter: int = 20
    max_eval: int | None = None
    history_size: int = 100
    tolerance_grad: float = 1e-7
    tolerance_change: float = 1e-9
    line_search: str = "strong_wolfe"  # 'strong_wolfe' | 'none'
    # Stall restarts and the cautious curvature update: the JAX package's
    # extensions beyond torch (its LBFGSOptions documents the measured
    # flagship stall they address). 0 and 0.0 give torch's semantics.
    max_restarts: int = 8
    curvature_guard: float = 1e-4

    def resolved_max_eval(self) -> int:
        return self.max_eval if self.max_eval is not None else self.max_iter * 5 // 4


@dataclass
class LBFGSState:
    x: torch.Tensor          # (n,) flat parameters
    f: np.floating           # current loss
    g: torch.Tensor          # (n,) current gradient
    d: torch.Tensor          # (n,) search direction
    t: np.floating           # last step size
    prev_g: torch.Tensor
    prev_f: np.floating
    s_hist: torch.Tensor     # (m, n) ring buffer of steps
    y_hist: torch.Tensor     # (m, n) ring buffer of gradient differences
    rho: torch.Tensor        # (m,) 1/(s.y); 0 marks an empty slot
    head: int                # ring start (oldest valid slot)
    num: int                 # valid history entries
    h_diag: np.floating      # H0 scale
    n_iter: int              # completed outer iterations
    func_evals: int          # objective evaluations
    reason: int              # stop code; RUNNING while active
    restarts: int            # stall restarts consumed
    records: list            # unflushed (fid, res, total) rows


# scalar fields exported as 0-d arrays, and their dtypes ('x' = the iterate's)
_SCALARS = {"f": "x", "t": "x", "prev_f": "x", "h_diag": "x", "head": np.int32,
            "num": np.int32, "n_iter": np.int32, "func_evals": np.int32,
            "reason": np.int32, "restarts": np.int32}
_TRANSIENT_FIELDS = ("records",)


def _cubic_interpolate(x1, f1, g1, x2, f2, g2, bounds=None):
    """Minimizer of the cubic through (x1,f1,g1),(x2,f2,g2), clamped to the
    bounds; torch's ``_cubic_interpolate`` with its bisection fallback.
    Host scalars of one numpy float type."""
    if bounds is not None:
        xmin_bound, xmax_bound = bounds
    else:
        xmin_bound, xmax_bound = min(x1, x2), max(x1, x2)
    ty = type(x1)
    with np.errstate(all="ignore"):
        d1 = g1 + g2 - ty(3) * (f1 - f2) / (x1 - x2)
        d2_square = d1 * d1 - g1 * g2
        d2 = np.sqrt(max(d2_square, ty(0)))
        if x1 <= x2:
            min_pos = x2 - (x2 - x1) * ((g2 + d2 - d1) / (g2 - g1 + ty(2) * d2))
        else:
            min_pos = x1 - (x1 - x2) * ((g1 + d2 - d1) / (g1 - g2 + ty(2) * d2))
        interpolated = np.clip(min_pos, xmin_bound, xmax_bound)
        bisection = (xmin_bound + xmax_bound) / ty(2)
    result = interpolated if d2_square >= 0 else bisection
    return ty(result) if np.isfinite(result) else ty(bisection)


class LBFGSRunner:
    """Chunked driver: each :meth:`run_chunk` advances outer iterations until
    the optimizer stops or the record rows reach the capacity, so the
    caller can flush ``log.txt`` and cut checkpoints at chunk boundaries."""

    def __init__(
        self,
        loss_fn: Callable | None,
        params_template: Any,
        options: LBFGSOptions,
        *,
        record_capacity: int = 8192,
        value_and_grad_fn: Callable | None = None,
    ):
        """``value_and_grad_fn(params, batch) -> ((total, (fid, res)),
        grads)`` evaluates the objective (the Trainer hands it K1's step);
        without it, autograd of ``loss_fn(params, batch) -> (total, (fid,
        res))``. ``params_template`` is a dict of tensors or one tensor."""
        self.options = options
        self._is_dict = isinstance(params_template, dict)
        self._template_keys = sorted(params_template) if self._is_dict else None
        tmpl = self._leaves(params_template)
        self._shapes = [tuple(v.shape) for v in tmpl]
        self._n = sum(int(v.numel()) for v in tmpl)
        self._dtype = tmpl[0].dtype
        self._device = tmpl[0].device
        self._np = np.float64 if self._dtype == torch.float64 else np.float32
        # a chunk ends when fewer than one worst-case line search
        # (MAX_LS + 2 rows) fits; below MAX_LS + 3 no iteration would fit
        self._record_capacity = max(record_capacity, MAX_LS + 3)
        if value_and_grad_fn is None:
            if loss_fn is None:
                raise ValueError("LBFGSRunner needs loss_fn or value_and_grad_fn")
            value_and_grad_fn = self._autograd(loss_fn)
        self._vg = value_and_grad_fn
        self._batch = None
        f = self._np
        self._tol_grad = f(options.tolerance_grad)
        self._tol_change = f(options.tolerance_change)
        self._lr = f(options.lr)

    # -------------------------------------------------------- flat vectors

    def _leaves(self, params) -> list[torch.Tensor]:
        if self._is_dict:
            return [params[k] for k in sorted(params)]
        return [params]

    def flatten(self, params) -> torch.Tensor:
        return torch.cat([v.reshape(-1) for v in self._leaves(params)])

    def params_from_flat(self, x) -> Any:
        """The parameter structure as views of a flat vector."""
        x = torch.as_tensor(x)
        out, off = [], 0
        for shape in self._shapes:
            size = int(np.prod(shape, dtype=np.int64))
            out.append(x[off : off + size].view(shape))
            off += size
        if not self._is_dict:
            return out[0]
        return dict(zip(self._template_keys, out))

    def _autograd(self, loss_fn):
        def vg(params, batch):
            with torch.enable_grad():
                if self._is_dict:
                    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
                    total, (fid, res) = loss_fn(leaves, batch)
                    grads = torch.autograd.grad(total, [leaves[k] for k in sorted(leaves)],
                                                allow_unused=True, materialize_grads=True)
                    grads = dict(zip(sorted(leaves), grads))
                else:
                    leaves = params.detach().requires_grad_()
                    total, (fid, res) = loss_fn(leaves, batch)
                    (grads,) = torch.autograd.grad(total, [leaves])
            return (total.detach(), (fid.detach(), res.detach())), grads

        return vg

    # ------------------------------------------------------------- evaluate

    def _evaluate(self, state: LBFGSState, x: torch.Tensor, d: torch.Tensor | None):
        """f(x), g(x) and g·d; appends the record row and counts the
        evaluation. One device-to-host copy."""
        (total, (fid, res)), grads = self._vg(self.params_from_flat(x), self._batch)
        g = self.flatten(grads).to(self._dtype) if self._is_dict else grads.reshape(-1).to(self._dtype)
        gtd = torch.dot(g, d) if d is not None else torch.zeros((), dtype=g.dtype, device=g.device)
        vals = torch.stack([torch.as_tensor(v, dtype=g.dtype, device=g.device).reshape(())
                            for v in (fid, res, total)] + [gtd]).cpu().numpy()
        state.records.append(vals[:3].astype(np.float32))
        state.func_evals += 1
        return self._np(vals[2]), g, self._np(vals[3])

    def _max_abs(self, v: torch.Tensor):
        return self._np(torch.max(torch.abs(v)).item())

    # ------------------------------------------------------------------ API

    def init(self, params: Any, batch) -> LBFGSState:
        self._batch = batch
        x = self.flatten(params).detach().to(self._dtype).clone()
        m = self.options.history_size
        f = self._np
        state = LBFGSState(
            x=x, f=f(0), g=x, d=x, t=f(1), prev_g=x, prev_f=f(0),
            s_hist=torch.zeros((m, self._n), dtype=self._dtype, device=x.device),
            y_hist=torch.zeros((m, self._n), dtype=self._dtype, device=x.device),
            rho=torch.zeros((m,), dtype=self._dtype, device=x.device),
            head=0, num=0, h_diag=f(1), n_iter=0, func_evals=0, reason=RUNNING,
            restarts=0, records=[],
        )
        fx, g, _ = self._evaluate(state, x, None)
        state.f, state.g, state.d, state.prev_g, state.prev_f = fx, g, -g, g, fx
        # initial convergence check (torch step() prologue)
        if self._max_abs(g) <= self._tol_grad:
            state.reason = CONVERGED_GRAD
        if self.options.max_iter <= 0:  # torch's 'while n_iter < max_iter'
            state.reason = MAX_ITER
        return state

    def run_chunk(self, state: LBFGSState, batch) -> tuple[LBFGSState, np.ndarray]:
        """Advance until done or the record rows fill; returns ``(state,
        records)`` with records a host ``(k, 3)`` float32 array."""
        self._batch = batch
        cap = self._record_capacity - (MAX_LS + 2)
        while state.reason == RUNNING and len(state.records) <= cap:
            self._step(state)
        return self.drain_records(state)

    def drain_records(self, state: LBFGSState) -> tuple[LBFGSState, np.ndarray]:
        """Flush the recorded-but-unflushed rows (e.g. the init evaluation
        when the optimizer converges at once) without running a chunk."""
        rows = np.asarray(state.records, np.float32).reshape(-1, 3)
        state.records = []
        return state, rows

    def finished(self, state: LBFGSState) -> bool:
        return state.reason != RUNNING

    def get_params(self, state: LBFGSState) -> Any:
        return self.params_from_flat(state.x)

    @property
    def n_params(self) -> int:
        return self._n

    def stop_reason(self, state: LBFGSState) -> str:
        return _REASONS[state.reason]

    # -------------------------------------------------------- serialization

    def export_state(self, state: LBFGSState) -> dict:
        """Checkpointable arrays of the optimizer state (the record rows are
        transient and not exported), named and typed as the JAX package's
        ``LBFGSRunner.export_state``."""
        out = {}
        for fld in fields(LBFGSState):
            k = fld.name
            if k in _TRANSIENT_FIELDS:
                continue
            v = getattr(state, k)
            if isinstance(v, torch.Tensor):
                out[k] = v.detach().cpu().numpy()
            else:
                dt = self._np if _SCALARS[k] == "x" else _SCALARS[k]
                out[k] = np.asarray(v, dtype=dt)
        return out

    def restore_state(self, raw: dict) -> LBFGSState:
        """Rebuild an exact-trajectory state from :meth:`export_state`
        output, validated against this runner's sizes."""
        raw = dict(raw)
        raw.setdefault("restarts", np.int32(0))  # checkpoints before the feature
        missing = [f.name for f in fields(LBFGSState)
                   if f.name not in raw and f.name not in _TRANSIENT_FIELDS]
        if missing:
            raise ValueError(f"L-BFGS checkpoint is missing fields {missing}")
        if np.shape(raw["x"]) != (self._n,):
            raise ValueError(
                f"L-BFGS checkpoint has {np.shape(raw['x'])[0]} flat parameters, "
                f"model has {self._n}"
            )
        m = self.options.history_size
        if np.shape(raw["rho"]) != (m,):
            raise ValueError(
                f"L-BFGS checkpoint history_size {np.shape(raw['rho'])[0]} != configured {m}"
            )
        vals: dict = {"records": []}
        for fld in fields(LBFGSState):
            k = fld.name
            if k in _TRANSIENT_FIELDS:
                continue
            if k in _SCALARS:
                vals[k] = self._np(raw[k]) if _SCALARS[k] == "x" else int(raw[k])
            else:
                vals[k] = torch.as_tensor(np.asarray(raw[k])).to(self._device, self._dtype)
        return LBFGSState(**vals)

    # ----------------------------------------------------------- iteration

    def _two_loop_direction(self, state: LBFGSState) -> torch.Tensor:
        """Two-loop recursion over the valid slots of the ring buffer,
        newest first, then oldest first."""
        m = state.rho.shape[0]
        idxs = [(state.head + j) % m for j in range(state.num)]
        q = -state.g
        alphas = {}
        for idx in reversed(idxs):
            al = state.rho[idx] * torch.dot(state.s_hist[idx], q)
            q = q - al * state.y_hist[idx]
            alphas[idx] = al
        r = q * float(state.h_diag)
        for idx in idxs:
            be = state.rho[idx] * torch.dot(state.y_hist[idx], r)
            r = r + state.s_hist[idx] * (alphas[idx] - be)
        return r

    def _step(self, state: LBFGSState) -> None:
        """One outer iteration: history update, direction, line search,
        stop checks (``lbfgs.py::make_lbfgs_step`` of the JAX package)."""
        o, f = self.options, self._np
        m = state.rho.shape[0]
        first = state.n_iter == 0

        # -- history update (iterations >= 2), torch order: update then direction
        if not first:
            y = state.g - state.prev_g
            s_vec = state.d * float(state.t)
            sc = torch.stack([torch.dot(y, s_vec), torch.linalg.norm(s_vec),
                              torch.linalg.norm(y), torch.dot(y, y)]).cpu().numpy()
            ys, s_norm, y_norm, yy = (f(v) for v in sc)
            ys_floor = f(1e-10)
            if o.curvature_guard > 0.0:
                # cautious update: reject noise pairs with cos(s, y) ~ 0
                ys_floor = max(ys_floor, f(o.curvature_guard) * s_norm * y_norm)
            if ys > ys_floor:
                slot = state.head if state.num == m else (state.head + state.num) % m
                state.s_hist[slot] = s_vec
                state.y_hist[slot] = y
                state.rho[slot] = float(f(1) / ys)
                if state.num == m:
                    state.head = (state.head + 1) % m
                else:
                    state.num += 1
                state.h_diag = ys / yy

        if first:
            d = -state.g
            sum_abs = f(torch.sum(torch.abs(state.g)).item())
            with np.errstate(divide="ignore"):
                t0 = min(f(1), f(1) / sum_abs) * self._lr
        else:
            d = self._two_loop_direction(state)
            t0 = self._lr

        gtd = f(torch.dot(state.g, d).item())
        not_descent = gtd > -self._tol_change
        prev_f, prev_g = state.f, state.g

        if not_descent:
            f_new, g_new, t_new = state.f, state.g, t0
        elif o.line_search == "strong_wolfe":
            d_norm = self._max_abs(d)
            f_new, g_new, t_new = self._strong_wolfe(state, t0, d, gtd, d_norm)
        else:
            # fixed step, then re-evaluate — except on the final iteration,
            # where torch skips the evaluation and keeps the pre-step loss
            if state.n_iter + 1 < o.max_iter:
                f_new, g_new, _ = self._evaluate(state, state.x + float(t0) * d, d)
            else:
                f_new, g_new = state.f, state.g
            t_new = t0
        x_new = state.x if not_descent else state.x + float(t_new) * d

        n_iter = state.n_iter + 1
        g_max = self._max_abs(g_new)
        opt_cond = g_max <= self._tol_grad
        step_small = self._max_abs(float(t_new) * d) <= self._tol_change
        loss_flat = abs(f_new - prev_f) < self._tol_change

        # first matching reason wins (torch's check order)
        reason = NOT_DESCENT if not_descent else RUNNING
        for hit, code in ((n_iter >= o.max_iter, MAX_ITER),
                          (state.func_evals >= o.resolved_max_eval(), MAX_EVAL),
                          (opt_cond, CONVERGED_GRAD), (step_small, CONVERGED_STEP),
                          (loss_flat, CONVERGED_LOSS)):
            if reason == RUNNING and hit:
                reason = code

        # stall restart: a step/loss/descent stop away from a critical point
        # clears the history and continues; never past an exhausted budget
        do_restart = (
            reason in (CONVERGED_STEP, CONVERGED_LOSS, NOT_DESCENT)
            and g_max > self._tol_grad
            and state.restarts < o.max_restarts
            and n_iter < o.max_iter
            and state.func_evals < o.resolved_max_eval()
        )
        if do_restart:
            state.rho.zero_()
            state.num, state.head, state.h_diag = 0, 0, f(1)
            reason = RUNNING
            state.restarts += 1
            # the next s = t*d is exactly 0, so the cross-restart pair is
            # never stored
            t_new = f(0)

        state.x, state.f, state.g, state.d, state.t = x_new, f_new, g_new, d, f(t_new)
        state.prev_g, state.prev_f = prev_g, prev_f
        state.n_iter, state.reason = n_iter, reason

    def _strong_wolfe(self, state: LBFGSState, t, d, gtd, d_norm):
        """torch-semantics strong-Wolfe search: bracket, then zoom.
        Returns ``(f_new, g_new, t)``; the caller applies ``x + t*d``."""
        f = self._np
        c1, c2 = f(C1), f(C2)
        x, f0, g0 = state.x, state.f, state.g

        def eval_at(step):
            return self._evaluate(state, x + float(step) * d, d)

        f_new, g_new, gtd_new = eval_at(t)
        t_prev, f_prev, g_prev, gtd_prev = f(0), f0, g0, gtd
        ls_iter, done, found = 0, False, False
        br_t, br_f, br_g, br_gtd = [f(0), f(0)], [f0, f0], [g0, g0], [gtd, gtd]

        # ---- bracket phase
        while ls_iter < MAX_LS and not found and not done:
            armijo_fail = (f_new > f0 + c1 * t * gtd) or (ls_iter > 1 and f_new >= f_prev)
            curvature_ok = (not armijo_fail) and abs(gtd_new) <= -c2 * gtd
            ascending = gtd_new >= 0
            if armijo_fail or curvature_ok or ascending:
                found = True
                if curvature_ok:
                    br_t, br_f, br_g, br_gtd = [t, t], [f_new, f_new], [g_new, g_new], [gtd_new, gtd_new]
                    done = True
                else:
                    br_t, br_f = [t_prev, t], [f_prev, f_new]
                    br_g, br_gtd = [g_prev, g_new], [gtd_prev, gtd_new]
                break
            min_step = t + f(0.01) * (t - t_prev)
            max_step = t * f(10)
            t_next = _cubic_interpolate(t_prev, f_prev, gtd_prev, t, f_new, gtd_new,
                                        bounds=(min_step, max_step))
            t_prev, f_prev, g_prev, gtd_prev = t, f_new, g_new, gtd_new
            f_new, g_new, gtd_new = eval_at(t_next)
            t = t_next
            ls_iter += 1

        if not found and not done:  # max_ls without a bracket: [0, t]
            br_t, br_f, br_g, br_gtd = [f(0), t], [f0, f_new], [g0, g_new], [gtd, gtd_new]

        # ---- zoom phase
        single_point = done
        insuf = False
        while (not done and ls_iter < MAX_LS
               and abs(br_t[1] - br_t[0]) * d_norm >= f(LS_TOLERANCE)):
            low = 0 if br_f[0] <= br_f[1] else 1
            high = 1 - low
            t_new = _cubic_interpolate(br_t[0], br_f[0], br_gtd[0], br_t[1], br_f[1], br_gtd[1])
            br_max, br_min = max(br_t), min(br_t)
            eps = f(0.1) * (br_max - br_min)
            close_to_edge = min(br_max - t_new, t_new - br_min) < eps
            displace = insuf or t_new >= br_max or t_new <= br_min
            if close_to_edge and displace:
                t_new = br_max - eps if abs(t_new - br_max) < abs(t_new - br_min) else br_min + eps
            insuf = close_to_edge and not displace

            f_new, g_new, gtd_new = eval_at(t_new)
            t = t_new
            armijo_fail = (f_new > f0 + c1 * t_new * gtd) or (f_new >= br_f[low])
            curvature_ok = abs(gtd_new) <= -c2 * gtd
            if armijo_fail:
                br_t[high], br_f[high], br_g[high], br_gtd[high] = t_new, f_new, g_new, gtd_new
            else:
                if not curvature_ok and gtd_new * (br_t[high] - br_t[low]) >= 0:
                    br_t[high], br_f[high] = br_t[low], br_f[low]
                    br_g[high], br_gtd[high] = br_g[low], br_gtd[low]
                br_t[low], br_f[low], br_g[low], br_gtd[low] = t_new, f_new, g_new, gtd_new
                done = curvature_ok
            ls_iter += 1

        if single_point:
            return f_new, g_new, t
        low = 0 if br_f[0] <= br_f[1] else 1
        return br_f[low], br_g[low], br_t[low]


def lbfgs_minimize(fun: Callable, x0: Any, options: LBFGSOptions | None = None):
    """Minimize ``fun(params) -> scalar`` (autograd); returns ``(x, info)``
    as the JAX package's ``lbfgs_minimize`` does."""
    options = options or LBFGSOptions()

    def loss_fn(params, batch):
        del batch
        v = fun(params)
        return v, (v, torch.zeros_like(v))

    runner = LBFGSRunner(loss_fn, x0, options)
    state = runner.init(x0, None)
    history = []
    while not runner.finished(state):
        state, records = runner.run_chunk(state, None)
        history.append(records)
    state, leftover = runner.drain_records(state)
    if leftover.size:
        history.append(leftover)
    info = {
        "fun": float(state.f),
        "nit": state.n_iter,
        "nfev": state.func_evals,
        "reason": runner.stop_reason(state),
        "grad_max": float(torch.max(torch.abs(state.g))),
        "history": np.concatenate(history, axis=0) if history else np.zeros((0, 3), np.float32),
    }
    return runner.get_params(state), info
