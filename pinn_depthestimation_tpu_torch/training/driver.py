"""Training driver: an Adam phase, then L-BFGS.

Port of the JAX package's ``training/driver.py`` for the newmethod
pipeline (reference ``train.py:46-200``, ``train_newmethod.py:46-209``):

* Adam is ``torch.optim.Adam`` (its defaults equal optax's) under
  ``StepLR(step_size, gamma)`` stepped once per iteration — optax's
  staircase ``exponential_decay``; on the card its update is one kernel
  launch a step (``optim.adam.FusedAdam``), with every bit of torch's;
* the L-BFGS phase is ``optim.lbfgs.LBFGSRunner`` (torch semantics plus
  the JAX package's stall restarts and cautious curvature update);
* every loss evaluation goes through one value-and-gradient function
  (:func:`decide_kernels`): K1 (``ops.kernels_step``, the one-kernel
  training step) when the configuration qualifies, else autograd of
  ``training.loss.build_loss_fn`` — on the card through the generic fused
  path (K2 forward, K3 or K4 backward, ``ops.kernels_vjp``) wherever its
  structural conditions hold, so the CMB pipeline runs kernels only; the
  kernels run at ``kernel_precision``'s tier (``f32``, ``bf16`` or
  ``f32x3``);
* the staged-precision schedule (``precision_schedule``, JAX
  ``training/driver.py:151-208``, ``:322-345``): the first
  ``prefix_iters`` Adam steps evaluate through a second value-and-gradient
  function at ``prefix_precision``, the rest of Adam and L-BFGS at the main
  tier. No Adam chunk straddles the boundary, and the switch is keyed on
  the absolute iteration counter, so ``--resume`` lands in the right tier.
  Where no kernel runs, the schedule is inert (a warning; the main
  function serves both);
* ``log.txt`` gets one reference-format row per evaluation, flushed once
  per 1000-step chunk from a device buffer (no host sync per Adam step);
* ``model_<iter>.npz`` checkpoints at the reference cadence carry the
  parameters, the Adam state, the counter and, inside the L-BFGS phase, the
  optimizer state, so ``--resume`` continues bit for bit;
* the ``data_at<N>.mat`` snapshot is written when the evaluation counter
  reaches ``snapshot_iteration``; it and :meth:`Trainer.predict` run K2 on
  the card (``mlp_apply`` under ``fused_kernel='off'``).

* the optional float64 L-BFGS polish (``f64_polish``, JAX
  ``training/driver.py:503-663``): after the f32 L-BFGS phase, the same
  optimizer in float64 on plain autograd (no kernel has an f64 tier, in
  either package), its rows in the same ``log.txt``, the live iterate
  rounded back to the f32 parameters before each record; mid-polish
  checkpoints carry its whole state (``lbfgs64``) and every checkpoint after
  it its f64 iterate (``params64``), so ``--resume`` continues it and a
  later run extends it from the exact iterate;
* data parallelism (``mesh=``, ``parallel.mesh``, JAX
  ``training/driver.py:87``): the batch split into shards, each on its
  device; one process drives them all, and Adam, L-BFGS, the log and the
  checkpoints act on the one master copy of the parameters on the mesh's
  first device. K1 (or K2 with K3/K4) launches on every shard.

* the Adam step replayed from one CUDA graph (:meth:`Trainer._adam_steps`):
  on the card the two-kernel autograd step (K2 forward with tangents, the
  loss, K3 or K4 backward, Adam's update in its capturable form) is
  captured once, after an uncaptured step that builds Adam's state, and
  replayed once a step; each replay writes its loss row into the block's
  device buffer and takes its Adam scalars from the optimizer's step table,
  which the host fills for the block (``FusedAdam.schedule``, which also
  steps ``StepLR``), so parameters, moments, step counts, the scheduler and
  the loss rows are the uncaptured steps' bit for bit. The one-kernel step
  (K1), the CPU, a mesh, a tier other than f32, a precision schedule's
  prefix and plain autograd run op by op; the Trainer says at construction
  which it does.

The iteration counter counts loss evaluations, as the reference's
``self.iter`` does (reference ``train.py:160``).

Spans (:mod:`tracing`): ``trainer#init`` over the construction, with
``trainer#init.data``, ``trainer#init.loss`` and ``trainer#init.optimizer``
(always recorded), and ``trainer#capture`` over each capture of the step;
while tracing is on, ``trainer#block`` over each Adam chunk, with
``trainer#dispatch`` (issuing its steps), ``trainer#sync`` (the loss rows'
copy to the host) and ``trainer#record`` (the flush, each save under it a
``trainer#checkpoint``), ``step#adam`` over each uncaptured optimizer and
scheduler step and ``step#replay`` over each replay of the graph. Counts
(:func:`tracing.count`, always on): ``step#replay`` and ``step#eager``, the
Adam steps by how they ran; the captures are ``trainer#capture``'s count
in :func:`tracing.summary`.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from scipy.io import savemat

from pinn_depthestimation_tpu_torch import data as data_mod
from pinn_depthestimation_tpu_torch import physics, tracing
from pinn_depthestimation_tpu_torch.config import Config
from pinn_depthestimation_tpu_torch.device import resolve_device
from pinn_depthestimation_tpu_torch.inference import resolve_use_kernel
from pinn_depthestimation_tpu_torch.models import MLPSpec, init_mlp_params, mlp_apply, params_from_numpy
from pinn_depthestimation_tpu_torch.models.mlp import PARAM_KEYS
from pinn_depthestimation_tpu_torch.ops import kernels, kernels_step, kernels_vjp
from pinn_depthestimation_tpu_torch.optim import lbfgs as lbfgs_mod
from pinn_depthestimation_tpu_torch.optim.adam import FusedAdam
from pinn_depthestimation_tpu_torch.parallel import Mesh, shard_batch
from pinn_depthestimation_tpu_torch.training import checkpoint as ckpt_mod
from pinn_depthestimation_tpu_torch.training.logging_utils import LossLog, make_run_dir
from pinn_depthestimation_tpu_torch.training.loss import (
    build_loss_fn,
    build_value_and_grad_fn,
    one_kernel_step_applicable,
    resolve_names,
    value_and_grad,
)

_CHUNK = 1000  # Adam steps per log flush; divides every reference cadence


def make_adam_optimizer(config: Config, params: list[torch.Tensor]):
    """``(FusedAdam, StepLR)``: Adam with torch's defaults (equal to optax's)
    and ``StepLR(step_size, gamma)`` stepped once per iteration (reference
    ``train.py:103-113,193``), which is optax's staircase
    ``exponential_decay`` on the step count. ``optim.adam.FusedAdam`` is a
    ``torch.optim.Adam`` whose update is one kernel launch on the card and
    torch's own step on the CPU."""
    optimizer = FusedAdam(params, lr=config.adam.learning_rate)
    scheduler = torch.optim.lr_scheduler.StepLR(
        optimizer, step_size=config.adam.scheduler_step_size, gamma=config.adam.scheduler_gamma
    )
    return optimizer, scheduler


@dataclass
class TrainState:
    params: dict[str, torch.Tensor]
    iteration: int  # completed loss evaluations


class KernelPlan(NamedTuple):
    """Which kernels a Trainer runs (:func:`decide_kernels`)."""

    k1: bool       # the one-kernel training step for every loss evaluation
    fused: bool    # the generic fused path: K2 forward + K3 backward
    predict: bool  # K2 for the snapshot and predict


def fused_structurally_ok(config: Config, spec: MLPSpec) -> bool:
    """The JAX package's structural conditions for the generic fused path
    (``training/driver.py:228-232``, ``:257-260``): no dropout, at least one
    hidden layer, width/d_in/d_out within 128, and the differentiated
    coordinates leading the residual inputs, in order."""
    if spec.dropout_rate or spec.n_hidden < 1 or max(spec.width, spec.d_in, spec.d_out) > 128:
        return False
    inputs = resolve_names(config)["residual_inputs"]
    needed = physics.required_grad_coords(config.physics)
    return all(c in inputs for c in needed) and (
        [inputs.index(c) for c in needed] == list(range(len(needed))))


def decide_kernels(config: Config, spec: MLPSpec, fidelity_is_residual: bool,
                   device_type: str) -> KernelPlan:
    """Which kernels run on a device of ``device_type``: K1, the generic
    fused path (K2 + K3) and K2-predict.

    ``fused_kernel``: ``'off'`` is the caller's request for the plain paths
    (autograd of the loss, ``mlp_apply``). ``'auto'`` and ``'on'`` take K1
    wherever the one-kernel gate holds; otherwise the generic fused path
    (residual forward and fidelity forward through K2, their backward
    through K3) wherever the JAX structural conditions hold
    (:func:`fused_structurally_ok`). Where those fail, ``'on'`` raises and
    ``'auto'`` takes autograd, as the JAX ``'auto'`` takes XLA. On the card
    ``'auto'`` takes the kernels; on the CPU only ``'on'`` does (their plain
    versions).

    Divergence from the JAX ``'auto'`` (the values are the same, only the
    route differs): no size or depth gate. The JAX package keeps the fused
    path off below 8192 collocation points or 16 hidden layers outside the
    one-kernel gate, and the separate fidelity forward on XLA below
    ``FUSED_FIDELITY_MIN_POINTS``; those were TPU measurements, so on the
    card the CMB net (10 hidden layers) trains through K2 + K3 and its 200
    fidelity rows go through K2 (K=0) + K3 (K=0).

    The kernels take every net the Pallas kernels take (``ops/widths.py``:
    any width, ``d_in`` and ``d_out`` up to 128), so a gate that holds on
    the card never raises for the net's shape; K1 also needs heads ``(U, V,
    h)`` and ``d_in >= 2``, which its gate implies. K2-predict likewise
    (:func:`inference.resolve_use_kernel`)."""
    mode = config.fused_kernel
    on_card = device_type == "cuda"
    use_k1 = use_fused = False
    if mode != "off":
        if (one_kernel_step_applicable(config, spec, fidelity_is_residual)
                and kernels_step.kernel_supports(spec)):
            use_k1 = mode == "on" or on_card
        elif fused_structurally_ok(config, spec):
            n_tangents = len(physics.required_grad_coords(config.physics))
            if on_card and n_tangents > min(kernels.MAX_TANGENTS, spec.d_in):
                raise ValueError(
                    f"the kernels take at most min(3, d_in) tangents; the physics "
                    f"{config.physics!r} needs {n_tangents} at sizes {spec.sizes}; set "
                    "fused_kernel='off' to train through plain autograd"
                )
            use_fused = mode == "on" or on_card
        elif mode == "on":
            raise ValueError(
                "fused_kernel='on' needs the one-kernel training step (K1) or the "
                "generic fused path (K2 forward + K3 backward): no dropout, >= 1 "
                "hidden layer, width/d_in/d_out <= 128 and the differentiated "
                f"coordinates leading the residual inputs; sizes {spec.sizes}, "
                f"dropout {spec.dropout_rate} and physics {config.physics!r} do not qualify"
            )
    use_k2 = resolve_use_kernel(spec, device_type, False if mode == "off" else None)
    return KernelPlan(use_k1, use_fused, use_k2)


class Trainer:
    def __init__(
        self,
        config: Config,
        *,
        run_dir: str | None = None,
        log_root: str = "./log",
        echo_every: int = 1000,
        initial_params=None,
        lbfgs_record_capacity: int | None = None,
        device: str | torch.device | None = None,
        mesh: Mesh | None = None,
        training_data: data_mod.TrainingData | None = None,
    ):
        """``initial_params``: the parameter exchange dict (numpy arrays or
        tensors); without it, :func:`init_mlp_params` from a CPU
        ``torch.Generator`` seeded with ``config.seed``. ``device``: the
        card by default; ``"cpu"`` runs the plain versions.
        ``training_data``: a dataset already loaded
        (``data.load_training_data``'s ``TrainingData``), taken as it is, as
        the JAX ``Trainer(training_data=)`` takes it; without it the
        Trainer loads the config's. ``mesh``
        (``parallel.make_mesh``): train data-parallel over its shards, the
        parameters and the optimizers on its first device (``device``, if
        given, must be that one)."""
        with tracing.setup_span("trainer#init"):
            self.config = config
            self.mesh = mesh
            if mesh is not None:
                if device is not None and torch.device(device) != mesh.first_device:
                    raise ValueError(f"device {str(device)!r} is not the mesh's first device "
                                     f"{str(mesh.first_device)!r}")
                device = mesh.first_device
            self.device = resolve_device(device)
            self.spec = MLPSpec.from_layers(config.layers)
            self.echo_every = echo_every
            self._lbfgs_record_capacity = lbfgs_record_capacity

            with tracing.setup_span("trainer#init.data"):
                self.data = (training_data if training_data is not None
                             else data_mod.load_training_data(config))
                for name, arr in (("fidelity", self.data.fidelity_input),
                                  ("residual", self.data.residual_input)):
                    if arr.shape[0] == 0:
                        raise ValueError(
                            f"{name} batch is empty after loading/NaN-masking — refusing to train"
                        )
                self.run_dir = run_dir or make_run_dir(log_root)
                self.log = LossLog(self.run_dir)

                if mesh is not None:
                    self.batch = shard_batch(self._host_batch(np.float32), mesh)
                else:
                    self.batch = {k: torch.as_tensor(v).to(self.device)
                                  for k, v in self._host_batch(np.float32).items()}
            with tracing.setup_span("trainer#init.loss"):
                fidelity_is_residual = getattr(self.data, "fidelity_is_residual", False)
                self.kernel_plan = decide_kernels(config, self.spec, fidelity_is_residual,
                                                  self.device.type)
                # one decision reaches both builders, as the JAX Trainer's
                # use_fused_kernel does: the loss runs through the kernels (K1, or
                # K2 with K3/K4), which also drops residual_chunk_size
                self.uses_kernels = self.kernel_plan.k1 or self.kernel_plan.fused
                self.loss_fn = build_loss_fn(
                    config, self.spec, residual_chunk_size=config.residual_chunk_size,
                    input_min_max=self.data.input_min_max, fused_kernel=self.uses_kernels,
                    fused_precision=config.resolved_kernel_precision(),
                    fidelity_is_residual=fidelity_is_residual, mesh=mesh,
                )
                self.fused_step_fn = build_value_and_grad_fn(
                    config, self.spec, input_min_max=self.data.input_min_max,
                    fused_kernel=self.uses_kernels,
                    fused_precision=config.resolved_kernel_precision(),
                    fidelity_is_residual=fidelity_is_residual,
                )
                self.value_and_grad_fn = self.fused_step_fn or value_and_grad(self.loss_fn)
                tier = config.resolved_kernel_precision()
                where = " (CUDA)" if self.device.type == "cuda" else " (plain versions on the CPU)"
                if self.fused_step_fn:
                    step = f"K1, the one-kernel training step, at {tier}" + where
                elif self.kernel_plan.fused:
                    bwd = "K4" if kernels_vjp.resolve_impl("auto", tier) == "rebuild" else "K3"
                    step = (f"autograd of the loss through K2 forward + {bwd} backward, "
                            f"at {tier}" + where)
                else:
                    step = "autograd of the loss (plain PyTorch)"
                predict = f"K2 at {tier}" if self.kernel_plan.predict else "plain mlp_apply"
                where = (f"mesh {mesh.shape['data']}x{mesh.shape['model']} over "
                         f"{[str(d) for d in mesh.data_devices]}" if mesh is not None
                         else f"device {self.device}")
                print(f"Training step: {step}; snapshot/predict: {predict}; {where}")
                self._prefix_iters, self._prefix_value_and_grad = self._build_schedule(
                    fidelity_is_residual)

            if initial_params is not None:
                arrays = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
                          for k, v in initial_params.items()}
                params = params_from_numpy(arrays, self.device)
            else:
                gen = torch.Generator().manual_seed(config.seed)
                params = init_mlp_params(gen, self.spec, device=self.device)
            # a copy of its own: Adam updates in place, and a CPU tensor made
            # from numpy shares the caller's memory
            params = {k: params[k].detach().clone().contiguous() for k in PARAM_KEYS}
            self.state = TrainState(params=params, iteration=0)
            with tracing.setup_span("trainer#init.optimizer"):
                self.optimizer, self.scheduler = make_adam_optimizer(
                    config, [params[k] for k in PARAM_KEYS])
            self._lbfgs_runner: lbfgs_mod.LBFGSRunner | None = None
            self._live_lbfgs_state = None       # exported into checkpoints
            self._pending_lbfgs_resume = None   # raw dict from a restored checkpoint
            # the f64 polish's counterparts (checkpoint sections lbfgs64, params64)
            self._lbfgs64_runner: lbfgs_mod.LBFGSRunner | None = None
            self._live_lbfgs64_state = None
            self._pending_lbfgs64_resume = None
            self._pending_params64 = None       # flat f64 iterate of a finished polish
            self._snapshot_done = False
            # the Adam step's CUDA graph: captured at the first step that
            # finds none (or a stale one), after an uncaptured step
            self._graph = None
            self.graph_step, why = self._graph_decision()
            print("Adam step: " + ("captured once into a CUDA graph and replayed a step"
                                   if self.graph_step else f"op by op ({why})"))

    def _host_batch(self, dtype) -> dict[str, np.ndarray]:
        return {k: np.asarray(getattr(self.data, k), dtype)
                for k in ("fidelity_input", "fidelity_true", "residual_input")}

    def _build_schedule(self, fidelity_is_residual: bool):
        """``(prefix_iters, prefix value-and-grad)`` of the precision
        schedule, ``(0, None)`` without one. The prefix function is the main
        one where the tiers agree or where no kernel runs (then the schedule
        is inert, as on the JAX package's XLA path, and says so)."""
        sched = self.config.precision_schedule
        if sched is None or sched.prefix_iters <= 0:
            return 0, None
        main_tier = self.config.resolved_kernel_precision()
        if not self.uses_kernels or sched.prefix_precision == main_tier:
            if not self.uses_kernels and sched.prefix_precision != main_tier:
                print("Warning: precision_schedule is inert on the plain (non-kernel) "
                      "path — precision tiers are properties of the kernels; the whole "
                      "run evaluates at f32.")
            return sched.prefix_iters, self.value_and_grad_fn
        kw = dict(input_min_max=self.data.input_min_max, fused_kernel=self.uses_kernels,
                  fused_precision=sched.prefix_precision,
                  fidelity_is_residual=fidelity_is_residual)
        prefix_vg = build_value_and_grad_fn(self.config, self.spec, **kw)
        if prefix_vg is None:
            prefix_vg = value_and_grad(build_loss_fn(
                self.config, self.spec, residual_chunk_size=self.config.residual_chunk_size,
                mesh=self.mesh, **kw))
        print(f"Precision schedule: the first {sched.prefix_iters} Adam steps at "
              f"{sched.prefix_precision}, then {main_tier}")
        return sched.prefix_iters, prefix_vg

    # ------------------------------------------------------------------ Adam

    def _dropout_generator(self, iteration: int):
        if self.spec.dropout_rate <= 0.0:
            return None
        # keyed by the absolute iteration, so a resumed run replays the
        # dropout masks an uninterrupted run would have drawn
        gen = torch.Generator(device=self.device)
        return gen.manual_seed(self.config.seed + 1 + iteration)

    def _graph_decision(self) -> tuple[bool, str]:
        """``(graphed, why not)``: the Adam step is replayed from a CUDA
        graph where it is the two-kernel autograd step at f32 on one card
        with every leaf a float32 card tensor (dropout 0 is part of that
        path)."""
        if self.device.type != "cuda":
            return False, f"no CUDA graph on {self.device.type}"
        if self.fused_step_fn is not None:
            return False, "the one-kernel step (K1) is not graphed"
        if not self.kernel_plan.fused:
            return False, "plain autograd is not graphed"
        if self.mesh is not None:
            return False, "a mesh's shards are not graphed"
        if self.config.resolved_kernel_precision() != "f32":
            # the card tests hold the replayed step to the uncaptured one bit
            # for bit at f32 alone
            return False, "only the f32 step is graphed"
        if not all(p.is_cuda and p.dtype == torch.float32 for p in self.state.params.values()):
            return False, "a leaf is not a float32 card tensor"
        if not isinstance(self.optimizer, FusedAdam):
            return False, "the optimizer has no capturable form"
        return True, ""

    def _graph_key(self, value_and_grad_fn) -> tuple:
        """What a captured graph holds the addresses of: the function, the
        batch, the leaves, Adam's moments and its step table."""
        opt = self.optimizer.state
        return (value_and_grad_fn, id(self.batch), id(self.optimizer.table),
                *((p.data_ptr(), *(opt[p][k].data_ptr() if p in opt else 0
                                   for k in ("exp_avg", "exp_avg_sq")))
                  for p in self.state.params.values()))

    def _capture(self, value_and_grad_fn) -> None:
        """Capture one Adam step through ``value_and_grad_fn`` into a CUDA
        graph (span ``trainer#capture``): the loss and its gradients, the
        loss row into the buffer's row ``counter`` and Adam's capturable
        update, which advances ``counter``. The launches inside are noted,
        to be counted once a replay."""
        with tracing.setup_span("trainer#capture"):
            self._graph = None
            table = self.optimizer.table or self.optimizer.attach_table(_CHUNK)
            rows = torch.zeros((table.capacity, 3), dtype=torch.float32, device=self.device)
            params = self.state.params
            graph = torch.cuda.CUDAGraph()
            with tracing.capturing_launches() as noted, torch.cuda.graph(graph):
                (total, (fid, res)), grads = value_and_grad_fn(params, self.batch, None)
                rows.index_copy_(0, table.counter, torch.stack((fid, res, total))[None])
                for k in PARAM_KEYS:
                    params[k].grad = grads[k]
                self.optimizer.step()
            for k in PARAM_KEYS:
                params[k].grad = None
            self._graph = (graph, rows, noted, self._graph_key(value_and_grad_fn))

    def _adam_steps(self, n: int, value_and_grad_fn=None) -> torch.Tensor:
        """``n`` Adam steps from the current state through
        ``value_and_grad_fn`` (default: the main one); returns the ``(n, 3)``
        ``(fid, res, total)`` rows on the device (no host sync). Where the
        Trainer graphs the step (:meth:`_graph_decision`) and the function
        is the main one, the steps are replays of its CUDA graph, captured
        after one uncaptured step where none is held for the present leaves,
        moments and batch."""
        value_and_grad_fn = value_and_grad_fn or self.value_and_grad_fn
        if not self.graph_step or value_and_grad_fn is not self.value_and_grad_fn:
            return self._eager_steps(n, value_and_grad_fn)
        losses = torch.empty((n, 3), dtype=torch.float32, device=self.device)
        done = 0
        if n and (self._graph is None or self._graph[3] != self._graph_key(value_and_grad_fn)):
            losses[:1] = self._eager_steps(1, value_and_grad_fn)
            done = 1
            self._capture(value_and_grad_fn)
        graph, rows, noted, _ = self._graph
        while done < n:
            m = min(n - done, rows.shape[0])
            self.optimizer.schedule(m, self.scheduler)
            for _ in range(m):
                with tracing.span("step#replay"):
                    graph.replay()
            tracing.add_launches(noted, m)
            tracing.count("step#replay", m)
            losses[done:done + m] = rows[:m]
            done += m
        return losses

    def _eager_steps(self, n: int, value_and_grad_fn) -> torch.Tensor:
        """:meth:`_adam_steps` op by op."""
        losses = torch.empty((n, 3), dtype=torch.float32, device=self.device)
        params = self.state.params
        for i in range(n):
            gen = self._dropout_generator(self.state.iteration + i)
            (total, (fid, res)), grads = value_and_grad_fn(params, self.batch, gen)
            losses[i] = torch.stack((fid, res, total))
            for k in PARAM_KEYS:
                params[k].grad = grads[k]
            with tracing.span("step#adam"):
                self.optimizer.step()
                self.scheduler.step()
        for k in PARAM_KEYS:
            params[k].grad = None
        tracing.count("step#eager", n)
        return losses

    def train_adam(self) -> None:
        """The Adam phase (reference ``train.py:188-193``). Resume-aware: a
        restored counter of N means N Adam steps are done (N <= max_it)."""
        remaining = max(0, self.config.adam.max_it - self.state.iteration)
        while remaining > 0:
            n = min(_CHUNK, remaining)
            # the schedule's prefix: no chunk straddles the tier boundary,
            # keyed on the absolute counter so a resume lands correctly
            in_prefix = (self._prefix_value_and_grad is not None
                         and self.state.iteration < self._prefix_iters)
            if in_prefix:
                n = min(n, self._prefix_iters - self.state.iteration)
            fn = self._prefix_value_and_grad if in_prefix else self.value_and_grad_fn
            with tracing.span("trainer#block"):
                with tracing.span("trainer#dispatch"):
                    losses = self._adam_steps(n, fn)
                with tracing.span("trainer#sync"):  # the host waits for the device
                    losses = losses.cpu().numpy()
                self._record(losses)
            remaining -= n

    # ---------------------------------------------------------------- L-BFGS

    def _set_params(self, new: dict) -> None:
        """Copy into the live tensors, which the Adam optimizer holds too."""
        with torch.no_grad():
            for k in PARAM_KEYS:
                self.state.params[k].copy_(new[k])

    def train_lbfgs(self) -> None:
        """The L-BFGS phase (reference ``train.py:195-200``)."""
        cfg = self.config.lbfgs
        if cfg.max_it <= 0:
            return
        if self._pending_lbfgs64_resume is not None and self._polish_enabled():
            # resumed inside the f64 polish: the f32 phase had ended before it
            # began, and a warm restart here would change the continuation
            return
        if self._lbfgs_runner is None:
            self._lbfgs_runner = lbfgs_mod.LBFGSRunner(
                loss_fn=self.loss_fn,
                value_and_grad_fn=self.value_and_grad_fn,
                params_template=self.state.params,
                options=lbfgs_mod.LBFGSOptions(
                    lr=cfg.learning_rate,
                    max_iter=cfg.max_it,
                    max_eval=cfg.max_evaluation,
                    history_size=cfg.history_size,
                    tolerance_grad=cfg.tolerance_grad,
                    tolerance_change=cfg.tolerance_change,
                    line_search=cfg.line_search_fn,
                ),
                # ~1000-evaluation chunks: checkpoint and snapshot cadence
                # inside the phase quantizes as in the Adam phase
                record_capacity=(
                    self._lbfgs_record_capacity
                    if self._lbfgs_record_capacity is not None
                    else 1000 + 2 * (lbfgs_mod.MAX_LS + 2)
                ),
            )
        runner = self._lbfgs_runner
        if self._pending_lbfgs_resume is not None:
            # exact continuation: the checkpoint carried the whole optimizer
            # state, so no init evaluation and no history warm restart
            state = runner.restore_state(self._pending_lbfgs_resume)
            self._pending_lbfgs_resume = None
        else:
            state = runner.init(self.state.params, self.batch)
        self._live_lbfgs_state = state
        while not runner.finished(state):
            state, records = runner.run_chunk(state, self.batch)
            # the live iterate first: checkpoints and the snapshot cut while
            # recording must see current weights (reference train.py:179)
            self._set_params(runner.get_params(state))
            self._record(records)
        # the init evaluation's row may still be unflushed (immediate stop):
        # the reference logs every closure call (train.py:162)
        state, leftover = runner.drain_records(state)
        self._set_params(runner.get_params(state))
        if leftover.size:
            self._record(leftover)
        self.lbfgs_stop_reason = runner.stop_reason(state)

    # ------------------------------------------------------------ f64 polish

    def _polish_enabled(self) -> bool:
        return self.config.f64_polish is not None and self.config.f64_polish.max_it > 0

    def polish_device(self) -> torch.device:
        """Where the polish runs its loop and its evaluations: the host CPU
        for ``backend='cpu'`` (the bit-exact resume guarantee, as in the JAX
        package), else the Trainer's device (the mesh's first device), which
        is the card: the H100 has native float64, so ``'device_eval'`` and
        ``'default'`` both run there. The JAX package's ``'device_eval'``
        route, a host loop calling its accelerator per evaluation, works
        around the TPU's emulated float64 and has no counterpart."""
        return torch.device("cpu") if self.config.f64_polish.backend == "cpu" else self.device

    def train_f64_polish(self) -> None:
        """The optional float64 L-BFGS polish (framework extension,
        ``config.F64PolishConfig``; JAX ``training/driver.py:503-663``).

        f32 quasi-Newton descent on the deep net stops at the ~5e-9
        evaluation-noise floor: every remaining decrement is below the noise
        and strong-Wolfe bracketing collapses to a zero step
        (``PARITY_LBFGS_WARM.md``). This phase reruns the same optimizer in
        float64, where those decrements resolve again: plain autograd of the
        loss (the unsharded batch, on :meth:`polish_device`; no kernel),
        K1's plain form inside the one-kernel gate. Evaluations go into
        ``log.txt`` and the checkpoints through :meth:`_record`, the live
        iterate rounded to the f32 parameters first."""
        if not self._polish_enabled():
            return
        cfg = self.config.f64_polish
        device = self.polish_device()
        f64 = torch.float64
        params64 = {k: self.state.params[k].detach().to(device, f64) for k in PARAM_KEYS}
        # the host data, not the (possibly sharded, padded) training batch:
        # the polish is single-device, as in the JAX package
        batch64 = {k: torch.as_tensor(v).to(device)
                   for k, v in self._host_batch(np.float64).items()}
        loss_fn = build_loss_fn(
            self.config, self.spec, residual_chunk_size=self.config.residual_chunk_size,
            input_min_max=self.data.input_min_max,
            fidelity_is_residual=getattr(self.data, "fidelity_is_residual", False),
        )
        runner = lbfgs_mod.LBFGSRunner(
            loss_fn=loss_fn,
            params_template=params64,
            options=lbfgs_mod.LBFGSOptions(
                lr=cfg.learning_rate,
                max_iter=cfg.max_it,
                max_eval=cfg.max_evaluation,
                history_size=cfg.history_size,
                tolerance_grad=cfg.tolerance_grad,
                tolerance_change=cfg.tolerance_change,
                line_search=cfg.line_search_fn,
            ),
            # f64 evaluations cost more than the f32 phases': a ~50-evaluation
            # cadence keeps log flushes and checkpoints regular
            record_capacity=(self._lbfgs_record_capacity
                             if self._lbfgs_record_capacity is not None
                             else 50 + 2 * (lbfgs_mod.MAX_LS + 2)),
        )
        self._lbfgs64_runner = runner
        if self._pending_lbfgs64_resume is not None:
            # exact continuation: the f64 iterate and history come from the
            # checkpoint (its f32 parameters are the rounded shadow); its
            # params64 is this same iterate
            state = runner.restore_state(self._pending_lbfgs64_resume)
            self._pending_lbfgs64_resume = self._pending_params64 = None
        else:
            pending, self._pending_params64 = self._pending_params64, None
            if pending is not None:
                # a finished polish's exact f64 iterate, used while the live
                # f32 parameters are still its untouched shadow: polishing
                # from the rounded shadow would re-pay the f32 rounding the
                # finished polish already descended through
                flat64 = np.asarray(pending, np.float64).ravel()
                cur = runner.flatten(self.state.params).detach().cpu().numpy()
                if (flat64.shape == (runner.n_params,)
                        and np.array_equal(flat64.astype(np.float32), cur)):
                    params64 = runner.params_from_flat(torch.as_tensor(flat64).to(device))
            state = runner.init(params64, batch64)
        self._live_lbfgs64_state = state
        while not runner.finished(state):
            state, records = runner.run_chunk(state, batch64)
            # the rounded live iterate first: checkpoints and the snapshot
            # cut while recording must see current weights
            self._set_params(runner.get_params(state))
            self._record(records)
        state, leftover = runner.drain_records(state)
        self._set_params(runner.get_params(state))
        if leftover.size:
            self._record(leftover)
        self.polish_stop_reason = runner.stop_reason(state)

    # ------------------------------------------------------------- lifecycle

    def train(self) -> None:
        """Both phases, the f64 polish, the snapshot and the final save
        (reference ``train.py:185-200``; snapshot as
        ``train_newmethod.py:141-153``)."""
        t0 = time.time()
        start_evals = self.state.iteration
        self.train_adam()
        t_adam = time.time()
        self._maybe_snapshot()
        self.train_lbfgs()
        t_lbfgs = time.time()
        evals_f32 = self.state.iteration
        self.train_f64_polish()
        t_polish = time.time()
        self.save("model")  # final save (reference train.py:288)

        # the rate covers the f32 phases only: the polish runs in another
        # float type at a deliberately different operating point
        evals = evals_f32 - start_evals
        points = int(self.data.residual_input.shape[0])
        total_t = max(t_lbfgs - t0, 1e-9)
        self.stats = {
            "adam_seconds": t_adam - t0,
            "lbfgs_seconds": t_lbfgs - t_adam,
            "loss_evaluations": evals,
            "collocation_points": points,
            "residual_point_evals_per_sec": evals * points / total_t,
        }
        polish = ""
        if self._polish_enabled():
            self.stats["f64_polish_seconds"] = t_polish - t_lbfgs
            self.stats["f64_polish_evaluations"] = self.state.iteration - evals_f32
            polish = f", f64 polish {self.stats['f64_polish_seconds']:.1f}s"
        print(
            f"Phase times: adam {self.stats['adam_seconds']:.1f}s, "
            f"lbfgs {self.stats['lbfgs_seconds']:.1f}s{polish} | "
            f"{evals} loss evals x {points} collocation pts -> "
            f"{self.stats['residual_point_evals_per_sec']:.3e} residual point-evals/s "
            f"on {self.device}"
        )

    def _record(self, losses: np.ndarray) -> None:
        """Flush a (n, 3) loss block to log.txt, stdout and checkpoints (the
        span ``trainer#record``, each save ``trainer#checkpoint``)."""
        with tracing.span("trainer#record"):
            start = self.state.iteration
            rows = [(start + i + 1, *(float(v) for v in losses[i]))
                    for i in range(losses.shape[0])]
            self.log.append(rows)
            self.state.iteration = start + losses.shape[0]
            for epoch, fid, res, total in rows:
                if self.echo_every and epoch % self.echo_every == 0:
                    LossLog.echo(epoch, fid, res, total)
            it = self.state.iteration
            points = ckpt_mod.checkpoint_points(start, it, self.config.kind)
            # one file per crossed cadence point, each with the block-end
            # state; only the last carries the L-BFGS history
            for i, point in enumerate(points):
                with tracing.span("trainer#checkpoint"):
                    self.save(f"model_{point}", include_lbfgs=i == len(points) - 1)
            snap = self.config.snapshot_iteration
            if snap is not None and start < snap <= it:
                self._maybe_snapshot()

    def _snapshot_name(self) -> str:
        snap = self.config.snapshot_iteration
        return "data_at50k.mat" if snap == 50_000 else f"data_at{snap}.mat"

    def _maybe_snapshot(self) -> None:
        """Write the prediction snapshot once the counter has reached
        ``snapshot_iteration`` (reference ``train_newmethod.py:141-153``)."""
        snap = self.config.snapshot_iteration
        if snap is None or self.state.iteration < snap or self._snapshot_done:
            return
        self._snapshot_done = True
        names = resolve_names(self.config)
        pred = self.predict(self.data.residual_input)
        out = {f"pred_{key}": pred[:, i : i + 1] for i, key in enumerate(names["network_outputs"])}
        fname = self._snapshot_name()
        savemat(os.path.join(self.run_dir, fname), out)
        print(f"Data saved to {fname} after {snap:,} iterations.")

    @torch.no_grad()
    def predict(self, inputs: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(inputs, np.float32)).to(self.device)
        if self.kernel_plan.predict:
            y, _ = kernels.mlp_fwd_tangents(self.state.params, x, self.spec, 0,
                                            precision=self.config.resolved_kernel_precision())
        else:
            y = mlp_apply(self.state.params, x, self.spec)
        return y.cpu().numpy()

    # ----------------------------------------------------------- checkpoints

    def _checkpoint_state(self, include_lbfgs: bool = True) -> dict:
        state: dict = {k: self.state.params[k] for k in PARAM_KEYS}
        state["iteration"] = np.asarray(self.state.iteration, np.int64)
        opt_state = self.optimizer.state
        live = [self.state.params[k] for k in PARAM_KEYS if self.state.params[k] in opt_state]
        if live:
            first = opt_state[self.state.params[PARAM_KEYS[0]]]
            state["opt"] = {
                "step": np.asarray(float(first["step"]), np.float32),
                "lr": np.asarray(self.optimizer.param_groups[0]["lr"], np.float64),
                "last_epoch": np.asarray(self.scheduler.last_epoch, np.int64),
                "exp_avg": {k: opt_state[self.state.params[k]]["exp_avg"] for k in PARAM_KEYS},
                "exp_avg_sq": {k: opt_state[self.state.params[k]]["exp_avg_sq"] for k in PARAM_KEYS},
            }
        run = self._live_lbfgs_state
        if (include_lbfgs and run is not None and self._lbfgs_runner is not None
                and run.reason == lbfgs_mod.RUNNING):
            # mid-phase checkpoints carry the whole optimizer state, so
            # --resume continues the exact trajectory; finished states are
            # not exported (resuming a finished run warm-restarts)
            state["lbfgs"] = self._lbfgs_runner.export_state(run)
        live64 = self._live_lbfgs64_state
        if include_lbfgs and live64 is not None:
            if live64.reason == lbfgs_mod.RUNNING:
                # the same contract for the polish: its whole f64 state
                state["lbfgs64"] = self._lbfgs64_runner.export_state(live64)
            # the f64 iterate itself, finished polishes too, so a later run
            # extends the polish without the f32 round trip
            state["params64"] = live64.x.detach().cpu().numpy()
        return state

    def save(self, name: str, include_lbfgs: bool = True) -> str:
        return ckpt_mod.save_checkpoint(
            os.path.join(self.run_dir, name), self._checkpoint_state(include_lbfgs)
        )

    def restore(self, path: str) -> None:
        raw = ckpt_mod.load_raw(path)
        self._set_params(params_from_numpy(raw, self.device))
        self.state.iteration = int(raw["iteration"])
        opt = raw.get("opt")
        if opt is not None:
            sd = self.optimizer.state_dict()
            sd["state"] = {
                i: {
                    "step": torch.tensor(float(opt["step"]), dtype=torch.float32),
                    "exp_avg": torch.as_tensor(opt["exp_avg"][k]),
                    "exp_avg_sq": torch.as_tensor(opt["exp_avg_sq"][k]),
                }
                for i, k in enumerate(PARAM_KEYS)
            }
            sd["param_groups"][0]["lr"] = float(opt["lr"])
            self.optimizer.load_state_dict(sd)
            self.scheduler.last_epoch = int(opt["last_epoch"])
            self.scheduler._last_lr = [float(opt["lr"])]
        self._pending_lbfgs_resume = raw.get("lbfgs")
        self._pending_lbfgs64_resume = raw.get("lbfgs64")
        self._pending_params64 = raw.get("params64")
        # a run resumed past the snapshot point does not rewrite the
        # snapshot with later parameters
        snap = self.config.snapshot_iteration
        if snap is not None and self.state.iteration >= snap:
            self._snapshot_done = True
            if not os.path.exists(os.path.join(self.run_dir, self._snapshot_name())):
                print(
                    f"Warning: resumed at iteration {self.state.iteration} >= "
                    f"snapshot_iteration {snap} but {self._snapshot_name()} is missing; "
                    "it will NOT be rewritten (current parameters are from a later iteration)"
                )
