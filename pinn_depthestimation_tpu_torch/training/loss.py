"""Loss assembly: weighted fidelity MSE + physics residual.

Port of the JAX package's ``training/loss.py`` (reference
``train.py:128-157``, ``train_newmethod.py:120-159``):

* fidelity: per-output weighted MSE between predictions and the stored
  truths (``loss.weight_<key>_loss``; unit weights in the newmethod
  pipeline);
* residual: the configured physics equation on the collocation batch, with
  derivatives from one forward-with-tangents pass;
* total = ``weight_fid_loss * fidelity + weight_res_loss * residual``.

Ported: the plain path, the shared-forward path (newmethod: fidelity and
residual on one point set, certified by the loader's
``fidelity_is_residual``), the separate fidelity forward with per-output
weights (CMB), the quirk-2 anchor toggle, the one-kernel gate and
:func:`build_value_and_grad_fn` (K1), and the generic fused path
(``fused_kernel``): the residual forward with its K coordinate tangents and
the fidelity forward (K=0) through ``ops.kernels_vjp.
fused_apply_with_tangents`` — K2 forward and, by the tier's default
backward, K3 (``f32``, ``f32x3``) or K4 (``bf16``) on the card.
``fused_precision`` is the kernels' tier for the forward and the backward
of both terms, and for K1. ``residual_chunk_size`` is dropped on the kernel
paths, whose backward is O(1) in activations, as the JAX package drops it
under ``fused_kernel``; on the plain path it evaluates the residual term
in chunks of points under ``torch.utils.checkpoint`` (JAX
``training/loss.py:314-385``), summing each chunk's sufficient statistics
(``physics.residual_stats``), so only one chunk's activations live through
the backward and the loss is the full-batch one.

Under a device mesh (``mesh``, ``parallel.mesh``) the batch is the list of
shards ``parallel.shard_batch`` makes, and each shard computes the sufficient
statistics of the residual (``physics.residual_stats``) and of the fidelity
(``_fid_sum_err2``, ``_fid_n``) from its own copy of the parameters; the
statistics are summed in shard order on the first shard's device and
combined once (JAX ``training/loss.py:242-300``). Autograd carries each
shard's gradient back to the one master copy. The unsharded generic loss
keeps the equation's direct form, as the JAX package does, so its rounding
stays the JAX package's. Inside the one-kernel gate an unsharded batch is
the one-shard case of the same code: K1's plain form and K1 itself take the
list of shards ``ops.kernels_step.make_step_batches`` builds (global
counts), and :func:`build_value_and_grad_fn` runs K1 on every shard.

Every loss follows the float type of its batch and parameters: the f64
polish (``training.driver.Trainer.train_f64_polish``) evaluates it in
float64.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from pinn_depthestimation_tpu_torch import physics
from pinn_depthestimation_tpu_torch.config import Config
from pinn_depthestimation_tpu_torch.models import MLPSpec, mlp_apply, mlp_apply_with_tangents
from pinn_depthestimation_tpu_torch.models.mlp import PARAM_KEYS
from pinn_depthestimation_tpu_torch.ops import kernels_step, kernels_vjp
from pinn_depthestimation_tpu_torch.parallel import replicate


def resolve_names(config: Config) -> dict:
    """Input/output name lists per pipeline kind."""
    if config.kind == "newmethod":
        d = config.data
        return {
            "fidelity_inputs": list(d.inputs),
            "fidelity_outputs": list(d.trues),
            "residual_inputs": list(d.inputs),
            "residual_grad_inputs": [n for n, g in zip(d.inputs, d.requires_grad) if g],
            "network_outputs": list(d.outputs),  # true heads then unknown heads
        }
    fd, rd = config.data_fidelity, config.data_residual
    return {
        "fidelity_inputs": list(fd.inputs),
        "fidelity_outputs": list(fd.outputs),
        "residual_inputs": list(rd.inputs),
        "residual_grad_inputs": [n for n, g in zip(rd.inputs, rd.requires_grad) if g],
        "network_outputs": list(rd.outputs),
    }


def _anchor_kwargs(config: Config, input_min_max: dict | None) -> dict:
    """Quirk-2 toggle (SURVEY.md §5): the reference compares its depth-anchor
    threshold (physical 25.5 m) against NORMALIZED x, selecting every point.
    parity=True reproduces that; parity=False maps the threshold into
    normalized space (the same as comparing against denormalized x)."""
    equation_kwargs: dict = {}
    if not config.parity and config.physics == "continuity_only":
        if (
            not input_min_max
            or "x" not in input_min_max
            or input_min_max["x"][0] == input_min_max["x"][1]
        ):
            # failing loudly, not falling back: without the x bounds the
            # threshold would be compared raw against normalized x and select
            # every point — the quirk-2 behavior parity=false opts out of
            raise ValueError(
                "parity=false with continuity_only physics needs "
                "input_min_max with non-degenerate 'x' bounds to place the "
                "anchor threshold in normalized coordinates (pass the "
                "loader's input_min_max to build_loss_fn/"
                "build_value_and_grad_fn)"
            )
        lo, hi = input_min_max["x"]
        anchor_raw = config.raw.get("anchor", {})
        threshold = float(anchor_raw.get("threshold", 25.5))
        equation_kwargs["anchor_threshold"] = 2 * (threshold - lo) / (hi - lo) - 1
        if "depth" in anchor_raw:
            equation_kwargs["anchor_depth"] = float(anchor_raw["depth"])
    return equation_kwargs


def build_loss_fn(
    config: Config,
    spec: MLPSpec,
    *,
    residual_chunk_size: int | None = None,
    input_min_max: dict | None = None,
    fused_kernel: bool = False,
    fused_precision: str = "f32",
    fidelity_is_residual: bool = False,
    mesh=None,
) -> Callable:
    """Returns ``loss_fn(params, batch, dropout_generator=None) -> (total,
    (fid, res))``, differentiable by autograd. With ``mesh``, ``batch`` is
    ``parallel.shard_batch``'s list of shards (module docstring). ``batch`` holds
    ``fidelity_input``, ``fidelity_true``, ``residual_input`` and optionally
    ``fidelity_mask``/``residual_mask`` (masked means). A configuration
    inside the one-kernel gate (:func:`one_kernel_step_applicable`) gets
    ``ops.kernels_step.shared_forward_loss_plain``, the plain form K1 is
    held to; one point set there carries one mask, ``residual_mask``.

    ``fused_kernel``: the loss runs through the kernels (a Trainer passes
    its plan's K1-or-fused decision). The residual forward (K coordinate
    tangents) and the separate fidelity forward (K=0) go through
    ``ops.kernels_vjp.fused_apply_with_tangents`` at the tier
    ``fused_precision`` — K2 forward and K3 (``f32``, ``f32x3``) or K4
    (``bf16``) backward for a batch on the card, their plain versions on the
    CPU; inside the one-kernel gate the loss is K1's plain form at that
    tier. It needs the differentiated coordinates to lead the residual
    inputs, in order, and no dropout, and raises otherwise, as the JAX
    package does. Unlike the JAX package, the fidelity forward takes the
    kernels at every size: its ``FUSED_FIDELITY_MIN_POINTS`` was a TPU
    measurement.

    ``residual_chunk_size``: dropped under ``fused_kernel`` (the kernels'
    backward is O(1) in activations; JAX ``training/loss.py:126-127``). On
    the plain path a collocation set larger than it is evaluated in chunks
    of that many points (:func:`_chunked_stats`); a smaller one takes the
    unchunked path, as in the JAX package. Under a mesh the chunking is
    per shard."""
    if fused_kernel:
        residual_chunk_size = None
    names = resolve_names(config)
    fid_outputs = names["fidelity_outputs"]
    net_outputs = names["network_outputs"]
    residual_inputs = names["residual_inputs"]

    equation = physics.residual_loss(config.physics)
    stats_fn = physics.residual_stats(config.physics)
    combine_fn = physics.residual_from_stats(config.physics)
    needed = physics.required_grad_coords(config.physics)
    missing = [c for c in needed if c not in residual_inputs]
    if missing:
        raise ValueError(
            f"physics equation {config.physics!r} needs input coordinates {needed}, "
            f"but residual inputs are {residual_inputs} (missing {missing})"
        )
    no_grad = [c for c in needed if c not in names["residual_grad_inputs"]]
    if no_grad:
        raise ValueError(
            f"physics equation {config.physics!r} differentiates w.r.t. {needed}, "
            f"but the config marks {no_grad} as requires_grad=false"
        )
    grad_coords = list(needed)
    if fused_kernel:
        # the kernels produce tangents for the FIRST K input columns in order
        cols = [residual_inputs.index(c) for c in grad_coords]
        if cols != list(range(len(cols))):
            raise ValueError(
                "fused_kernel requires the differentiated coordinates to be "
                f"the leading residual inputs in order; got {grad_coords} "
                f"within {residual_inputs}"
            )
        if spec.dropout_rate:
            raise ValueError("fused_kernel does not support dropout")
        kernels_vjp.check_precision(fused_precision, "K2/K3/K4")
    fid_weight_list = [config.output_weight(k) for k in fid_outputs]
    parity = config.parity
    equation_kwargs = _anchor_kwargs(config, input_min_max)
    # reuse the residual forward for the fidelity term only when the loader
    # certifies one point set and the forward is deterministic
    share_forward = fidelity_is_residual and spec.dropout_rate == 0.0

    if residual_chunk_size is None and one_kernel_step_applicable(config, spec,
                                                                  fidelity_is_residual):
        # inside the one-kernel gate the shared-forward loss has one plain
        # form, the one K1's plain version differentiates (a chunked plain
        # loss sums the statistics of build_loss_fn's own chunks instead)
        step_batch = _step_batch_fn(config, input_min_max)

        tier = fused_precision if fused_kernel else "f32"

        def shared_loss_fn(params, batch, dropout_generator=None):
            del dropout_generator  # dropout == 0 is part of the gate
            total, fid, res = kernels_step.shared_forward_loss_plain(params, step_batch(batch),
                                                                     spec, tier)
            return total, (fid, res)

        return shared_loss_fn

    def apply_with_tangents(params):
        if fused_kernel:
            return lambda x, t: kernels_vjp.fused_apply_with_tangents(
                params, x, spec, t.shape[0], fused_precision)
        return lambda x, t: mlp_apply_with_tangents(params, x, t, spec)

    def fidelity_forward(params, x, dropout_generator):
        """The separate fidelity forward (reference train.py:131-141): the
        CMB pipeline's observation points differ from its collocation
        grid."""
        if fused_kernel:
            y, _ = kernels_vjp.fused_apply_with_tangents(params, x, spec, 0, fused_precision)
            return y
        return mlp_apply(params, x, spec, dropout_generator=dropout_generator)

    n_fid = len(fid_outputs)

    def shard_stats(params, shard, dropout_generator):
        """The residual's and the fidelity's sufficient statistics on one
        shard's rows, chunked where the shard is larger than the chunk."""
        pts = shard["residual_input"]
        ones = pts.new_ones((pts.shape[0],))

        def bundle(points):
            return physics.model_fields_and_grads(
                apply_with_tangents(params), points, residual_inputs, grad_coords, net_outputs)

        shared = n_fid if share_forward else 0
        kw = dict(parity=parity, **equation_kwargs)
        if residual_chunk_size is not None and pts.shape[0] > residual_chunk_size:
            stats = _chunked_stats(bundle, shard, residual_chunk_size, stats_fn, net_outputs,
                                   shared, kw)
        else:
            fid = ((shard["fidelity_true"], shard.get("fidelity_mask", ones)) if shared else ())
            stats = _point_stats(bundle, stats_fn, net_outputs, shared, kw, pts,
                                 shard.get("residual_mask", ones), *fid)
        if not share_forward:
            x = shard["fidelity_input"]
            pred = fidelity_forward(params, x, dropout_generator)[..., :n_fid]
            f_m = shard.get("fidelity_mask", x.new_ones((x.shape[0],)))
            stats["_fid_sum_err2"] = torch.sum((shard["fidelity_true"] - pred) ** 2
                                               * f_m[:, None], dim=0)
            stats["_fid_n"] = torch.sum(f_m)
        return stats

    def sharded_loss_fn(params, shards, dropout_generator=None):
        first = shards[0]["residual_input"].device
        summed: dict = {}
        for copy, shard in zip(replicate(params, mesh), shards):
            for k, v in shard_stats(copy, shard, dropout_generator).items():
                v = v.to(first)
                summed[k] = v if k not in summed else summed[k] + v
        per_output = summed.pop("_fid_sum_err2") / summed.pop("_fid_n")
        fid_weights = torch.as_tensor(fid_weight_list, dtype=per_output.dtype, device=first)
        fidelity = torch.sum(fid_weights * per_output)
        residual = combine_fn(summed)
        total = config.weight_fidelity * fidelity + config.weight_residual * residual
        return total, (fidelity, residual)

    if mesh is not None:
        return sharded_loss_fn

    def loss_fn(params, batch, dropout_generator=None):
        res_input = batch["residual_input"]
        fid_weights = torch.as_tensor(fid_weight_list, dtype=res_input.dtype,
                                      device=res_input.device)

        def fidelity_from(pred):
            err2 = (batch["fidelity_true"] - pred[..., : len(fid_outputs)]) ** 2
            fid_mask = batch.get("fidelity_mask")
            per_output = (
                torch.mean(err2, dim=0)
                if fid_mask is None
                else torch.sum(err2 * fid_mask[:, None], dim=0) / torch.sum(fid_mask)
            )
            return torch.sum(fid_weights * per_output)

        def bundle(points):
            return physics.model_fields_and_grads(
                apply_with_tangents(params), points, residual_inputs, grad_coords, net_outputs)

        if residual_chunk_size is not None and res_input.shape[0] > residual_chunk_size:
            summed = _chunked_stats(bundle, batch, residual_chunk_size, stats_fn, net_outputs,
                                    n_fid if share_forward else 0,
                                    dict(parity=parity, **equation_kwargs))
            if share_forward:
                per_output = summed.pop("_fid_sum_err2") / summed.pop("_fid_n")
                fidelity = torch.sum(fid_weights * per_output)
            residual = combine_fn(summed)
        else:
            coords, fields, grads = bundle(res_input)
            residual = equation(coords, fields, grads, mask=batch.get("residual_mask"),
                                parity=parity, **equation_kwargs)
            if share_forward:
                # fidelity output i == network output i for the true heads
                fidelity = fidelity_from(torch.stack([fields[k] for k in net_outputs], dim=-1))
        if not share_forward:
            fidelity = fidelity_from(
                fidelity_forward(params, batch["fidelity_input"], dropout_generator))
        total = config.weight_fidelity * fidelity + config.weight_residual * residual
        return total, (fidelity, residual)

    return loss_fn


def _point_stats(bundle, stats_fn, net_outputs, n_fid: int, equation_kwargs: dict, pts, m,
                 *fid):
    """The residual's sufficient statistics on ``pts`` (mask ``m``) and, with
    ``n_fid`` shared fidelity heads and ``fid = (f_true, f_mask)``, the
    fidelity's ``_fid_sum_err2`` and ``_fid_n`` from the same forward."""
    coords, fields, grads = bundle(pts)
    stats = dict(stats_fn(coords, fields, grads, mask=m, **equation_kwargs))
    if n_fid:
        f_true, f_m = fid
        pred = torch.stack([fields[k] for k in net_outputs], dim=-1)[..., :n_fid]
        stats["_fid_sum_err2"] = torch.sum((f_true - pred) ** 2 * f_m[:, None], dim=0)
        stats["_fid_n"] = torch.sum(f_m)
    return stats


def _chunked_stats(bundle, batch, chunk: int, stats_fn, net_outputs, n_fid: int,
                   equation_kwargs: dict) -> dict:
    """The residual's sufficient statistics (and, with ``n_fid`` shared
    fidelity heads, the fidelity's ``_fid_sum_err2`` and ``_fid_n``) from
    chunks of ``chunk`` points: each chunk's statistics under
    ``torch.utils.checkpoint`` (its activations recomputed in the backward,
    not kept), summed (JAX ``training/loss.py:314-385``). The last chunk is
    the remainder: the JAX package pads to a multiple of the chunk because
    ``lax.map`` needs one shape, which PyTorch does not. Where the fidelity
    rows are the residual rows, the fidelity term rides the same sweep: a
    separate full-batch forward over those rows would keep every layer's
    activations for the whole set, the memory chunking saves."""
    points = batch["residual_input"]
    ones = points.new_ones((points.shape[0],))
    mask = batch.get("residual_mask", ones)
    if n_fid:
        fid_true, fid_mask = batch["fidelity_true"], batch.get("fidelity_mask", ones)

    def chunk_stats(pts, m, *fid):
        return _point_stats(bundle, stats_fn, net_outputs, n_fid, equation_kwargs, pts, m, *fid)

    summed: dict = {}
    for start in range(0, points.shape[0], chunk):
        rows = slice(start, start + chunk)
        args = (points[rows], mask[rows]) + ((fid_true[rows], fid_mask[rows]) if n_fid else ())
        for k, v in checkpoint(chunk_stats, *args, use_reentrant=False).items():
            summed[k] = v if k not in summed else summed[k] + v
    return summed


def value_and_grad(loss_fn: Callable) -> Callable:
    """``fn(params, batch, dropout_generator=None) -> ((total, (fid, res)),
    grads)`` by autograd — the generic path, counterpart of
    ``jax.value_and_grad(loss_fn, has_aux=True)``."""

    def fn(params, batch, dropout_generator=None):
        leaves = {k: params[k].detach().requires_grad_() for k in PARAM_KEYS}
        with torch.enable_grad():
            total, (fid, res) = loss_fn(leaves, batch, dropout_generator)
            grads = torch.autograd.grad(total, [leaves[k] for k in PARAM_KEYS],
                                        allow_unused=True, materialize_grads=True)
        return (total.detach(), (fid.detach(), res.detach())), dict(zip(PARAM_KEYS, grads))

    return fn


def one_kernel_step_applicable(config: Config, spec: MLPSpec, fidelity_is_residual: bool) -> bool:
    """Does this configuration qualify for the one-kernel training step
    (K1)? The semantics of the JAX package's gate, verbatim."""
    if not fidelity_is_residual or spec.dropout_rate:
        return False
    if config.physics not in ("continuity_only", "continuity_ftemp"):
        return False
    names = resolve_names(config)
    net_outputs = names["network_outputs"]
    fid_outputs = names["fidelity_outputs"]
    n_true = len(fid_outputs)
    has_anchor = config.physics == "continuity_only"
    if net_outputs[:3] != ["U", "V", "h"] or spec.d_out != 3:
        return False
    if fid_outputs != net_outputs[:n_true]:
        return False
    if n_true > (2 if has_anchor else 3):
        return False
    if names["residual_inputs"][:2] != ["x", "y"]:
        return False
    return True


def _step_batch_fn(config: Config, input_min_max: dict | None) -> Callable:
    """``step_batch(batch) -> list[kernels_step.StepBatch]`` for a
    configuration inside the one-kernel gate: the selector ``sel`` (as the
    JAX package builds it), the mask and the scales, built once per batch,
    one ``StepBatch`` per shard with the global counts (a batch dict is one
    shard). One point set carries one mask, ``residual_mask``."""
    names = resolve_names(config)
    n_true = len(names["fidelity_outputs"])
    # the anchor selector rides the h head; a 3-head anchored fidelity is
    # refused by the gate
    has_anchor = config.physics == "continuity_only"
    kwargs = _anchor_kwargs(config, input_min_max)
    anchor_threshold = kwargs.get("anchor_threshold", 25.5)
    anchor_depth = kwargs.get("anchor_depth", 0.75)
    fid_weights = [config.output_weight(k) for k in names["fidelity_outputs"]]
    ix = names["residual_inputs"].index("x")
    cache: dict = {}

    def step_batch(batch) -> list[kernels_step.StepBatch]:
        if cache.get("batch") is not batch:
            coords, trues, sel, mask = [], [], [], []
            for shard in batch if isinstance(batch, list) else [batch]:
                x = shard["residual_input"]
                m = shard.get("residual_mask")
                if m is None:
                    m = torch.ones((x.shape[0],), dtype=x.dtype, device=x.device)
                coords.append(x)
                trues.append(shard["fidelity_true"])
                sel.append(torch.where(x[:, ix] < anchor_threshold, 1.0, 0.0).to(m.dtype) * m)
                mask.append(m)
            cache["batch"] = batch
            cache["step"] = kernels_step.make_step_batches(
                coords, trues, sel, mask, fid_weights, n_true, float(config.weight_fidelity),
                float(config.weight_residual), anchor_depth=anchor_depth,
                has_anchor=has_anchor)
        return cache["step"]

    return step_batch


def build_value_and_grad_fn(
    config: Config,
    spec: MLPSpec,
    *,
    input_min_max: dict | None = None,
    fused_kernel: bool = False,
    fused_precision: str = "f32",
    fidelity_is_residual: bool = False,
):
    """Loss and gradient from the one-kernel training step (K1,
    ``ops.kernels_step.fused_loss_and_grad``) when ``fused_kernel`` is set
    and the configuration permits, else ``None`` (the caller takes
    :func:`value_and_grad` of :func:`build_loss_fn`).

    Returns ``fn(params, batch, dropout_generator=None) -> ((total, (fid,
    res)), grads)`` with ``build_loss_fn``'s semantics at the tier
    ``fused_precision``: K1 for a batch on a CUDA device, its plain version
    for one on the CPU. The
    selector ``sel``, the mask and the scales are built once per batch
    (``make_step_batches``), not per evaluation. A list of shards
    (``parallel.shard_batch``) runs K1 on each."""
    if not fused_kernel:
        return None
    if not one_kernel_step_applicable(config, spec, fidelity_is_residual):
        return None
    kernels_step.check_precision(fused_precision, "K1")
    step_batch = _step_batch_fn(config, input_min_max)

    def value_and_grad_fn(params, batch, dropout_generator=None):
        del dropout_generator  # dropout == 0 is part of the gate
        return kernels_step.fused_loss_and_grad(params, step_batch(batch), spec,
                                                precision=fused_precision)

    return value_and_grad_fn
