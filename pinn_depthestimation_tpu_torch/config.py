"""Config system: accepts the reference JSON schema verbatim, adds validation.

A whole copy of the JAX package's ``config.py`` (stdlib only): the port
imports nothing of that package, so both parse one file into equal values.
The kernel fields parse here too: the port reads ``kernel_precision``
(:meth:`Config.resolved_kernel_precision`: the kernels' tier, ``f32``,
``bf16`` or ``f32x3``), ``fused_kernel`` (whether training
takes the kernels; ``'off'`` also sends the Trainer's predictions through
the plain ``mlp_apply``), ``precision_schedule``, ``f64_polish`` (the
float64 polish after the f32 L-BFGS phase) and ``parallel`` (the mesh a
Trainer trains over).

The reference drives everything from plain JSON with no schema or defaults
(reference ``train.py:35``, ``test.py:137``): sections ``layers``,
``adam_optimizer``, ``lbfgs_optimizer``, ``loss``, ``data_fidelity`` /
``data_residual`` (the "CMB" pipeline, reference ``config_CMB.json``) or a
single ``data`` block with ``inputs`` / ``trues`` / ``unknowns`` (the
"newmethod" pipeline, reference ``config_CMB_h.json:33-41``), plus
``data_test`` and ``plot``.

This module accepts those files unchanged and additionally:

* tolerates the legacy schema of ``config.json`` / ``config_txyz.json``
  (``data_fidelity.dir`` instead of ``file``, missing ``dropout_rate`` /
  ``init_type`` — reference ``config.json:2-7``), which the reference itself
  can no longer run;
* validates types/ranges with actionable errors instead of deep KeyErrors;
* supports framework extensions under keys the reference never reads:
  ``physics`` (equation name override), ``parity`` (reproduce the reference's
  numerical quirks bit-for-honest vs corrected physics), ``parallel``
  (device-mesh shape), ``kernel_precision``, ``f64_polish`` and
  ``snapshot_iteration``.
"""

from __future__ import annotations

import copy
import json
import math
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence


class ConfigError(ValueError):
    """Raised when a config file is malformed or inconsistent."""


_VALID_INIT_TYPES = ("xavier", "kaiming")
_VALID_LINE_SEARCH = ("strong_wolfe", "none")
_VALID_PHYSICS = (
    "continuity_only",     # reference physics.py:18
    "continuity_ftemp",    # reference physics.py:37
    "navier_stokes",       # reference physics.py:50
    "wave_averaged",       # reference physics.py:91 (`physics_equation`)
)


def _as_int(value: Any, where: str) -> int:
    """Ints may be written in scientific notation in reference configs
    (``"max_it": 5.00e4``, reference ``config.json:26``)."""
    try:
        f = float(value)
    except (TypeError, ValueError):
        raise ConfigError(f"{where}: expected a number, got {value!r}")
    i = int(round(f))
    if not math.isfinite(f) or abs(f - i) > 1e-9 * max(1.0, abs(f)):
        raise ConfigError(f"{where}: expected an integer-valued number, got {value!r}")
    return i


def _as_float(value: Any, where: str) -> float:
    try:
        return float(value)
    except (TypeError, ValueError):
        raise ConfigError(f"{where}: expected a number, got {value!r}")


def _requires_grad(info: Any) -> bool:
    """Reference encodes per-input differentiability as
    ``{"requires_grad": ["true"]}`` and tests membership of the string "true"
    (reference ``train.py:87``). Accept that form plus plain booleans."""
    if isinstance(info, Mapping):
        flag = info.get("requires_grad", False)
    else:
        flag = info
    if isinstance(flag, bool):
        return flag
    if isinstance(flag, str):
        return "true" in flag.lower()
    if isinstance(flag, Sequence):
        return any("true" in str(x).lower() for x in flag)
    return bool(flag)


@dataclass(frozen=True)
class LayersConfig:
    input_features: int
    hidden_layers: int
    hidden_width: int
    output_features: int
    dropout_rate: float = 0.0
    init_type: str = "xavier"

    @property
    def sizes(self) -> list[int]:
        """Layer-size list exactly as the reference constructs it
        (reference ``train.py:56``)."""
        return (
            [self.input_features]
            + [self.hidden_width] * self.hidden_layers
            + [self.output_features]
        )


@dataclass(frozen=True)
class AdamConfig:
    max_it: int
    learning_rate: float
    scheduler_step_size: int
    scheduler_gamma: float


@dataclass(frozen=True)
class LBFGSConfig:
    max_it: int
    learning_rate: float
    max_evaluation: int
    history_size: int
    tolerance_grad: float
    tolerance_change: float
    line_search_fn: str = "strong_wolfe"


@dataclass(frozen=True)
class F64PolishConfig:
    """Framework extension (no reference counterpart): an optional float64
    L-BFGS *polish* phase appended after the reference's f32 L-BFGS phase,
    where f32 loss-evaluation noise stops strong-Wolfe bracketing above the
    optimum (full diagnosis in PARITY_LBFGS_WARM.md).

    ``backend`` says where the loop and its loss evaluations run. In the JAX
    package: ``'device_eval'`` (loop on the host, evaluations on the
    accelerator), ``'cpu'`` (both on the host; the bit-exact resume
    guarantee) or ``'default'`` (the whole loop on the accelerator); its
    ``config.py`` records its TPU measurements for each. In the port the
    card has native float64, so ``'device_eval'`` and ``'default'`` both run
    the loop and its evaluations on the Trainer's device (the card), and
    ``'cpu'`` both on the host CPU (the bit-exact resume guarantee;
    ``training.driver.Trainer.polish_device``). Tolerances default far
    tighter than the f32 phase's since they gate on f64-resolvable changes.
    """

    max_it: int = 1000
    learning_rate: float = 1.0
    max_evaluation: int = 1250
    history_size: int = 100
    tolerance_grad: float = 1e-10
    tolerance_change: float = 1e-13
    line_search_fn: str = "strong_wolfe"
    backend: str = "device_eval"  # 'device_eval' | 'cpu' | 'default'


@dataclass(frozen=True)
class PrecisionScheduleConfig:
    """Framework extension (no reference counterpart): a staged-precision
    Adam schedule — the FIRST ``prefix_iters`` Adam steps evaluate
    loss+gradients at the cheap ``prefix_precision`` kernel tier, then the
    run continues at the configured ``kernel_precision`` (f32 by default)
    for the Adam tail and the L-BFGS phase.

    The defaults are the JAX package's, set from its own TPU measurements
    (its ``config.py``); the port's times on the card are in ``PERF.md``.

    Resume-aware by construction: the tier switch is keyed on the ABSOLUTE
    iteration counter, which checkpoints carry.
    """

    prefix_precision: str = "bf16"  # 'bf16' | 'f32x3' | 'f32' (no-op)
    prefix_iters: int = 35_000


@dataclass(frozen=True)
class FidelityDataConfig:
    """CMB fidelity block (reference ``config_CMB.json:39-44``)."""

    file: str
    inputs: tuple[str, ...]
    outputs: tuple[str, ...]
    training_points: int


@dataclass(frozen=True)
class ResidualDataConfig:
    """CMB residual/collocation block (reference ``config_CMB.json:46-56``).

    ``input_files``/``output_files`` carry the per-key file stems of the
    legacy schema (reference ``config.json:40-52``: each input/output maps to
    a ``{"file": stem}`` entry naming the FUNWAVE snapshot file family or the
    static ``dep.out``); for current-schema configs they equal the names.
    """

    file: str
    inputs: tuple[str, ...]
    requires_grad: tuple[bool, ...]
    outputs: tuple[str, ...]
    interval_x: int = 1
    interval_y: int = 1
    snapshots: tuple[int, ...] = ()
    input_files: tuple[str, ...] = ()
    output_files: tuple[str, ...] = ()


@dataclass(frozen=True)
class NumericalModelConfig:
    """Legacy FUNWAVE snapshot-grid block (reference ``config.json:55-68``):
    the uniform grid the time-indexed snapshot files live on, plus the
    subsampling intervals and snapshot time spacing."""

    dir: str
    nx: int
    ny: int
    dx: float
    dy: float
    x_min: float
    x_max: float
    y_min: float
    y_max: float
    interval_x: int = 1
    interval_y: int = 1
    dt: float = 1.0
    number_of_files: int | None = None


@dataclass(frozen=True)
class UnifiedDataConfig:
    """newmethod data block (reference ``config_CMB_h.json:33-41``)."""

    file: str
    inputs: tuple[str, ...]
    requires_grad: tuple[bool, ...]
    trues: tuple[str, ...]
    unknowns: tuple[str, ...]

    @property
    def outputs(self) -> tuple[str, ...]:
        """Network output order: true heads first, then unknown heads
        (reference ``train_newmethod.py:136-139``)."""
        return self.trues + self.unknowns


@dataclass(frozen=True)
class TestDataConfig:
    model: str | None
    file: str | None
    inputs: tuple[str, ...]
    requires_grad: tuple[bool, ...]
    outputs: tuple[str, ...]
    nx: int | None = None
    ny: int | None = None
    dx: float | None = None
    dy: float | None = None
    x_min: float | None = None
    x_max: float | None = None
    y_min: float | None = None
    y_max: float | None = None
    dt: float | None = None


@dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh shape (framework extension; the reference is single-device,
    reference ``train.py:25-32``). ``data=None`` means "all visible devices"."""

    data: int | None = None
    model: int = 1


@dataclass
class Config:
    raw: dict[str, Any]
    kind: str  # 'cmb' | 'newmethod'
    layers: LayersConfig
    adam: AdamConfig
    lbfgs: LBFGSConfig
    loss_weights: dict[str, float]
    weight_fidelity: float
    weight_residual: float
    data_fidelity: FidelityDataConfig | None = None
    data_residual: ResidualDataConfig | None = None
    data: UnifiedDataConfig | None = None
    data_test: TestDataConfig | None = None
    numerical_model: NumericalModelConfig | None = None
    physics: str = "continuity_only"
    parity: bool = True
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    snapshot_iteration: int | None = None
    perform_optimization: bool = False
    seed: int = 1234
    residual_chunk_size: int | None = None  # gradient-accumulation chunk (extension)
    fused_kernel: str = "auto"  # 'auto' | 'on' | 'off' (Pallas training kernels)
    # 'auto' | 'f32' (HIGHEST) | 'f32x3' (split-f32) | 'bf16'. 'auto' resolves
    # to true f32 in both modes (the f32x3 tier's gradient noise floors
    # corrected-mode convergence — see resolved_kernel_precision below);
    # faster tiers are explicit opt-ins (MIGRATION.md "Precision tiers").
    kernel_precision: str = "auto"
    f64_polish: F64PolishConfig | None = None  # extension; see F64PolishConfig
    # extension; see PrecisionScheduleConfig (staged cheap-tier Adam prefix)
    precision_schedule: PrecisionScheduleConfig | None = None

    def resolved_kernel_precision(self) -> str:
        """The effective Pallas precision tier. ``'auto'`` resolves to TRUE
        f32 for the whole schedule: a round-3 corrected-mode 50k A/B soak
        (.soak/default_path_soak_r3.py) measured the f32x3 tier's ~5e-6
        relative gradient noise flooring the Adam phase at 4.1e-5 total
        loss where f32 reaches 1.25e-5 — the round-2 "f32x3 matches
        full-schedule convergence" result (4.0093e-5 vs 4.00e-5) holds only
        in parity mode, whose optimum sits ABOVE the f32x3 noise floor.
        Defaults must not silently cost 3x in final loss; ``f32x3``/
        ``bf16`` remain explicit opt-ins with their budgets documented in
        MIGRATION.md. (A round-3 per-phase variant — f32x3 Adam + f32
        L-BFGS — was measured and rejected: L-BFGS does <30 evals under
        the reference tolerances and cannot recover the floored Adam
        phase, .soak/default_soak_auto_default.json.)"""
        if self.kernel_precision != "auto":
            return self.kernel_precision
        return "f32"

    def output_weight(self, key: str) -> float:
        """Per-output fidelity loss weight ``weight_<key>_loss``
        (reference ``train.py:94-95,140-141``); 1.0 when absent (the
        newmethod pipeline weights every output equally via ``F.mse_loss``,
        reference ``train_newmethod.py:129-133``)."""
        return float(self.loss_weights.get(f"weight_{key}_loss", 1.0))


def _parse_layers(d: Mapping[str, Any]) -> LayersConfig:
    for k in ("input_features", "hidden_layers", "hidden_width", "output_features"):
        if k not in d:
            raise ConfigError(f"layers.{k} is required")
    init_type = str(d.get("init_type", "xavier"))
    if init_type not in _VALID_INIT_TYPES:
        raise ConfigError(
            f"layers.init_type must be one of {_VALID_INIT_TYPES}, got {init_type!r}"
        )
    dropout = _as_float(d.get("dropout_rate", 0.0), "layers.dropout_rate")
    if not 0.0 <= dropout < 1.0:
        raise ConfigError(f"layers.dropout_rate must be in [0, 1), got {dropout}")
    cfg = LayersConfig(
        input_features=_as_int(d["input_features"], "layers.input_features"),
        hidden_layers=_as_int(d["hidden_layers"], "layers.hidden_layers"),
        hidden_width=_as_int(d["hidden_width"], "layers.hidden_width"),
        output_features=_as_int(d["output_features"], "layers.output_features"),
        dropout_rate=dropout,
        init_type=init_type,
    )
    for k in ("input_features", "hidden_layers", "hidden_width", "output_features"):
        if getattr(cfg, k) <= 0 and k != "hidden_layers":
            raise ConfigError(f"layers.{k} must be positive")
    if cfg.hidden_layers < 1:
        raise ConfigError("layers.hidden_layers must be >= 1")
    return cfg


def _parse_adam(d: Mapping[str, Any]) -> AdamConfig:
    return AdamConfig(
        max_it=_as_int(d.get("max_it", 0), "adam_optimizer.max_it"),
        learning_rate=_as_float(d.get("learning_rate", 1e-4), "adam_optimizer.learning_rate"),
        scheduler_step_size=_as_int(
            d.get("scheduler_step_size", 10_000), "adam_optimizer.scheduler_step_size"
        ),
        scheduler_gamma=_as_float(
            d.get("scheduler_gamma", 1.0), "adam_optimizer.scheduler_gamma"
        ),
    )


def _parse_lbfgs(d: Mapping[str, Any]) -> LBFGSConfig:
    ls = str(d.get("line_search_fn", "strong_wolfe") or "none")
    if ls not in _VALID_LINE_SEARCH:
        raise ConfigError(
            f"lbfgs_optimizer.line_search_fn must be one of {_VALID_LINE_SEARCH}, got {ls!r}"
        )
    return LBFGSConfig(
        max_it=_as_int(d.get("max_it", 0), "lbfgs_optimizer.max_it"),
        learning_rate=_as_float(d.get("learning_rate", 1.0), "lbfgs_optimizer.learning_rate"),
        max_evaluation=_as_int(
            # torch's default: max_iter * 5 // 4 (floor, not banker's round)
            d.get("max_evaluation", _as_int(d.get("max_it", 0), "lbfgs_optimizer.max_it") * 5 // 4),
            "lbfgs_optimizer.max_evaluation",
        ),
        history_size=_as_int(d.get("history_size", 100), "lbfgs_optimizer.history_size"),
        tolerance_grad=_as_float(d.get("tolerance_grad", 1e-7), "lbfgs_optimizer.tolerance_grad"),
        tolerance_change=_as_float(
            d.get("tolerance_change", 1e-9), "lbfgs_optimizer.tolerance_change"
        ),
        line_search_fn=ls,
    )


def _parse_f64_polish(value: Any) -> F64PolishConfig | None:
    """``"f64_polish"`` accepts ``true`` (all defaults), ``false``/absent
    (disabled), or a dict overriding any :class:`F64PolishConfig` field."""
    if value is None or value is False:
        return None
    if value is True:
        return F64PolishConfig()
    if not isinstance(value, Mapping):
        raise ConfigError(
            f"f64_polish must be a boolean or an object, got {value!r}"
        )
    unknown = set(value) - {
        "max_it", "learning_rate", "max_evaluation", "history_size",
        "tolerance_grad", "tolerance_change", "line_search_fn", "backend",
    }
    if unknown:
        raise ConfigError(f"f64_polish: unknown keys {sorted(unknown)}")
    ls = str(value.get("line_search_fn", "strong_wolfe") or "none")
    if ls not in _VALID_LINE_SEARCH:
        raise ConfigError(
            f"f64_polish.line_search_fn must be one of {_VALID_LINE_SEARCH}, got {ls!r}"
        )
    backend = str(value.get("backend", "device_eval"))
    if backend not in ("device_eval", "cpu", "default"):
        raise ConfigError(
            f"f64_polish.backend must be 'device_eval', 'cpu' or 'default', "
            f"got {backend!r}"
        )
    max_it = _as_int(value.get("max_it", 1000), "f64_polish.max_it")
    return F64PolishConfig(
        max_it=max_it,
        learning_rate=_as_float(
            value.get("learning_rate", 1.0), "f64_polish.learning_rate"
        ),
        # torch's default eval budget: max_iter * 5 // 4
        max_evaluation=_as_int(
            value.get("max_evaluation", max_it * 5 // 4), "f64_polish.max_evaluation"
        ),
        history_size=_as_int(value.get("history_size", 100), "f64_polish.history_size"),
        tolerance_grad=_as_float(
            value.get("tolerance_grad", 1e-10), "f64_polish.tolerance_grad"
        ),
        tolerance_change=_as_float(
            value.get("tolerance_change", 1e-13), "f64_polish.tolerance_change"
        ),
        line_search_fn=ls,
        backend=backend,
    )


def _inputs_and_grads(d: Any, where: str) -> tuple[tuple[str, ...], tuple[bool, ...]]:
    """Residual-style inputs are a dict name -> {requires_grad: [...]}
    (reference ``config_CMB.json:48-51``); fidelity-style inputs are a plain
    list (reference ``config_CMB.json:41``)."""
    if isinstance(d, Mapping):
        names = tuple(d.keys())
        grads = tuple(_requires_grad(v) for v in d.values())
    elif isinstance(d, Sequence) and not isinstance(d, (str, bytes)):
        names = tuple(str(x) for x in d)
        grads = tuple(True for _ in names)
    else:
        raise ConfigError(f"{where}.inputs must be a list or a mapping, got {type(d).__name__}")
    if not names:
        raise ConfigError(f"{where}.inputs must not be empty")
    return names, grads


def _file_of(d: Mapping[str, Any], where: str) -> str:
    # Legacy configs use 'dir' where current ones use 'file'
    # (reference config.json:38 vs config_CMB.json:40).
    if "file" in d:
        return str(d["file"])
    if "dir" in d:
        return str(d["dir"])
    raise ConfigError(f"{where}.file is required")


def _output_names(d: Any) -> tuple[str, ...]:
    # Legacy residual outputs are a mapping name -> {file: ...}
    # (reference config.json:46-51); current ones are a list.
    if isinstance(d, Mapping):
        return tuple(d.keys())
    return tuple(str(x) for x in d)


def _file_stems(d: Any, names: tuple[str, ...]) -> tuple[str, ...]:
    """Per-key file stems of the legacy mapping schema (reference
    ``config.json:40-52``); the key name itself when absent."""
    if isinstance(d, Mapping):
        return tuple(
            str(v.get("file", k)) if isinstance(v, Mapping) else str(k)
            for k, v in d.items()
        )
    return names


def _parse_precision_schedule(value: Any) -> PrecisionScheduleConfig | None:
    """``"precision_schedule"`` accepts ``true`` (measured defaults:
    bf16 prefix, 35k iterations), ``false``/absent (disabled), or a dict
    overriding :class:`PrecisionScheduleConfig` fields."""
    if value is None or value is False:
        return None
    if value is True:
        return PrecisionScheduleConfig()
    if not isinstance(value, Mapping):
        raise ConfigError(
            f"precision_schedule must be a boolean or an object, got {value!r}"
        )
    unknown = set(value) - {"prefix_precision", "prefix_iters"}
    if unknown:
        raise ConfigError(f"precision_schedule: unknown keys {sorted(unknown)}")
    tier = str(value.get("prefix_precision", "bf16")).lower()
    if tier not in ("f32", "f32x3", "bf16"):
        raise ConfigError(
            f"precision_schedule.prefix_precision must be 'f32', 'f32x3' or "
            f"'bf16', got {value.get('prefix_precision')!r}"
        )
    iters = _as_int(
        value.get("prefix_iters", 35_000), "precision_schedule.prefix_iters"
    )
    if iters < 0:
        raise ConfigError(
            f"precision_schedule.prefix_iters must be >= 0, got {iters}"
        )
    return PrecisionScheduleConfig(prefix_precision=tier, prefix_iters=iters)


def _as_kernel_precision(value: Any) -> str:
    v = str(value).lower()
    if v not in ("auto", "f32", "f32x3", "bf16"):
        raise ConfigError(
            f"kernel_precision must be 'auto', 'f32', 'f32x3' or 'bf16', "
            f"got {value!r}"
        )
    return v


def _as_fused(value: Any) -> str:
    if isinstance(value, bool):
        return "on" if value else "off"
    v = str(value).lower()
    if v not in ("auto", "on", "off", "true", "false"):
        raise ConfigError(f"fused_kernel must be auto/on/off, got {value!r}")
    return {"true": "on", "false": "off"}.get(v, v)


def parse_config(raw: Mapping[str, Any]) -> Config:
    raw = copy.deepcopy(dict(raw))
    if "layers" not in raw:
        raise ConfigError("config must contain a 'layers' section")
    layers = _parse_layers(raw["layers"])
    adam = _parse_adam(raw.get("adam_optimizer", {}))
    lbfgs = _parse_lbfgs(raw.get("lbfgs_optimizer", {}))

    loss_raw = raw.get("loss", {})
    weights = {k: _as_float(v, f"loss.{k}") for k, v in loss_raw.items()}
    weight_fid = weights.get("weight_fid_loss", 1.0)
    weight_res = weights.get("weight_res_loss", 1.0)

    data_fidelity = data_residual = data = None
    if "data" in raw:
        kind = "newmethod"
        d = raw["data"]
        names, grads = _inputs_and_grads(d.get("inputs"), "data")
        data = UnifiedDataConfig(
            file=_file_of(d, "data"),
            inputs=names,
            requires_grad=grads,
            trues=tuple(d.get("trues", ())),
            unknowns=tuple(d.get("unknowns", ())),
        )
        if len(data.inputs) != layers.input_features:
            raise ConfigError(
                f"data.inputs has {len(data.inputs)} entries but "
                f"layers.input_features={layers.input_features}"
            )
        if len(data.outputs) != layers.output_features:
            raise ConfigError(
                f"data.trues+unknowns has {len(data.outputs)} entries but "
                f"layers.output_features={layers.output_features}"
            )
    elif "data_fidelity" in raw:
        kind = "cmb"
        fd = raw["data_fidelity"]
        fid_inputs = tuple(str(x) for x in fd.get("inputs", ()))
        data_fidelity = FidelityDataConfig(
            file=_file_of(fd, "data_fidelity"),
            inputs=fid_inputs,
            outputs=tuple(str(x) for x in fd.get("outputs", ())),
            training_points=_as_int(
                fd.get("training_points", 0), "data_fidelity.training_points"
            ),
        )
        rd = raw.get("data_residual", {})
        r_names, r_grads = _inputs_and_grads(rd.get("inputs"), "data_residual")
        data_residual = ResidualDataConfig(
            file=_file_of(rd, "data_residual") if ("file" in rd or "dir" in rd) else "",
            inputs=r_names,
            requires_grad=r_grads,
            outputs=_output_names(rd.get("outputs", ())),
            interval_x=_as_int(rd.get("interval_x", 1), "data_residual.interval_x"),
            interval_y=_as_int(rd.get("interval_y", 1), "data_residual.interval_y"),
            snapshots=tuple(
                _as_int(s, "data_residual.snapshots")
                for s in rd.get("snapshots", rd.get("numerical_model_snapshots", ()))
            ),
            input_files=_file_stems(rd.get("inputs"), r_names),
            output_files=_file_stems(
                rd.get("outputs", ()), _output_names(rd.get("outputs", ()))
            ),
        )
        if len(fid_inputs) != layers.input_features:
            raise ConfigError(
                f"data_fidelity.inputs has {len(fid_inputs)} entries but "
                f"layers.input_features={layers.input_features}"
            )
    else:
        raise ConfigError("config must contain either a 'data' or a 'data_fidelity' section")

    data_test = None
    if "data_test" in raw:
        td = raw["data_test"]
        t_names, t_grads = _inputs_and_grads(td.get("inputs", ["x", "y"]), "data_test")
        data_test = TestDataConfig(
            model=td.get("model"),
            file=td.get("file"),
            inputs=t_names,
            requires_grad=t_grads,
            outputs=tuple(str(x) for x in td.get("outputs", ())),
            nx=_as_int(td["nx"], "data_test.nx") if "nx" in td else None,
            ny=_as_int(td["ny"], "data_test.ny") if "ny" in td else None,
            dx=_as_float(td["dx"], "data_test.dx") if "dx" in td else None,
            dy=_as_float(td["dy"], "data_test.dy") if "dy" in td else None,
            x_min=_as_float(td["x_min"], "data_test.x_min") if "x_min" in td else None,
            x_max=_as_float(td["x_max"], "data_test.x_max") if "x_max" in td else None,
            y_min=_as_float(td["y_min"], "data_test.y_min") if "y_min" in td else None,
            y_max=_as_float(td["y_max"], "data_test.y_max") if "y_max" in td else None,
            dt=_as_float(td["dt"], "data_test.dt") if "dt" in td else None,
        )

    # Physics equation: reference hardcodes the choice per entry script
    # (train.py:17 imports physics_equation; train_newmethod.py:18 imports
    # continuity_only; test.py:6 imports Navier_Stokes). Default by pipeline,
    # overridable with the 'physics' extension key.
    default_physics = "continuity_only" if kind == "newmethod" else "wave_averaged"
    physics = str(raw.get("physics", default_physics))
    if physics not in _VALID_PHYSICS:
        raise ConfigError(f"physics must be one of {_VALID_PHYSICS}, got {physics!r}")

    par_raw = raw.get("parallel", {})
    parallel = ParallelConfig(
        data=_as_int(par_raw["data"], "parallel.data") if "data" in par_raw else None,
        model=_as_int(par_raw.get("model", 1), "parallel.model"),
    )

    # The reference snapshots predictions exactly at iteration 50,000 in the
    # newmethod pipeline (train_newmethod.py:141-153).
    default_snapshot = 50_000 if (kind == "newmethod" and data and data.unknowns) else None
    snap = raw.get("snapshot_iteration", default_snapshot)

    numerical_model = None
    if "numerical_model" in raw:
        nm = raw["numerical_model"]
        for req in ("dir", "nx", "ny", "dx", "dy", "x_min", "y_min"):
            if req not in nm:
                raise ConfigError(f"numerical_model.{req} is required")
        numerical_model = NumericalModelConfig(
            dir=str(nm["dir"]),
            nx=_as_int(nm["nx"], "numerical_model.nx"),
            ny=_as_int(nm["ny"], "numerical_model.ny"),
            dx=_as_float(nm["dx"], "numerical_model.dx"),
            dy=_as_float(nm["dy"], "numerical_model.dy"),
            x_min=_as_float(nm["x_min"], "numerical_model.x_min"),
            x_max=_as_float(nm.get("x_max", 0.0), "numerical_model.x_max"),
            y_min=_as_float(nm["y_min"], "numerical_model.y_min"),
            y_max=_as_float(nm.get("y_max", 0.0), "numerical_model.y_max"),
            interval_x=_as_int(nm.get("interval_x", 1), "numerical_model.interval_x"),
            interval_y=_as_int(nm.get("interval_y", 1), "numerical_model.interval_y"),
            dt=_as_float(nm.get("dt", 1.0), "numerical_model.dt"),
            number_of_files=(
                _as_int(nm["number_of_files"], "numerical_model.number_of_files")
                if "number_of_files" in nm
                else None
            ),
        )

    return Config(
        raw=raw,
        kind=kind,
        layers=layers,
        adam=adam,
        lbfgs=lbfgs,
        loss_weights=weights,
        weight_fidelity=weight_fid,
        weight_residual=weight_res,
        data_fidelity=data_fidelity,
        data_residual=data_residual,
        data=data,
        data_test=data_test,
        numerical_model=numerical_model,
        physics=physics,
        parity=bool(raw.get("parity", True)),
        parallel=parallel,
        snapshot_iteration=_as_int(snap, "snapshot_iteration") if snap is not None else None,
        perform_optimization=bool(raw.get("perform_optimization", False)),
        seed=_as_int(raw.get("seed", 1234), "seed"),
        residual_chunk_size=(
            _as_int(raw["residual_chunk_size"], "residual_chunk_size")
            if "residual_chunk_size" in raw
            else None
        ),
        fused_kernel=_as_fused(raw.get("fused_kernel", "auto")),
        kernel_precision=_as_kernel_precision(raw.get("kernel_precision", "auto")),
        f64_polish=_parse_f64_polish(raw.get("f64_polish")),
        precision_schedule=_parse_precision_schedule(
            raw.get("precision_schedule")
        ),
    )


def load_config(path: str) -> Config:
    with open(path, "r") as f:
        try:
            raw = json.load(f)
        except json.JSONDecodeError as e:
            raise ConfigError(f"{path}: invalid JSON: {e}") from e
    try:
        return parse_config(raw)
    except ConfigError as e:
        raise ConfigError(f"{path}: {e}") from e
