"""Adam whose update, on the card, is one hand-written kernel.

:class:`FusedAdam` is ``torch.optim.Adam`` (same options, ``state``,
``param_groups``, ``state_dict`` and schedulers) with another ``step``. Where
:func:`fused_applicable` holds, the leaves are updated by launches of
``csrc/adam_step.cu`` (:func:`fused_adam_update`) in place of the seven
``multi_tensor_apply`` kernels of torch's foreach path and their Python: one
launch a group, device and :data:`MAX_LEAVES` leaves, so one a step for every
Trainer. The kernel keeps the foreach path's arithmetic, operation for
operation, so parameters and moments keep every bit (the card tests in
``tests/test_torch_cuda.py``). Where a leaf is on the CPU or not float32, or
an option makes Adam another function (``amsgrad``, ``weight_decay``,
``maximize``) or asks for another of torch's implementations
(``differentiable``, ``capturable``, ``fused``), ``step`` calls
``torch.optim.Adam.step`` itself, looked up at call time.

On the card the kernel takes what torch's foreach step takes: any number of
leaves on any devices, leaves without a gradient left alone (their ``step``
count too), a non-contiguous gradient through a contiguous copy, ``foreach``
set or not. It raises, where torch's non-capturable step would run, on a
tensor ``lr`` or betas, a non-contiguous leaf, a ``step`` count that is not
a float32 on the CPU (Adam's own under torch's default dtype), a leaf of 2**31
elements or more, and inside a CUDA graph capture: the kernel's scalars are
worked out on the host each step.

The host's share of a step is kept small: the leaves' and moments' pointers
sit in ctypes blocks built once (:class:`AdamLeaves`, the kernel's
``__grid_constant__`` argument), so a step reads the gradients' pointers and
calls one C entry a launch, which works out the scalars in double as
``torch.optim.Adam`` does and raises each leaf's ``step`` count once the
launch succeeded. The blocks are built anew when ``state`` or
``param_groups`` are replaced (``load_state_dict``), a leaf's storage moves
or the leaves with a gradient change; they hold the state's tensors, so a
moment replaced in place of another by hand is not seen.

:func:`adam_update_plain` is the kernel's per-element arithmetic in torch
operations, in the kernel's order, and :func:`adam_scalars` its scalars:
the CPU tests hold them to ``torch.optim.Adam`` bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from pinn_depthestimation_tpu_torch.tracing import count_launch, reset_launches

MAX_LEAVES = 16  # csrc/adam_step.cu kMaxLeaves
# the kernel indexes a launch's 4-element quads and a leaf's elements with int
_MAX_QUADS, _MAX_NUMEL = 2**31 - 128, 2**31 - 4
_STRIDED = torch.strided


# ------------------------------------------------------------ plain version

def adam_scalars(lr: float, beta1: float, beta2: float, step: float) -> tuple[float, float]:
    """``(step_size, bc2_sqrt)`` of step ``step``, in double as
    ``torch.optim.Adam``'s non-capturable step works them out:
    ``-lr / (1 - beta1^t)`` and ``(1 - beta2^t)^0.5``."""
    bias_correction1 = 1 - beta1**step
    bias_correction2 = 1 - beta2**step
    return (lr / bias_correction1) * -1, bias_correction2**0.5


def adam_update_plain(p, g, m, v, step_size: float, bc2_sqrt: float, beta1: float,
                      beta2: float, eps: float) -> None:
    """One Adam update of ``p``, ``m`` (``exp_avg``) and ``v``
    (``exp_avg_sq``) in place, from the gradient ``g``: the kernel's
    arithmetic in its order, each step one torch operation."""
    m.lerp_(g, 1 - beta1)
    v.mul_(beta2)
    v.addcmul_(g, g, value=1 - beta2)
    d = v.sqrt()
    d.div_(bc2_sqrt)
    d.add_(eps)
    p.addcdiv_(m, d, value=step_size)


# ----------------------------------------------------------------- decision

def _another_function(group) -> bool:
    """The group asks for something other than the kernel's update: an
    option that changes Adam's function, or another of torch's
    implementations."""
    return bool(group["amsgrad"] or group["maximize"] or group["weight_decay"] != 0
                or group["differentiable"] or group["capturable"] or group["fused"])


def fused_applicable(param_groups) -> bool:
    """Whether the kernel takes the next step of an optimizer that holds
    ``param_groups`` (``torch.optim.Adam``'s): some leaf has a gradient,
    every leaf with one is a float32 CUDA tensor with a dense gradient, and
    no group asks for another function or implementation."""
    found = False
    for group in param_groups:
        if _another_function(group):
            return False
        for p in group["params"]:
            if p.grad is None:
                continue
            if p.device.type != "cuda" or p.dtype != torch.float32 or p.grad.layout != _STRIDED:
                return False
            found = True
    return found


def _check_scalars(group) -> None:
    beta1, beta2 = group["betas"]
    if (isinstance(group["lr"], torch.Tensor) or isinstance(beta1, torch.Tensor)
            or isinstance(beta2, torch.Tensor)):
        raise ValueError("FusedAdam on the card takes lr and betas as numbers, not tensors")


def _check_state(p, st) -> None:
    """A leaf's state as Adam's non-capturable step keeps it: ``step`` a
    float32 number on the CPU, the moments contiguous like the leaf."""
    step = st["step"]
    if not (step.device.type == "cpu" and step.dtype == torch.float32 and step.numel() == 1):
        raise ValueError(f"FusedAdam on the card takes a float32 step count on the CPU, not "
                         f"{step.dtype} on {step.device}")
    for key in ("exp_avg", "exp_avg_sq"):
        t = st[key]
        if t.device != p.device or t.dtype != torch.float32 or t.shape != p.shape \
                or not t.is_contiguous():
            raise ValueError(f"FusedAdam's {key} is not a contiguous float32 tensor like its leaf")


# ------------------------------------------------------------- CUDA launch

class AdamLeaves(ctypes.Structure):
    """The kernel's argument block (``csrc/adam_step.cu`` ``Leaves``)."""

    _fields_ = [("p", ctypes.c_void_p * MAX_LEAVES), ("g", ctypes.c_void_p * MAX_LEAVES),
                ("m", ctypes.c_void_p * MAX_LEAVES), ("v", ctypes.c_void_p * MAX_LEAVES),
                ("numel", ctypes.c_int * MAX_LEAVES),
                ("quad_start", ctypes.c_int * (MAX_LEAVES + 1)),
                ("vec", ctypes.c_int * MAX_LEAVES),
                ("step_size", ctypes.c_float * MAX_LEAVES),
                ("bc2_sqrt", ctypes.c_float * MAX_LEAVES),
                ("w1", ctypes.c_float), ("beta2", ctypes.c_float), ("w2", ctypes.c_float),
                ("eps", ctypes.c_float), ("n", ctypes.c_int)]


def _quads(p) -> int:
    return (p.numel() + 3) // 4


class _Launch:
    """One launch: the argument block of up to :data:`MAX_LEAVES` leaves of
    one group on one device, built once from the leaves and their state
    (made here where Adam has not made it yet, as ``Adam._init_group``
    makes it)."""

    def __init__(self, group, params, state):
        from pinn_depthestimation_tpu_torch.ops.cuda_build import adam_library

        lib = adam_library()
        if lib.adam_leaves_bytes() != ctypes.sizeof(AdamLeaves) or lib.adam_max_leaves() != MAX_LEAVES:
            raise RuntimeError("csrc/adam_step.cu and optim/adam.py disagree on the argument block")
        self.entry, self.error_string = lib.adam_step, lib.adam_error_string
        self.group, self.params = group, params
        self.device_index = params[0].device.index
        self.leaves = AdamLeaves()
        self.leaves.n = n = len(params)
        self.tensors, steps, quads = [], [], 0  # what the block points at, kept alive
        for i, p in enumerate(params):
            if not p.is_contiguous():
                raise ValueError("FusedAdam on the card takes contiguous leaves")
            st = state[p]
            if not st:
                st["step"] = torch.tensor(0.0, dtype=torch.float64 if torch.get_default_dtype()
                                          == torch.float64 else torch.float32)
                st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            _check_state(p, st)
            self.tensors += [p, st["exp_avg"], st["exp_avg_sq"], st["step"]]
            steps.append(st["step"].data_ptr())
            self.leaves.p[i] = p.data_ptr()
            self.leaves.m[i] = st["exp_avg"].data_ptr()
            self.leaves.v[i] = st["exp_avg_sq"].data_ptr()
            self.leaves.numel[i] = p.numel()
            self.leaves.quad_start[i] = quads
            quads += _quads(p)
        self.leaves.quad_start[n] = quads
        self.data = [p.data_ptr() for p in params]
        self.grads = (ctypes.c_void_p * n)()
        self.steps = (ctypes.c_void_p * n)(*steps)
        self.addresses = tuple(ctypes.addressof(x) for x in (self.leaves, self.grads, self.steps))
        self.copies = []

    def ready(self) -> bool:
        """The gradients' pointers noted (a strided gradient through a
        contiguous copy); False where a leaf lost its gradient or its
        storage moved."""
        copies = self.copies = []
        for i, p in enumerate(self.params):
            g = p.grad
            if g is None or g.layout != _STRIDED or p.data_ptr() != self.data[i]:
                return False
            if not g.is_contiguous():
                g = g.contiguous()
                copies.append(g)
            self.grads[i] = g.data_ptr()
        return True


def _launches(group, state) -> list[_Launch]:
    """The group's leaves with a gradient, by device, in launches of up to
    :data:`MAX_LEAVES` leaves and ``_MAX_QUADS`` quads."""
    _check_scalars(group)
    by_device: dict = {}
    for p in group["params"]:
        if p.grad is not None:
            by_device.setdefault(p.device, []).append(p)
    out = []
    for params in by_device.values():
        chunk, quads = [], 0
        for p in params:
            if p.numel() > _MAX_NUMEL:
                raise ValueError(f"FusedAdam's kernel takes leaves of under 2**31 elements, "
                                 f"not {p.numel()}")
            if len(chunk) == MAX_LEAVES or quads + _quads(p) > _MAX_QUADS:
                out.append(_Launch(group, chunk, state))
                chunk, quads = [], 0
            chunk.append(p)
            quads += _quads(p)
        out.append(_Launch(group, chunk, state))
    return out


class _Plan:
    """A step's launches, kept while the groups, the state, the leaves'
    storage and which leaves have a gradient stay as they were."""

    def __init__(self, param_groups, state):
        self.groups, self.state = list(param_groups), state
        self.sizes = [len(g["params"]) for g in param_groups]
        self.without = [p for g in param_groups for p in g["params"] if p.grad is None]
        self.launches = [launch for g in param_groups for launch in _launches(g, state)]

    def ready(self, param_groups, state) -> bool:
        if state is not self.state or len(param_groups) != len(self.groups):
            return False
        for group, mine, size in zip(param_groups, self.groups, self.sizes):
            if group is not mine or len(group["params"]) != size or _another_function(group):
                return False
            _check_scalars(group)
        for p in self.without:
            if p.grad is not None:
                return False
        for launch in self.launches:
            if not launch.ready():
                return False
        return True


def fused_adam_update(launch: _Launch) -> None:
    """One launch of Adam's update over ``launch``'s leaves on the current
    stream, with the gradients :meth:`_Launch.ready` noted. Every launch
    counts one in ``fused_adam_update.launches``."""
    group = launch.group
    beta1, beta2 = group["betas"]
    index = launch.device_index
    err = launch.entry(*launch.addresses, group["lr"], beta1, beta2, group["eps"], index,
                       torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"Adam's update failed to launch: CUDA error {err} "
                           f"({launch.error_string(err).decode()})")
    count_launch(fused_adam_update, "f32")


reset_launches(fused_adam_update)


# ----------------------------------------------------------------- optimizer

def _torch_adam_step(optimizer, closure=None):
    """``torch.optim.Adam.step``, looked up now (so a patch of it holds).
    Where torch has wrapped it with its step hooks (it does once a plain
    Adam exists), the wrapped function: ``FusedAdam.step``'s own wrapper
    has run the hooks."""
    step = torch.optim.Adam.step
    if getattr(step, "hooked", False):
        step = step.__wrapped__
    return step(optimizer, closure)


class FusedAdam(torch.optim.Adam):
    """``torch.optim.Adam`` whose step is one kernel launch a group on the
    card (module docstring)."""

    _plan: _Plan | None = None

    def step(self, closure=None):
        """One Adam step: the kernel where :func:`fused_applicable` holds,
        else ``torch.optim.Adam.step``."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        plan = self._plan
        if plan is None or not plan.ready(self.param_groups, self.state):
            self._plan = None
            if not fused_applicable(self.param_groups):
                _torch_adam_step(self)
                return loss
            plan = _Plan(self.param_groups, self.state)
            if not plan.ready(self.param_groups, self.state):
                raise RuntimeError("FusedAdam's launches do not hold their own leaves")
            self._plan = plan
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("FusedAdam's step works out its scalars on the host each step, "
                               "so a CUDA graph cannot capture it")
        for launch in plan.launches:
            fused_adam_update(launch)
        return loss
