"""Adam's update as one kernel (``optim.adam``), held on the CPU.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``
holds it to ``torch.optim.Adam``'s foreach path bit for bit). Here:

* its per-element arithmetic, written as torch operations in the kernel's
  order (``adam_update_plain``, ``adam_scalars``), equals
  ``torch.optim.Adam``'s update bit for bit, single-tensor and foreach,
  over 50 steps across a ``StepLR`` boundary;
* the decision (``fused_applicable``) as a function of what the optimizer
  holds, and the card path's host side (its launches, what it raises on)
  with the library replaced by a fake;
* on the CPU ``FusedAdam.step`` is ``torch.optim.Adam.step``, looked up at
  call time, and its state, ``state_dict`` and a Trainer's checkpoints are
  Adam's.
"""

import copy
import os

import numpy as np
import pytest
import torch

from pinn_depthestimation_tpu_torch.config import parse_config
from pinn_depthestimation_tpu_torch.optim import adam
from pinn_depthestimation_tpu_torch.training import checkpoint as ckpt
from pinn_depthestimation_tpu_torch.training import driver
from pinn_depthestimation_tpu_torch.training.driver import Trainer
from pinn_depthestimation_tpu_torch.utils import synthetic

FLAGSHIP = {"w_in": (2, 20), "b_in": (20,), "w_hidden": (99, 20, 20), "b_hidden": (99, 20),
            "w_out": (20, 3), "b_out": (3,)}
CMB = {"w_in": (2, 10), "b_in": (10,), "w_hidden": (9, 10, 10), "b_hidden": (9, 10),
       "w_out": (10, 6), "b_out": (6,)}


def leaves(shapes, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen).mul_(0.3).requires_grad_() for s in shapes.values()]


@pytest.mark.parametrize("foreach", [False, True])
@pytest.mark.parametrize("shapes", [FLAGSHIP, CMB], ids=["flagship", "cmb"])
def test_plain_update_is_torch_adams_bit_for_bit(shapes, foreach):
    """Both routes from the same leaves and gradients, lr 1e-3 under StepLR
    (20 steps, gamma 0.8): every parameter and moment equal after every one
    of 50 steps. The gradients' scale swings over four decades so the
    moments and the bias corrections are exercised."""
    params = leaves(shapes, seed=1)
    plain = [p.detach().clone() for p in params]
    m = [torch.zeros_like(p) for p in plain]
    v = [torch.zeros_like(p) for p in plain]
    opt = torch.optim.Adam(params, lr=1e-3, foreach=foreach)
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=20, gamma=0.8)
    gen = torch.Generator().manual_seed(2)
    beta1, beta2 = opt.param_groups[0]["betas"]
    eps = opt.param_groups[0]["eps"]
    step = torch.tensor(0.0)
    for t in range(50):
        grads = [torch.randn(p.shape, generator=gen) * 10.0 ** (t % 5 - 3) for p in params]
        lr = opt.param_groups[0]["lr"]
        for p, g in zip(params, grads):
            p.grad = g.clone()
        opt.step()
        sched.step()
        step += 1
        step_size, bc2_sqrt = adam.adam_scalars(lr, beta1, beta2, step.item())
        for i, g in enumerate(grads):
            adam.adam_update_plain(plain[i], g, m[i], v[i], step_size, bc2_sqrt, beta1, beta2, eps)
        for i, p in enumerate(params):
            st = opt.state[p]
            assert torch.equal(p.detach(), plain[i]), (t, i)
            assert torch.equal(st["exp_avg"], m[i]) and torch.equal(st["exp_avg_sq"], v[i]), (t, i)
    assert opt.param_groups[0]["lr"] == pytest.approx(1e-3 * 0.8**2)


# ----------------------------------------------------------------- decision

class Grad:
    def __init__(self, layout=torch.strided, contiguous=True):
        self.layout, self._contiguous = layout, contiguous

    def is_contiguous(self):
        return self._contiguous


class Leaf:
    """What the decision reads of a leaf: its device, type, layout, size and
    gradient (a CUDA tensor cannot be made on the CPU)."""

    def __init__(self, device="cuda:0", dtype=torch.float32, grad=None, shape=(4, 5)):
        self.device, self.dtype, self.shape = torch.device(device), dtype, torch.Size(shape)
        self.grad = Grad() if grad is None else grad

    def is_contiguous(self):
        return True

    def numel(self):
        return self.shape.numel()


def group(params, **options):
    """A param group with torch.optim.Adam's own keys and defaults."""
    g = dict(torch.optim.Adam([torch.zeros(1)], **{"lr": 1e-4, **options}).param_groups[0])
    g["params"] = params
    return g


def test_fused_on_a_cuda_float32_group_with_defaults():
    ps = [Leaf(shape=s) for s in FLAGSHIP.values()]
    assert adam.fused_applicable([group(ps)])
    assert adam.fused_applicable([group(ps, lr=3e-2, betas=(0.8, 0.95), eps=1e-6)])
    assert adam.fused_applicable([group(ps[:3]), group(ps[3:])])


@pytest.mark.parametrize("case", [
    "no_grad", "strided_grad", "foreach_refused", "two_devices", "too_many_leaves",
    "beta2_zero", "tensor_lr",
])
def test_fused_where_torch_computes_the_same_function(case):
    """What the kernel's launches take (or, for a tensor lr, raise on) on
    the card: torch's step would compute the same function, so there is no
    fall-back to it."""
    ps = [Leaf(shape=s) for s in FLAGSHIP.values()]
    options = {}
    if case == "no_grad":
        ps[4].grad = None
    elif case == "strided_grad":
        ps[3] = Leaf(grad=Grad(contiguous=False))
    elif case == "foreach_refused":
        options["foreach"] = False
    elif case == "two_devices":
        ps[5] = Leaf(device="cuda:1")
    elif case == "too_many_leaves":
        ps = [Leaf() for _ in range(adam.MAX_LEAVES + 1)]
    elif case == "beta2_zero":
        options["betas"] = (0.9, 0.0)
    elif case == "tensor_lr":
        options["lr"] = torch.tensor(1e-4)
    assert adam.fused_applicable([group(ps, **options)])


@pytest.mark.parametrize("case", [
    "cpu_leaf", "f64_leaf", "amsgrad", "weight_decay", "maximize", "sparse_grad",
    "capturable", "differentiable", "torch_fused", "no_grad_at_all", "no_groups",
])
def test_torch_step_where_the_kernel_does_not_apply(case):
    """A CPU or non-float32 leaf, an option that changes Adam's function or
    picks another of torch's implementations, a sparse gradient (torch's
    step raises on it), or nothing to update."""
    ps = [Leaf(shape=s) for s in FLAGSHIP.values()]
    options = {}
    if case == "cpu_leaf":
        ps = [torch.zeros(s, requires_grad=True) for s in FLAGSHIP.values()]
        for p in ps:
            p.grad = torch.ones_like(p)
    elif case == "f64_leaf":
        ps[0] = Leaf(dtype=torch.float64)
    elif case in ("amsgrad", "maximize", "capturable", "differentiable"):
        options[case] = True
    elif case == "torch_fused":
        options["fused"] = True
    elif case == "weight_decay":
        options["weight_decay"] = 1e-2
    elif case == "sparse_grad":
        ps[1] = Leaf(grad=Grad(layout=torch.sparse_coo))
    elif case == "no_grad_at_all":
        for p in ps:
            p.grad = None
    groups = [] if case == "no_groups" else [group(ps, **options)]
    assert not adam.fused_applicable(groups)


# ------------------------------------------- the launches, with a fake library

class FakeLibrary:
    """``cuda_build.adam_library()``'s entries, recording each launch's
    leaves, quad offsets, gradient pointers and lr in place of launching."""

    def __init__(self):
        self.calls, self.err = [], 0

    def adam_leaves_bytes(self):
        return adam.ctypes.sizeof(adam.AdamLeaves)

    def adam_max_leaves(self):
        return adam.MAX_LEAVES

    def adam_step(self, leaves, grads, steps, lr, beta1, beta2, eps, device, stream):
        block = adam.AdamLeaves.from_address(leaves)
        ptrs = (adam.ctypes.c_void_p * block.n).from_address(grads)
        self.calls.append((block.n, list(block.quad_start[:block.n + 1]), list(ptrs), lr))
        return self.err

    def adam_error_string(self, err):
        return b"fake error"


@pytest.fixture
def fake_card(monkeypatch):
    """The card path on CPU tensors: the decision, the stream and the
    library replaced, so the launches' host side runs here."""
    from pinn_depthestimation_tpu_torch.ops import cuda_build

    lib = FakeLibrary()
    monkeypatch.setattr(cuda_build, "adam_library", lambda: lib)
    monkeypatch.setattr(adam, "fused_applicable", lambda groups: True)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 0, raising=False)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    adam.reset_launches(adam.fused_adam_update)
    return lib


def test_launches_split_leaves_and_skip_those_without_a_gradient(fake_card):
    """20 leaves go in launches of 16 and 3, the one without a gradient
    left out and its state not made. A launch gets this step's gradients'
    pointers, a transposed gradient's through a contiguous copy. The
    launches are made once and kept until a leaf gains a gradient."""
    ps = [torch.zeros(i + 1, 3, requires_grad=True) for i in range(20)]
    for i, p in enumerate(ps):
        p.grad = torch.ones(3, i + 1).t() if i == 7 else torch.ones_like(p)
    ps[18].grad = None
    opt = adam.FusedAdam(ps, lr=1e-3)
    opt.step()
    assert [c[0] for c in fake_card.calls] == [16, 3]
    # quads of 4 elements: leaves of 3, 6, ... elements; the second launch
    # holds leaves 16, 17 and 19 (51, 54 and 60 elements: 13 + 14 + 15)
    assert fake_card.calls[0][1][:4] == [0, 1, 3, 6] and fake_card.calls[1][1] == [0, 13, 27, 42]
    want = [p.grad.data_ptr() for i, p in enumerate(ps) if i != 18]
    got = fake_card.calls[0][2] + fake_card.calls[1][2]
    assert [i for i, (g, w) in enumerate(zip(got, want)) if g != w] == [7]
    assert ps[18] not in opt.state and len(opt.state) == 19
    plan = opt._plan
    opt.step()
    assert opt._plan is plan and adam.fused_adam_update.launches == 4
    ps[18].grad = torch.ones_like(ps[18])
    opt.step()
    assert opt._plan is not plan and [c[0] for c in fake_card.calls[4:]] == [16, 4]


def test_launches_follow_load_state_dict_and_moved_storage(fake_card):
    ps = [torch.zeros(5, requires_grad=True), torch.zeros(2, 2, requires_grad=True)]
    for p in ps:
        p.grad = torch.ones_like(p)
    opt = adam.FusedAdam(ps, lr=1e-3)
    opt.step()
    plan = opt._plan
    opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    opt.step()
    assert opt._plan is not plan
    plan = opt._plan
    ps[0].data = torch.zeros(5)
    opt.step()
    assert opt._plan is not plan and fake_card.calls[-1][0] == 2
    assert fake_card.calls[-1][3] == 1e-3


@pytest.mark.parametrize("case", ["tensor_lr", "tensor_beta", "strided_leaf", "f64_step",
                                  "capture", "launch_error"])
def test_the_card_path_raises_where_the_kernel_cannot_take_it(fake_card, monkeypatch, case):
    """No silent fall-back on the card: a tensor lr or beta, a
    non-contiguous leaf, a step count kept as float64, a CUDA graph
    capture and a failed launch raise."""
    p = torch.zeros(4, 6, requires_grad=True)
    leaf = p.detach().t().requires_grad_() if case == "strided_leaf" else p
    leaf.grad = torch.ones_like(leaf)
    options = {"lr": torch.tensor(1e-3)} if case == "tensor_lr" else {"lr": 1e-3}
    if case == "tensor_beta":
        options["betas"] = (torch.tensor(0.9), torch.tensor(0.999))
    opt = adam.FusedAdam([leaf], **options)
    if case == "f64_step":
        opt.state[leaf] = {"step": torch.tensor(2.0, dtype=torch.float64),
                           "exp_avg": torch.zeros_like(leaf), "exp_avg_sq": torch.zeros_like(leaf)}
    if case == "capture":
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    if case == "launch_error":
        fake_card.err = 700
    with pytest.raises(RuntimeError if case in ("capture", "launch_error") else ValueError):
        opt.step()
    assert adam.fused_adam_update.launches == 0


def test_the_fused_block_matches_the_kernels_layout():
    """The ctypes argument block: pointers first, 8-byte aligned, in the
    order and size of csrc/adam_step.cu's Leaves (the library reports its
    size, which the launch compares)."""
    block = adam.AdamLeaves
    n = adam.MAX_LEAVES
    assert block.p.offset == 0 and block.v.offset == 3 * 8 * n
    assert block.quad_start.offset == 4 * 8 * n + 4 * n
    assert block.n.offset == 4 * 8 * n + 4 * (n + n + 1 + n + n + n) + 4 * 4
    assert adam.ctypes.sizeof(block) == 856


# ------------------------------------------------------------- on the CPU

def test_cpu_step_is_torch_adams_looked_up_at_call_time(monkeypatch):
    params = leaves(CMB, seed=3)
    twin = [p.detach().clone().requires_grad_() for p in params]
    fused, ref = adam.FusedAdam(params, lr=1e-3), torch.optim.Adam(twin, lr=1e-3)
    for t in range(3):
        for p, q in zip(params, twin):
            p.grad = torch.full_like(p, 0.1 * (t + 1))
            q.grad = p.grad.clone()
        fused.step()
        ref.step()
    assert all(torch.equal(p, q) for p, q in zip(params, twin))
    before = [p.detach().clone() for p in params]
    moments = [fused.state[p]["exp_avg"].clone() for p in params]
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    fused.step()
    assert all(torch.equal(p, b) for p, b in zip(params, before))
    assert all(torch.equal(fused.state[p]["exp_avg"], m) for p, m in zip(params, moments))
    assert float(fused.state[params[0]]["step"]) == 3.0
    assert adam.fused_adam_update.launches == 0


def test_closure_is_evaluated_once():
    p = torch.ones(3, requires_grad=True)
    opt = adam.FusedAdam([p], lr=1e-2)
    calls = []

    def closure():
        calls.append(1)
        opt.zero_grad()
        loss = (p * p).sum()
        loss.backward()
        return loss

    assert float(opt.step(closure).detach()) == 3.0
    assert len(calls) == 1 and float(opt.state[p]["step"]) == 1.0


def test_hooks_run_once_a_step():
    """Step hooks run once a step, though torch hooks Adam.step itself once
    a plain Adam exists and the CPU step goes through it."""
    torch.optim.Adam([torch.zeros(1)])
    assert getattr(torch.optim.Adam.step, "hooked", False)
    p = torch.ones(3)
    p.grad = torch.ones(3)
    opt = adam.FusedAdam([p], lr=1e-2)
    calls = []
    opt.register_step_pre_hook(lambda o, args, kwargs: calls.append("pre"))
    opt.register_step_post_hook(lambda o, args, kwargs: calls.append("post"))
    opt.step()
    opt.step()
    assert calls == ["pre", "post"] * 2 and float(opt.state[p]["step"]) == 2.0


def test_state_dict_round_trip_is_adams():
    params = leaves(FLAGSHIP, seed=4)
    twin = [p.detach().clone().requires_grad_() for p in params]
    fused, ref = adam.FusedAdam(params, lr=1e-3), torch.optim.Adam(twin, lr=1e-3)
    for t in range(4):
        for p, q in zip(params, twin):
            p.grad = torch.randn(p.shape, generator=torch.Generator().manual_seed(t))
            q.grad = p.grad.clone()
        fused.step()
        ref.step()
    sd, want = fused.state_dict(), ref.state_dict()
    assert sd["param_groups"] == want["param_groups"]
    assert sd["state"].keys() == want["state"].keys()
    for i, st in sd["state"].items():
        assert st.keys() == want["state"][i].keys() == {"step", "exp_avg", "exp_avg_sq"}
        for k, x in st.items():
            assert x.dtype == want["state"][i][k].dtype and torch.equal(x, want["state"][i][k])
    again = adam.FusedAdam([p.detach().clone().requires_grad_() for p in params], lr=5.0)
    again.load_state_dict(copy.deepcopy(sd))  # torch's load shares the tensors it is given
    assert again.param_groups[0]["lr"] == 1e-3
    for p, q in zip(again.param_groups[0]["params"], params):
        p.grad = torch.ones_like(p)
        q.grad = torch.ones_like(q)
    again.step()
    fused.step()
    for p, q in zip(again.param_groups[0]["params"], params):
        assert torch.equal(p, q) and torch.equal(again.state[p]["exp_avg_sq"],
                                                 fused.state[q]["exp_avg_sq"])


def newmethod_raw(mat, adam_it):
    return {
        "layers": {"input_features": 2, "hidden_layers": 3, "hidden_width": 16,
                   "output_features": 3, "dropout_rate": 0.0, "init_type": "xavier"},
        "adam_optimizer": {"max_it": adam_it, "learning_rate": 1e-3,
                           "scheduler_step_size": 7, "scheduler_gamma": 0.8},
        "lbfgs_optimizer": {"max_it": 0},
        "loss": {"weight_fid_loss": 1, "weight_res_loss": 1},
        "data": {"file": mat, "inputs": {"x": {"requires_grad": ["true"]},
                                         "y": {"requires_grad": ["true"]}},
                 "trues": ["U", "V"], "unknowns": ["h"]},
        "fused_kernel": "on",
    }


def torch_adam(config, params):
    optimizer = torch.optim.Adam(params, lr=config.adam.learning_rate)
    return optimizer, torch.optim.lr_scheduler.StepLR(
        optimizer, step_size=config.adam.scheduler_step_size, gamma=config.adam.scheduler_gamma)


def test_trainer_checkpoints_are_adams(tmp_path, monkeypatch):
    """A Trainer's FusedAdam on the CPU, saved at step 10 and restored into
    a new Trainer that runs to step 20, writes the checkpoints (``opt/...``
    keys and values) and the parameters of a Trainer on torch.optim.Adam."""
    mat = str(tmp_path / "d.mat")
    synthetic.make_newmethod_mat(mat, nx=12, ny=14, nan_fraction=0.05, seed=3)

    def run(name, fused):
        if not fused:
            monkeypatch.setattr(driver, "make_adam_optimizer", torch_adam)
        out = str(tmp_path / name)
        os.makedirs(out)
        first = Trainer(parse_config(newmethod_raw(mat, 10)), run_dir=out, echo_every=0,
                        device="cpu")
        assert isinstance(first.optimizer, adam.FusedAdam) == fused
        first.train_adam()
        path = first.save("model_10")
        second = Trainer(parse_config(newmethod_raw(mat, 20)), run_dir=out, echo_every=0,
                         device="cpu")
        second.restore(path)
        second.train_adam()
        monkeypatch.undo()
        return ckpt.load_raw(path), ckpt.load_raw(second.save("model_20"))

    got, want = run("fused", True), run("torch", False)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) and sorted(g["opt"]) == sorted(w["opt"])
        for k in ("w_in", "b_in", "w_hidden", "b_hidden", "w_out", "b_out", "iteration"):
            np.testing.assert_array_equal(g[k], w[k])
        for k in ("step", "lr", "last_epoch"):
            np.testing.assert_array_equal(g["opt"][k], w["opt"][k])
        for k in ("exp_avg", "exp_avg_sq"):
            for leaf in g["opt"][k]:
                np.testing.assert_array_equal(g["opt"][k][leaf], w["opt"][k][leaf])
    assert float(got[1]["opt"]["step"]) == 20.0
