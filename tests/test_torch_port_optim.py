"""The optimizer's contract on the CPU (``train/optim.py``): what the train
step and the benchmark read from ``AdamW`` (``names``, one first moment a
parameter in ``moment_dtype``, ``b1``, ``count``, the logged norms), the
step's ``grad_norm`` and ``param_norm`` logs with ``update`` wrapped as the
port's train-step tests wrap it, the CPU staying on the plain version, and
the fused kernels' layout of the tensors (``ops/kernels/adamw.plan``),
which the card's launch count follows."""

import numpy as np
import pytest
import torch
from torch import nn

from mde_tpu_torch.ops import kernels
from mde_tpu_torch.ops.kernels.adamw import MAX_TENSORS, launches, plan
from mde_tpu_torch.ops.tnn import BatchNorm
from mde_tpu_torch.train.optim import build_optimizer, global_norm
from mde_tpu_torch.train.state import TrainState
from mde_tpu_torch.train.step import make_train_step
from _torch_port_threads import one_torch_thread  # noqa: F401


class _TinyDepth(nn.Module):
    """A depth model small enough for a CPU step: NHWC in, (B, H, W, 1) out."""

    def __init__(self):
        super().__init__()
        self.encoder = nn.Linear(3, 8)
        self.bn = BatchNorm(8)
        self.head = nn.Linear(8, 1)

    def forward(self, x, generator=None):
        return nn.functional.softplus(self.head(torch.relu(self.bn(self.encoder(x))))) + 0.5


def _opt(**optimizer):
    return {"model": {"name": "tiny"}, "loss": {"alpha": 10.0, "beta": 0.15, "per_image": True},
            "optimizer": dict({"lr": 1e-3, "weight_decay": 0.1, "eps": 1e-6}, **optimizer),
            "scheduler": {"name": "onecycle", "cycle_momentum": True},
            "train": {"grad_norm": 0.1}}


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(2, 6, 10, 3).astype(np.float32),
            "depth": rng.uniform(0.5, 60.0, (2, 6, 10, 1)).astype(np.float32)}


def _f64_norm(tensors) -> float:
    return float(torch.sqrt(sum((t.detach().double() ** 2).sum() for t in tensors)))


@pytest.mark.parametrize("zero_grad_bn", [False, True])
@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
def test_adamw_keeps_its_contract_on_the_cpu(moment_dtype, zero_grad_bn):
    torch.manual_seed(0)
    model = _TinyDepth()
    opt = build_optimizer(_opt(moment_dtype=moment_dtype), 10, model, zero_grad_bn)
    params = dict(model.named_parameters())
    bn = {"bn.weight", "bn.bias"}
    assert opt.names == [n for n in params if not (zero_grad_bn and n in bn)]
    assert opt._fused is None
    want = torch.bfloat16 if moment_dtype else torch.float32
    assert [tuple(m.shape) for m in opt.mu] == [tuple(params[n].shape) for n in opt.names]
    assert all(m.dtype == want for m in opt.mu) and all(v.dtype == torch.float32 for v in opt.nu)
    assert opt.b1 == 0.9 and opt.count == 0 and opt.grad_norm is None
    before = {n: p.detach().clone() for n, p in params.items()}
    launched = kernels.launch_counts["adamw"]
    for step in range(2):
        grads = {n: torch.randn_like(p) for n, p in params.items()}
        opt.update(grads)
        assert opt.count == step + 1
        for norm, tensors in ((opt.grad_norm, grads.values()), (opt.param_norm, params.values())):
            assert norm.dtype == torch.float32 and norm.dim() == 0
            assert abs(float(norm) - _f64_norm(tensors)) <= 1e-6 * _f64_norm(tensors)
    assert kernels.launch_counts["adamw"] == launched
    moved = {n for n, p in params.items() if not torch.equal(p.detach(), before[n])}
    assert moved == (set(params) - bn if zero_grad_bn else set(params))


@pytest.mark.parametrize("zero_grad_bn", [False, True])
def test_step_logs_the_norms_the_optimizer_leaves(zero_grad_bn):
    """``update`` wrapped by a function that returns nothing, as the port's
    train-step tests wrap it: the logs still hold every gradient's norm
    before the clip and every parameter's after the update."""
    torch.manual_seed(1)
    model = _TinyDepth()
    opt = _opt()
    state = TrainState.create(model, opt, 10, zero_grad_bn=zero_grad_bn)
    seen = {}
    real = state.optimizer.update

    def update(grads):
        seen.update({n: g.clone() for n, g in grads.items()})
        real(grads)

    state.optimizer.update = update
    step = make_train_step(opt, 0.001, 80.0)
    for i in range(2):
        state, logs = step(state, _batch(i), torch.Generator().manual_seed(i))
        assert set(seen) == {n for n, _ in model.named_parameters()}
        assert torch.equal(logs["grad_norm"], global_norm(list(seen.values())))
        assert torch.equal(logs["param_norm"], global_norm(list(model.parameters())))
        assert abs(float(logs["grad_norm"]) - _f64_norm(seen.values())) <= (
            1e-6 * _f64_norm(seen.values()))
    assert state.optimizer.count == state.step == 2


@pytest.mark.parametrize("numels,n_update,windows", [
    ([1, 0, 7, 4096, 5], 5, 1),
    ([3] * 520, 500, 1),
    ([1] * MAX_TENSORS, MAX_TENSORS, 1),
    ([2] * (MAX_TENSORS + 1), 700, 2),
    ([9] * (2 * MAX_TENSORS + 3), 2 * MAX_TENSORS + 3, 3),
])
def test_fused_plan_pads_each_tensor_and_windows_the_table(numels, n_update, windows):
    """Each tensor starts on a 16-byte vector (its offset a multiple of 4
    elements) right after the one before; the windows cover the tensors in
    order, at most ``MAX_TENSORS`` each, their update ranges stopping at
    the first tensor without an update; a step is two launches a window
    and one more."""
    offsets, plan_windows = plan(numels, n_update)
    assert offsets[0] == 0 and all(o % 4 == 0 for o in offsets)
    assert all(b - a == (n + 3) // 4 * 4 for a, b, n in zip(offsets, offsets[1:], numels))
    assert len(plan_windows) == windows == (len(numels) + MAX_TENSORS - 1) // MAX_TENSORS
    t = 0
    for t0, t1, u1 in plan_windows:
        assert t0 == t and t1 - t0 <= MAX_TENSORS and t0 <= u1 <= t1
        assert u1 == max(t0, min(t1, n_update))
        t = t1
    assert t == len(numels)
    assert launches(len(numels)) == 2 * windows + 1


def test_fused_step_is_three_launches_for_the_benchmarked_models():
    """The flagship's 520 tensors and ``oda_conv``'s 363 take one window."""
    assert launches(520) == launches(363) == launches(5) == 3
