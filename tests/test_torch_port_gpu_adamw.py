"""The optimizer's fused kernels (``ops/kernels/adamw.py``) on the card,
against ``AdamW``'s plain version on the same card.

Every test needs an NVIDIA card (marker ``gpu``) and skips without one; the
file imports nothing of JAX:

    python -m pytest tests/test_torch_port_gpu_adamw.py -m gpu --noconftest -q

Tolerances, per tensor: the kernel and PyTorch's foreach kernels round the
same f32 operations, but either may contract a product and a sum into one
FMA, and the clip's norm is summed in f64 by the kernel and in f32 norms
by the plain version, so nu and an update agree to a few ulps (``REL`` of
the tensor's largest); p to one ulp of itself beyond that. A bf16 first
moment whose f32 value lands on the other side of a rounding boundary
moves by one bf16 ulp (2^-8), and the next steps carry it: ``REL_BF16``.
The norms hold to the f64 sums within ``NORM_REL``.
"""

import numpy as np
import pytest
import torch

from mde_tpu_torch.ops import kernels
from mde_tpu_torch.ops.kernels.adamw import launches
from mde_tpu_torch.train.optim import AdamW

REL = 1e-5
REL_BF16 = 2 ** -7
NORM_REL = 1e-6
STEPS = 3
EPS32 = 2 ** -23

# name -> AdamW options (and how the gradients are made)
CASES = {
    "clip": dict(max_norm=0.1),
    "no_clip": dict(max_norm=1e9),
    "max_norm_0": dict(max_norm=0.0),
    "nan_gradient": dict(max_norm=0.1),
    "moment_bf16": dict(max_norm=0.1, moment_dtype=torch.bfloat16),
    "no_update": dict(max_norm=0.1),
    "encoder_scale": dict(max_norm=0.1, encoder_scale=0.1),
    "b1_schedule": dict(max_norm=0.1, b1_schedule=lambda count: 0.95 - 0.03 * count),
    "gradient_views": dict(max_norm=0.1),
    # past MAX_TENSORS (640): two windows, the second's tensors without an update
    "two_windows": dict(max_norm=0.1),
}
# tensors in each case's mix
TENSORS = {"two_windows": 700}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _shapes(n: int, seed: int = 0) -> dict:
    """``n`` named shapes in the flagship's mix: mostly LayerNorm and bias
    vectors and modest weights, a few large ones (past a block's share of
    the concatenation), 1-element and zero-size tensors, odd sizes; every
    fifth under an ``encoder``, every seventh a BatchNorm's."""
    rng = np.random.RandomState(seed)
    fixed = [(1,), (0,), (7,), (129, 3), (1023,), (3, 700, 1001), (512, 2048), (5,), (1, 1)]
    out = {}
    for i in range(n):
        if i < len(fixed):
            shape = fixed[i]
        elif i % 9 == 0:
            shape = (int(rng.randint(64, 1024)), int(rng.randint(64, 1024)))
        else:
            shape = (int(rng.randint(1, 2049)),)
        part = "encoder" if i % 5 == 0 else "decoder"
        kind = "bn" if i % 7 == 3 else "linear"
        out[f"{part}.{i}.{kind}.weight"] = shape
    return out


def _optimizer(shapes: dict, device, seed: int, case: str) -> AdamW:
    g = torch.Generator().manual_seed(seed)
    params = {n: (torch.randn(s, generator=g) * 0.05).to(device) for n, s in shapes.items()}
    no_update = ([n for n in shapes if ".bn." in n] if case in ("no_update", "two_windows")
                 else ())
    return AdamW(params, lambda count: 1e-3 * (1 + count), b1=0.9, b2=0.999, eps=1e-6,
                 weight_decay=0.1, no_update=no_update, **CASES.get(case, {}))


def _grads(shapes: dict, device, seed: int, case: str) -> dict:
    g = torch.Generator().manual_seed(seed)
    grads = {n: torch.randn(s, generator=g) * 0.3 for n, s in shapes.items()}
    if case == "nan_gradient":
        name = next(n for n, s in shapes.items() if int(np.prod(s)) > 1000)
        grads[name].view(-1)[17] = float("nan")
    if case == "gradient_views":
        # one flat buffer at an odd offset, as an all-reduce's split leaves them
        flat = torch.cat([torch.zeros(1)] + [t.reshape(-1) for t in grads.values()]).to(device)
        parts = flat[1:].split([t.numel() for t in grads.values()])
        return {n: p.view(t.shape) for (n, t), p in zip(grads.items(), parts)}
    return {n: t.to(device) for n, t in grads.items()}


def _plain(opt: AdamW) -> AdamW:
    opt._fused = None  # the plain version on the card
    return opt


def _f64_norm(tensors) -> float:
    return float(torch.sqrt(sum((t.double() ** 2).sum() for t in tensors)))


def _close(ours, ref, rel, what):
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(ours), nan), what
    ours, ref = ours[~nan].double(), ref[~nan].double()
    if ref.numel():
        err = (ours - ref).abs().max().item()
        assert err <= rel * ref.abs().max().item() + 1e-30, (what, err)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_adamw_kernel_matches_plain(cuda, case):
    """Three steps of the kernels against three of the plain version, from
    the same parameters and gradients: p, mu, nu and the norms."""
    shapes = _shapes(TENSORS.get(case, 520))
    fused, plain = _optimizer(shapes, cuda, 1, case), _plain(_optimizer(shapes, cuda, 1, case))
    assert fused._fused is not None
    rel_mu = REL_BF16 if case == "moment_bf16" else REL
    rel_u = REL_BF16 if case == "moment_bf16" else REL
    for step in range(STEPS):
        grads = _grads(shapes, cuda, 10 + step, case)
        before = [p.clone() for p in plain.params]
        fused.update(grads)
        plain.update(grads)
        torch.cuda.synchronize()
        assert fused.count == plain.count == step + 1
        exact = _f64_norm(grads.values())
        if case == "nan_gradient":
            assert torch.isnan(fused.grad_norm) and torch.isnan(plain.grad_norm)
        else:
            assert abs(float(fused.grad_norm) - exact) <= NORM_REL * exact
            assert abs(float(fused.param_norm) - _f64_norm(fused.all_params)) <= (
                NORM_REL * _f64_norm(fused.all_params))
        assert fused.grad_norm.dtype == torch.float32 and fused.grad_norm.dim() == 0
        for name, p, q, p0, m, mq, v, vq in zip(fused.names, fused.params, plain.params, before,
                                               fused.mu, plain.mu, fused.nu, plain.nu):
            assert m.dtype == CASES[case].get("moment_dtype", torch.float32)
            _close(m.float(), mq.float(), rel_mu, (name, step, "mu"))
            _close(v, vq, REL, (name, step, "nu"))
            du, dq = p.double() - p0.double(), q.double() - p0.double()
            nan = torch.isnan(q)
            assert torch.equal(torch.isnan(p), nan), (name, step)
            if (~nan).any():
                err = (du - dq)[~nan].abs()
                tol = 2 * EPS32 * q.double()[~nan].abs() + rel_u * dq[~nan].abs().max()
                assert (err <= tol).all(), (name, step, err.max().item())
    rest = [n for n in shapes if n not in fused.names]
    assert bool(rest) == (case in ("no_update", "two_windows"))


@pytest.mark.gpu
def test_adamw_kernel_gives_the_same_bits_twice(cuda):
    shapes = _shapes(520)
    runs = []
    for _ in range(2):
        opt = _optimizer(shapes, cuda, 2, "no_update")
        for step in range(STEPS):
            opt.update(_grads(shapes, cuda, 20 + step, "no_update"))
        torch.cuda.synchronize()
        runs.append([opt.grad_norm, opt.param_norm] + opt.params + opt.mu + opt.nu)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.gpu
@pytest.mark.parametrize("n,expect", [(5, 3), (520, 3), (700, 5)])
def test_adamw_kernel_launches_and_reads_nothing_back(cuda, n, expect):
    """3 launches a step up to 640 tensors (the flagship's 520 as 5), two
    more a window past them, and no synchronisation and no copy from
    pageable host memory in ``update`` (PyTorch's sync debug mode raises on
    either)."""
    shapes = _shapes(n)
    opt = _optimizer(shapes, cuda, 3, "clip")
    grads = _grads(shapes, cuda, 30, "clip")
    opt.update(grads)  # first use: the build
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        opt.update(grads)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert kernels.launch_counts == dict(dict.fromkeys(kernels.KERNELS, 0), adamw=expect)
    assert launches(n) == expect
