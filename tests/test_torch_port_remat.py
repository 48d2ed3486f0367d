"""The port's recompute policies (``mde_tpu_torch/ops/remat.py``) on a tiny
flagship (encoder depths (2, 2, 2, 2) of widths 16-128, one repeat of the
head, dec_dim 32), f32 on the CPU.

- ``MDE_REMAT_POLICY`` selects JAX's four policies and JAX's default.
- In each policy a recomputing train step (stochastic depth 0.3, dropout
  0.2, attention dropout 0.1, batch statistics) gives the gradients of the
  step without recompute within 1e-6 of each tensor's max |g|, or of 1%
  of the largest |g| of any tensor where that is more (the recompute runs
  the same f32 ops again; the order in which autograd sums a gradient's
  parts may differ, and the key projections' biases, whose gradient is 0
  in exact arithmetic, hold rounding noise), the same BatchNorm statistics
  and the same dropout masks, drawn from one generator.
- The same holds where the masks come from the global generator
  (``generator`` None, the default of ``make_train_step``), and the step
  leaves that generator where the step without recompute leaves it.
- The bytes the step's forward saves for the backward, counted through a
  caller's ``saved_tensors_hooks`` (each storage once), fall in the order
  none > save_sa_conv_glu > save_sa_conv > save_sa > full.
- The depthwise conv's forward (K3's plain version on the CPU) runs as the
  card's launch counts are derived: once a FF without recompute or where
  its output is saved, twice under ``full`` and ``save_sa``.
- At ``save_sa_conv`` the port's recomputing step against JAX's
  ``make_train_step`` of the same model with ``use_checkpoint`` and
  ``MDE_REMAT_POLICY=save_sa_conv`` (stochastic depth and dropout off):
  the gradients within 1e-4 max-abs, the logs within 1e-5 relative.
"""

import jax.numpy as jnp
import pytest
import torch

import _torch_port_train_case as case
import mde_tpu.models.oda2.red_order_swin2 as jax_flagship
from mde_tpu_torch.convert import from_jax_variables
from mde_tpu_torch.models import build_model
from mde_tpu_torch.ops import drop, remat
from mde_tpu_torch.ops.kernels import depthwise
from test_torch_port_flagship import _random_jax_variables
from _torch_port_threads import one_torch_thread  # noqa: F401

CFG = dict(case.CFG, num_repeats=1)
ENC = dict(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(1, 2, 4, 8), window_size=4)
RATES = dict(drop_prob=0.2, attn_drop_prob=0.1)
POLICIES = ["full", "save_sa", "save_sa_conv", "save_sa_conv_glu"]
# the depthwise conv's forward calls in a step of one repeat (two FFs)
K3_CALLS = {None: 2, "full": 4, "save_sa": 4, "save_sa_conv": 2, "save_sa_conv_glu": 2}
GRAD_TOL = 1e-6
JAX_GRAD_TOL = 1e-4


def _step(policy, monkeypatch, rates=RATES, path_drop_prob=0.3, own_generator=True):
    """One port train step of the tiny flagship (seed 0 weights, generator
    seed 3; with ``own_generator`` False the global generator, seeded 3)
    with ``policy`` (None: no recompute): (gradients, BatchNorm statistics,
    loss, the keep masks drawn, the depthwise conv's forward calls, the
    bytes the forward saved, the global generator's state after the
    step)."""
    if policy is not None:
        monkeypatch.setenv("MDE_REMAT_POLICY", policy)
    model = build_model(dict(CFG, **rates), 0.001, 80.0, device="cpu", seed=0,
                        resize_to_multiple=False, encoder_kwargs=ENC,
                        use_checkpoint=policy is not None,
                        path_drop_prob=path_drop_prob).train()
    masks, calls, seen, saved = [], [0], set(), [0]
    keep_mask, conv = drop._keep_mask, depthwise.plain_depthwise_conv2d

    def recording_mask(*a):
        masks.append(keep_mask(*a))
        return masks[-1]

    def counting_conv(*a):
        calls[0] += 1
        return conv(*a)

    def pack(t):
        if t.untyped_storage().data_ptr() not in seen:
            seen.add(t.untyped_storage().data_ptr())
            saved[0] += t.untyped_storage().nbytes()
        return t

    monkeypatch.setattr(drop, "_keep_mask", recording_mask)
    monkeypatch.setattr(depthwise, "plain_depthwise_conv2d", counting_conv)
    data = case.batch(seed=1)
    torch.manual_seed(3)
    generator = torch.Generator().manual_seed(3) if own_generator else None
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        _, outs = model(torch.from_numpy(data["image"]), generator)
    drawn = len(masks)
    loss = sum(o.mean() for o in outs)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    stats = {n: b for n, b in model.named_buffers() if "running" in n}
    return grads, stats, loss.item(), masks[:drawn], calls[0], saved[0], torch.get_rng_state()


@pytest.fixture(scope="module")
def plain():
    with pytest.MonkeyPatch.context() as mp:
        return _step(None, mp)


@pytest.fixture(scope="module")
def plain_global():
    with pytest.MonkeyPatch.context() as mp:
        return _step(None, mp, own_generator=False)


def test_policy_reads_the_environment(monkeypatch):
    monkeypatch.delenv("MDE_REMAT_POLICY", raising=False)
    assert remat.remat_policy() == {"sa_out", "dw_conv"}
    for name, saves in remat.POLICIES.items():
        monkeypatch.setenv("MDE_REMAT_POLICY", name)
        assert remat.remat_policy() == saves
    monkeypatch.setenv("MDE_REMAT_POLICY", "no_such_policy")
    assert remat.remat_policy() == remat.POLICIES["save_sa_conv"]
    assert remat.POLICIES["full"] == frozenset()


def _assert_step_matches(step, ref):
    grads, stats, loss, masks = step[:4]
    ref_grads, ref_stats, ref_loss, ref_masks = ref[:4]
    assert loss == ref_loss
    assert len(masks) == len(ref_masks) > 0
    assert all(torch.equal(a, b) for a, b in zip(masks, ref_masks))
    assert set(grads) == set(ref_grads)
    floor = case.GRAD_FLOOR * max(g.abs().max().item() for g in ref_grads.values())
    for name, g in ref_grads.items():
        assert g is not None and grads[name] is not None, name
        scale = max(g.abs().max().item(), floor)
        assert (grads[name] - g).abs().max().item() <= GRAD_TOL * scale, name
    for name, s in ref_stats.items():
        assert torch.equal(stats[name], s), name


@pytest.mark.parametrize("policy", POLICIES)
def test_recompute_matches_no_recompute(plain, policy, monkeypatch):
    _assert_step_matches(_step(policy, monkeypatch), plain)


@pytest.mark.parametrize("policy", POLICIES)
def test_recompute_with_the_global_generator(plain_global, policy, monkeypatch):
    step = _step(policy, monkeypatch, own_generator=False)
    _assert_step_matches(step, plain_global)
    assert torch.equal(step[6], plain_global[6])


@pytest.mark.parametrize("policy", [None] + POLICIES, ids=["none"] + POLICIES)
def test_depthwise_forward_calls_per_policy(policy, monkeypatch):
    assert _step(policy, monkeypatch)[4] == K3_CALLS[policy]


def test_saved_bytes_fall_with_the_policy(plain, monkeypatch):
    saved = {p: _step(p, monkeypatch)[5] for p in POLICIES}
    order = [plain[5], saved["save_sa_conv_glu"], saved["save_sa_conv"], saved["save_sa"],
             saved["full"]]
    assert order == sorted(order, reverse=True) and len(set(order)) == 5, order


def test_save_sa_conv_matches_jax(monkeypatch):
    monkeypatch.setenv("MDE_REMAT_POLICY", "save_sa_conv")
    model = jax_flagship.ODA2OrderedSwin2RegModel.build(
        CFG, 0.001, 80.0, resize_to_multiple=False, encoder_kwargs=ENC,
        use_checkpoint=True, scan_repeats=False, path_drop_prob=0.0)
    data = case.batch()
    variables = _random_jax_variables(model, jnp.asarray(data["image"]), seed=5)
    jax_grads, jax_logs, _, _ = case.jax_step(model, case.make_opt(), variables, data)
    port = build_model(CFG, 0.001, 80.0, device="cpu", resize_to_multiple=False,
                       encoder_kwargs=ENC, use_checkpoint=True, path_drop_prob=0.0)
    port.load_state_dict(from_jax_variables(variables))
    grads, logs = case.port_step_of(port, case.make_opt(), data)
    case.assert_logs(logs, jax_logs)
    ref = case.port_names(jax_grads)
    assert set(grads) == set(ref)
    worst = max(((grads[n] - ref[n]).abs().max().item(), n) for n in ref)
    assert worst[0] <= JAX_GRAD_TOL, worst
