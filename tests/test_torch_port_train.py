"""The port's training path against the JAX package's, on the CPU in f32.

- The train step (``_torch_port_train_case.py`` holds the comparison and
  its tolerances): one port step against JAX's ``make_train_step``, with
  ``num_accum`` 1 and 2, and with the optimizer options ``zero_grad_bn``,
  ``same_lr=False`` and ``moment_dtype=bfloat16`` with ``cycle_momentum``.
  An optimizer option changes only JAX's update, so its reference is JAX's
  optimizer applied to the gradients of JAX's step. The port runs with and
  without recompute (``use_checkpoint``).
- The losses against ``mde_tpu.train.loss`` at 1e-6 of their magnitude.
- The learning-rate and momentum schedules against optax's.
- The eval step against JAX's ``make_eval_step``, Garg crop and flip.
- Stochastic depth: with recompute on, the gradients equal those without,
  from one seeded generator (the masks are drawn outside the recompute).
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_port_train_case as case
from mde_tpu.train import loss as jax_loss
from mde_tpu.train.optim import build_lr_schedule as jax_lr_schedule
from mde_tpu.train.optim import build_momentum_schedule as jax_momentum_schedule
from mde_tpu.train.step import make_eval_step as jax_make_eval_step
from mde_tpu_torch.convert import from_jax_variables
from mde_tpu_torch.models import build_model
from mde_tpu_torch.ops.drop import DropPath, Dropout
from mde_tpu_torch.train import loss as port_loss
from mde_tpu_torch.train.optim import build_lr_schedule, build_momentum_schedule
from mde_tpu_torch.train.state import TrainState
from mde_tpu_torch.train.step import make_eval_step, make_train_step
from _torch_port_threads import one_torch_thread  # noqa: F401

LOSS_TOL = 1e-6

# optimizer options, each on the base forward
OPTIMIZER = {"zero_grad_bn": dict(zero_grad_bn=True),
             "same_lr_false": dict(same_lr=False),
             "moment_bf16_cycle_momentum": dict(moment_dtype="bfloat16", cycle_momentum=True)}


@pytest.fixture(scope="module")
def ref():
    return case.JaxReference()


@pytest.mark.parametrize("use_checkpoint", [False, True])
@pytest.mark.parametrize("variant", ["base", "num_accum_2"])
def test_train_step_matches_jax(ref, variant, use_checkpoint):
    num_accum, _, _ = case.FORWARD[variant]
    grads, logs, model = case.port_step(ref, case.make_opt(), num_accum,
                                        use_checkpoint=use_checkpoint,
                                        batch_size=case.BATCH.get(variant, 2))
    jax_grads, jax_logs, jax_stats, jax_params = ref.step(variant)
    case.assert_logs(logs, jax_logs)
    case.assert_grads(grads, jax_grads)
    case.assert_stats(model, ref.variables["params"], jax_stats)
    case.assert_params(model, jax_params)


@pytest.mark.parametrize("use_checkpoint", [False, True])
@pytest.mark.parametrize("option", list(OPTIMIZER))
def test_train_step_optimizer_options_match_optax(ref, option, use_checkpoint):
    opt = case.make_opt(**OPTIMIZER[option])
    grads, logs, model = case.port_step(ref, opt, zero_grad_bn=opt["train"].get(
        "zero_grad_bn", False), use_checkpoint=use_checkpoint)
    jax_grads, jax_logs, jax_stats, _ = ref.step("base")
    jax_params = ref.update(opt, jax_grads)
    jax_logs = dict(jax_logs, param_norm=float(optax.global_norm(jax_params)))
    case.assert_logs(logs, jax_logs)
    case.assert_grads(grads, jax_grads)
    case.assert_stats(model, ref.variables["params"], jax_stats)
    case.assert_params(model, jax_params)
    start = case.port_names(ref.variables["params"])
    moved = {n for n, p in model.named_parameters() if not torch.equal(p.detach(), start[n])}
    bn = {n for n in start if ".bn" in n}
    if option == "zero_grad_bn":  # BatchNorm scale and bias did not move
        assert bn and not bn & moved and moved
    else:
        assert moved == set(start)


def _loss_inputs(seed=0):
    rng = np.random.RandomState(seed)
    pred = rng.uniform(0.1, 70.0, (2, 12, 20, 1)).astype(np.float32)
    gt = rng.uniform(0.5, 90.0, (2, 12, 20, 1)).astype(np.float32)
    gt[0, :3] = 0.0  # invalid pixels
    return pred, gt, (gt > 0.001) & (gt <= 80.0)


def _close(ours, ref) -> bool:
    ref = float(ref)
    return abs(float(ours) - ref) <= LOSS_TOL * max(1.0, abs(ref))


@pytest.mark.parametrize("per_image", [True, False])
def test_losses_match_jax(per_image):
    pred, gt, mask = _loss_inputs()
    t = torch.from_numpy
    assert _close(port_loss.silog_loss(t(pred), t(gt), t(mask), 10.0, 0.15, per_image),
                  jax_loss.silog_loss(pred, gt, mask, 10.0, 0.15, per_image))
    assert _close(port_loss.sog_loss(t(pred[..., 0]), t(gt[..., 0]), t(mask[..., 0])),
                  jax_loss.sog_loss(pred[..., 0], gt[..., 0], mask[..., 0]))
    centers = np.random.RandomState(1).uniform(0.5, 80.0, (2, 16)).astype(np.float32)
    assert _close(port_loss.chamfer_bin_loss(t(centers), t(gt), t(mask), chunk=100),
                  jax_loss.chamfer_bin_loss(centers, gt, mask, chunk=100))
    # the composite: four maps at two sizes, oda weighting, sog and chamfer on
    cfg = {"alpha": 10.0, "beta": 0.15, "per_image": per_image, "oda_weight": 0.5,
           "sog_weight": 0.3, "chamfer_weight": 0.1}
    rng = np.random.RandomState(2)
    maps = [rng.uniform(0.5, 60.0, (2, h, w, 1)).astype(np.float32)
            for h, w in ((6, 10), (6, 10), (6, 10), (12, 20))]
    ours, ours_logs = port_loss.DepthLoss(cfg, 0.001, 80.0)([t(m) for m in maps], t(gt),
                                                           bin_centers=t(centers))
    ref, ref_logs = jax_loss.DepthLoss(cfg, 0.001, 80.0)([jnp.asarray(m) for m in maps],
                                                        jnp.asarray(gt),
                                                        bin_centers=jnp.asarray(centers))
    assert _close(ours, ref) and set(ours_logs) == set(ref_logs)
    for key in ref_logs:
        assert _close(ours_logs[key], ref_logs[key]), key


@pytest.mark.parametrize("total", [10, 100, 1000])
def test_schedules_match_optax(total):
    opt = case.make_opt(cycle_momentum=True)
    lr, jlr = build_lr_schedule(opt, total), jax_lr_schedule(opt, total)
    b1, jb1 = build_momentum_schedule(opt, total), jax_momentum_schedule(opt, total)
    steps = sorted({0, 1, 2, total // 4 - 1, total // 4, total // 4 + 1, total // 2,
                    total - 1, total, total + 5})
    for s in steps:
        assert abs(lr(s) - float(jlr(s))) <= 1e-6 * float(opt["optimizer"]["lr"]), s
        assert abs(b1(s) - float(jb1(jnp.asarray(s)))) <= 1e-6, s
    opt["scheduler"] = {"name": "constant", "cycle_momentum": False}
    assert build_lr_schedule(opt, total)(7) == float(jax_lr_schedule(opt, total)(7))
    assert build_momentum_schedule(opt, total) is None


def test_eval_step_matches_jax(ref):
    opt = case.make_opt()
    model = build_model(case.CFG, 0.001, 80.0, device="cpu", resize_to_multiple=False,
                        encoder_kwargs=case.ENC, use_checkpoint=False)
    model.load_state_dict(from_jax_variables(ref.variables))
    rng = np.random.RandomState(3)
    batch = {"image": ref.batch["image"],
             "depth": rng.uniform(0.5, 90.0, (2, 80, 120, 1)).astype(np.float32)}
    ours = make_eval_step(model, opt, 0.001, 80.0, "KITTI", flip_eval=True)(batch)
    jax_step = jax_make_eval_step(ref.model, opt, 0.001, 80.0, "KITTI", flip_eval=True)
    theirs = jax_step(ref.variables, {k: jnp.asarray(v) for k, v in batch.items()})
    assert set(ours) == set(theirs)
    assert not model.training
    for key, value in theirs.items():
        value = np.asarray(value)
        assert ours[key].shape == value.shape == (2,), key
        np.testing.assert_allclose(ours[key].numpy(), value, rtol=1e-4, atol=1e-6,
                                   err_msg=key)


def _drop_path_step(use_checkpoint, seed, path_drop_prob=0.5, **encoder_rates):
    opt = case.make_opt()
    model = build_model(case.CFG, 0.001, 80.0, device="cpu", seed=1, resize_to_multiple=False,
                        encoder_kwargs=dict(case.ENC, **encoder_rates),
                        path_drop_prob=path_drop_prob, use_checkpoint=use_checkpoint)
    state = TrainState.create(model, opt, case.TOTAL_STEPS)
    seen = {}
    real = state.optimizer.update
    state.optimizer.update = lambda grads: (seen.update(grads), real(grads))
    _, logs = make_train_step(opt, 0.001, 80.0)(state, case.batch(4),
                                                torch.Generator().manual_seed(seed))
    stats = {k: v for k, v in model.state_dict().items() if "running" in k}
    return seen, float(logs["loss"]), stats


def test_drop_path_recompute_keeps_the_masks():
    plain, loss, stats = _drop_path_step(False, seed=7)
    again, loss2, stats2 = _drop_path_step(True, seed=7)
    assert loss == loss2
    for name in plain:
        assert torch.allclose(plain[name], again[name], rtol=1e-6, atol=1e-9), name
    for name in stats:  # the recompute does not update BatchNorm statistics again
        assert torch.equal(stats[name], stats2[name]), name
    # the masks are drawn from the generator: another seed, other gradients
    other, _, _ = _drop_path_step(False, seed=8)
    assert any(not torch.allclose(plain[n], other[n]) for n in plain)


def test_dropout_recompute_keeps_the_masks():
    """The encoder's element-wise dropout (``drop_prob`` and
    ``attn_drop_prob`` through ``encoder_kwargs``) in a recomputed block
    draws the same masks again from the saved generator state: the
    recomputing step's loss and gradients are the plain step's."""
    rates = dict(drop_prob=0.2, attn_drop_prob=0.1)
    plain, loss, _ = _drop_path_step(False, seed=9, **rates)
    again, loss2, _ = _drop_path_step(True, seed=9, **rates)
    assert loss == loss2
    for name in plain:
        assert torch.allclose(plain[name], again[name], rtol=1e-6, atol=1e-9), name
    other, _, _ = _drop_path_step(False, seed=9, path_drop_prob=0.5)
    assert any(not torch.allclose(plain[n], other[n]) for n in plain)


@pytest.mark.parametrize("dtype,rate", [(torch.float32, 0.5), (torch.bfloat16, 0.1)],
                         ids=["float32-0.5", "bfloat16-0.1"])
def test_drop_path_and_dropout_numerics(dtype, rate):
    """DropPath as JAX's, and Dropout against flax's ``nn.Dropout``: on the
    elements both keep, the same bits. At rate 0.1 the keep probability 0.9
    is not a bf16 value: flax divides by it rounded to bf16."""
    x = torch.from_numpy(np.random.RandomState(5).randn(4, 3, 5, 2).astype(np.float32)).to(dtype)
    drop = DropPath(0.25)
    keep = drop.draw(4, torch.Generator().manual_seed(0), x.device)
    out = drop(x, keep)
    for b in range(4):  # JAX: where(keep, x / keep_prob, 0)
        expect = x[b] / torch.tensor(0.75, dtype=dtype) if keep[b] else torch.zeros_like(x[b])
        assert torch.equal(out[b], expect)
    assert drop.eval().draw(4, None, x.device) is None and drop(x, None) is x
    dropout = Dropout(rate)
    x = torch.from_numpy(np.random.RandomState(6).randn(100_000).astype(np.float32)).to(dtype)
    y = dropout(x, torch.Generator().manual_seed(1))
    ref = flax_nn.Dropout(rate, deterministic=False).apply(
        {}, jnp.asarray(x.float().numpy(), jnp.dtype(str(dtype).split(".")[1])),
        rngs={"dropout": jax.random.PRNGKey(2)})
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32))).to(dtype)
    kept, ref_kept = y != 0, ref != 0
    both = kept & ref_kept
    assert 0.4 < kept.float().mean() < 0.95
    assert both.sum() > 0.2 * x.numel() and torch.equal(y[both], ref[both])
    assert dropout.eval()(x) is x and Dropout(0.0)(x) is x
