"""The train-step comparison shared by ``test_torch_port_train*.py``: one
step of the port's ``make_train_step`` against one step of the JAX
package's, on the tiny flagship of ``test_torch_port_flagship.py`` (red33
neck, stochastic depth off so that no random draw differs), from the same
weights (``from_jax_variables``) and the same numpy batch, in f32 on the
CPU.

JAX's gradients come out of its own ``make_train_step``: a first link in
the optimizer chain stores the gradients it is given in its state. The
port's come out of its step the same way, by wrapping the optimizer's
``update``. So each side's gradients are exactly the ones its step used.

Tolerances:
- logs: 1e-5 of their magnitude (losses ~10, norms ~1-100);
- gradients: each tensor's max-abs difference within 5e-4 of that
  tensor's max |g|, or of 1% of the largest |g| of any tensor where that
  is more (the backward runs through BatchNorm statistics, softmaxes and
  bilinear resizes whose f32 sums the frameworks order differently, ~1e-4
  of a tensor here; the key projections' biases get a gradient that is 0
  in exact arithmetic, as a softmax does not see a shift of all its
  logits, so both sides hold rounding noise there);
- BatchNorm running statistics: 1e-5 of their magnitude;
- new parameters: Adam's first update is about lr * g / (|g| + eps), near
  lr * sign(g), so where g is within a few eps of 0 a tiny relative
  difference in g moves the parameter by a sizeable part of lr. The new
  parameters are therefore held at 0.1 * lr0 (lr0 the first step's
  learning rate, 4e-6), a tenth of the largest update Adam takes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import mde_tpu.models.oda2.red_order_swin2 as jax_flagship
from mde_tpu.train.optim import bn_label_fn
from mde_tpu.train.optim import build_optimizer as jax_build_optimizer
from mde_tpu.train.state import TrainState as JaxTrainState
from mde_tpu.train.step import make_train_step as jax_make_train_step
from mde_tpu_torch.convert import from_jax_variables
from mde_tpu_torch.models import build_model
from mde_tpu_torch.train.state import TrainState
from mde_tpu_torch.train.step import make_train_step
from test_torch_port_flagship import ENC, _random_jax_variables

CFG = dict(name="oda2_red_order_swin2", encoder_type="custom", dec_dim=32, num_heads=4,
           num_repeats=2, num_emb=16, window_size=4, neck_type="red33")
TOTAL_STEPS = 100
LR0 = 1e-4 / 25  # the onecycle schedule's first value
LOG_TOL = 1e-5
GRAD_TOL = 5e-4
GRAD_FLOOR = 1e-2
STATS_TOL = 1e-5
PARAM_TOL = 0.1 * LR0

# (num_accum, freeze_bn, freeze_encoder_bn): the forward variants, each a
# JAX step of its own. Two microbatches take four images: with one image a
# microbatch, the BatchNorm variances of the decoder's last maps
# (E[x^2] - E[x]^2 over 384 pixels) cancel badly enough that XLA's compiled
# step departs from JAX's own eager forward by 2e-5 of the loss.
FORWARD = {"base": (1, False, False), "num_accum_2": (2, False, False),
           "freeze_bn": (1, True, False), "freeze_encoder_bn": (1, False, True)}
BATCH = {"num_accum_2": 4}


def make_opt(**changes):
    """The config of the step: the flagship's loss and optimizer at the
    tiny model; ``changes`` go into its ``optimizer`` and ``scheduler``
    sections, or ``zero_grad_bn`` into ``train``."""
    opt = {"model": dict(CFG),
           "loss": {"alpha": 10.0, "beta": 0.15, "per_image": True, "si_weight": 1.0},
           "optimizer": {"lr": 1e-4, "betas": [0.9, 0.999], "weight_decay": 0.1,
                         "eps": 1e-6, "same_lr": True},
           "scheduler": {"name": "onecycle", "pct_start": 0.25, "div_factor": 25,
                         "final_div_factor": 100},
           "train": {"grad_norm": 0.1},
           "eval": {"garg_crop": True, "eigen_crop": False}}
    for key, value in changes.items():
        section = {"moment_dtype": "optimizer", "same_lr": "optimizer",
                   "cycle_momentum": "scheduler", "zero_grad_bn": "train"}[key]
        opt[section][key] = value
    return opt


def batch(seed=0, size=2):
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(size, 64, 96, 3).astype(np.float32),
            "depth": rng.uniform(0.5, 60.0, (size, 64, 96, 1)).astype(np.float32)}


class JaxReference:
    """The JAX model and weights, and one JAX step per forward variant,
    computed once."""

    def __init__(self):
        self.model = jax_flagship.ODA2OrderedSwin2RegModel.build(
            CFG, 0.001, 80.0, resize_to_multiple=False, encoder_kwargs=ENC,
            use_checkpoint=False, scan_repeats=False, path_drop_prob=0.0)
        self.batch = batch()
        self.variables = _random_jax_variables(self.model, jnp.asarray(self.batch["image"]),
                                               seed=5)
        self._steps = {}
        self._updates = {}

    def tx(self, opt):
        labels = (bn_label_fn(self.variables["params"], self.variables["batch_stats"])
                  if opt["train"].get("zero_grad_bn") else None)
        return jax_build_optimizer(opt, TOTAL_STEPS, bn_labels=labels)

    def step(self, variant):
        """(grads, logs, new batch_stats, new params) of one JAX step of the
        forward variant with the default optimizer."""
        if variant not in self._steps:
            num_accum, freeze_bn, freeze_encoder_bn = FORWARD[variant]
            opt = make_opt()
            stash = optax.GradientTransformation(
                lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
                lambda updates, state, params=None: (updates, updates))
            tx = optax.chain(stash, self.tx(opt))
            state = JaxTrainState.create(self.variables["params"],
                                         self.variables["batch_stats"], tx)
            step = jax_make_train_step(self.model, opt, 0.001, 80.0, tx, num_accum=num_accum,
                                       freeze_bn=freeze_bn,
                                       freeze_encoder_bn=freeze_encoder_bn, donate=False)
            data = batch(size=BATCH.get(variant, 2))
            new, logs = step(state, {k: jnp.asarray(v) for k, v in data.items()},
                             jax.random.PRNGKey(0))
            self._steps[variant] = (new.opt_state[0], {k: float(v) for k, v in logs.items()},
                                    new.batch_stats, new.params)
        return self._steps[variant]

    def update(self, opt, grads):
        """New params after the optimizer of ``opt`` takes ``grads`` from the
        start weights (the JAX step's own update, on the same gradients)."""
        key = repr(opt)
        if key not in self._updates:
            tx = self.tx(opt)

            @jax.jit
            def apply(params, grads):
                updates, _ = tx.update(grads, tx.init(params), params)
                return optax.apply_updates(params, updates)

            self._updates[key] = apply
        return self._updates[key](self.variables["params"], grads)


def port_step(ref: JaxReference, opt, num_accum=1, freeze_bn=False, freeze_encoder_bn=False,
              zero_grad_bn=False, use_checkpoint=False, batch_size=2):
    """One port step from the reference's weights on ``batch(size=batch_size)``:
    (grads, logs, model)."""
    model = build_model(CFG, 0.001, 80.0, device="cpu", resize_to_multiple=False,
                        encoder_kwargs=ENC, path_drop_prob=0.0, use_checkpoint=use_checkpoint)
    model.load_state_dict(from_jax_variables(ref.variables))
    state = TrainState.create(model, opt, TOTAL_STEPS, zero_grad_bn=zero_grad_bn)
    seen = {}
    real = state.optimizer.update

    def update(grads):
        seen.update({n: g.clone() for n, g in grads.items()})
        real(grads)

    state.optimizer.update = update
    step = make_train_step(opt, 0.001, 80.0, num_accum=num_accum, freeze_bn=freeze_bn,
                           freeze_encoder_bn=freeze_encoder_bn)
    state, logs = step(state, batch(size=batch_size), torch.Generator().manual_seed(0))
    assert state.step == 1
    return seen, {k: float(v) for k, v in logs.items()}, model


def port_names(params, stats=None):
    """A JAX tree of params (or, given ``stats``, the batch stats beside
    those params) in the port's names and layouts."""
    converted = from_jax_variables({"params": params, "batch_stats": stats or {}})
    if stats is None:
        return converted
    return {k: v for k, v in converted.items() if k.endswith(("running_mean", "running_var"))}




def jax_step(model, opt, variables, data, adapter=None, freeze_bn=False):
    """(grads, logs, new batch_stats, new params) of one step of JAX's
    ``make_train_step`` of ``model`` and ``opt`` (``adapter`` None for
    JAX's default; ``freeze_bn``) from ``variables`` on the numpy batch
    ``data``, the gradients stashed by a first link in the optimizer chain:
    the reference side of a family's train-step test."""
    stash = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))
    tx = optax.chain(stash, jax_build_optimizer(opt, TOTAL_STEPS))
    state = JaxTrainState.create(variables["params"], variables["batch_stats"], tx)
    step = jax_make_train_step(model, opt, 0.001, 80.0, tx, adapter=adapter,
                               freeze_bn=freeze_bn, donate=False)
    new, logs = step(state, {k: jnp.asarray(v) for k, v in data.items()},
                     jax.random.PRNGKey(0))
    return (new.opt_state[0], {k: float(v) for k, v in logs.items()}, new.batch_stats,
            new.params)


def port_step_of(model, opt, data, freeze_bn=False):
    """One step of the port's ``make_train_step`` of ``model`` (weights
    loaded) and ``opt`` (and ``freeze_bn``) on ``data``: (the gradients its
    optimizer took, logs)."""
    state = TrainState.create(model, opt, TOTAL_STEPS)
    seen = {}
    real = state.optimizer.update

    def update(grads):
        seen.update({n: g.clone() for n, g in grads.items()})
        real(grads)

    state.optimizer.update = update
    state, logs = make_train_step(opt, 0.001, 80.0, freeze_bn=freeze_bn)(
        state, data, torch.Generator().manual_seed(0))
    assert state.step == 1
    return seen, {k: float(v) for k, v in logs.items()}


def assert_logs(ours, ref):
    for key in ("loss", "loss_si", "grad_norm", "param_norm"):
        assert abs(ours[key] - ref[key]) <= LOG_TOL * max(1.0, abs(ref[key])), (key, ours, ref)


def assert_grads(ours, jax_grads):
    ref = port_names(jax_grads)
    assert set(ours) == set(ref)
    floor = GRAD_FLOOR * max(g.abs().max().item() for g in ref.values())
    worst = max(((ours[n].double() - ref[n].double()).abs().max().item()
                 / max(ref[n].abs().max().item(), floor), n) for n in ref)
    assert worst[0] <= GRAD_TOL, worst


def assert_stats(model, jax_params, jax_stats):
    ref = port_names(jax_params, jax_stats)
    state = model.state_dict()
    assert ref
    for name, value in ref.items():
        scale = max(1.0, value.abs().max().item())
        assert (state[name] - value).abs().max().item() <= STATS_TOL * scale, name


def assert_params(model, jax_params):
    ref = port_names(jax_params)
    params = dict(model.named_parameters())
    assert set(params) == set(ref)
    worst = max(((params[n].detach() - ref[n]).abs().max().item(), n) for n in ref)
    assert worst[0] <= PARAM_TOL, worst
