"""The port's train step against JAX's with BatchNorm frozen: ``freeze_bn``
(every BN normalises with its running statistics and keeps them) and
``freeze_encoder_bn`` (the encoder's only; the flagship's Swin encoder has
none, so this step equals the unfrozen one). The comparison and its
tolerances are in ``_torch_port_train_case.py``; the port runs with and
without recompute."""

import pytest

import _torch_port_train_case as case


@pytest.fixture(scope="module")
def ref():
    return case.JaxReference()


@pytest.mark.parametrize("use_checkpoint", [False, True])
@pytest.mark.parametrize("variant", ["freeze_bn", "freeze_encoder_bn"])
def test_frozen_bn_train_step_matches_jax(ref, variant, use_checkpoint):
    num_accum, freeze_bn, freeze_encoder_bn = case.FORWARD[variant]
    grads, logs, model = case.port_step(ref, case.make_opt(), num_accum, freeze_bn,
                                        freeze_encoder_bn, use_checkpoint=use_checkpoint)
    jax_grads, jax_logs, jax_stats, jax_params = ref.step(variant)
    case.assert_logs(logs, jax_logs)
    case.assert_grads(grads, jax_grads)
    case.assert_stats(model, ref.variables["params"], jax_stats)
    case.assert_params(model, jax_params)
    if freeze_bn:  # the running statistics did not move
        case.assert_stats(model, ref.variables["params"], ref.variables["batch_stats"])
