"""The frozen reference against the program's CPU path (its plain
versions of every kernel), on the same weights, at reduced depth and
width, in float32: the forward pass, and one train step with stochastic
depth and dropout drawn from the same seed (loss, the clipped gradient
the optimizer takes, the updated parameters and BatchNorm statistics)."""

from __future__ import annotations

import copy

import pytest
import torch

from benchmark import harness, inputs, reference
from benchmark.reference.layers import Numerics
from benchmark.reference.train import AdamW, train_step

TINY = {
    "flagship": ({"encoder_type": "custom", "dec_dim": 32, "num_heads": 2, "num_repeats": 2,
                  "num_emb": 16, "encoder_kwargs": {"embed_dim": 16, "depths": [2, 2, 2, 2],
                                                    "num_heads": [1, 2, 2, 4]}},
                 (224, 224)),
    "oda_conv": ({"decoder_channels": 64,
                  "encoder_kwargs": {"embed_dim": 16, "depths": [2, 2, 2, 2],
                                     "num_heads": [1, 2, 2, 4]}},
                 (384, 384)),
}


def tiny_config(name: str) -> dict:
    config = copy.deepcopy(harness.load_json("configs", name))
    config["model"].update(copy.deepcopy(TINY[name][0]))
    config["dtype"] = "float32"
    return config


def pair(name: str, seed: int = 3):
    """(the program's model, the reference) on the CPU with one state dict."""
    config = tiny_config(name)
    hw = TINY[name][1]
    ref = reference.build(config, Numerics("f32"), hw)
    state = inputs.make_weights(harness.template(ref), seed, "cpu")
    ref.load_state_dict(state)
    prog = harness.build_program(config, "cpu")
    prog.load_state_dict(state)
    return config, prog, ref


@pytest.mark.parametrize("name", sorted(TINY))
def test_forward_matches_program(name):
    config, prog, ref = pair(name)
    hw = TINY[name][1]
    x = inputs.make_images(1, 2, *hw, seed=5, device="cpu")[0]
    with torch.no_grad():
        want = ref.eval()(x)[0]
        got = prog.eval()(x)[0]
    assert got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err


@pytest.mark.parametrize("name", sorted(TINY))
def test_train_step_matches_program(name):
    from mde_tpu_torch.train.state import TrainState
    from mde_tpu_torch.train.step import make_train_step

    config, prog, ref = pair(name, seed=11)
    hw = TINY[name][1]
    images = inputs.make_images(1, 2, *hw, seed=7, device="cpu")[0]
    depths = inputs.make_depths(1, 2, *hw, seed=7, device="cpu", density=0.3, sky_rows=0.2,
                                max_depth=80.0)[0]
    opt = harness.program_options(config)
    state = TrainState.create(prog, opt, config["total_steps"])
    step = make_train_step(opt, config["min_depth"], config["max_depth"])
    state, logs = step(state, {"image": images, "depth": depths},
                       inputs.generator(1, "dropout", "cpu"))
    ref_opt = AdamW(dict(ref.named_parameters()), opt, config["total_steps"])
    out = train_step(ref, ref_opt, images, depths, opt, config["min_depth"],
                     config["max_depth"], inputs.generator(1, "dropout", "cpu"))
    assert abs(logs["loss"].item() - out["loss"]) <= 1e-4 * abs(out["loss"])
    b1 = state.optimizer.b1
    grads = dict(zip(ref_opt.names, out["grads"]))
    sizes = sorted(g.abs().max().item() for g in grads.values())
    median = sizes[len(sizes) // 2]
    for name_, mu in zip(state.optimizer.names, state.optimizer.mu):
        g = grads[name_]
        gap = (mu / (1 - b1) - g).abs().max().item()
        assert gap <= 1e-3 * max(g.abs().max().item(), median), name_
    got = prog.state_dict()
    for key, want in ref.state_dict().items():
        if want.is_floating_point():
            gap = (got[key] - want).abs().max().item()
            assert gap <= 1e-5 * max(want.abs().max().item(), 1e-3), key
