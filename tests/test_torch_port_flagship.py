"""The ported slice as a whole: a tiny ``oda2_red_order_swin2`` against JAX.

Tiny flagship: custom Swin (embed 16, depths (2, 1, 2, 1), so that JAX
stores both the scan-stacked and the unrolled block layouts), dec_dim 32, 4
heads, num_emb 16, 2 repeats, on 64x96 images (stages 3 and 4 are padded to
the window) without the 224-multiple resize. All six necks, f32 on the CPU:
``out`` and every map of ``outs`` agree at max-abs 1e-4, and each repeat's
index map is compared too, so that a flipped bucket is reported as such.

Weights go both ways: JAX variables -> ``from_jax_variables`` -> port, and
port ``state_dict`` -> ``convert_oda2_red_order_swin2`` -> JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mde_tpu.models.oda2.red_order_swin2 as jax_flagship
import mde_tpu_torch.models.oda2.red_order_swin2 as port_flagship
from mde_tpu.core.checkpoint import convert_oda2_red_order_swin2
from mde_tpu.ops.resize import resize_bilinear as jax_resize
from mde_tpu_torch.convert import from_jax_variables
from mde_tpu_torch.models import build_model
from mde_tpu_torch.serve import Predictor
from _torch_port_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
ENC = dict(embed_dim=16, depths=(2, 1, 2, 1), num_heads=(1, 2, 4, 8), window_size=4)
NUM_REPEATS = 2


def _cfg(neck, output_scale):
    return dict(name="oda2_red_order_swin2", encoder_type="custom", dec_dim=32, num_heads=4,
                num_repeats=NUM_REPEATS, num_emb=16, window_size=4, neck_type=neck,
                output_scale=output_scale)


def _images(seed=0):
    return np.random.RandomState(seed).rand(2, 64, 96, 3).astype(np.float32)


def _jax_model(cfg):
    return jax_flagship.ODA2OrderedSwin2RegModel.build(
        cfg, 0.001, 80.0, resize_to_multiple=False, encoder_kwargs=ENC,
        use_checkpoint=False, scan_repeats=False)


def _port_model(cfg, seed=0):
    return build_model(cfg, 0.001, 80.0, device="cpu", seed=seed,
                       resize_to_multiple=False, encoder_kwargs=ENC, use_checkpoint=False)


def _random_jax_variables(model, x, seed):
    """The JAX model's own variable tree (from tracing its init), filled
    with seeded numpy values at scales that keep activations O(1)."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x[:1], train=False))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        keys = [getattr(p, "key", "") for p in path]
        name, shape = keys[-1], s.shape
        if name == "kernel":
            fan = 25 if "conv2" in keys else (np.prod(shape[:3]) if len(shape) == 4
                                              else shape[-2])
            v = rng.randn(*shape) / np.sqrt(fan)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            v = 1 + 0.1 * rng.randn(*shape)
        elif name in ("depth_embedding", "relative_position_bias_table"):
            v = 0.5 * rng.randn(*shape)
        else:
            v = 0.1 * rng.randn(*shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _record_indices(monkeypatch, module):
    """Record every index map the head quantises (name lookup at call time)."""
    seen = []
    real = module._quantize_logit

    def record(logit, num_emb):
        idx = real(logit, num_emb)
        seen.append(np.asarray(idx))
        return idx

    monkeypatch.setattr(module, "_quantize_logit", record)
    return seen


def _compare(port_outs, jax_outs, port_idx, jax_idx):
    assert len(port_outs) == len(jax_outs) == NUM_REPEATS + 1
    flips = [int((a != b).sum()) for a, b in zip(port_idx, jax_idx)]
    assert len(port_idx) == len(jax_idx) == NUM_REPEATS
    for i, (p, j) in enumerate(zip(port_outs, jax_outs)):
        assert p.shape == j.shape
        err = float(np.max(np.abs(p.numpy().astype(np.float64) - np.asarray(j, np.float64))))
        assert err <= TOL, f"map {i}: max-abs {err}; index flips per repeat {flips}"
    assert flips == [0] * NUM_REPEATS, f"index flips per repeat {flips}"


@pytest.mark.parametrize("neck,output_scale", [("red", 2), ("fpn", 4), ("segformer", 4),
                                               ("red33", 4), ("red33r", 4), ("red33res", 4)])
def test_flagship_matches_jax_both_ways(neck, output_scale, monkeypatch):
    cfg = _cfg(neck, output_scale)
    x = _images()
    jm = _jax_model(cfg)
    variables = _random_jax_variables(jm, jnp.asarray(x), seed=1)

    # JAX -> port
    port = _port_model(cfg)
    port.load_state_dict(from_jax_variables(variables, output_scale=output_scale))
    jax_idx = _record_indices(monkeypatch, jax_flagship)
    port_idx = _record_indices(monkeypatch, port_flagship)
    _, jax_outs, _ = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out, outs = port(torch.from_numpy(x))
    _compare(outs, jax_outs, port_idx, jax_idx)
    assert torch.equal(out, outs[-1])

    # port -> JAX: the converter gives back exactly the variables the port
    # was loaded from, so the JAX forward above is the forward of the
    # converted port weights
    back = convert_oda2_red_order_swin2(
        {k: v.numpy() for k, v in port.state_dict().items()}, depths=ENC["depths"],
        num_repeats=NUM_REPEATS, neck_type=neck, output_scale=output_scale,
        scan_repeats=False)
    flat_a = jax.tree_util.tree_leaves_with_path(back)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(leaf, flat_b[path], err_msg=jax.tree_util.keystr(path))


def test_port_init_through_converter_and_predictor(monkeypatch):
    """Weights drawn by the port (realistic init: linear depth prior) go to
    JAX through the converter; ``Predictor.predict`` matches JAX forward +
    align-corners resize to the input + clip at 0."""
    cfg = _cfg("red33", 4)
    port = _port_model(cfg, seed=3)
    variables = convert_oda2_red_order_swin2(
        {k: v.numpy() for k, v in port.state_dict().items()}, depths=ENC["depths"],
        num_repeats=NUM_REPEATS, neck_type="red33", scan_repeats=False)
    x = _images(seed=4)
    jax_idx = _record_indices(monkeypatch, jax_flagship)
    port_idx = _record_indices(monkeypatch, port_flagship)
    jax_out, jax_outs, _ = _jax_model(cfg).apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        _, outs = port(torch.from_numpy(x))
    _compare(outs, jax_outs, port_idx, jax_idx)

    pred = Predictor(port).predict(x)
    ref = np.clip(np.asarray(jax_resize(jax_out, x.shape[1:3])), 0.0, None)
    assert pred.shape == (2, 64, 96, 1)
    assert float(np.max(np.abs(pred.numpy() - ref))) <= TOL


def test_scan_head_layout_is_rejected():
    stacked = {"params": {"decoder": {"reducer": {"repeat": {"conv_out": {
        "kernel": np.zeros((2, 1, 1, 8, 1), np.float32)}}}}}}
    with pytest.raises(ValueError, match="migrate_head_layout"):
        from_jax_variables(stacked)
