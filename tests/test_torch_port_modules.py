"""The port's modules (mde_tpu_torch) against the JAX package's, one by one.

Each port module gets a random state dict from a seed; the JAX package's own
torch -> flax converters (``mde_tpu/core/checkpoint.py``) carry it into the
JAX module, and both run on the same seeded numpy input in f32 on the CPU.
Outputs agree at max-abs 1e-4.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mde_tpu.core.checkpoint import (KeyAccountant, _convbn, _dense, _dwconv_ff, _ordered_sa,
                                     _swin_block_params)
from mde_tpu.models.oda2.red_order_swin2 import _quantize_logit as jax_quantize
from mde_tpu.models.swin import SwinBlock as JaxSwinBlock
from mde_tpu.ops import pad as jax_pad
from mde_tpu.ops import resize as jax_resize
from mde_tpu.ops import tnn as jax_tnn
from mde_tpu.ops import window as jax_window
from mde_tpu.ops.attention import WindowAttention as JaxWindowAttention
from mde_tpu.ops.conv import ConvBN as JaxConvBN
from mde_tpu.ops.mlp import PreNormDWConvFF as JaxFF
from mde_tpu.ops.ordered_attention import PreNormOrderedSwinSA as JaxSA
from mde_tpu_torch.models.oda2.red_order_swin2 import _quantize_logit
from mde_tpu_torch.models.swin import SwinBlock
from mde_tpu_torch.ops import pad, resize, tnn, window
from mde_tpu_torch.ops.attention import WindowAttention
from mde_tpu_torch.ops.conv import ConvBN
from mde_tpu_torch.ops.mlp import PreNormDWConvFF
from mde_tpu_torch.ops.ordered_attention import PreNormOrderedSwinSA
from _torch_port_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
# BatchNorm running statistics, relative to max(1, max |JAX's|): they are
# f32 means of E[x^2] - E[x]^2 over the batch, summed in another order
STATS_TOL = 1e-6


def _max_abs(a, b) -> float:
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.detach().numpy() if torch.is_tensor(b) else np.asarray(b)
    return float(np.max(np.abs(a.astype(np.float64) - b.astype(np.float64))))


def _randomize(module: torch.nn.Module, seed: int) -> dict:
    """Fill every float tensor of ``module`` from a seed (BN variances
    positive) and return a copy of its state dict as numpy arrays, prefixed
    'm.' (a copy: a BatchNorm in training updates its statistics in place)."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if not t.is_floating_point():
                continue
            if name.endswith("running_var"):
                vals = rng.uniform(0.5, 1.5, t.shape)
            elif name.endswith("depth_embedding"):
                vals = rng.randn(*t.shape) * 0.5
            else:
                vals = rng.randn(*t.shape) * 0.2
            t.copy_(torch.from_numpy(vals.astype(np.float32)))
    return {f"m.{k}": v.numpy().copy() for k, v in module.state_dict().items()}


def _stats_close(ours, ref) -> bool:
    scale = max(1.0, float(np.max(np.abs(np.asarray(ref)))))
    return _max_abs(ours, ref) <= STATS_TOL * scale


def _input(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("with_mask", [False, True])
def test_window_attention(with_mask):
    r, c, nh = 4, 32, 2
    mod = WindowAttention(c, nh, r)
    sd = _randomize(mod, 0)
    acc = KeyAccountant(sd)
    params = {"qkv": _dense(acc, "m.qkv"), "proj": _dense(acc, "m.proj"),
              "relative_position_bias_table": acc.take("m.relative_position_bias_table")}
    acc.assert_exhausted()
    x = _input(1, 3 * 4, r * r, c)  # 3 images of 4 windows
    mask = np.array(jax_window.shifted_window_attn_mask(2 * r, 2 * r, r, r // 2))
    ours = mod(torch.from_numpy(x), torch.from_numpy(mask) if with_mask else None)
    ref = JaxWindowAttention(num_heads=nh, window_size=r).apply(
        {"params": params}, jnp.asarray(x), mask=jnp.asarray(mask) if with_mask else None)
    assert _max_abs(ours, ref) <= TOL


@pytest.mark.parametrize("shift", [0, 2])
def test_swin_block(shift):
    c, nh, r = 32, 2, 4
    mod = SwinBlock(c, nh, r, shift)
    sd = _randomize(mod, 2)
    params = _swin_block_params(KeyAccountant(sd), "m")
    x = _input(3, 2, 10, 13, c)  # not a multiple of the window: padded
    ours = mod(torch.from_numpy(x))
    ref = JaxSwinBlock(num_heads=nh, window_size=r, shift_size=shift).apply(
        {"params": params}, jnp.asarray(x))
    assert _max_abs(ours, ref) <= TOL


@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("bias_type", ["depth", "none"])
def test_ordered_sa(shift, bias_type):
    c, nh, r, e = 32, 4, 8, 16
    mod = PreNormOrderedSwinSA(c, nh, e, r, shift, bias_type=bias_type)
    sd = _randomize(mod, 4)
    params = _ordered_sa(KeyAccountant(sd), "m", bias_type)
    x = _input(5, 2, 16, 24, c)
    idx = np.random.RandomState(6).randint(0, e, (2, 16, 24)).astype(np.int32)
    ours = mod(torch.from_numpy(x), torch.from_numpy(idx))
    ref, _ = JaxSA(num_heads=nh, num_emb=e, window_size=r, shift_size=shift,
                   bias_type=bias_type).apply({"params": params}, jnp.asarray(x),
                                              jnp.asarray(idx))
    assert _max_abs(ours, ref) <= TOL


def test_dwconv_ff():
    c = 16
    mod = PreNormDWConvFF(c).eval()
    sd = _randomize(mod, 7)
    params, stats = _dwconv_ff(KeyAccountant(sd), "m")
    x = _input(8, 2, 6, 10, c)
    ours = mod(torch.from_numpy(x))
    ref = JaxFF().apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    assert _max_abs(ours, ref) <= TOL


@pytest.mark.parametrize("k", [1, 3])
def test_convbn(k):
    mod = ConvBN(12, 20, k).eval()
    sd = _randomize(mod, 9)
    params, stats = _convbn(KeyAccountant(sd), "m")
    x = _input(10, 2, 7, 9, 12)
    ours = mod(torch.from_numpy(x))
    ref = JaxConvBN(20, k).apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    assert _max_abs(ours, ref) <= TOL


def _convbn_train(k, seed):
    """ConvBN in training mode against JAX's with train=True: the output
    and the new running statistics."""
    mod = ConvBN(12, 20, k).train()
    sd = _randomize(mod, seed)
    params, stats = _convbn(KeyAccountant(sd), "m")
    x = _input(seed + 1, 2, 7, 9, 12) * 2 + 0.5
    ours = mod(torch.from_numpy(x))
    ref, upd = JaxConvBN(20, k).apply({"params": params, "batch_stats": stats},
                                      jnp.asarray(x), train=True, mutable=["batch_stats"])
    assert _max_abs(ours, ref) <= TOL
    new = upd["batch_stats"]["norm"]
    assert _stats_close(mod.bn.running_mean, new["mean"])
    assert _stats_close(mod.bn.running_var, new["var"])


def test_training_mode_is_not_ported():
    """Training mode, which the first slice left out, is ported now: ConvBN
    normalises with batch statistics and updates its running ones as flax
    does (biased variance, momentum 0.9 in flax's convention)."""
    _convbn_train(3, seed=20)


@pytest.mark.parametrize("k", [1, 3])
def test_convbn_train_matches_jax(k):
    _convbn_train(k, seed=21)


def test_dwconv_ff_train_matches_jax():
    c = 16
    mod = PreNormDWConvFF(c).train()
    sd = _randomize(mod, 22)
    params, stats = _dwconv_ff(KeyAccountant(sd), "m")
    x = _input(23, 2, 6, 10, c)
    ours = mod(torch.from_numpy(x))
    ref, upd = JaxFF().apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                             train=True, mutable=["batch_stats"])
    assert _max_abs(ours, ref) <= TOL
    assert _stats_close(mod.bn2.running_mean, upd["batch_stats"]["bn2"]["mean"])
    assert _stats_close(mod.bn2.running_var, upd["batch_stats"]["bn2"]["var"])


def test_bn_freeze_scope():
    """In training mode inside the freeze scope a BatchNorm normalises with
    its running statistics and leaves them alone; outside it, not."""
    mod = ConvBN(6, 8, 3)
    _randomize(mod, 24)
    x = torch.from_numpy(_input(25, 2, 5, 5, 6))
    ref = mod.eval()(x)
    before = mod.bn.running_var.clone()
    mod.train()
    with tnn.bn_freeze_scope(mod, lambda path: path[0] == "bn"):
        assert torch.equal(mod(x), ref)
    with tnn.bn_freeze_scope(mod, tnn.encoder_only):  # no encoder here: not frozen
        assert not torch.equal(mod(x), ref)
    assert not mod.bn.frozen and not torch.equal(mod.bn.running_var, before)


def test_window_helpers():
    x = _input(11, 2, 8, 12, 5)
    w = window.window_partition(torch.from_numpy(x), 4)
    assert _max_abs(w, jax_window.window_partition(jnp.asarray(x), 4)) == 0
    assert torch.equal(window.window_reverse(w, 4, 8, 12), torch.from_numpy(x))
    for s in (0, 2, 3):
        assert _max_abs(window.cyclic_shift(torch.from_numpy(x), s),
                        jax_window.cyclic_shift(jnp.asarray(x), s)) == 0
    assert _max_abs(window.shifted_window_attn_mask(14, 21, 7, 3),
                    jax_window.shifted_window_attn_mask(14, 21, 7, 3)) == 0


@pytest.mark.parametrize("mode", ["edge", "zeros"])
def test_pad(mode):
    x = _input(12, 2, 5, 7, 3)
    assert _max_abs(pad.pad2d(torch.from_numpy(x), 1, 2, 3, 0, mode),
                    jax_pad.pad2d(jnp.asarray(x), 1, 2, 3, 0, mode)) == 0
    assert _max_abs(pad.pad_to_multiple(torch.from_numpy(x), 4, mode),
                    jax_pad.pad_to_multiple(jnp.asarray(x), 4, mode)) == 0


def test_quantize_logit():
    logit = np.concatenate([np.linspace(-15, 15, 301), [-40.0, 40.0]]).astype(np.float32)
    logit = logit.reshape(1, 1, -1, 1)
    ours = _quantize_logit(torch.from_numpy(logit), 128)
    ref = np.asarray(jax_quantize(jnp.asarray(logit), 128))
    assert ours.dtype == torch.int32 and np.array_equal(ours.numpy(), ref)
    assert ours.min() == 0 and ours.max() == 127  # -1 clamps to 0


def test_resize_and_gelu():
    x = _input(13, 2, 5, 7, 3)
    assert _max_abs(resize.resize_bilinear(torch.from_numpy(x), (9, 4)),
                    jax_resize.resize_bilinear(jnp.asarray(x), (9, 4))) <= 1e-5
    assert _max_abs(resize.upsample2d(torch.from_numpy(x), 4),
                    jax_resize.upsample2d(jnp.asarray(x), 4)) <= 1e-5
    assert _max_abs(tnn.gelu(torch.from_numpy(x)), jax_tnn.gelu(jnp.asarray(x))) <= 1e-6


def test_port_imports_no_jax():
    code = ("import sys, mde_tpu_torch, mde_tpu_torch.models, mde_tpu_torch.serve, "
            "mde_tpu_torch.convert, mde_tpu_torch.train.step, mde_tpu_torch.train.optim, "
            "mde_tpu_torch.train.loss, mde_tpu_torch.core.metrics, mde_tpu_torch.core.config, "
            "mde_tpu_torch.core.averages, mde_tpu_torch.core.dist, "
            "mde_tpu_torch.core.checkpoint, mde_tpu_torch.data.splits, mde_tpu_torch.data.png, "
            "mde_tpu_torch.data.dataset, mde_tpu_torch.data.augment, "
            "mde_tpu_torch.data.loader, mde_tpu_torch.utils.wandb_utils, "
            "mde_tpu_torch.utils.visualize, mde_tpu_torch.train.driver, "
            "mde_tpu_torch.models.newcrfs, mde_tpu_torch.ops.reduction, "
            "mde_tpu_torch.models.oda2.red_order_reg, mde_tpu_torch.models.oda2.red_order_swin, "
            "mde_tpu_torch.models.oda2.red_reg, mde_tpu_torch.models.oda2.conv, "
            "mde_tpu_torch.models.oda2.base, mde_tpu_torch.models.efficientnet, "
            "mde_tpu_torch.models.adabins.model, mde_tpu_torch.models.depthformer.layers, "
            "mde_tpu_torch.models.depthformer.model, mde_tpu_torch.models.depthformer.versions, "
            "mde_tpu_torch.ops.luna, mde_tpu_torch.models.depthformer.luna_versions, "
            "mde_tpu_torch.models.oda.encoder, mde_tpu_torch.models.oda.decoders, "
            "mde_tpu_torch.models.oda.models, mde_tpu_torch.ops.ppm, "
            "mde_tpu_torch.models.oda.lion, mde_tpu_torch.models.oda.lime, "
            "mde_tpu_torch.models.oda.jeju, mde_tpu_torch.ops.resize\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
            "'optax', 'orbax', 'mde_tpu')]\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_port_reads_only_the_split_lists_of_the_jax_package():
    """The only place the port's source names a path under ``mde_tpu/`` is
    the split lists' directory, ``mde_tpu/data/train_test_inputs``."""
    import ast
    import pathlib
    import mde_tpu_torch
    from mde_tpu_torch.data import splits
    root = pathlib.Path(mde_tpu_torch.__file__).parent
    named = []
    for path in sorted(root.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and (node.value == "mde_tpu" or node.value.startswith(("mde_tpu/",
                                                                          "mde_tpu\\")))):
                named.append((path.relative_to(root).as_posix(), node.lineno))
    want = [("data/splits.py", n) for p, n in named if p == "data/splits.py"]
    # the wandb project's name is no path
    assert [n for n in named if n[0] != "utils/wandb_utils.py"] == want and len(want) == 1
    repo = pathlib.Path(__file__).resolve().parents[1]
    assert pathlib.Path(splits.VENDORED_SPLIT_DIR) == repo / "mde_tpu" / "data" / "train_test_inputs"
    assert splits.load_split("NYU", "test")


def test_build_model_defaults_to_cuda():
    from mde_tpu_torch.models import build_model, resolve_device
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model({"name": "oda2_red_order_swin2"}, 0.001, 80.0)
    with pytest.raises(ValueError, match="Unknown model 'oda_lions'"):
        build_model({"name": "oda_lions"}, 0.001, 80.0, device="cpu")
    # every name of the JAX registry is ported
    from mde_tpu.models import available_models as jax_models
    from mde_tpu_torch.models import available_models
    assert available_models() == jax_models() and len(available_models()) == 27
