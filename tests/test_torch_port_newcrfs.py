"""The port's NewCRFs (``newcrfs``) against the JAX package's, in f32 on the CPU.

- ``pixel_shuffle`` / ``pixel_unshuffle`` and ``GroupNorm`` (against flax's,
  512 channels in 256 groups on a 1x1 map, each group's two values far
  apart) at 1e-4.
- The zero-padded Swin of NewCRFs at 57x90 (not a multiple of the patch or
  the window at any stage) with ``frozen_stages`` 2: outputs and the
  gradients of a weighted sum of them at 1e-4.
- K1's q|k + separate-v entry: the plain forward against
  ``fused_window_attention(..., impl="pallas_interpret")`` and its dqk, dv
  and dbias (the autograd Function's plain backward) against ``jax.vjp``
  of it, with and without the SW-MSA mask, at 1e-5 of the larger of 1 and
  the reference's largest magnitude.
- ``CRFWindowAttention``, ``CRFBlock`` (shift 0 and 3, at maps that are
  not window multiples), ``NewCRF`` (with and without its projections),
  ``PSP`` (eval, and training with its new running statistics),
  ``UPerHead`` (both ``use_norm`` variants) and ``convex_upsample_4x``
  against the JAX modules at 1e-4; the attention's dropout path against
  the same computation with the port's own dropout mask.
- The tiny ``NewCRFDepth`` of ``tests/test_newcrfs.py`` (``custom04``),
  bilinear and mask upsampling, against the jitted JAX model at 1e-5 of
  ``max_depth``, weights through ``from_jax_variables``.
- A ``tiny07`` port ``state_dict()`` through the JAX package's
  ``convert_newcrfs_model``: every name and shape of the JAX model's tree.
- ``serve.Predictor`` on the tiny model at batch 2 (the model returns one
  tensor, not a tuple).

Each JAX module's variables are seeded numpy values; they reach the port
through ``from_jax_variables``, placed where ``NewCRFDepth`` holds that
module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import flax.linen as flax_nn

from mde_tpu.core.checkpoint import convert_newcrfs_model
from mde_tpu.models import swin as jax_swin
from mde_tpu.models.newcrfs import layers as jax_layers
from mde_tpu.models.newcrfs import model as jax_model
from mde_tpu.models.newcrfs.uper import UPerHead as JaxUPerHead
from mde_tpu.ops.pallas.window_attention import fused_window_attention
from mde_tpu.ops.pixel_shuffle import pixel_shuffle as jax_shuffle
from mde_tpu.ops.pixel_shuffle import pixel_unshuffle as jax_unshuffle
from mde_tpu.ops.window import shifted_window_attn_mask as jax_mask
from mde_tpu_torch.convert import from_jax_variables
from mde_tpu_torch.models import build_model
from mde_tpu_torch.models.newcrfs import UPerHead
from mde_tpu_torch.models.newcrfs.layers import CRFBlock, CRFWindowAttention, NewCRF
from mde_tpu_torch.models.newcrfs.model import PSP, NewCRFDepth, convex_upsample_4x
from mde_tpu_torch.models.swin import SwinTransformer
from mde_tpu_torch.ops.kernels.window_attention import window_attention_qk_v
from mde_tpu_torch.ops.pixel_shuffle import pixel_shuffle, pixel_unshuffle
from mde_tpu_torch.ops.resize import resize_bilinear
from mde_tpu_torch.ops.tnn import GroupNorm
from mde_tpu_torch.serve import Predictor
from _torch_port_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
KERNEL_TOL = 1e-5
MAX_DEPTH = 10.0
# the tiny model of tests/test_newcrfs.py
TINY = dict(version="custom04", encoder_kwargs=dict(
    embed_dim=8, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8),
    in_channels=(8, 16, 32, 64), crf_dims=(8, 16, 32, 64)))
CFG = dict(name="newcrfs", version=TINY["version"])


def _np(a) -> np.ndarray:
    a = a.detach().cpu().float().numpy() if torch.is_tensor(a) else np.asarray(a)
    return a.astype(np.float64)


def _max_abs(a, b) -> float:
    return float(np.max(np.abs(_np(a) - _np(b))))


def _rel(a, b) -> float:
    """max |a - b| over max(1, max |b|)."""
    return _max_abs(a, b) / max(1.0, float(np.max(np.abs(_np(b)))))


def _random_vars(module, *args, seed: int, **kwargs):
    """The JAX module's own variable tree (from tracing its init), filled
    with seeded numpy values at scales that keep activations O(1)."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name, shape = getattr(path[-1], "key", ""), s.shape
        if name == "kernel":
            fan = np.prod(shape[:3]) if len(shape) == 4 else shape[-2]
            v = rng.randn(*shape) / np.sqrt(fan)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "scale":
            v = 1 + 0.1 * rng.randn(*shape)
        elif name == "relative_position_bias_table":
            v = 0.5 * rng.randn(*shape)
        else:
            v = 0.1 * rng.randn(*shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _load(port_module, variables, where, prefix):
    """Load the JAX ``variables`` of a module into ``port_module``: the tree
    goes through ``from_jax_variables`` placed at ``where`` in
    ``NewCRFDepth``'s tree, and the port names under ``prefix`` are kept.
    The module is left in eval mode."""
    def nest(tree):
        for key in reversed(where):
            tree = {key: tree}
        return tree

    params = nest(dict(variables["params"]))
    if where[0] != "crf0":  # the converter tells the tree by its CRF stages
        params["crf0"] = {"norm_crf": {"scale": np.ones(1, np.float32)}}
    state = from_jax_variables({"params": params,
                                "batch_stats": nest(dict(variables.get("batch_stats", {})))})
    state = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    port_module.load_state_dict(state)
    return port_module.eval()


@pytest.mark.parametrize("unshuffle", [False, True])
def test_pixel_shuffle_matches_jax(unshuffle):
    x = np.random.RandomState(0).randn(2, 6, 10, 16).astype(np.float32)
    fn, ref = (pixel_unshuffle, jax_unshuffle) if unshuffle else (pixel_shuffle, jax_shuffle)
    out = fn(torch.from_numpy(x), 2)
    assert out.shape == ref(jnp.asarray(x), 2).shape
    assert _max_abs(out, ref(jnp.asarray(x), 2)) == 0.0
    assert torch.equal((pixel_shuffle if unshuffle else pixel_unshuffle)(out, 2),
                       torch.from_numpy(x))


# the PSP's scale-1 norm (512 channels in 256 groups on a 1x1 map: two
# values a group, far apart), and a map of 32 groups of 2
@pytest.mark.parametrize("shape,groups", [((2, 1, 1, 512), 256), ((2, 3, 5, 64), 32)])
def test_group_norm_matches_flax(shape, groups):
    rng = np.random.RandomState(1)
    x = (3 * rng.randn(*shape) + 1).astype(np.float32)
    gn = flax_nn.GroupNorm(num_groups=groups, epsilon=1e-5)
    variables = {"params": {"scale": (1 + 0.1 * rng.randn(shape[-1])).astype(np.float32),
                            "bias": (0.1 * rng.randn(shape[-1])).astype(np.float32)}}
    ref = gn.apply(variables, jnp.asarray(x))
    port = GroupNorm(groups, shape[-1])
    port.load_state_dict({"weight": torch.from_numpy(variables["params"]["scale"]),
                          "bias": torch.from_numpy(variables["params"]["bias"])})
    assert _max_abs(port(torch.from_numpy(x)), ref) <= TOL
    assert float(np.abs(np.asarray(ref)).min()) < 10  # normalised, not a passed-through 0


def test_zero_padded_swin_with_frozen_stages_matches_jax():
    """NewCRFs' Swin variant at 57x90: zeros pad the image to patches (15x23
    tokens), odd maps before a merge (15x23, 8x12) and every token map to
    7x7 windows; ``frozen_stages`` 2 stops the gradient after the patch
    embedding and stage 0."""
    enc = dict(embed_dim=8, depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 4), window_size=7,
               path_drop_prob=0.0, frozen_stages=2)
    x = np.random.RandomState(2).rand(2, 57, 90, 3).astype(np.float32)
    model = jax_swin.SwinTransformer(padding_mode="zeros", **enc)
    variables = _random_vars(model, jnp.asarray(x[:1]), seed=3)
    weights = [np.random.RandomState(4 + i).randn(*s).astype(np.float32)
               for i, s in enumerate([(2, 15, 23, 8), (2, 8, 12, 16), (2, 4, 6, 32),
                                      (2, 2, 3, 64)])]

    def loss(params, images):
        outs = model.apply({"params": params}, images)
        return sum((o * w).sum() for o, w in zip(outs, weights)), outs

    (_, ref_outs), ref_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"], jnp.asarray(x))
    port = _load(SwinTransformer(padding_mode="zeros", **enc), variables, ("backbone",),
                 "backbone.")
    outs = port(torch.from_numpy(x))
    assert [tuple(o.shape) for o in outs] == [w.shape for w in weights]
    for o, r in zip(outs, ref_outs):
        assert _max_abs(o, r) <= TOL
    sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, weights)).backward()
    ref = _load(SwinTransformer(padding_mode="zeros", **enc), {"params": ref_grads},
                ("backbone",), "backbone.")
    frozen = 0
    for (name, p), (_, g) in zip(port.named_parameters(), ref.named_parameters()):
        if name.startswith(("patch_embed.", "layers.0.")):
            assert p.grad is None and float(g.abs().max()) == 0.0, name
            frozen += 1
        else:
            assert _rel(p.grad, g) <= TOL, name
    assert frozen > 0


def _qk_v_case(with_mask, seed=5):
    r, images, nh, c = 7, 2, 2, 32
    h, w = 2 * r, 3 * r
    nw = (h // r) * (w // r)
    rng = np.random.RandomState(seed)
    qk = rng.randn(images * nw, r * r, 2 * c).astype(np.float32)
    v, g = (rng.randn(images * nw, r * r, c).astype(np.float32) for _ in range(2))
    bias = rng.randn(nh, r * r, r * r).astype(np.float32)
    mask = np.array(jax_mask(h, w, r, r // 2)) if with_mask else None
    return qk, v, g, bias, mask, nh, (c // nh) ** -0.5


def _jax_qk_v(qk, v, bias, mask, nh, scale):
    c = v.shape[-1]
    return fused_window_attention(qk[..., :c], qk[..., c:], v, bias, mask, nh, scale,
                                  impl="pallas_interpret")


@pytest.mark.parametrize("with_mask", [False, True])
def test_window_attention_qk_v_forward_matches_pallas(with_mask):
    qk, v, _, bias, mask, nh, scale = _qk_v_case(with_mask)
    out = window_attention_qk_v(torch.from_numpy(qk), torch.from_numpy(v),
                                torch.from_numpy(bias),
                                None if mask is None else torch.from_numpy(mask), nh, scale)
    ref = _jax_qk_v(jnp.asarray(qk), jnp.asarray(v), jnp.asarray(bias),
                    None if mask is None else jnp.asarray(mask), nh, scale)
    assert out.shape == v.shape
    assert _rel(out, ref) <= KERNEL_TOL


@pytest.mark.parametrize("with_mask", [False, True])
def test_window_attention_qk_v_grads_match_pallas(with_mask):
    qk, v, g, bias, mask, nh, scale = _qk_v_case(with_mask, seed=6)
    tqk, tv, tb = (torch.from_numpy(a).requires_grad_() for a in (qk, v, bias))
    window_attention_qk_v(tqk, tv, tb, None if mask is None else torch.from_numpy(mask), nh,
                          scale).backward(torch.from_numpy(g))
    m = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda a, b, c: _jax_qk_v(a, b, c, m, nh, scale),
                     jnp.asarray(qk), jnp.asarray(v), jnp.asarray(bias))
    for name, ours, ref in zip(("dqk", "dv", "dbias"), (tqk.grad, tv.grad, tb.grad),
                               vjp(jnp.asarray(g))):
        assert ours.shape == ref.shape, name
        assert _rel(ours, ref) <= KERNEL_TOL, (name, _rel(ours, ref))


@pytest.mark.parametrize("shifted", [False, True])
def test_crf_window_attention_matches_jax(shifted):
    r, nh, c = 7, 2, 16
    h, w = 2 * r, 2 * r
    bw = 2 * (h // r) * (w // r)
    rng = np.random.RandomState(7)
    x, v = (rng.randn(bw, r * r, c).astype(np.float32) for _ in range(2))
    mask = np.array(jax_mask(h, w, r, 3)) if shifted else None
    module = jax_layers.CRFWindowAttention(num_heads=nh, window_size=r)
    args = (jnp.asarray(x), jnp.asarray(v), None if mask is None else jnp.asarray(mask))
    variables = _random_vars(module, *args, seed=8)
    ref = module.apply(variables, *args)
    port = _load(CRFWindowAttention(c, nh, r), variables, ("crf0", "blocks0", "attn"),
                 "crf0.crf_layer.blocks.0.attn.")
    out = port(torch.from_numpy(x), torch.from_numpy(v),
               None if mask is None else torch.from_numpy(mask))
    assert _max_abs(out, ref) <= TOL


def test_crf_window_attention_dropout_path():
    """In training with attention dropout the port takes the einsum path, as
    JAX does: it gives the fused path's probabilities, dropped by the
    port's own keep mask and rescaled, times v."""
    r, nh, c, bw = 7, 2, 16, 4
    rng = np.random.RandomState(9)
    x, v = (torch.from_numpy(rng.randn(bw, r * r, c).astype(np.float32)) for _ in range(2))
    port = CRFWindowAttention(c, nh, r, attn_drop_prob=0.25)
    torch.nn.init.normal_(port.relative_position_bias_table, std=0.5)
    port.train()
    out = port(x, v, None, torch.Generator().manual_seed(3))
    keep = torch.rand((bw, nh, r * r, r * r), generator=torch.Generator().manual_seed(3)) >= 0.25
    q, k = port.qk(x).reshape(bw, r * r, 2, nh, c // nh).unbind(2)
    bias = port.relative_position_bias_table[port.relative_position_index]
    bias = bias.reshape(r * r, r * r, nh).permute(2, 0, 1)
    p = (torch.einsum("bqhd,bkhd->bhqk", q * (c // nh) ** -0.5, k) + bias).softmax(-1)
    p = torch.where(keep, p / 0.75, torch.zeros(()))
    ref = port.proj(torch.einsum("bhqk,bkhd->bqhd", p, v.reshape(bw, r * r, nh, c // nh))
                    .reshape(bw, r * r, c))
    assert _max_abs(out, ref) <= 1e-5
    port.eval()
    assert _max_abs(port(x, v), port(x, v)) == 0.0


# (map, shift): not window multiples, so x and v are zero-padded (with the
# mask built on the padded grid); v taller than x by one row, as a shuffled
# coarser stage is where a Swin stage had an odd map
@pytest.mark.parametrize("hw,v_hw,shift", [((9, 12), (9, 12), 0), ((9, 12), (9, 12), 3),
                                           ((15, 23), (16, 24), 3)])
def test_crf_block_matches_jax(hw, v_hw, shift):
    c, nh = 16, 2
    rng = np.random.RandomState(10)
    x = rng.randn(2, *hw, c).astype(np.float32)
    v = rng.randn(2, *v_hw, c).astype(np.float32)
    module = jax_layers.CRFBlock(num_heads=nh, window_size=7, shift_size=shift)
    variables = _random_vars(module, jnp.asarray(x), jnp.asarray(v), seed=11)
    ref = module.apply(variables, jnp.asarray(x), jnp.asarray(v))
    port = _load(CRFBlock(c, nh, 7, shift), variables, ("crf0", "blocks0"),
                 "crf0.crf_layer.blocks.0.")
    assert _max_abs(port(torch.from_numpy(x), torch.from_numpy(v)), ref) <= TOL


# (x channels, v channels): both projected, neither
@pytest.mark.parametrize("in_dim,v_dim", [(12, 4), (16, 16)])
def test_new_crf_matches_jax(in_dim, v_dim):
    rng = np.random.RandomState(12)
    x = rng.randn(2, 8, 12, in_dim).astype(np.float32)
    v = rng.randn(2, 8, 12, v_dim).astype(np.float32)
    module = jax_layers.NewCRF(embed_dim=16, num_heads=2)
    variables = _random_vars(module, jnp.asarray(x), jnp.asarray(v), seed=13)
    ref = module.apply(variables, jnp.asarray(x), jnp.asarray(v))
    port = _load(NewCRF(in_dim, v_dim, 16, 2), variables, ("crf0",), "crf0.")
    assert (port.proj_x is None) == (in_dim == 16) and (port.proj_v is None) == (v_dim == 16)
    assert _max_abs(port(torch.from_numpy(x), torch.from_numpy(v)), ref) <= TOL


@pytest.mark.parametrize("train", [False, True])
def test_psp_matches_jax(train):
    """Eval with the seeded running statistics; training with batch
    statistics over 4 images, 2x3 maps pooled to 1, 2, 3 and 6 (and the
    running statistics it leaves)."""
    rng = np.random.RandomState(14)
    x = (rng.randn(4, 2, 3, 24) + rng.randn(4, 1, 1, 24)).astype(np.float32)
    module = jax_model.PSP(channels=16)
    variables = _random_vars(module, jnp.asarray(x), seed=15)
    port = _load(PSP(24, 16), variables, ("decoder",), "decoder.")
    if train:
        ref, new = module.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        port.train()
    else:
        ref = module.apply(variables, jnp.asarray(x))
    assert _max_abs(port(torch.from_numpy(x)), ref) <= TOL
    if train:
        stats = _load(PSP(24, 16), {"params": variables["params"], **new}, ("decoder",),
                      "decoder.").state_dict()
        for name, value in port.state_dict().items():
            if "running" in name:
                assert _max_abs(value, stats[name]) <= 1e-5, name


def _uper_to_port(variables):
    """UPerHead's JAX names -> the port's (``lateral{i}_conv`` ->
    ``lateral_convs.{i}.conv``, ``fpn0_*`` -> ``fpn_convs.0.*``), with the
    port's layouts."""
    out = {}
    for coll, tree in variables.items():
        for name, leaves in tree.items():
            i, kind = name[len("lateral"):].split("_") if name.startswith("lateral") else \
                ("0", name.split("_")[1])
            head = f"lateral_convs.{i}" if name.startswith("lateral") else "fpn_convs.0"
            for leaf, value in leaves.items():
                key = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
                       "var": "running_var"}.get(leaf, leaf)
                value = np.asarray(value)
                if leaf == "kernel":
                    value = value.transpose(3, 2, 0, 1)
                out[f"{head}.{kind}.{key}"] = torch.from_numpy(value.copy())
                if leaf == "mean":
                    out[f"{head}.{kind}.num_batches_tracked"] = torch.tensor(0)
    return out


@pytest.mark.parametrize("use_norm", [False, True])
def test_uper_head_matches_jax(use_norm):
    rng = np.random.RandomState(16)
    feats = [rng.randn(2, 16 // s, 24 // s, 8 * s).astype(np.float32) for s in (1, 2, 4, 8)]
    module = JaxUPerHead(channels=16, use_norm=use_norm)
    variables = _random_vars(module, [jnp.asarray(f) for f in feats], seed=17)
    ref = module.apply(variables, [jnp.asarray(f) for f in feats])
    port = UPerHead([8, 16, 32, 64], channels=16, use_norm=use_norm).eval()
    port.load_state_dict(_uper_to_port(variables))
    out = port([torch.from_numpy(f) for f in feats])
    assert out.shape == (2, 16, 24, 16)
    assert _max_abs(out, ref) <= TOL


def test_convex_upsample_matches_jax():
    rng = np.random.RandomState(18)
    disp = rng.rand(2, 5, 7, 1).astype(np.float32)
    mask = (2 * rng.randn(2, 5, 7, 144)).astype(np.float32)
    ref = jax_model.convex_upsample_4x(jnp.asarray(disp), jnp.asarray(mask))
    out = convex_upsample_4x(torch.from_numpy(disp), torch.from_numpy(mask))
    assert out.shape == (2, 20, 28, 1)
    assert _max_abs(out, ref) <= TOL


@pytest.fixture(scope="module", params=["bilinear", "mask"])
def tiny(request):
    """(up_mode, JAX variables, images, the jitted JAX model's depth)."""
    model = jax_model.NewCRFDepth(min_depth=0.001, max_depth=MAX_DEPTH,
                                  up_mode=request.param, **TINY)
    x = np.random.RandomState(19).rand(2, 64, 96, 3).astype(np.float32)
    variables = _random_vars(model, jnp.asarray(x[:1]), seed=20)
    ref = jax.jit(lambda v, images: model.apply(v, images))(variables, jnp.asarray(x))
    return request.param, variables, x, np.asarray(ref)


def _port_tiny(up_mode, variables=None):
    model = build_model(dict(CFG, up_mode=up_mode), 0.001, MAX_DEPTH, device="cpu",
                        encoder_kwargs=TINY["encoder_kwargs"])
    if variables is not None:
        model.load_state_dict(from_jax_variables(variables))
    return model


def test_tiny_newcrfs_forward_matches_jax(tiny):
    up_mode, variables, x, ref = tiny
    model = _port_tiny(up_mode, variables)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert torch.is_tensor(out) and out.shape == ref.shape == (2, 64, 96, 1)
    assert _max_abs(out, ref) <= 1e-5 * MAX_DEPTH
    assert 0.0 <= float(out.min()) and float(out.max()) <= MAX_DEPTH


def test_predictor_serves_a_single_tensor_model_at_batch_2(tiny):
    """``Predictor`` takes the map a model returns alone (NewCRFs), at batch
    2, where unpacking a tuple would split the batch."""
    up_mode, variables, x, ref = tiny
    pred = Predictor(_port_tiny(up_mode, variables)).predict(x[:, :62, :90])
    model = _port_tiny(up_mode, variables)
    with torch.no_grad():
        want = resize_bilinear(model(torch.from_numpy(x[:, :62, :90])), (62, 90),
                               align_corners=True).clamp_min(0.0)
    assert pred.shape == (2, 62, 90, 1)
    assert torch.equal(pred, want)


def test_tiny07_state_dict_converts_to_the_jax_tree():
    """A ``tiny07`` port (Swin-T, the fixed CRF widths) ``state_dict``
    through ``convert_newcrfs_model``: the JAX model's every name and shape.
    Built on the meta device: only names and shapes are compared."""
    with torch.device("meta"):
        port = NewCRFDepth(version="tiny07")
    state = {k: np.broadcast_to(np.float32(0), tuple(v.shape))
             for k, v in port.state_dict().items() if not k.endswith("num_batches_tracked")}
    converted = convert_newcrfs_model(state, version="tiny07")
    model = jax_model.NewCRFDepth(version="tiny07")
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 64, 96, 3))))

    def flat(tree):
        return {"/".join(str(getattr(p, "key", p)) for p in path): tuple(np.shape(leaf))
                for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}

    want = flat({k: shapes[k] for k in ("params", "batch_stats")})
    assert flat(converted) == want
    assert len(want) > 250


def test_newcrfs_build_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model({"name": "newcrfs", "version": "large07"}, 0.001, 80.0)
