"""Carry weights from the JAX package into the port.

``from_jax_variables`` turns the ``{'params', 'batch_stats'}`` tree of a
JAX model the port has (arrays of any kind numpy can read) into the port's
``state_dict``: the inverse of the JAX package's torch -> flax converters
(``convert_oda2_red_order_swin2``, ``convert_oda2_ksa_decoder``,
``convert_newcrfs_model``, ``convert_oda2_red_order_decoder``,
``convert_oda2_red_order_swin_decoder``, ``convert_oda2_red_decoder``,
``convert_oda2_conv_decoder``, ``convert_oda2_luna_decoder``,
``convert_oda2_red_luna_decoder``, ``convert_adabins_model`` with
``convert_efficientnet_b5``, ``convert_depthformer_v2_decoder``,
``convert_depthformer_v4_decoder``, ``convert_depthformer_luna_decoder``,
``convert_oda_conv_decoder``, ``convert_oda_luna_decoder``,
``convert_oda_lion_decoder``, ``convert_oda_lime_decoder``,
``convert_oda_jeju_decoder``; Depthformer v1
and v3, which have none, on their pattern; the ODA encoder as the Swin
backbones, without output norms; the ODA heads as AdaBins'), written
without importing the JAX package.

Layouts: dense (in, out) -> (out, in); conv HWIO -> OIHW; depthwise
(kh, kw, C) -> (C, 1, kh, kw); flax BN scale/bias/mean/var ->
weight/bias/running_mean/running_var; LN and GroupNorm scale -> weight;
flax's multi-head attention (per-head q, k, v and out kernels) -> torch's
packed ``in_proj_weight``, ``in_proj_bias`` and ``out_proj``. Swin stages of
even depth are stored ``nn.scan``-stacked under ``blocks/blk0|blk1`` with a
leading pair axis: pair p becomes blocks 2p and 2p+1.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]


def _flatten(tree: Mapping, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    out: Dict[Path, np.ndarray] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(_flatten(value, prefix + (str(key),)))
        else:
            out[prefix + (str(key),)] = np.asarray(value)
    return out


def _unstack_blocks(flat: Dict[Path, np.ndarray]) -> Dict[Path, np.ndarray]:
    """blocks/blk{t}/... with a leading pair axis -> blocks/{2p+t}/...;
    blocks{j}/... -> blocks/{j}/..."""
    out: Dict[Path, np.ndarray] = {}
    for path, arr in flat.items():
        i = next((i for i, seg in enumerate(path) if re.fullmatch(r"blocks\d*", seg)), None)
        if i is None:
            out[path] = arr
        elif path[i] == "blocks":  # blocks/blk{t}: a stacked pair axis
            t = int(path[i + 1][len("blk"):])
            for p in range(arr.shape[0]):
                out[path[:i] + ("blocks", str(2 * p + t)) + path[i + 2:]] = arr[p]
        else:
            out[path[:i] + ("blocks", path[i][len("blocks"):]) + path[i + 1:]] = arr
    return out


def _flagship_segment(seg: str, num_repeats: int, output_scale: int) -> str:
    """A decoder segment of the flagship's tree in the port's names."""
    if m := re.fullmatch(r"enc_conv(\d+)_res", seg):
        return f"enc_res{m.group(1)}"
    if m := re.fullmatch(r"enc_conv(\d+)_(\d+)", seg):
        return f"enc_conv{m.group(1)}.{m.group(2)}"
    if re.fullmatch(r"enc_conv\d+", seg):
        return f"{seg}.0"  # segformer: a plain conv inside a Sequential
    if m := re.fullmatch(r"conv(\d+)_(\d+|out)", seg):
        i = int(m.group(1))
        off = 1 if (i == num_repeats and output_scale == 2) else 0
        j = 2 if m.group(2) == "out" else int(m.group(2))
        return f"conv_layers.{i}.{j + off}"
    if m := re.fullmatch(r"attn(\d+)", seg):
        return f"attn_layers.{m.group(1)}"
    return seg


def _ppm_segment(seg: str) -> str:
    """A segment of the V2 pyramid pooling module's tree in the port's names."""
    if m := re.fullmatch(r"reduce(\d+)_(conv|bn)", seg):
        return f"conv_reduce_layers.{m.group(1)}.{0 if m.group(2) == 'conv' else 1}"
    return {"out_conv": "conv.0", "out_bn": "conv.1"}.get(seg, seg)


def _ksa_segment(seg: str, parent: str) -> str:
    """A decoder segment of ``oda2_ksa_reg``'s tree in the port's names."""
    if m := re.fullmatch(r"layers(\d+)_blocks(\d+)", seg):
        return f"layers.{m.group(1)}.blocks.{m.group(2)}"
    if m := re.fullmatch(r"layers(\d+)_up", seg):
        return f"layers.{m.group(1)}.upsample"
    return _ppm_segment(seg) if parent == "ppm32" else seg


def _sibling_segment(seg: str, parent: str) -> str:
    """A decoder segment of the ODA2 siblings' trees (``oda2_red_order_reg``
    and ``_cls``, ``oda2_red_order_swin``, ``oda2_red_reg``, ``oda2_conv``,
    ``oda2_luna_reg`` and ``_cls``, ``oda2_red_luna_reg``) in the port's
    names: their necks' modules sit at the decoder's top level ("" drops
    the ``neck`` segment); ``de_ff{0,1}`` and a gate's ``luna/ff{0,1}`` are
    the reference's ``de_ff.{0,3}`` and ``ff.{0,3}``, ``bins{0,1}``
    ``bins.{0,2}``; red-Luna's ``layers{i}_{luna1,ff_aux,luna2,ff}`` its
    ``layers.{i}.*``; ``out_conv{j}``, ``block2_out`` and ``block4_out``
    Sequential slots; the conv decoder's ``block{L}_2`` follows the upsample
    at index 2; the head's ``conv{i}_{j}`` and ``attn{i}`` as the
    flagship's."""
    if seg == "neck":
        return ""
    if parent == "ppm":
        return _ppm_segment(seg)
    if m := re.fullmatch(r"(de_)?ff(\d)", seg):
        if m.group(1) or parent == "luna":
            return f"{m.group(1) or ''}ff.{3 * int(m.group(2))}"
    if m := re.fullmatch(r"bins(\d)", seg):
        return f"bins.{2 * int(m.group(1))}"
    if m := re.fullmatch(r"layers(\d+)_(luna1|luna2|ff_aux|ff)", seg):
        return f"layers.{m.group(1)}.{m.group(2)}"
    if m := re.fullmatch(r"out_conv(\d)", seg):
        return f"out_conv.{m.group(1)}"
    if m := re.fullmatch(r"block(\d+)_(\d|out)", seg):
        j = 1 if m.group(2) == "out" else int(m.group(2))
        return f"block{m.group(1)}.{3 if j == 2 else j}"
    return _flagship_segment(seg, num_repeats=0, output_scale=4)


def _is_newcrfs(paths) -> bool:
    """Whether a tree is ``NewCRFDepth``'s: it has CRF stages ``crf0``.."""
    return any(p[0] == "crf0" for p in paths)


def _newcrfs_path(path: Path) -> Path:
    """A path of ``NewCRFDepth``'s tree (blocks unstacked) in the port's
    segments: the PSP's ``pool{i}_{conv,gn,bn}`` and ``bottleneck_{conv,bn}``,
    the CRF blocks under ``crf_layer``, the disparity and mask heads."""
    head, rest = path[0], path[1:]
    if head == "decoder":
        if m := re.fullmatch(r"pool(\d+)_(conv|gn|bn)", rest[0]):
            return ("decoder", "psp_modules", m.group(1), "1", m.group(2)) + rest[1:]
        if m := re.fullmatch(r"bottleneck_(conv|bn)", rest[0]):
            return ("decoder", "bottleneck", m.group(1)) + rest[1:]
    if re.fullmatch(r"crf\d+", head) and rest[0] == "blocks":
        return (head, "crf_layer") + rest
    if head == "disp_head1_conv":
        return ("disp_head1", "conv1") + rest
    if m := re.fullmatch(r"mask_head_conv(\d)", head):  # Sequential(conv, ReLU, conv)
        return ("mask_head", str(2 * int(m.group(1)))) + rest
    return path


def _rename(path: Path, segment: Callable[[str, str], str], convbn: bool) -> str:
    segs = []
    for parent, seg in zip(("",) + path[:-2], path[:-1]):
        if re.fullmatch(r"layers\d+", seg):
            seg = f"layers.{seg[6:]}"
        elif path[0] == "decoder":
            seg = segment(seg, parent)
        if seg:
            segs.append(seg)
    if convbn and segs and segs[-1] == "norm":
        segs[-1] = "bn"
    leaf = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
            "var": "running_var"}.get(path[-1], path[-1])
    return ".".join(segs + [leaf])


def _leaf(path: Path, arr: np.ndarray) -> np.ndarray:
    if path[-1] == "depth_bins":  # the reference's NCHW broadcast shape
        return arr.reshape(1, -1, 1, 1)
    if path[-1] == "position_embedding" and arr.ndim == 4:  # Depthformer v7's, NCHW
        return arr.transpose(0, 3, 1, 2)
    if path[-1] != "kernel":
        return arr
    if arr.ndim == 2:
        return arr.T
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 3:
        return arr.transpose(2, 0, 1)[:, None]
    raise ValueError(f"{'/'.join(path)}: unexpected kernel of shape {arr.shape}")


def _is_ksa(paths) -> bool:
    """Whether a tree is ``ODA2KSARegModel``'s: its decoder holds a
    ``ppm32`` or ``layers{i}_blocks{j}`` / ``layers{i}_up``, segments the
    flagship's decoder never has."""
    return any(len(p) > 1 and p[0] == "decoder"
               and re.fullmatch(r"ppm32|layers\d+_(blocks\d+|up)", p[1]) for p in paths)


def _is_sibling(paths) -> bool:
    """Whether a tree is one of the ODA2 siblings': its decoder holds a
    ``neck`` (the reduction decoders), a ``ppm`` (``oda2_conv``, the Luna
    decoders), a gate ``block{L}_gate`` (the Luna decoders), or
    ``aux_linear1`` or ``luna`` (red-Luna), which the flagship's and the
    KSA decoder's never do."""
    return any(len(p) > 1 and p[0] == "decoder"
               and re.fullmatch(r"neck|ppm|aux_linear1|luna|block\d+_gate", p[1])
               for p in paths)


def _is_efficientnet(paths) -> bool:
    """Whether a tree is AdaBins' or a Depthformer's: an EfficientNet
    encoder (``encoder/conv_stem``)."""
    return any(p[:2] == ("encoder", "conv_stem") for p in paths)


# Depthformer decoder segments {name}{i} -> the reference's list {list}.{i}
_DF_LISTS = {"post_conv": "post_conv_layers", "vit": "vit_layers", "vit_bn": "vit_bn_layers",
             "patchify": "patchify_layers", "position_embeddings": "position_embeddings",
             "q_proj": "q_projections", "k_proj": "k_projections", "v_proj": "v_projections",
             "post_cls": "post_cls_layers", "post_cls_ln": "post_cls_ln",
             "post_weight": "post_weight_layers", "luna": "luna_layers",
             "shoot": "shoot_layers", "aux_vit": "aux_layers"}


def _merge_mha(flat: Dict[Path, np.ndarray]) -> Dict[Path, np.ndarray]:
    """flax ``MultiHeadDotProductAttention`` leaves (``self_attn/{query,
    key,value}`` kernels (E, heads, hd) and biases (heads, hd), ``out``
    (heads, hd, E)) -> torch's packed ``in_proj_weight`` (3E, E) and
    ``in_proj_bias``, and ``out_proj`` as a (in, out) dense."""
    out: Dict[Path, np.ndarray] = {}
    for path, arr in flat.items():
        if len(path) < 3 or path[-3] != "self_attn" or path[-2] not in (
                "query", "key", "value", "out"):
            out[path] = arr
        elif path[-2] == "out":
            out[path[:-2] + ("out_proj", path[-1])] = (
                arr.reshape(-1, arr.shape[-1]) if path[-1] == "kernel" else arr)
        elif path[-2] == "query":
            base = path[:-2]
            parts = [flat[base + (n, path[-1])] for n in ("query", "key", "value")]
            if path[-1] == "kernel":
                out[base + ("in_proj_weight",)] = np.concatenate(
                    [w.reshape(w.shape[0], -1).T for w in parts])
            else:
                out[base + ("in_proj_bias",)] = np.concatenate([b.reshape(-1) for b in parts])
    return out


def _efficientnet_path(path: Path, final_last: bool, luna: int = 0) -> Path:
    """A path of AdaBins' or a Depthformer's tree in the port's segments:
    the encoder under ``encoder.original_model`` with ``blocks{s}_{b}`` as
    ``blocks.{s}.{b}``, its ``_BN`` wrappers' ``bn`` dropped and the raw
    ``conv_dw`` weight as a kernel; AdaBins' ``up{u}/{conv,bn}{i}`` as
    ``_net.{0,1,3,4}``, ``layer{i}`` as ``transformer_encoder.layers.{i}``;
    ``regressor{i}`` as ``regressor.{2i}``; the Depthformer decoders'
    ``{name}{i}`` as their lists' ``{list}.{i}``, ``layers{j}`` as
    ``layers.{j}``, ``cls_to_weight{i}_{j}`` as
    ``cls_to_weight_layers.{i}.{0,3}``, and their heads as ``final_block``:
    ``final{i}`` (v1), ``final_res`` (v4) at 1, ``final_out`` at 2 where
    ``final_last``, else at 0. The Luna decoders (``luna``: the version,
    6-8, else 0): ``luna{i}``, ``shoot{i}`` and ``aux_vit{i}`` as
    ``{luna,shoot,aux}_layers.{i}``, ``post_conv{i}_{j}`` as
    ``post_conv_layers.{i}`` (v6: ``.{j}``), ``bin_regressor{0,1,_out}`` as
    ``bin_regressor.{0,2,4}`` (v8: ``{0,3,6}``) and ``bin_pred{0,1,_out}``
    as ``bin_predictor.{0,1}``, the out conv last."""
    if path[0] == "encoder":
        out = ["encoder", "original_model"]
        for parent, seg in zip(path, path[1:]):
            if m := re.fullmatch(r"blocks(\d+)_(\d+)", seg):
                out += ["blocks", m.group(1), m.group(2)]
            elif not (seg == "bn" and re.fullmatch(r"bn\d", parent)):
                out.append(seg)
        return tuple(out + ["kernel"] if out[-1] == "conv_dw" else out)
    out = [path[0]]
    for parent, seg in zip(path, path[1:]):
        if (m := re.fullmatch(r"(conv|bn)(\d)", seg)) and re.fullmatch(r"up\d", parent):
            out += ["_net", str(3 * int(m.group(2)) + (m.group(1) == "bn"))]
        elif m := re.fullmatch(r"post_conv(\d+)_(\d+)", seg):
            out += ["post_conv_layers", m.group(1)] + ([m.group(2)] if luna == 6 else [])
        elif m := re.fullmatch(r"bin_regressor(\d|_out)", seg):
            k = 2 if m.group(1) == "_out" else int(m.group(1))
            out += ["bin_regressor", str(k * (3 if luna == 8 else 2))]
        elif m := re.fullmatch(r"bin_pred(\d|_out)", seg):
            out += ["bin_predictor", str((2 if luna == 8 else 1) if m.group(1) == "_out"
                                         else int(m.group(1)))]
        elif m := re.fullmatch(r"layer(\d+)", seg):
            out += ["transformer_encoder", "layers", m.group(1)]
        elif m := re.fullmatch(r"regressor(\d)", seg):
            out += ["regressor", str(2 * int(m.group(1)))]
        elif m := re.fullmatch(r"cls_to_weight(\d)_(\d)", seg):
            out += ["cls_to_weight_layers", m.group(1), str(3 * int(m.group(2)))]
        elif (m := re.fullmatch(r"([a-z_]+?)(\d+)", seg)) and m.group(1) in _DF_LISTS:
            out += [_DF_LISTS[m.group(1)], m.group(2)]
        elif m := re.fullmatch(r"layers(\d+)", seg):
            out += ["layers", m.group(1)]
        elif m := re.fullmatch(r"final(\d)", seg):
            out += ["final_block", m.group(1)]
        elif seg in ("final_res", "final_out"):
            out += ["final_block", "1" if seg == "final_res" else "2" if final_last else "0"]
        else:
            out.append(seg)
    return tuple(out)


def _is_oda(paths) -> bool:
    """Whether a tree is an ODA model's: its encoder wraps the Swin as
    ``encoder/backbone``."""
    return any(p[:2] == ("encoder", "backbone") for p in paths)


# the conv FFs' segments (Lion's, Jeju's, Lime's conv block) -> their slots
_CONV_FF = {"conv1": ("conv1", "0"), "bn1": ("conv1", "1"), "conv2": ("conv2", "0"),
            "bn2": ("conv2", "1"), "conv3": ("conv3", "0"), "bn3": ("conv3", "1"),
            "se0": ("se", "0"), "se1": ("se", "2")}
# Lime's stem segments -> their slots
_LIME_STEM = {"stem_conv0": ("stem_conv", "0"), "stem_bn0": ("stem_conv", "1"),
              "stem_conv1": ("stem_conv", "3"), "stem_bn1": ("stem_conv", "4"),
              "stem_enc_norm": ("stem_enc", "0"), "stem_enc_linear": ("stem_enc", "1")}


def _oda_segment(parent: str, seg: str) -> Tuple[str, ...]:
    """A decoder segment of an ODA model's tree in the port's segments:
    the conv and Luna decoders' ``block{L}_{0,1,2}`` as ``block{L}.{0,1,3}``
    (slot 2 the upsample), ``block2_out`` as ``block2.1``,
    ``block{L}_post`` as ``block{L}_post.1`` (slot 0 the upsample); the
    PPMs' ``reduce{i}[_conv]`` as ``conv_reduce_layers.{i}``, gen-1's
    ``out_conv``, ``out_bn`` as ``conv``, ``bn``; Lion's, Lime's and Jeju's
    ``out_conv{j}`` as ``out_conv.{j}``, their conv FFs' ``conv{j}``,
    ``bn{j}``, ``se{j}`` as ``conv{j}.{0,1}``, ``se.{0,2}``; Lion's
    ``out_norm`` and ``out_bn`` as ``out`` and ``out.0``; Lime's stem as
    ``stem_conv.{0,1,3,4}`` and ``stem_enc.{0,1}``, ``layers{i}_{conv,attn}``
    as ``layers.{i}.{conv,attn}``; Jeju's ``jeju{L}`` and ``jeju{L}_ff`` as
    ``jeju{L}.jeju_attn`` and ``.jeju_ff``, ``up{L}`` as
    ``hidden_{L}to{L/2}`` (its BatchNorm ``bn`` as ``norm.0``),
    ``aux_up{L}`` as ``aux_{L}to{L/2}``."""
    if parent == "ppm" and (m := re.fullmatch(r"reduce(\d+)(_conv)?", seg)):
        return ("conv_reduce_layers", m.group(1))
    if parent == "ppm" and seg in ("out_conv", "out_bn"):
        return (seg[len("out_"):],)
    if m := re.fullmatch(r"block(\d+)_(\d|out)", seg):
        j = 1 if m.group(2) == "out" else int(m.group(2))
        return (f"block{m.group(1)}", str(3 if j == 2 else j))
    if re.fullmatch(r"block\d+_post", seg):
        return (seg, "1")
    if parent == "decoder" and (m := re.fullmatch(r"out_conv(\d)", seg)):
        return ("out_conv", m.group(1))
    if seg in _CONV_FF and re.fullmatch(r"feed_forward_[hw]|jeju\d+_ff|layers\d+_conv", parent):
        return _CONV_FF[seg]
    if re.fullmatch(r"lion\d+", parent) and seg in ("out_norm", "out_bn"):
        return ("out",) if seg == "out_norm" else ("out", "0")
    if seg in _LIME_STEM:
        return _LIME_STEM[seg]
    if m := re.fullmatch(r"layers(\d+)_(conv|attn)", seg):
        return ("layers", m.group(1), m.group(2))
    if m := re.fullmatch(r"jeju(\d+)(_ff)?", seg):
        return (f"jeju{m.group(1)}", "jeju_ff" if m.group(2) else "jeju_attn")
    if m := re.fullmatch(r"(aux_)?up(\d+)", seg):
        level = int(m.group(2))
        return (f"{'aux' if m.group(1) else 'hidden'}_{level}to{level // 2}",)
    if re.fullmatch(r"up\d+", parent) and seg == "bn":
        return ("norm", "0")
    return (seg,)


def _oda_path(path: Path) -> Path:
    """A path of an ODA model's tree (blocks unstacked) in the port's
    segments: the decoder's as ``_oda_segment`` maps them; the cls head's
    ``bin_regressor{i}`` as ``bin_regressor.{2i}``; mViT as AdaBins'
    (``_efficientnet_path``)."""
    if path[0] == "encoder":
        return path
    if m := re.fullmatch(r"bin_regressor(\d)", path[0]):  # the cls head's
        return ("bin_regressor", str(2 * int(m.group(1)))) + path[1:]
    if path[0] != "decoder":
        return _efficientnet_path(path, False)
    out = ["decoder"]
    for parent, seg in zip(path, path[1:]):
        out += _oda_segment(parent, seg)
    return tuple(out)


def _luna_version(paths) -> int:
    """The Depthformer Luna decoder's version told by its segments (6:
    ``luna_final``, 7: ``aux_lst_ln``, 8: ``aux_layer``), else 0."""
    segs = {p[1] for p in paths if len(p) > 1 and p[0] == "decoder"}
    return next((v for v, seg in ((6, "luna_final"), (7, "aux_lst_ln"), (8, "aux_layer"))
                 if seg in segs), 0)


def _family(paths) -> str:
    if _is_efficientnet(paths):
        return "efficientnet"
    if _is_oda(paths):
        return "oda"
    if _is_newcrfs(paths):
        return "newcrfs"
    if _is_ksa(paths):
        return "ksa"
    return "sibling" if _is_sibling(paths) else "flagship"


def from_jax_variables(variables: Mapping, output_scale: int = 4) -> Dict[str, torch.Tensor]:
    """JAX model variables -> the port's state dict (load it with
    ``model.load_state_dict``, which checks every name and shape).

    The tree's layout is told from its segments: an EfficientNet encoder's
    stem (AdaBins, Depthformer), the ODA encoder's ``backbone``, the KSA
    decoder's, the CRF stages', the siblings' ``neck`` or ``ppm``, else the
    flagship's. ``output_scale``
    must be the flagship's: at 2 its last conv head starts with a
    parameter-free upsample that shifts its indices."""
    params = _flatten(variables["params"])
    stats = _flatten(variables.get("batch_stats", {}))
    paths = list(params) + list(stats)
    family = _family(paths)
    if family in ("newcrfs", "efficientnet", "oda"):
        def segment(seg, parent):
            return seg
    elif family == "ksa":
        segment = _ksa_segment
    elif family == "sibling":
        segment = _sibling_segment
    else:
        if any("repeat" in path for path in paths):
            raise ValueError("the head is in the nn.scan layout (params under repeat/); "
                             "convert it to the unrolled layout first with "
                             "mde_tpu.core.checkpoint.migrate_head_layout(variables, "
                             "to_scan=False)")
        num_repeats = max((int(m.group(1)) for path in params for seg in path
                           if (m := re.fullmatch(r"conv(\d+)_out", seg))), default=0)

        def segment(seg, parent):
            return _flagship_segment(seg, num_repeats, output_scale)
    if family == "efficientnet":
        final_last = any(len(p) > 1 and p[0] == "decoder"
                         and re.fullmatch(r"final\d|final_res", p[1]) for p in paths)
        luna = _luna_version(paths)
        params = {_efficientnet_path(p, final_last, luna): a
                  for p, a in _merge_mha(params).items()}
        stats = {_efficientnet_path(p, final_last, luna): a for p, a in stats.items()}
    elif family == "oda":
        params = {_oda_path(p): a for p, a in _unstack_blocks(_merge_mha(params)).items()}
        stats = {_oda_path(p): a for p, a in _unstack_blocks(stats).items()}
    else:
        params, stats = _unstack_blocks(params), _unstack_blocks(stats)
    if family == "newcrfs":
        params = {_newcrfs_path(p): a for p, a in params.items()}
        stats = {_newcrfs_path(p): a for p, a in stats.items()}
    out: Dict[str, torch.Tensor] = {}
    for flat in (params, stats):
        for path, arr in flat.items():
            # a ConvBN's norm is the reference's ``bn``; Jeju's upsampling
            # pairs its conv with an LN, which keeps the name ``norm``
            convbn = (path[:-2] + ("conv", "kernel") in params
                      and not any(re.fullmatch(r"hidden_\d+to\d+", seg) for seg in path[-3:-2]))
            name = _rename(path, segment, convbn)
            out[name] = torch.from_numpy(np.array(_leaf(path, arr), dtype=np.float32))
            if path[-1] == "mean":
                out[name[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return out
