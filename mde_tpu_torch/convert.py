"""Carry weights from the JAX package into the port.

``from_jax_variables`` turns the ``{'params', 'batch_stats'}`` tree of a
JAX model the port has (arrays of any kind numpy can read) into the port's
``state_dict``: the inverse of the JAX package's torch -> flax converters
(``convert_oda2_red_order_swin2``, ``convert_oda2_ksa_decoder``), written
without importing the JAX package.

Layouts: dense (in, out) -> (out, in); conv HWIO -> OIHW; depthwise
(kh, kw, C) -> (C, 1, kh, kw); flax BN scale/bias/mean/var ->
weight/bias/running_mean/running_var; LN scale -> weight. Swin stages of
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


def _ksa_segment(seg: str, parent: str) -> str:
    """A decoder segment of ``oda2_ksa_reg``'s tree in the port's names."""
    if m := re.fullmatch(r"layers(\d+)_blocks(\d+)", seg):
        return f"layers.{m.group(1)}.blocks.{m.group(2)}"
    if m := re.fullmatch(r"layers(\d+)_up", seg):
        return f"layers.{m.group(1)}.upsample"
    if parent == "ppm32":
        if m := re.fullmatch(r"reduce(\d+)_(conv|bn)", seg):
            return f"conv_reduce_layers.{m.group(1)}.{0 if m.group(2) == 'conv' else 1}"
        return {"out_conv": "conv.0", "out_bn": "conv.1"}.get(seg, seg)
    return seg


def _rename(path: Path, segment: Callable[[str, str], str], convbn: bool) -> str:
    segs = []
    for parent, seg in zip(("",) + path[:-2], path[:-1]):
        if re.fullmatch(r"layers\d+", seg):
            seg = f"layers.{seg[6:]}"
        elif path[0] == "decoder":
            seg = segment(seg, parent)
        segs.append(seg)
    if convbn and segs and segs[-1] == "norm":
        segs[-1] = "bn"
    leaf = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
            "var": "running_var"}.get(path[-1], path[-1])
    return ".".join(segs + [leaf])


def _leaf(path: Path, arr: np.ndarray) -> np.ndarray:
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


def from_jax_variables(variables: Mapping, output_scale: int = 4) -> Dict[str, torch.Tensor]:
    """JAX model variables -> the port's state dict (load it with
    ``model.load_state_dict``, which checks every name and shape).

    The tree is the flagship's ``ODA2OrderedSwin2RegModel`` or
    ``ODA2KSARegModel``, told apart by the KSA decoder's own segments.
    ``output_scale`` must be the flagship's: at 2 its last conv head starts
    with a parameter-free upsample that shifts its indices."""
    params = _flatten(variables["params"])
    stats = _flatten(variables.get("batch_stats", {}))
    if _is_ksa(list(params) + list(stats)):
        segment = _ksa_segment
    else:
        if any("repeat" in path for path in list(params) + list(stats)):
            raise ValueError("the head is in the nn.scan layout (params under repeat/); "
                             "convert it to the unrolled layout first with "
                             "mde_tpu.core.checkpoint.migrate_head_layout(variables, "
                             "to_scan=False)")
        num_repeats = max((int(m.group(1)) for path in params for seg in path
                           if (m := re.fullmatch(r"conv(\d+)_out", seg))), default=0)

        def segment(seg, parent):
            return _flagship_segment(seg, num_repeats, output_scale)
    params, stats = _unstack_blocks(params), _unstack_blocks(stats)
    out: Dict[str, torch.Tensor] = {}
    for flat in (params, stats):
        for path, arr in flat.items():
            convbn = path[:-2] + ("conv", "kernel") in params
            name = _rename(path, segment, convbn)
            out[name] = torch.from_numpy(np.array(_leaf(path, arr), dtype=np.float32))
            if path[-1] == "mean":
                out[name[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return out
