"""Carry weights from the JAX package into the port.

``from_jax_variables`` turns the JAX flagship's ``{'params',
'batch_stats'}`` tree (arrays of any kind numpy can read) into the port's
``state_dict``: the inverse of ``mde_tpu.core.checkpoint``'s torch -> flax
converters, written without importing the JAX package.

Layouts: dense (in, out) -> (out, in); conv HWIO -> OIHW; depthwise
(kh, kw, C) -> (C, 1, kh, kw); flax BN scale/bias/mean/var ->
weight/bias/running_mean/running_var; LN scale -> weight. Swin stages of
even depth are stored ``nn.scan``-stacked under ``blocks/blk0|blk1`` with a
leading pair axis: pair p becomes blocks 2p and 2p+1.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

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


def _rename(path: Path, num_repeats: int, output_scale: int, convbn: bool) -> str:
    segs = []
    for seg in path[:-1]:
        if re.fullmatch(r"layers\d+", seg):
            seg = f"layers.{seg[6:]}"
        elif m := re.fullmatch(r"enc_conv(\d+)_res", seg):
            seg = f"enc_res{m.group(1)}"
        elif m := re.fullmatch(r"enc_conv(\d+)_(\d+)", seg):
            seg = f"enc_conv{m.group(1)}.{m.group(2)}"
        elif re.fullmatch(r"enc_conv\d+", seg):
            seg = f"{seg}.0"  # segformer: a plain conv inside a Sequential
        elif m := re.fullmatch(r"conv(\d+)_(\d+|out)", seg):
            i = int(m.group(1))
            off = 1 if (i == num_repeats and output_scale == 2) else 0
            j = 2 if m.group(2) == "out" else int(m.group(2))
            seg = f"conv_layers.{i}.{j + off}"
        elif m := re.fullmatch(r"attn(\d+)", seg):
            seg = f"attn_layers.{m.group(1)}"
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


def from_jax_variables(variables: Mapping, output_scale: int = 4) -> Dict[str, torch.Tensor]:
    """JAX ``ODA2OrderedSwin2RegModel`` variables -> the port's state dict
    (load it with ``model.load_state_dict``, which checks every name and
    shape). ``output_scale`` must be the model's: at 2 the last conv head
    starts with a parameter-free upsample that shifts its indices."""
    params = _flatten(variables["params"])
    stats = _flatten(variables.get("batch_stats", {}))
    if any("repeat" in path for path in list(params) + list(stats)):
        raise ValueError("the head is in the nn.scan layout (params under repeat/); "
                         "convert it to the unrolled layout first with "
                         "mde_tpu.core.checkpoint.migrate_head_layout(variables, "
                         "to_scan=False)")
    params, stats = _unstack_blocks(params), _unstack_blocks(stats)
    num_repeats = max((int(m.group(1)) for path in params for seg in path
                       if (m := re.fullmatch(r"conv(\d+)_out", seg))), default=0)
    out: Dict[str, torch.Tensor] = {}
    for flat in (params, stats):
        for path, arr in flat.items():
            convbn = path[:-2] + ("conv", "kernel") in params
            name = _rename(path, num_repeats, output_scale, convbn)
            out[name] = torch.from_numpy(np.array(_leaf(path, arr), dtype=np.float32))
            if path[-1] == "mean":
                out[name[:-len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return out
