"""Model registry of the port (``mde_tpu/models/__init__.py``).

``build_model(opt, min_depth, max_depth)`` builds the model that the
config's ``model.name`` names, with weights drawn from ``seed``, in eval
mode (the train step switches it to training), on the card unless
``device`` asks for another. Keyword overrides go to the model's
constructor: ``dtype``, ``use_checkpoint`` (recompute blocks in the
backward pass), ``path_drop_prob`` (the encoder's stochastic depth).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..ops.init import init_weights
from .oda2.ksa import ODA2KSARegModel
from .oda2.red_order_swin2 import ODA2OrderedSwin2RegModel

_REGISTRY = {"oda2_red_order_swin2": ODA2OrderedSwin2RegModel, "oda2_ksa_reg": ODA2KSARegModel}


def available_models():
    return sorted(_REGISTRY)


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means CUDA; raise when CUDA is asked for and missing."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; the port runs on the card unless the "
                           "caller asks for the CPU (device='cpu')")
    return device


def build_model(opt, min_depth: float, max_depth: float,
                device: Optional[Union[str, torch.device]] = None, seed: int = 0,
                **overrides) -> torch.nn.Module:
    """opt is the full config or its ``model`` section."""
    device = resolve_device(device)
    model_opt = opt["model"] if "model" in opt else opt
    name = model_opt["name"]
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"Model {name!r} is not ported yet (ported: {available_models()}); "
            f"see ROADMAP.md Queue 1 for the order of the rest")
    model = _REGISTRY[name].build(model_opt, min_depth, max_depth, **overrides)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
