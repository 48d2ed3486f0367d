"""Model registry of the port (``mde_tpu/models/__init__.py``).

``build_model(opt, min_depth, max_depth)`` builds the model that the
config's ``model.name`` names, with weights drawn from ``seed``, in eval
mode (the train step switches it to training), on the card unless
``device`` asks for another. Keyword overrides go to the model's
constructor: ``dtype``, and for the Swin models ``use_checkpoint``
(recompute blocks in the backward pass) and ``path_drop_prob`` (the
encoder's stochastic depth; the ODA models' is fixed at 0.1, as JAX's).
Every name the JAX registry holds is ported.
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import torch

from ..ops.init import init_weights, no_default_init
from .adabins.model import UnetAdaptiveBins
from .depthformer.model import Depthformer
from .depthformer.luna_versions import DepthformerLuna
from .depthformer.versions import DepthformerV2, DepthformerV3, DepthformerV4
from .newcrfs.model import NewCRFDepth
from .oda.jeju import ODAJejuModel
from .oda.lime import ODALimeModel
from .oda.lion import ODALionModel
from .oda.models import ODABinsModel, ODAConvModel, ODALunaModel
from .oda2.conv import ODA2ConvModel
from .oda2.ksa import ODA2KSARegModel
from .oda2.luna import ODA2LunaModel
from .oda2.red_order_reg import ODA2OrderedRegModel
from .oda2.red_order_swin import ODA2OrderedSwinModel
from .oda2.red_luna import ODA2RedLunaRegModel
from .oda2.red_order_swin2 import ODA2OrderedSwin2RegModel
from .oda2.red_reg import ODA2RedRegModel

# name -> build(model_opt, min_depth, max_depth, **overrides)
_REGISTRY = {"oda2_red_order_swin2": ODA2OrderedSwin2RegModel.build,
             "oda2_ksa_reg": ODA2KSARegModel.build, "newcrfs": NewCRFDepth.build,
             "oda2_red_order_reg": ODA2OrderedRegModel.build,
             "oda2_red_order_cls": functools.partial(ODA2OrderedRegModel.build, cls_head=True),
             "oda2_red_order_swin": ODA2OrderedSwinModel.build,
             "oda2_red_reg": ODA2RedRegModel.build, "oda2_conv": ODA2ConvModel.build,
             "oda2_luna_reg": ODA2LunaModel.build,
             "oda2_luna_cls": functools.partial(ODA2LunaModel.build, cls_head=True),
             "oda2_red_luna_reg": ODA2RedLunaRegModel.build,
             "adabins": UnetAdaptiveBins.build, "depthformer": Depthformer.build,
             "depthformer_v2": functools.partial(DepthformerV2.build, 2),
             "depthformer_v3": DepthformerV3.build, "depthformer_v4": DepthformerV4.build,
             "depthformer_v5": functools.partial(DepthformerV2.build, 5),
             **{f"depthformer_v{v}": functools.partial(DepthformerLuna.build, v)
                for v in (6, 7, 8)},
             "oda_conv": ODAConvModel.build, "oda_luna": ODALunaModel.build,
             "oda_luna_cls": functools.partial(ODALunaModel.build, cls_head=True),
             "oda_bins": ODABinsModel.build, "oda_lion": ODALionModel.build,
             "oda_lime": ODALimeModel.build, "oda_jeju": ODAJejuModel.build}


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
        raise ValueError(f"Unknown model {name!r}. Available: {available_models()}")
    with no_default_init():
        model = _REGISTRY[name](model_opt, min_depth, max_depth, **overrides)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
