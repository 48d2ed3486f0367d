"""Config layer of the port, a copy of ``mde_tpu/core/config.py`` (that
module imports no JAX, but the port imports nothing of the JAX package).

The reference drives every experiment from a flat JSON dict parsed by its
``utils/common_utils.py:34-52``. The same schema loads here unchanged, with
the same defaults, so one JSON file starts a JAX run and a port run alike.
``num_devices`` (from ``gpu_ids``) stays advisory: the port runs on one card.

Schema superset (reference ``json/kitti/oda2/oda2_red_order_swin2_neck_red33.json:1-73``):
    gpu_ids, output_dir, checkpoint, wandb{...}, model{name,...}, loss{...},
    dataset{data_type,...}, dataloader{...}, optimizer{...}, scheduler{...},
    train{...}, eval{...}
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping


class Config(dict):
    """A dict with attribute access and recursive wrapping.

    Mirrors the reference's plain-dict config access patterns
    (``opt["model"]["name"]``, ``opt.get(...)``) while also allowing
    ``opt.model.name`` for brevity.
    """

    def __init__(self, data: Mapping[str, Any] | None = None, **kwargs):
        super().__init__()
        data = dict(data or {})
        data.update(kwargs)
        for key, value in data.items():
            self[key] = value

    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, Mapping) and not isinstance(value, Config):
            value = Config(value)
        super().__setitem__(key, value)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def to_dict(self) -> dict:
        out = {}
        for key, value in self.items():
            out[key] = value.to_dict() if isinstance(value, Config) else value
        return out


# Per-section defaults applied on load. Only keys that some reference configs
# omit get defaults; values follow the most common reference settings.
_DEFAULTS = {
    "checkpoint": "",
    "output_dir": "./output/test",
    "gpu_ids": [0],
}

_MODEL_DEFAULTS = {
    # oda2_red_order_swin2 optional keys (reference build(): oda2_red_order_swin2.py:98-116)
    "window_size": 8,
    "output_scale": 4,
    "drop_prob": 0.0,
    "attn_drop_prob": 0.0,
    "bias_type": "depth",
    "bias_init": "linear",
    "neck_type": "red",
    "bn_momentum": 0.1,
    "bn_eps": 1.0e-5,
}

_TRAIN_DEFAULTS = {
    "print_freq": 25,
    "valid_freq": 250,
    "epoch": 24,
    "num_accum": 1,
    "grad_norm": 0.1,
    "freeze_encoder_bn": False,
    "freeze_all_bn": -1,
}

_EVAL_DEFAULTS = {
    "garg_crop": False,
    "eigen_crop": False,
    "flip_eval": False,
}

_LOSS_DEFAULTS = {
    "alpha": 10.0,
    "beta": 0.15,
    "per_image": True,
    "chamfer_weight": 0.0,
    "si_weight": 1.0,
    "sog_weight": 0.0,
    "oda_weight": 0.0,
}

_DATASET_DEFAULTS = {
    "img_size": None,
    "height_drop": [0.0, 0],
    "width_drop": [0.0, 0],
    "drop_edge": False,
    "use_right": False,
    "clip_depth": False,
}

_OPTIMIZER_DEFAULTS = {
    "betas": [0.9, 0.999],
    "eps": 1.0e-6,
    "weight_decay": 0.0,
    "same_lr": True,
}

_SCHEDULER_DEFAULTS = {
    "name": "onecycle",
    "pct_start": 0.25,
    "div_factor": 25,
    "final_div_factor": 100,
}


def _apply_defaults(section: Config, defaults: Mapping[str, Any]) -> None:
    for key, value in defaults.items():
        section.setdefault(key, value)


def load_config(data: Mapping[str, Any]) -> Config:
    """Wrap + default-fill a raw config mapping (already-parsed JSON)."""
    opt = Config(data)
    _apply_defaults(opt, _DEFAULTS)
    for section, defaults in (
        ("model", _MODEL_DEFAULTS),
        ("train", _TRAIN_DEFAULTS),
        ("eval", _EVAL_DEFAULTS),
        ("loss", _LOSS_DEFAULTS),
        ("dataset", _DATASET_DEFAULTS),
        ("optimizer", _OPTIMIZER_DEFAULTS),
        ("scheduler", _SCHEDULER_DEFAULTS),
    ):
        opt.setdefault(section, Config())
        _apply_defaults(opt[section], defaults)

    # Reference: num_gpus = len(gpu_ids) (common_utils.parse:38-43); advisory
    # here, as in the JAX package.
    opt["num_devices"] = max(1, len(opt.get("gpu_ids", [0])))
    return opt


def parse(json_path: str, dump_option: bool = True) -> Config:
    """Load an experiment JSON (reference ``common_utils.parse`` equivalent).

    Reads the JSON, fills defaults, creates ``output_dir`` and dumps the
    resolved config there as ``option.json`` (matching the reference's
    behavior of writing the parsed option next to run outputs).
    """
    with open(json_path, "r") as f:
        raw = json.load(f)
    opt = load_config(raw)

    if dump_option:
        out_dir = opt.get("output_dir", "")
        if out_dir:
            try:
                os.makedirs(out_dir, exist_ok=True)
                with open(os.path.join(out_dir, "option.json"), "w") as f:
                    json.dump(opt.to_dict(), f, indent=4)
            except OSError:
                pass  # read-only or unavailable output dir: non-fatal
    return opt
