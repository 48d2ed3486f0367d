"""What every run shares: finding a cell's files by name, building the
program under test, the device's description and the guard against the
JAX package.

Everything that belongs to one configuration, traffic mix, cell or
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:
``configs/<config>.json``, ``traffic/<mix>.json``,
``workloads/<cell>.json``, ``metrics/<metric>.py`` (or the file of the
part of the name before its first dot), ``work/<module>.py``, and the
driver of a traffic mix's ``mode`` in ``modes/<mode>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Tuple

import torch

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# top-level module names that no run may load: JAX and the JAX package
BANNED = ("jax", "jaxlib", "flax", "mde_tpu")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def load_json(kind: str, name: str) -> dict:
    with open(ROOT / kind / f"{name}.json") as f:
        return json.load(f)


def manifest() -> dict:
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


_LOADED: Dict[Path, ModuleType] = {}


def load_module(kind: str, name: str) -> ModuleType:
    """``<ROOT>/<kind>/<name>.py`` as the module ``benchmark.<kind>.<name>``
    (a name may hold dots), loaded once."""
    path = ROOT / kind / f"{name}.py"
    if path not in _LOADED:
        if not path.exists():
            raise FileNotFoundError(f"no {kind} named {name!r}: {path} is missing")
        spec = importlib.util.spec_from_file_location(f"{__package__}.{kind}.{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _LOADED[path] = module
    return _LOADED[path]


def metric_reader(name: str) -> ModuleType:
    """The reader of a per-layer metric: ``metrics/<name>.py``, else the file
    of the part of the name before its first dot."""
    if (ROOT / "metrics" / f"{name}.py").exists():
        return load_module("metrics", name)
    return load_module("metrics", name.split(".")[0])


def cell_metrics(section: str, cell: str) -> List[dict]:
    """The metrics of ``BENCHMARK.json``'s ``section`` that ``cell`` reports."""
    return [m for m in manifest()[section] if cell in m.get("workloads", [cell])]


def template(model: torch.nn.Module) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """(shape, dtype) of each entry of a model's state dict."""
    return {k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items()}


def program_options(config: dict) -> dict:
    """The configuration's sections as the program's config takes them."""
    return {k: config[k] for k in ("model", "loss", "optimizer", "scheduler", "train")}


def build_program(config: dict, device) -> torch.nn.Module:
    """The program's model of ``config`` on ``device``, its recompute policy
    set (the program reads it from the environment at each call)."""
    os.environ["MDE_REMAT_POLICY"] = config["remat_policy"]
    from mde_tpu_torch.models import build_model
    model = {k: v for k, v in config["model"].items() if k != "path_drop_prob"}
    extra = {"encoder_kwargs": model["encoder_kwargs"]} if "encoder_kwargs" in model else {}
    return build_model({"model": model}, config["min_depth"], config["max_depth"],
                       device=device, dtype=DTYPES[config["dtype"]],
                       use_checkpoint=config["use_checkpoint"], **extra)


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(n for n in sys.modules if n.split(".")[0] in BANNED)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def require_cards(count: int) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < count:
        raise SystemExit(f"the cell needs {count} cards; {torch.cuda.device_count()} found")
