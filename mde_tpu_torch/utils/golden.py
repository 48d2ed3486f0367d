"""Golden-image regression (``mde_tpu/utils/golden.py``): compare
prediction PNGs against fixtures, pairing files by their path under the
golden tree. PNGs are read with the port's codec (``data/png.py``); the
card's machine has no Pillow.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..data.png import read_png


def compare_png_dirs(pred_dir: str, golden_dir: str, tolerance: float = 0.0,
                     names: Optional[list] = None) -> Dict[str, dict]:
    """Compare same-named PNGs in two trees.

    Returns {relpath: {"max_abs_diff": float, "shape_match": bool,
    "pass": bool}} for every PNG under ``golden_dir`` (or just ``names``).
    Missing predictions and shapes that differ report ``pass=False`` with
    ``max_abs_diff=inf``."""
    report: Dict[str, dict] = {}
    for root, _, files in os.walk(golden_dir):
        for f in sorted(files):
            if not f.endswith(".png"):
                continue
            rel = os.path.relpath(os.path.join(root, f), golden_dir)
            if names is not None and rel not in names and f not in names:
                continue
            gold = read_png(os.path.join(root, f)).astype(np.float64)
            pred_path = os.path.join(pred_dir, rel)
            if not os.path.exists(pred_path):
                report[rel] = {"max_abs_diff": float("inf"), "shape_match": False,
                               "pass": False}
                continue
            pred = read_png(pred_path).astype(np.float64)
            if pred.shape != gold.shape:
                report[rel] = {"max_abs_diff": float("inf"), "shape_match": False,
                               "pass": False}
                continue
            d = float(np.max(np.abs(pred - gold))) if gold.size else 0.0
            report[rel] = {"max_abs_diff": d, "shape_match": True, "pass": d <= tolerance}
    return report


def summarize(report: Dict[str, dict]) -> str:
    lines = []
    for rel, r in sorted(report.items()):
        status = "OK " if r["pass"] else "FAIL"
        lines.append(f"{status} {rel}: max|d|={r['max_abs_diff']:g}")
    n_pass = sum(r["pass"] for r in report.values())
    lines.append(f"{n_pass}/{len(report)} golden files match")
    return "\n".join(lines)
