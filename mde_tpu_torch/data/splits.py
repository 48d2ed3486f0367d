"""Dataset constants and split-file handling (``mde_tpu/data/splits.py``).

Per-dataset constants mirror the reference ``DepthDataset`` switch
(``dataset/depth_dataset.py:47-157``): KITTI (Eigen split), NYU Depth v2 and
ONLINE (KITTI benchmark), each with min/max depth, PNG saving factor, default
train/test sizes, rotation degree and KB-crop behavior.

Split files are the reference's own txt lists (format: ``img gt [focal]``).
They are data, not code, and are not copied into the port: it reads the
lists vendored beside the JAX package (``mde_tpu/data/train_test_inputs``)
by path, found from this file's place in the repository, and imports nothing
of that package. ``MDE_SPLIT_DIR`` overrides the location and
``MDE_NYU_TRAIN_LIST`` picks the NYU train list, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

# <repo>/mde_tpu/data/train_test_inputs, from <repo>/mde_tpu_torch/data/splits.py
VENDORED_SPLIT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "mde_tpu", "data", "train_test_inputs")

# NYU train list: the reference ships 24k and 36k variants and hardcodes 36k
# (24k commented out, ``dataset/depth_dataset.py:78-79``); MDE_NYU_TRAIN_LIST
# = "24k" selects the smaller one.
_NYU_TRAIN = f"NYU/nyu_train_{os.environ.get('MDE_NYU_TRAIN_LIST', '36k')}.txt"

_SPLIT_FILES = {
    ("KITTI", "train"): "KITTI/kitti_eigen_train.txt",
    ("KITTI", "test"): "KITTI/kitti_eigen_test.txt",
    ("ONLINE", "train"): "KITTI/kitti_benchmark_train.txt",
    ("ONLINE", "test"): "KITTI/kitti_benchmark_val.txt",
    ("ONLINE", "benchmark"): "KITTI/kitti_benchmark_test.txt",
    ("NYU", "train"): _NYU_TRAIN,
    ("NYU", "test"): "NYU/nyu_test.txt",
}

NYU_DEFAULT_FOCAL = 518.8579  # reference depth_dataset.py:172


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    data_type: str
    mode: str
    height: int
    width: int
    min_depth: float
    max_depth: float
    saving_factor: float
    do_kb_crop: bool
    do_random_rotate: bool
    degree: float
    img_subdir: str  # joined onto data_path for images
    gt_subdir: str   # joined onto data_path for GT depth


def dataset_spec(data_type: str, mode: str,
                 img_size: Optional[Tuple[int, int]] = None) -> DatasetSpec:
    data_type = data_type.upper()
    mode = mode.lower()
    if mode not in ("train", "test", "benchmark"):
        raise ValueError(f"Unsupported mode {mode}.")
    if data_type not in ("KITTI", "NYU", "ONLINE"):
        raise ValueError(f"Unsupported data_type {data_type}.")
    if mode == "benchmark" and data_type != "ONLINE":
        raise ValueError("Benchmark should only run with ONLINE data type.")

    if data_type == "KITTI":
        size = (352, 704) if mode == "train" else (376, 1241)
        return DatasetSpec(
            data_type, mode, *(img_size or size), 0.001, 80.0, 256.0,
            do_kb_crop=True, do_random_rotate=mode == "train", degree=1.0,
            img_subdir="raw", gt_subdir="gts")
    if data_type == "NYU":
        size = (480, 640)
        return DatasetSpec(
            data_type, mode, *(img_size or size), 0.001, 10.0, 1000.0,
            do_kb_crop=False, do_random_rotate=mode == "train", degree=2.5,
            img_subdir="", gt_subdir="")
    # ONLINE
    size = (352, 704) if mode == "train" else (376, 1241)
    sub = ("raw", "gts") if mode == "train" else ("", "")
    return DatasetSpec(
        data_type, mode, *(img_size or size), 0.001, 88.0, 256.0,
        do_kb_crop=True, do_random_rotate=mode == "train", degree=1.0,
        img_subdir=sub[0], gt_subdir=sub[1])


def find_split_dir() -> Optional[str]:
    """``MDE_SPLIT_DIR`` (read at each call) where it names a directory, else
    the vendored lists."""
    for d in (os.environ.get("MDE_SPLIT_DIR", ""), VENDORED_SPLIT_DIR):
        if d and os.path.isdir(d):
            return d
    return None


def parse_split_line(line: str, data_type: str):
    """-> (image_rel, depth_rel, focal). NYU train lines carry a leading '/'
    (stripped, reference ``:176-179``); KITTI lines carry focal in col 3."""
    parts = line.strip().split()
    img = parts[0].lstrip("/")
    depth = parts[1].lstrip("/") if len(parts) > 1 else ""
    if data_type.upper() == "KITTI" and len(parts) > 2:
        focal = float(parts[2])
    else:
        focal = NYU_DEFAULT_FOCAL
    return img, depth, focal


def load_split(data_type: str, mode: str,
               split_dir: Optional[str] = None) -> List[str]:
    split_dir = split_dir or find_split_dir()
    if split_dir is None:
        return []
    rel = _SPLIT_FILES[(data_type.upper(), mode.lower())]
    path = os.path.join(split_dir, rel)
    if not os.path.isfile(path):
        return []
    with open(path) as f:
        return [l for l in (ln.strip() for ln in f) if l]


def check_split(data_type: str, mode: str, data_path: str,
                split_dir: Optional[str] = None) -> Tuple[int, int]:
    """Integrity check: (#found, #missing) — port of the reference
    ``dataset/*_check_dataset.py`` scripts."""
    spec = dataset_spec(data_type, mode)
    lines = load_split(data_type, mode, split_dir)
    found = missing = 0
    for line in lines:
        img, depth, _ = parse_split_line(line, data_type)
        ip = os.path.join(data_path, spec.img_subdir, img)
        ok = os.path.isfile(ip)
        if depth and mode != "benchmark":
            dp = os.path.join(data_path, spec.gt_subdir, depth)
            ok = ok and os.path.isfile(dp)
        if ok:
            found += 1
        else:
            missing += 1
    return found, missing
