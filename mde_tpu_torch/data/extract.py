"""Dataset extraction and preparation (``mde_tpu/data/extract.py``), as
functions and a CLI (``python -m mde_tpu_torch.data.extract <cmd> ...``):

* ``extract_subset``: copy the image and ground-truth pairs a split file
  names out of the full corpus into a slim tree (reference
  ``dataset/extract_kitti.py``, ``extract_nyu.py``).
* ``convert_nyu_mat``: NYU Depth v2's official ``nyu_depth_v2_labeled.mat``
  into per-scene ``rgb_%05d.jpg`` / ``sync_depth_%05d.png`` trees with the
  official train/test split, depth as uint16 millimetres, a 7-pixel black
  border on the RGB (reference
  ``dataset/train_test_inputs/NYU/extract_official_train_test_set_from_mat.py``).
  It needs h5py, scipy and Pillow (for the JPEGs), imported inside it: a
  preparation step, not part of the runtime (the card's machine has none
  of the three).
* ``check``: the split-integrity walk (reference ``dataset/*_check_dataset.py``),
  over :func:`mde_tpu_torch.data.splits.check_split`.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional, Tuple

import numpy as np

from .png import write_png
from .splits import check_split, load_split, parse_split_line


def extract_subset(data_type: str, mode: str, src_root: str, dst_root: str,
                   img_subdir: str = "", gt_subdir: str = "",
                   split_dir: Optional[str] = None,
                   missing_ok: bool = False) -> Tuple[int, int]:
    """Copy every (image, gt) pair of a split from ``src_root`` to
    ``dst_root``, keeping the layout under the roots; ``img_subdir`` and
    ``gt_subdir`` are joined under both (KITTI uses raw/ and gts/, NYU
    none). Returns (copied, missing); a pair with a missing file raises
    ``FileNotFoundError`` unless ``missing_ok``."""
    copied = missing = 0
    for line in load_split(data_type, mode, split_dir):
        img, depth, _ = parse_split_line(line, data_type)
        rels = [os.path.join(img_subdir, img)]
        if depth:
            rels.append(os.path.join(gt_subdir, depth))
        if not all(os.path.isfile(os.path.join(src_root, rel)) for rel in rels):
            missing += 1
            if missing_ok:
                continue
            raise FileNotFoundError(f"split line has missing files: {line}")
        for rel in rels:
            dst = os.path.join(dst_root, rel)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copy2(os.path.join(src_root, rel), dst)
        copied += 1
    return copied, missing


def convert_nyu_mat(mat_path: str, split_mat_path: str, out_folder: str,
                    limit: Optional[int] = None) -> int:
    """NYU's official labelled .mat -> per-scene jpg/png trees, as the
    official converter the reference vendors: depth written as uint16
    millimetres (x 1000, the port's PNG codec), the RGB with a 7-pixel
    black border (rows and columns [7:474, 7:632] kept, JPEG quality 95),
    scenes split train/test by ``splits.mat``'s 1-based indices. Returns
    the frames written."""
    import h5py  # preparation only
    import scipy.io
    from PIL import Image

    split = scipy.io.loadmat(split_mat_path)
    test_images = set(int(x) for x in split["testNdxs"].ravel())
    train_images = set(int(x) for x in split["trainNdxs"].ravel())
    written = 0
    with h5py.File(mat_path, "r") as h5:
        depths = h5["rawDepths"] if "rawDepths" in h5 else h5["depths"]
        images = h5["images"]
        scenes = (["".join(chr(c[0]) for c in h5[ref][:]) for ref in h5["sceneTypes"][0]]
                  if "sceneTypes" in h5 else None)
        names = h5["scenes"] if "scenes" in h5 else None
        count = int(images.shape[0])
        if limit is not None:
            count = min(count, limit)
        for i in range(count):
            idx = i + 1
            if idx in train_images:
                tt = "train"
            elif idx in test_images:
                tt = "test"
            else:
                raise ValueError(f"index {idx} neither in training set nor in test set")
            scene = ("".join(chr(c[0]) for c in h5[names[0][i]][:]) if names is not None
                     else (scenes[i] if scenes else "scene"))
            folder = os.path.join(out_folder, tt, scene)
            os.makedirs(folder, exist_ok=True)
            # the mat arrays are (W, H) and (C, W, H)
            depth_raw = np.asarray(depths[i]).T
            image = np.transpose(np.asarray(images[i]), (2, 1, 0))
            write_png(os.path.join(folder, f"sync_depth_{i:05d}.png"),
                      (depth_raw * 1000.0).astype(np.uint16))
            bounded = np.zeros((480, 640, 3), dtype=np.uint8)
            bounded[7:474, 7:632, :] = image[7:474, 7:632, :]
            Image.fromarray(bounded).save(os.path.join(folder, f"rgb_{i:05d}.jpg"),
                                          quality=95)
            written += 1
    return written


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    px = sub.add_parser("extract", help="copy a split's files out of a corpus")
    px.add_argument("data_type", choices=["KITTI", "NYU", "ONLINE"])
    px.add_argument("mode", choices=["train", "test", "benchmark"])
    px.add_argument("src_root")
    px.add_argument("dst_root")
    px.add_argument("--img-subdir", default="")
    px.add_argument("--gt-subdir", default="")
    px.add_argument("--missing-ok", action="store_true")

    pm = sub.add_parser("convert-nyu-mat", help="NYU official .mat -> jpg/png")
    pm.add_argument("mat_path")
    pm.add_argument("split_mat_path")
    pm.add_argument("out_folder")

    pc = sub.add_parser("check", help="verify every split line exists on disk")
    pc.add_argument("data_type", choices=["KITTI", "NYU", "ONLINE"])
    pc.add_argument("mode", choices=["train", "test", "benchmark"])
    pc.add_argument("data_path")

    args = p.parse_args(argv)
    if args.cmd == "extract":
        copied, missing = extract_subset(
            args.data_type, args.mode, args.src_root, args.dst_root,
            img_subdir=args.img_subdir, gt_subdir=args.gt_subdir, missing_ok=args.missing_ok)
        print(f"copied {copied}, missing {missing}")
    elif args.cmd == "convert-nyu-mat":
        n = convert_nyu_mat(args.mat_path, args.split_mat_path, args.out_folder)
        print(f"wrote {n} frames")
    else:
        found, missing = check_split(args.data_type, args.mode, args.data_path)
        print(f"found {found}, missing {missing}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
