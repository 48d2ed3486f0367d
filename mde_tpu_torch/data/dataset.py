"""DepthDataset, the host stage of the data pipeline (``mde_tpu/data/dataset.py``).

The reference ``DepthDataset`` (``dataset/depth_dataset.py``) split in two:

* **host stage (this file)**: split parsing, PNG decode (the port's own
  codec, ``png.py``), KB-crop, the NYU ground truth's region mask, depth
  scaling (/256 KITTI, /1000 NYU), with numpy only;
* **device stage** (``augment.py``): rotation, random crop, flip,
  photometric augmentation, depth clipping, ImageNet normalisation and band
  masks, batched on the card.

``host_augment=True`` is a parity mode that runs the reference's whole
pipeline on the host (Python ``random`` in its call order; the rotation
needs Pillow, imported only there). NYU's JPEG images need Pillow too. Where
Pillow is missing, both raise an error that names the file.

When ``data_path`` is not a directory, or the split lists no file, the
dataset makes seeded random samples of the right shapes, the same bits as
the JAX package's.
"""

from __future__ import annotations

import os
import random
from typing import Dict, Optional, Tuple

import numpy as np

from .png import read_png
from .splits import DatasetSpec, dataset_spec, load_split, parse_split_line

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def kb_crop_bounds(height: int, width: int) -> Tuple[int, int]:
    """KITTI-benchmark crop to (352, 1216): (top_margin, left_margin)
    (reference ``:197-206``)."""
    return int(height - 352), int((width - 1216) / 2)


def _pillow(path: str, what: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: {what} needs the Pillow package (PIL), which is not "
                          f"installed") from e
    return Image


def read_image(path: str) -> np.ndarray:
    """An image file as uint8 (or uint16) numpy: PNG by the port's codec,
    anything else (NYU's JPEGs) by Pillow."""
    if path.lower().endswith(".png"):
        return read_png(path)
    with _pillow(path, "reading a non-PNG image").open(path) as image:
        return np.asarray(image)


class DepthDataset:
    def __init__(self,
                 data_path: str,
                 data_type: str = "NYU",
                 mode: str = "train",
                 img_size: Optional[Tuple[int, int]] = None,
                 height_drop: Tuple[float, int] = (0.0, 0),
                 width_drop: Tuple[float, int] = (0.0, 0),
                 clip_depth: Optional[float] = None,
                 use_right: bool = False,
                 drop_edge: bool = False,
                 split_dir: Optional[str] = None,
                 host_augment: bool = False,
                 synthetic_len: int = 64):
        if use_right:
            raise ValueError("use_right=True is not supported (nor by the reference).")
        self.spec: DatasetSpec = dataset_spec(data_type, mode, img_size)
        self.data_path = data_path
        self.data_type = self.spec.data_type
        self.mode = self.spec.mode
        self.height, self.width = self.spec.height, self.spec.width
        self.min_depth = self.spec.min_depth
        self.max_depth = self.spec.max_depth
        self.clip_depth = float(clip_depth) if clip_depth else self.spec.max_depth
        self.height_drop = height_drop
        self.width_drop = width_drop
        self.drop_edge = drop_edge
        self.host_augment = host_augment

        self.synthetic = not (data_path and os.path.isdir(data_path))
        self.filenames = load_split(self.data_type, self.mode, split_dir)
        if self.synthetic or not self.filenames:
            self.synthetic = True
            self.filenames = [f"synthetic_{i:06d}" for i in range(synthetic_len)]

        self.img_path = os.path.join(data_path, self.spec.img_subdir) \
            if self.spec.img_subdir else data_path
        self.gt_path = os.path.join(data_path, self.spec.gt_subdir) \
            if self.spec.gt_subdir else data_path

    def __len__(self) -> int:
        return len(self.filenames)

    # ---------------- raw sample loading (host) ----------------

    def _load_synthetic(self, idx: int):
        rng = np.random.RandomState(idx)
        if self.mode == "train":
            h, w = self.height, self.width
        elif self.spec.do_kb_crop:
            h, w = 352, 1216
        else:
            h, w = self.height, self.width
        image = rng.randint(0, 256, (h, w, 3)).astype(np.float32) / 255.0
        # plausible depth field: smooth ramp + noise, sparse invalids
        yy = np.linspace(0.1, 1.0, h, dtype=np.float32)[:, None]
        depth = (yy * 0.8 * self.max_depth
                 + rng.rand(h, w).astype(np.float32)) * np.ones((h, w), np.float32)
        depth = np.clip(depth, 0.0, self.max_depth * 0.95)
        invalid = rng.rand(h, w) < 0.3
        depth[invalid] = 0.0
        return image, depth[..., None], 720.0, self.filenames[idx], ""

    def _load_real(self, idx: int):
        line = self.filenames[idx]
        img_rel, depth_rel, focal = parse_split_line(line, self.data_type)
        image_path = os.path.join(self.img_path, img_rel)
        image = read_image(image_path)
        if self.mode == "benchmark":
            depth_gt = np.zeros(image.shape[:2], np.int16)
            depth_rel = ""
        else:
            depth_gt = read_image(os.path.join(self.gt_path, depth_rel))

        if self.spec.do_kb_crop:  # KITTI's images are at least 352x1216
            top, left = kb_crop_bounds(*image.shape[:2])
            image = image[top:top + 352, left:left + 1216]
            depth_gt = depth_gt[top:top + 352, left:left + 1216]

        if self.mode == "train":
            if self.data_type == "NYU":
                # zero GT outside the Eigen-valid region (reference ``:210-217``)
                d = depth_gt.astype(np.float32)
                m = np.zeros_like(d)
                m[45:472, 43:608] = 1
                depth_gt = d * m

            if self.host_augment and self.spec.do_random_rotate:
                angle = (random.random() - 0.5) * 2 * self.spec.degree
                image, depth_gt = self._rotate(image_path, image, depth_gt, angle)

        image = image.astype(np.float32) / 255.0
        depth = depth_gt.astype(np.float32)[..., None] / self.spec.saving_factor
        return image, depth, focal, img_rel, depth_rel

    @staticmethod
    def _rotate(path: str, image: np.ndarray, depth: np.ndarray, angle: float):
        """Pillow's ``rotate``: bilinear for the image, nearest for the depth."""
        Image = _pillow(path, "host_augment's rotation")
        image = Image.fromarray(image).rotate(angle, resample=Image.BILINEAR)
        depth = Image.fromarray(depth).rotate(angle, resample=Image.NEAREST)
        return np.asarray(image), np.asarray(depth)

    def load_raw(self, idx: int):
        """Decode + geometric fixes; augmentation NOT applied (device stage)."""
        if self.synthetic:
            return self._load_synthetic(idx)
        return self._load_real(idx)

    # ---------------- host-parity full pipeline ----------------

    def __getitem__(self, idx: int) -> Dict:
        """Full reference-order host pipeline (parity mode). Returns the HWC
        float32 image (normalized) and the HW1 depth."""
        image, depth, focal, img_rel, depth_rel = self.load_raw(idx)

        if self.mode == "train":
            image, depth = self._random_crop(image, depth)
            if self.host_augment:
                image, depth = self._train_preprocess(image, depth)

        image = (image - IMAGENET_MEAN) / IMAGENET_STD
        if self.mode == "train" and self.host_augment:
            image, depth = self._random_masking(image, depth)

        return {"image": image.astype(np.float32), "depth": depth,
                "focal": focal, "image_path": img_rel, "depth_path": depth_rel}

    def _random_crop(self, img, depth):
        h, w = self.height, self.width
        if img.shape[0] < h or img.shape[1] < w:
            raise ValueError(f"image {img.shape[:2]} is smaller than the crop {(h, w)}")
        if img.shape[:2] == (h, w):
            return img, depth
        x = random.randint(0, img.shape[1] - w)
        y = random.randint(0, img.shape[0] - h)
        return img[y:y + h, x:x + w], depth[y:y + h, x:x + w]

    def _train_preprocess(self, image, depth):
        if random.random() > 0.5:
            image = image[:, ::-1].copy()
            depth = depth[:, ::-1].copy()
        # gamma / brightness / per-channel color (reference ``:262-280``)
        gamma = random.uniform(0.9, 1.1)
        image = image ** gamma
        bright = random.uniform(0.75, 1.25) if self.data_type == "NYU" \
            else random.uniform(0.9, 1.1)
        image = image * bright
        for c in range(3):
            image[:, :, c] *= random.uniform(0.9, 1.1)
        image = np.clip(image, 0, 1)
        depth = depth.copy()
        depth[depth > self.clip_depth] = 0.0
        return image, depth

    def _random_masking(self, image, depth):
        """Structured band dropout (reference ``RandomMasking``, ``:314-386``)."""
        h, w = image.shape[:2]
        hr, hc = max(min(self.height_drop[0], 1.0), 0.0), max(self.height_drop[1], 0)
        wr, wc = max(min(self.width_drop[0], 1.0), 0.0), max(self.width_drop[1], 0)
        mask = np.ones((h, w), np.float32)
        if not self.drop_edge:
            for _ in range(hc):
                ln = random.randint(0, int((h - 1) * hr))
                st = random.randint(0, h - ln)
                mask[st:st + ln, :] = 0
            for _ in range(wc):
                ln = random.randint(0, int((w - 1) * wr))
                st = random.randint(0, w - ln)
                mask[:, st:st + ln] = 0
        else:
            hc, wc = min(hc, 1), min(wc, 1)
            mask[:] = 0
            if hc > 0:
                ln = random.randint(0, int((h - 1) * (1.0 - hr)))
                st = random.randint(0, h - ln)
                mask[st:st + ln, :] = 1
            if wc > 0:
                ln = random.randint(0, int((w - 1) * (1.0 - wr)))
                st = random.randint(0, w - ln)
                mask[:, st:st + ln] = 1
        return image * mask[..., None], depth * mask[..., None]
