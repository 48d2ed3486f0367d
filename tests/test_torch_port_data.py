"""The port's data path and driver modules against the JAX package's, on the
CPU, with no model: config, splits, the PNG codec (against Pillow),
``DepthDataset.load_raw`` and its host-parity pipeline, the augmentation
(given JAX's draws), the host loader's batches, checkpoints and ``colorize``.

Tolerances: everything on the host is held equal, bit for bit. The
augmentation, fed the values JAX draws from its keys: images within 1e-5
(two frameworks' f32 sin, cos, pow and products); depths equal except where
a pixel's nearest-neighbour source lies within 1e-4 of a rounding boundary
(there the two f32 source coordinates may round apart), at most 0.1% of the
pixels. ``normalize_eval_batch`` within 1e-6.

JAX's ``device_augment_batch`` and its draws run with jit disabled here,
op by op as the port computes them: compiled, XLA contracts multiply-adds
(the source coordinates' ``cy + (cos * yy + sin * xx)``, a uniform draw's
``u * (max - min) + min``), which moves a bilinear weight by up to an f32
ulp of the coordinate (8e-6 of a [0, 1] value at 80x120) and a normalised
value by four times that.
"""

import dataclasses
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import mde_tpu.data.augment as jax_aug
from chip_smoke import TRAIN_OPT
from mde_tpu.core.config import load_config as jax_load_config
from mde_tpu.core.config import parse as jax_parse
from mde_tpu.data import splits as jax_splits
from mde_tpu.data.dataset import DepthDataset as JaxDepthDataset
from mde_tpu.data.loader import DataLoader as JaxDataLoader
from mde_tpu.utils.visualize import colorize as jax_colorize
from mde_tpu_torch.core import checkpoint as ckpt
from mde_tpu_torch.core.config import load_config, parse
from mde_tpu_torch.data import augment, png, splits
from mde_tpu_torch.data.dataset import DepthDataset
from mde_tpu_torch.data.loader import DataLoader
from mde_tpu_torch.ops.tnn import BatchNorm
from mde_tpu_torch.train.state import TrainState
from mde_tpu_torch.utils.visualize import colorize
from test_driver import TINY_OPT
from _torch_port_threads import one_torch_thread  # noqa: F401

IMAGE_TOL = 1e-5
ROUNDING_BAND = 1e-4
MAX_ROUNDING_SHARE = 1e-3
EVAL_NORM_TOL = 1e-6
PAIRS = [(d, m) for d in ("KITTI", "NYU", "ONLINE") for m in ("train", "test", "benchmark")]


@pytest.mark.parametrize("raw", [dict(TINY_OPT, output_dir="x"), TRAIN_OPT],
                         ids=["tiny", "flagship"])
def test_config_matches_jax(raw, tmp_path):
    assert load_config(raw).to_dict() == jax_load_config(raw).to_dict()
    path = tmp_path / "opt.json"
    path.write_text(__import__("json").dumps(dict(raw, output_dir=str(tmp_path / "port"))))
    port = parse(str(path)).to_dict()
    (tmp_path / "opt.json").write_text(__import__("json").dumps(
        dict(raw, output_dir=str(tmp_path / "jax"))))
    ref = jax_parse(str(path)).to_dict()
    assert dict(port, output_dir=None) == dict(ref, output_dir=None)
    assert ((tmp_path / "port" / "option.json").read_text()
            == (tmp_path / "jax" / "option.json").read_text().replace("/jax", "/port"))


def test_splits_match_jax():
    for data_type, mode in PAIRS:
        try:
            want = dataclasses.asdict(jax_splits.dataset_spec(data_type, mode))
        except ValueError:
            with pytest.raises(ValueError):
                splits.dataset_spec(data_type, mode)
            continue
        assert dataclasses.asdict(splits.dataset_spec(data_type, mode)) == want
        assert splits.dataset_spec(data_type, mode, (64, 96)) == \
            splits.DatasetSpec(**dataclasses.asdict(jax_splits.dataset_spec(data_type, mode,
                                                                            (64, 96))))
        lines = splits.load_split(data_type, mode)
        assert lines == jax_splits.load_split(data_type, mode)
        for line in lines[:50] + lines[-50:]:
            assert splits.parse_split_line(line, data_type) == \
                jax_splits.parse_split_line(line, data_type)
    assert splits.find_split_dir() == jax_splits.find_split_dir()
    assert len(splits.load_split("KITTI", "train")) > 0


def test_split_dir_from_the_environment(tmp_path, monkeypatch):
    """``MDE_SPLIT_DIR`` names the split lists, read at each call (the JAX
    package reads it once, at import); a name that is no directory leaves
    the vendored lists."""
    os.makedirs(tmp_path / "KITTI")
    (tmp_path / "KITTI" / "kitti_eigen_test.txt").write_text("a.png b.png 721.5377\n")
    monkeypatch.setenv("MDE_SPLIT_DIR", str(tmp_path))
    assert splits.find_split_dir() == str(tmp_path)
    assert splits.load_split("KITTI", "test") == ["a.png b.png 721.5377"]
    monkeypatch.setenv("MDE_SPLIT_DIR", str(tmp_path / "missing"))
    assert splits.find_split_dir() == splits.VENDORED_SPLIT_DIR


def _png_images():
    rng = np.random.RandomState(0)
    h, w = 40, 70
    yy, xx = np.mgrid[:h, :w]
    ramp = ((3 * yy + 2 * xx) % 256).astype(np.uint8)
    rgb = np.stack([ramp, ramp[::-1], (ramp // 2 + rng.randint(0, 8, (h, w))).astype(np.uint8)],
                   -1)
    rgb[15:25] = rng.randint(0, 256, (10, w, 3))
    gray16 = (700 * yy + 13 * xx + rng.randint(0, 50, (h, w))).astype(np.uint16)
    gray16[30:] = rng.randint(0, 65535, (h - 30, w))
    rgba = np.concatenate([rgb, ramp[..., None]], -1)
    return {"rgb": rgb, "gray16": gray16, "gray8": rgb[..., 1], "rgba": rgba}


@pytest.mark.parametrize("kind", ["rgb", "gray16", "gray8", "rgba"])
def test_png_codec_matches_pillow(kind, tmp_path):
    """Pillow's files (adaptive row filters: ``optimize=True`` makes it try
    all five) decode to Pillow's arrays; the codec's files read back in
    Pillow to the array written."""
    image = _png_images()[kind]
    path = str(tmp_path / "pil.png")
    Image.fromarray(image).save(path, optimize=True)
    raw = np.frombuffer(__import__("zlib").decompress(b"".join(
        _chunks(open(path, "rb").read(), b"IDAT"))), np.uint8)
    filters = set(raw.reshape(image.shape[0], -1)[:, 0].tolist())
    assert {png.AVERAGE, png.PAETH} & filters and len(filters) >= 3, filters
    got, want = png.read_png(path), np.asarray(Image.open(path))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    ours = str(tmp_path / "ours.png")
    png.write_png(ours, image)
    assert np.array_equal(np.asarray(Image.open(ours)), image)
    assert np.array_equal(png.read_png(ours), image)


def _chunks(data, kind):
    pos = 8
    while pos < len(data):
        length = int.from_bytes(data[pos:pos + 4], "big")
        if data[pos + 4:pos + 8] == kind:
            yield data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _filter_rows(rows, bpp, filters):
    """The PNG encoder's side: each row of ``rows`` (H, stride) uint8 filtered
    with its type in ``filters``, after its filter byte (PNG spec, section 9)."""
    x = np.zeros((rows.shape[0] + 1, rows.shape[1] + bpp), np.int32)
    x[1:, bpp:] = rows
    a, b, c = x[1:, :-bpp], x[:-1, bpp:], x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    f = np.asarray(filters)[:, None]
    pred = np.select([f == 0, f == 1, f == 2, f == 3], [0, a, b, (a + b) >> 1], paeth)
    return np.concatenate([f.astype(np.uint8), ((rows - pred) & 0xFF).astype(np.uint8)], 1)


@pytest.mark.parametrize("filt", [png.NONE, png.SUB, png.UP, png.AVERAGE, png.PAETH, "mixed"])
def test_png_unfilter_each_filter(filt):
    """Rows filtered with one type (or the five in turn) unfilter to the
    bytes that were filtered, for 1, 2 (16-bit gray), 3 and 4 bytes a pixel."""
    for kind, image in _png_images().items():
        rows = (image.astype(">u2").view(np.uint8) if image.dtype == np.uint16
                else image).reshape(image.shape[0], -1)
        bpp = rows.shape[1] // image.shape[1]
        filters = np.arange(rows.shape[0]) % 5 if filt == "mixed" else [filt] * rows.shape[0]
        got = png.unfilter(_filter_rows(rows, bpp, filters), bpp)
        assert np.array_equal(got, rows), (kind, filt)
    raw = _filter_rows(rows, bpp, filters)
    raw[7, 0] = 5
    with pytest.raises(ValueError, match="unknown PNG row filter 5 in row 7"):
        png.unfilter(raw, bpp)


def test_png_codec_refuses_other_formats(tmp_path):
    path = str(tmp_path / "p.png")
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).convert("P").save(path)
    with pytest.raises(ValueError, match="colour type 3"):
        png.read_png(path)
    with pytest.raises(ValueError, match="cannot write"):
        png.encode_png(np.zeros((4, 4, 3), np.uint16))


def _write_tree(root, data_type, mode, n=2, seed=0):
    """A dataset tree of ``n`` samples written by Pillow (KITTI: 375x1242
    RGB PNGs and uint16 depth x 256; NYU: 480x640 JPEGs and uint16 depth
    x 1000) and its split list."""
    rng = np.random.RandomState(seed)
    spec = splits.dataset_spec(data_type, mode)
    lines = []
    for i in range(n):
        if data_type == "KITTI":
            shape, img, gt = (375, 1242), f"seq/img_{i}.png", f"seq/gt_{i}.png"
            depth = (rng.rand(*shape) * 80 * 256).astype(np.uint16)
        else:
            shape, img, gt = (480, 640), f"scene/rgb_{i}.jpg", f"scene/depth_{i}.png"
            depth = (rng.rand(*shape) * 10000).astype(np.uint16)
        depth[rng.rand(*shape) < 0.3] = 0
        for rel, sub, arr in ((img, spec.img_subdir, rng.randint(0, 256, shape + (3,),
                                                                 dtype=np.uint8)),
                              (gt, spec.gt_subdir, depth)):
            path = os.path.join(root, "data", sub, rel)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(arr).save(path)
        lines.append(f"{'/' if data_type == 'NYU' else ''}{img} {gt} 718.856")
    rel = jax_splits._SPLIT_FILES[(data_type, mode)]
    os.makedirs(os.path.join(root, "splits", os.path.dirname(rel)), exist_ok=True)
    with open(os.path.join(root, "splits", rel), "w") as f:
        f.write("\n".join(lines) + "\n")
    return os.path.join(root, "data"), os.path.join(root, "splits")


def _same_sample(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("data_type,mode", [("KITTI", "train"), ("KITTI", "test"),
                                            ("NYU", "train"), ("NYU", "test")])
def test_load_raw_matches_jax(data_type, mode, tmp_path):
    """Synthetic samples, then real files: decode, KB-crop, the NYU train
    region mask, the depth scaling."""
    for i in (0, 5):
        _same_sample(DepthDataset("", data_type, mode, img_size=(48, 64)).load_raw(i),
                     JaxDepthDataset("", data_type, mode, img_size=(48, 64)).load_raw(i))
    data, split_dir = _write_tree(str(tmp_path), data_type, mode)
    port = DepthDataset(data, data_type, mode, split_dir=split_dir)
    ref = JaxDepthDataset(data, data_type, mode, split_dir=split_dir)
    assert not port.synthetic and len(port) == len(ref) == 2
    for i in range(2):
        _same_sample(port.load_raw(i), ref.load_raw(i))


def test_host_parity_pipeline_matches_jax(tmp_path):
    """``host_augment``: Pillow's rotation and the reference's host
    augmentation and masking, from the same Python ``random`` state."""
    data, split_dir = _write_tree(str(tmp_path), "KITTI", "train", n=1)
    kw = dict(split_dir=split_dir, host_augment=True, height_drop=(0.2, 2),
              width_drop=(0.3, 1))
    port, ref = DepthDataset(data, "KITTI", "train", **kw), JaxDepthDataset(data, "KITTI",
                                                                             "train", **kw)
    for seed in (0, 1):
        random.seed(seed)
        got = port[0]
        random.seed(seed)
        want = ref[0]
        for key in ("image", "depth"):
            assert np.array_equal(got[key], want[key]), key


def _jax_draws(cfg, key, batch, in_hw):
    """The values ``device_augment_batch`` draws from ``key``
    (``mde_tpu/data/augment.py:116-160``), as the port's ``draw_params``
    names them."""
    h, w = cfg.out_height, cfg.out_width
    hc, wc = augment._band_counts(cfg)
    out = {k: [] for k in ("angle", "crop_y", "crop_x", "flip", "gamma", "bright", "color",
                           "h_len", "h_start", "w_len", "w_start")}

    def bands(k, size, frac, count):
        lens, starts = [], []
        if cfg.drop_edge:
            count, frac = min(count, 1), 1.0 - frac
        for _ in range(count):
            k1, k2, k = jax.random.split(k, 3)
            ln = jax_aug._rand_int(k1, int((size - 1) * frac))
            lens.append(int(ln))
            starts.append(int(jax_aug._rand_int(k2, size - ln)))
        return lens, starts

    bright = (0.75, 1.25) if cfg.data_type.upper() == "NYU" else (0.9, 1.1)
    for k in jax.random.split(key, batch):
        keys = jax.random.split(k, 12)
        out["angle"].append(float(jax.random.uniform(keys[0], minval=-cfg.degree,
                                                     maxval=cfg.degree)))
        out["crop_y"].append(int(jax_aug._rand_int(keys[1], in_hw[0] - h)))
        out["crop_x"].append(int(jax_aug._rand_int(keys[2], in_hw[1] - w)))
        out["flip"].append(bool(jax.random.bernoulli(keys[3])))
        out["gamma"].append(float(jax.random.uniform(keys[4], minval=0.9, maxval=1.1)))
        out["bright"].append(float(jax.random.uniform(keys[5], minval=bright[0],
                                                      maxval=bright[1])))
        out["color"].append(np.asarray(jax.random.uniform(keys[6], (3,), minval=0.9,
                                                          maxval=1.1)))
        for axis, k2, size, drop, count in (("h", keys[7], h, cfg.height_drop, hc),
                                            ("w", keys[8], w, cfg.width_drop, wc)):
            lens, starts = bands(k2, size, drop[0], count)
            out[f"{axis}_len"].append(lens)
            out[f"{axis}_start"].append(starts)
    dtypes = {"angle": torch.float32, "gamma": torch.float32, "bright": torch.float32,
              "color": torch.float32, "flip": torch.bool}
    return {k: torch.tensor(np.asarray(v), dtype=dtypes.get(k, torch.int32)).reshape(
        (batch, -1) if k.startswith(("h_", "w_")) else (batch, 3) if k == "color" else (batch,))
        for k, v in out.items()}


def _near_rounding(params, in_hw, cfg):
    """(B, h, w) pixels whose nearest-neighbour source coordinate lies
    within ROUNDING_BAND of a rounding boundary (computed in f64)."""
    h, w = cfg.out_height, cfg.out_width
    rows = params["crop_y"].numpy()[:, None, None] + np.arange(h)[None, :, None]
    j = np.where(params["flip"].numpy()[:, None], w - 1 - np.arange(w), np.arange(w))
    cols = params["crop_x"].numpy()[:, None, None] + j[:, None, :]
    theta = np.deg2rad(params["angle"].numpy().astype(np.float64))[:, None, None]
    cy, cx = (in_hw[0] - 1) / 2.0, (in_hw[1] - 1) / 2.0
    yy, xx = rows - cy, cols - cx
    sy = cy + np.cos(theta) * yy + np.sin(theta) * xx
    sx = cx - np.sin(theta) * yy + np.cos(theta) * xx
    return ((np.abs(sy - np.floor(sy) - 0.5) < ROUNDING_BAND)
            | (np.abs(sx - np.floor(sx) - 0.5) < ROUNDING_BAND))


@pytest.mark.parametrize("data_type", ["NYU", "KITTI"])
@pytest.mark.parametrize("drop_edge", [False, True], ids=["bands", "drop_edge"])
def test_augment_matches_jax(data_type, drop_edge):
    """B=2 raw 80x120 -> 64x96 with rotation (2.5 degrees), crop, flip,
    photometric augmentation, clip_depth and band masks (two of each axis;
    one kept band of each with drop_edge): the port's ``apply`` on JAX's
    draws against JAX's ``device_augment_batch``."""
    cfg = dict(out_height=64, out_width=96, degree=2.5, data_type=data_type, clip_depth=7.0,
               height_drop=(0.3, 2), width_drop=(0.25, 2), drop_edge=drop_edge)
    rng = np.random.RandomState(3)
    images = rng.rand(2, 80, 120, 3).astype(np.float32) * 1.1 - 0.05
    depths = (rng.rand(2, 80, 120, 1) * 10).astype(np.float32)
    key = jax.random.PRNGKey(11)
    with jax.disable_jit():  # op by op, as the port computes (module docstring)
        want_img, want_depth = jax_aug.device_augment_batch(
            jax_aug.AugmentConfig(**cfg), key, jnp.asarray(images), jnp.asarray(depths))
        params = _jax_draws(augment.AugmentConfig(**cfg), key, 2, (80, 120))
    got_img, got_depth = augment.apply(augment.AugmentConfig(**cfg), params,
                                       torch.from_numpy(images), torch.from_numpy(depths))
    assert np.abs(got_img.numpy() - np.asarray(want_img)).max() <= IMAGE_TOL
    near = _near_rounding(params, (80, 120), augment.AugmentConfig(**cfg))
    assert near.mean() <= MAX_ROUNDING_SHARE, f"{near.sum()} pixels near a rounding boundary"
    differ = got_depth.numpy()[..., 0] != np.asarray(want_depth)[..., 0]
    print(f"{data_type} drop_edge={drop_edge}: images within "
          f"{np.abs(got_img.numpy() - np.asarray(want_img)).max():.2e}; {near.sum()} of "
          f"{near.size} depth pixels near a rounding boundary, {differ.sum()} differ")
    assert not (differ & ~near).any(), (
        f"{(differ & ~near).sum()} depths differ away from rounding boundaries "
        f"({near.sum()} pixels near one, {differ.sum()} differ)")
    # the port's own draws: the same shapes, masks applied, depth clipped
    gen = torch.Generator().manual_seed(0)
    img, depth = augment.device_augment_batch(augment.AugmentConfig(**cfg), gen,
                                              torch.from_numpy(images), torch.from_numpy(depths))
    assert img.shape == (2, 64, 96, 3) and depth.shape == (2, 64, 96, 1)
    assert depth.max() <= 7.0 and torch.isfinite(img).all()


def test_normalize_eval_batch_matches_jax():
    images = np.random.RandomState(4).rand(2, 16, 24, 3).astype(np.float32) * 1.2 - 0.1
    got = augment.normalize_eval_batch(torch.from_numpy(images)).numpy()
    want = np.asarray(jax_aug.normalize_eval_batch(jnp.asarray(images)))
    assert np.abs(got - want).max() <= EVAL_NORM_TOL


@pytest.mark.parametrize("mode,drop_last", [("train", True), ("train", False),
                                            ("test", False)])
def test_host_loader_matches_jax(mode, drop_last):
    """``host_only`` epochs: the same batches in the same order."""
    kw = dict(batch_size=3, shuffle=mode == "train", num_workers=2, drop_last=drop_last,
              host_only=True, seed=5)
    port = DataLoader(DepthDataset("", "NYU", mode, img_size=(24, 32), synthetic_len=10), **kw)
    ref = JaxDataLoader(JaxDepthDataset("", "NYU", mode, img_size=(24, 32), synthetic_len=10),
                        **kw)
    assert len(port) == len(ref)
    for epoch in (0, 1):
        got, want = list(port.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == len(port)
        for a, b in zip(got, want):
            for key in ("image", "depth", "focal"):
                assert np.array_equal(a[key], b[key]), key


def test_loader_on_cpu_augments_and_normalises():
    ds = DepthDataset("", "KITTI", "train", img_size=(32, 48), synthetic_len=6)
    batches = list(DataLoader(ds, 2, shuffle=True, num_workers=2, device="cpu").epoch(0))
    assert len(batches) == 3
    for b in batches:
        assert isinstance(b["image"], torch.Tensor) and b["image"].shape == (2, 32, 48, 3)
        assert b["depth"].shape == (2, 32, 48, 1) and b["depth"].min() >= 0
    test = DataLoader(DepthDataset("", "KITTI", "test", synthetic_len=2), 2, device="cpu")
    batch = next(iter(test))
    raw = np.stack([test.dataset.load_raw(i)[0] for i in range(2)])
    want = augment.normalize_eval_batch(torch.from_numpy(raw))
    assert batch["image"].shape == (2, 352, 1216, 3) and torch.equal(batch["image"], want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DataLoader(ds, 2)


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = torch.nn.Linear(3, 4)
        self.bn = BatchNorm(4)


def test_checkpoint_save_restore_gc(tmp_path):
    opt = {"optimizer": {"lr": 1e-3, "weight_decay": 0.1}, "scheduler": {"name": "onecycle"},
           "train": {"grad_norm": 0.1}}
    torch.manual_seed(0)
    state = TrainState.create(_Tiny(), opt, 10)
    ckpt_dir = str(tmp_path / "ckpt")
    for step in range(1, 6):
        grads = {n: torch.randn_like(p) for n, p in state.model.named_parameters()}
        state.optimizer.update(grads)
        state.model.bn.running_mean += 0.5
        state.step = step
        ckpt.save_checkpoint(ckpt_dir, state, step, best_value=0.1 * step)
    assert sorted(os.listdir(ckpt_dir)) == ["step_3", "step_4", "step_5"]
    assert ckpt.latest_checkpoint(ckpt_dir) == os.path.join(ckpt_dir, "step_5")
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None

    torch.manual_seed(1)
    fresh = TrainState.create(_Tiny(), opt, 10)
    meta = ckpt.restore_checkpoint(ckpt.latest_checkpoint(ckpt_dir), fresh)
    assert meta == {"step": 5, "best_value": 0.5} and fresh.step == 5
    for (name, a), (_, b) in zip(state.model.state_dict().items(),
                                 fresh.model.state_dict().items()):
        assert torch.equal(a, b), name
    assert fresh.optimizer.count == state.optimizer.count == 5
    for a, b in zip(state.optimizer.mu + state.optimizer.nu,
                    fresh.optimizer.mu + fresh.optimizer.nu):
        assert torch.equal(a, b)
    other = TrainState.create(_Tiny(), opt, 10, zero_grad_bn=True)
    with pytest.raises(ValueError, match="other parameters"):
        ckpt.restore_checkpoint(ckpt.latest_checkpoint(ckpt_dir), other)


def test_colorize_matches_jax():
    depth = np.random.RandomState(6).uniform(-1, 12, (30, 40)).astype(np.float32)
    depth[0, :3] = [np.nan, np.inf, 10.0]
    for vmin, vmax in ((0.0, 10.0), (None, None)):
        for cmap in ("magma_r", "magma"):
            assert np.array_equal(colorize(depth, vmin, vmax, cmap),
                                  jax_colorize(depth, vmin, vmax, cmap))
