"""The port's driver (``mde_tpu_torch/train/driver.py``) against the JAX
package's (``mde_tpu/train/driver.py``), on ``tests/test_driver.py``'s
``TINY_OPT`` (synthetic NYU, the tiny flagship of ``TINY_ENC``, no
recompute, no resize to multiples of 224) on the CPU.

The JAX ``Trainer``'s initial weights go into the port's by
``from_jax_variables``. Both drivers' test split is cut to 16 synthetic
images of 64x64 (the NYU test split's own 480x640 would make each forward
of both sides cost seconds here); the train split keeps its 64 images.
Tolerances: ``validate()``'s nine metrics within 1e-4 relative; the uint16
``predict()`` PNGs within 1 count on at least 99.9% of the pixels (the two
frameworks' f32 forwards differ by ~1e-5 m, 0.01 counts at NYU's factor
1000, and truncation moves a value within that of an integer by one).
"""

import json
import os

import numpy as np
import pytest
import torch

import mde_tpu.data.dataset as jax_dataset
from mde_tpu.core.config import load_config as jax_load_config
from mde_tpu.train import driver as jax_driver
from mde_tpu_torch import models as port_models
from mde_tpu_torch.convert import from_jax_variables
from mde_tpu_torch.core.config import load_config
from mde_tpu_torch.data.png import read_png
from mde_tpu_torch.serve import Predictor
from mde_tpu_torch.train import driver
from test_driver import TINY_ENC, TINY_OPT

OVERRIDES = dict(use_checkpoint=False, resize_to_multiple=False, encoder_kwargs=TINY_ENC)
METRIC_TOL = 1e-4
PNG_SHARE = 0.999


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread. Under the suite's parallel workers,
    torch's pool of a thread a core in every worker made the fit loop's many
    small ops wait on each other (a 1.4 s test took 121 s)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _small_test_split(cls):
    """``cls`` (either package's DepthDataset) with 16 images of 64x64 in
    every split but train."""
    def make(data_path, data_type="NYU", mode="train", **kw):
        if mode != "train":
            kw.update(img_size=(64, 64), synthetic_len=16)
        return cls(data_path, data_type, mode, **kw)
    return make


@pytest.fixture
def small_splits(monkeypatch):
    monkeypatch.setattr(jax_driver, "DepthDataset", _small_test_split(jax_dataset.DepthDataset))
    # the JAX predict imports its DepthDataset when it runs
    monkeypatch.setattr(jax_dataset, "DepthDataset", _small_test_split(jax_dataset.DepthDataset))
    monkeypatch.setattr(driver, "DepthDataset", _small_test_split(driver.DepthDataset))


def _opt(tmp_path, **changes):
    return dict(TINY_OPT, output_dir=str(tmp_path / "run"), **changes)


def test_validate_and_predict_match_jax(tmp_path, small_splits):
    ref = jax_driver.Trainer(jax_load_config(_opt(tmp_path)), model_overrides=OVERRIDES,
                             use_mesh=False)
    ref.init_state()
    port = driver.Trainer(load_config(_opt(tmp_path)), model_overrides=OVERRIDES, device="cpu")
    port.init_state()
    port.model.load_state_dict(from_jax_variables(
        {"params": ref.state.params, "batch_stats": ref.state.batch_stats}))

    want, got = ref.validate(), port.validate()
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert abs(got[key] - value) <= METRIC_TOL * abs(value), (key, got[key], value)

    assert ref.predict(str(tmp_path / "jax")) == port.predict(str(tmp_path / "port")) == 16
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    diffs = np.concatenate([
        np.abs(read_png(str(tmp_path / "port" / n)).astype(np.int64)
               - read_png(str(tmp_path / "jax" / n)).astype(np.int64)).ravel() for n in names])
    assert (diffs <= 1).mean() >= PNG_SHARE, np.bincount(diffs)[:4]

    # the PNG is the Predictor's depth times 1000, truncated
    image = next(iter(port.test_loader))["image"][:1]
    depth = Predictor(port.model).predict(image)[0, ..., 0].numpy()
    assert np.array_equal(read_png(str(tmp_path / "port" / names[0])),
                          (depth * 1000.0).astype(np.uint16))


def test_fit_saves_and_resumes(tmp_path, small_splits, monkeypatch):
    """fit(max_steps=4), two loader batches a step, validates and saves at
    step 4; a new Trainer pointed at the checkpoints resumes there with the
    same weights, statistics and moments; ``main --eval-only`` validates."""
    trainer = driver.Trainer(load_config(_opt(tmp_path)), model_overrides=OVERRIDES,
                             device="cpu")
    metrics = trainer.fit(max_steps=4)
    assert trainer.global_step == trainer.state.step == 4
    assert all(np.isfinite(v) for v in metrics.values()) and len(metrics) == 9
    ckpt_dir = tmp_path / "run" / "checkpoints"
    assert os.listdir(ckpt_dir) == ["step_4"]

    resumed = driver.Trainer(load_config(_opt(tmp_path, checkpoint=str(ckpt_dir))),
                             model_overrides=OVERRIDES, device="cpu", seed=1)
    resumed.init_state()
    assert resumed.global_step == resumed.state.step == 4
    assert resumed.best_value == trainer.best_value == metrics["abs_rel"]
    for (name, a), (_, b) in zip(trainer.model.state_dict().items(),
                                 resumed.model.state_dict().items()):
        assert torch.equal(a, b), name
    opt_a, opt_b = trainer.state.optimizer, resumed.state.optimizer
    assert opt_a.count == opt_b.count == 4
    for a, b in zip(opt_a.mu + opt_a.nu, opt_b.mu + opt_b.nu):
        assert torch.equal(a, b)

    path = tmp_path / "opt.json"
    path.write_text(json.dumps(_opt(tmp_path)))
    build = port_models.build_model
    monkeypatch.setattr(driver, "build_model",
                        lambda *a, **kw: build(*a, **dict(kw, **OVERRIDES)))
    metrics = driver.main(["--opt", str(path), "--eval-only", "--device", "cpu"])
    assert len(metrics) == 9 and all(np.isfinite(v) for v in metrics.values())


def test_fit_raises_where_the_checkpoint_cannot_be_saved(tmp_path, small_splits):
    """A best checkpoint that cannot be written stops ``fit`` with the
    error; training does not go on without it."""
    (tmp_path / "run").mkdir()
    (tmp_path / "run" / "checkpoints").write_text("a file where the directory goes")
    trainer = driver.Trainer(load_config(_opt(tmp_path)), model_overrides=OVERRIDES,
                             device="cpu")
    with pytest.raises(OSError):
        trainer.fit(max_steps=4)
    assert trainer.global_step == 4


def test_trainer_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        driver.Trainer(load_config(_opt(tmp_path)), model_overrides=OVERRIDES)
