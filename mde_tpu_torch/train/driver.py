"""Training driver of the port (``mde_tpu/train/driver.py``):

    parse --opt JSON -> DepthDataset loaders (augmentation on the card) ->
    build_model -> AdamW + OneCycle -> train step (accumulation, clip) ->
    print_freq logging -> valid_freq eval (crop masks, 9 metrics) ->
    best-checkpoint saving -> resume; predict writes uint16 PNGs.

    python -m mde_tpu_torch.train.driver --opt x.json [--bf16] [--max-steps N]
        [--eval-only | --predict DIR] [--device cuda|cpu]

Everything runs on the card unless the caller asks for the CPU. The fit
loop keeps each step's logs on the card and reads them back only every
``print_freq`` steps, so it adds no per-step wait for the card.

Data parallelism: under ``torchrun`` (or in processes that joined a data
group, ``parallel/mesh.py``) every rank builds the same model and loaders
and runs ``train.spmd``'s step: ``gspmd``, the default
(``make_train_step_gspmd``: each rank its rows of every microbatch, with
the global batch's BatchNorm statistics, dropout masks and loss; a loader
batch, which is one microbatch, must split over the ranks), or
``shard_map`` (``make_train_step_shard_map``: each rank its rows of the
step batch, gradients, BatchNorm statistics and logs averaged over the
ranks). Rank 0 alone prints, logs and checkpoints.

    torchrun --nproc_per_node 4 -m mde_tpu_torch.train.driver --opt x.json --bf16
"""

from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from ..core import checkpoint as ckpt
from ..core.averages import RunningAverage, Timer, time_log
from ..core.config import Config, parse
from ..core.dist import dprint, is_primary
from ..data.dataset import DepthDataset
from ..data.loader import DataLoader
from ..data.png import write_png
from ..data.splits import dataset_spec, parse_split_line
from ..models import build_model, resolve_device
from ..parallel.mesh import make_mesh, replicate, shard_batch
from ..serve import Predictor
from ..utils.wandb_utils import set_wandb
from .state import TrainState
from .step import make_eval_step, make_train_step_gspmd, make_train_step_shard_map

SPMD_MODES = ("gspmd", "shard_map")


def build_all(opt: Config, dtype=torch.float32, model_overrides=None,
              device: Optional[torch.device] = None, seed: int = 0):
    """Construct the loaders and the model from a config:
    (train_loader, test_loader, model, min_depth, max_depth, total_steps)."""
    ds_opt = opt["dataset"]
    spec = dataset_spec(ds_opt["data_type"], "train",
                        ds_opt.get("img_size") or None)
    min_depth, max_depth = spec.min_depth, spec.max_depth

    train_ds = DepthDataset(
        ds_opt.get("data_path", ""), ds_opt["data_type"], "train",
        img_size=tuple(ds_opt["img_size"]) if ds_opt.get("img_size") else None,
        height_drop=tuple(ds_opt.get("height_drop", (0.0, 0))),
        width_drop=tuple(ds_opt.get("width_drop", (0.0, 0))),
        clip_depth=ds_opt.get("clip_depth") or None,
        drop_edge=ds_opt.get("drop_edge", False))
    test_ds = DepthDataset(ds_opt.get("data_path", ""), ds_opt["data_type"], "test")

    dl_opt = opt.get("dataloader", {})
    batch_size = int(dl_opt.get("batch_size", 8))
    workers = int(dl_opt.get("num_workers", 4))
    train_loader = DataLoader(train_ds, batch_size, shuffle=True, num_workers=workers,
                              device_augment=True, device=device)
    # post-KB-crop KITTI test images are all 352x1216 and NYU's all 480x640,
    # so eval batches freely (the metrics stay per image); eval.batch_size
    # overrides
    eval_bs = int(opt.get("eval", {}).get("batch_size", batch_size))
    test_loader = DataLoader(test_ds, batch_size=max(eval_bs, 1), shuffle=False,
                             num_workers=workers, drop_last=False, device_augment=False,
                             device=device)

    # JAX sizes a model by its first train batch (``Trainer.init_state``); the
    # port's ODA models fix their encoder windows (the resize off) and
    # oda_lion its position embedding's grid at build: from the train crop,
    # unless the model's config or the overrides name a size
    overrides = dict(model_overrides or {})
    model_opt = opt["model"] if "model" in opt else opt
    if model_opt["name"].startswith("oda_") and not model_opt.get("img_size"):
        overrides.setdefault("img_size", (spec.height, spec.width))
    model = build_model(opt, min_depth, max_depth, device=device, seed=seed, dtype=dtype,
                        **overrides)

    # one optimizer step consumes num_accum loader batches (effective batch
    # batch_size * num_accum); the OneCycle schedule runs over optimizer steps
    num_accum = int(opt["train"].get("num_accum", 1))
    steps_per_epoch = max(len(train_loader) // num_accum, 1)
    total_steps = int(opt["train"]["epoch"]) * steps_per_epoch
    return train_loader, test_loader, model, min_depth, max_depth, total_steps


class Trainer:
    """The driver's state: loaders, model, train state, best value, step.
    Builds on the card unless ``device`` asks for another (raises where
    CUDA is missing); the model's weights are drawn from ``seed``. Joins
    the data group (``parallel.mesh.make_mesh``). Across several ranks a
    ``gspmd`` step's loader batch (one microbatch), or a ``shard_map``
    step's batch, must split over the ranks."""

    def __init__(self, opt: Config, dtype=torch.float32, model_overrides=None,
                 device: Optional[Union[str, torch.device]] = None, seed: int = 0):
        self.opt = opt
        self.mesh = make_mesh(resolve_device(device))
        self.device = self.mesh.device
        t = opt["train"]
        self.spmd = t.get("spmd", "gspmd")
        if self.spmd not in SPMD_MODES:
            raise ValueError(f"train.spmd {self.spmd!r}: expected one of {SPMD_MODES}")
        self.num_accum = int(t.get("num_accum", 1))
        batch_size = int(opt.get("dataloader", {}).get("batch_size", 8))
        if self.spmd == "gspmd" and batch_size % self.mesh.size:
            raise ValueError(f"a microbatch of {batch_size} images (dataloader.batch_size) "
                             f"does not split over {self.mesh.size} ranks")
        rows = batch_size * self.num_accum
        if rows % self.mesh.size:
            raise ValueError(f"a step's {rows} images do not split over {self.mesh.size} ranks")
        (self.train_loader, self.test_loader, self.model, self.min_depth, self.max_depth,
         self.total_steps) = build_all(opt, dtype, model_overrides, self.device, seed)
        self.run, self.run_dir = set_wandb(opt)

        self.print_freq = int(t.get("print_freq", 25))
        self.valid_freq = int(t.get("valid_freq", 250))
        self.epochs = int(t.get("epoch", 24))
        self.freeze_encoder_bn = bool(t.get("freeze_encoder_bn", False))
        self.freeze_all_bn_epoch = int(t.get("freeze_all_bn", -1))

        ev = opt["eval"]
        self.eval_step = make_eval_step(
            self.model, opt, float(ev.get("min_depth_eval", 1e-3)),
            float(ev.get("max_depth_eval", self.max_depth)),
            data_type=opt["dataset"]["data_type"],
            flip_eval=bool(ev.get("flip_eval", False)))

        # two step flavours: BN live / BN frozen (freeze_all_bn epoch switch)
        self._steps = {}
        self.best_value: Optional[float] = None
        self.state: Optional[TrainState] = None
        self.global_step = 0

    def _get_step(self, freeze_bn: bool):
        if freeze_bn not in self._steps:
            kw = dict(num_accum=self.num_accum, freeze_bn=freeze_bn,
                      freeze_encoder_bn=self.freeze_encoder_bn)
            make = make_train_step_shard_map if self.spmd == "shard_map" else make_train_step_gspmd
            self._steps[freeze_bn] = make(self.opt, self.min_depth, self.max_depth, self.mesh,
                                          **kw)
        return self._steps[freeze_bn]

    def init_state(self) -> TrainState:
        """The optimizer over the model's weights (``zero_grad_bn`` leaves
        the BatchNorms' parameters out), then the resume from the config's
        ``checkpoint`` (a ``step_N`` directory or its parent)."""
        zero_grad_bn = bool(self.opt["train"].get("zero_grad_bn", False))
        self.state = TrainState.create(self.model, self.opt, self.total_steps,
                                       zero_grad_bn=zero_grad_bn)
        resume = self.opt.get("checkpoint", "")
        if resume:
            path = ckpt.latest_checkpoint(resume) or (
                resume if os.path.isdir(resume) else None)
            if path:
                meta = ckpt.restore_checkpoint(path, self.state)
                self.best_value = meta.get("best_value") or None
                self.global_step = int(meta.get("step", 0))
                dprint(f"Resumed from {path} at step {self.global_step}")
        replicate(self.mesh, self.state)
        return self.state

    def validate(self) -> dict:
        """The eval step over the test split: per-image metrics times their
        validity, summed on the card, read back once at the end (the
        per-image-then-mean average of the reference's
        ``RunningAverageDict``)."""
        sums = None
        for batch in self.test_loader.epoch(0):
            m = self.eval_step(batch)
            valid = (m.pop("count") > 0).float()  # (B,)
            contrib = torch.stack([valid.sum()] + [(v * valid).sum() for v in m.values()])
            sums = contrib if sums is None else sums + contrib
            names = list(m)
        if sums is None:
            return {}
        n_imgs, *values = sums.tolist()  # the one read from the card
        n = max(n_imgs, 1.0)
        return {k: v / n for k, v in zip(names, values)}

    def predict(self, out_dir: str, mode: Optional[str] = None,
                visualize: bool = False) -> int:
        """Depth of every image of the eval (or ONLINE benchmark) split,
        written as uint16 PNGs of depth * the dataset's saving factor (256
        KITTI and ONLINE, 1000 NYU), mirroring each sample's relative path;
        with ``visualize`` also a coloured ``*_vis.png``. The depth is
        ``serve.Predictor``'s: the last map, resized back to the image with
        align_corners, clipped at 0. Returns the number of files written.
        Every rank holds the same state: rank 0 alone predicts and writes,
        and the other ranks write nothing and return 0."""
        from ..utils.visualize import colorize

        if not is_primary():
            return 0

        ds_opt = self.opt["dataset"]
        data_type = ds_opt["data_type"]
        mode = mode or ("benchmark" if data_type.upper() == "ONLINE" else "test")
        ds = DepthDataset(ds_opt.get("data_path", ""), data_type, mode)
        loader = DataLoader(ds, batch_size=1, shuffle=False, num_workers=2, drop_last=False,
                            device_augment=False, device=self.device)
        predictor = Predictor(self.model)
        factor = float(ds.spec.saving_factor)

        os.makedirs(out_dir, exist_ok=True)
        written = 0
        for i, batch in enumerate(loader.epoch(0)):
            arr = predictor.predict(batch["image"])[0, ..., 0].cpu().numpy()
            if ds.synthetic:
                rel = f"{ds.filenames[i]}.png"
            else:
                rel = parse_split_line(ds.filenames[i], data_type)[0]
                rel = os.path.splitext(rel)[0] + ".png"
            path = os.path.join(out_dir, rel)
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            write_png(path, (arr * factor).astype(np.uint16))
            if visualize:
                write_png(os.path.splitext(path)[0] + "_vis.png",
                          colorize(arr, 0.0, ds.max_depth))
            written += 1
        dprint(f"wrote {written} predictions to {out_dir}")
        return written

    def fit(self, max_steps: Optional[int] = None) -> dict:
        """The training loop; returns the last validation's metrics."""
        if self.state is None:
            self.init_state()

        loss_avg = RunningAverage()
        timer = Timer()
        generator = torch.Generator(device=self.device).manual_seed(1234)
        metrics = {}
        # each step's logs stay on the card until print_freq: reading one
        # back every step would make the host wait for the card every step
        log_buf = []
        ckpt_dir = os.path.join(self.opt.get("output_dir", "./output"), "checkpoints")

        for epoch in range(self.epochs):
            freeze_bn = (self.freeze_all_bn_epoch >= 0
                         and epoch >= self.freeze_all_bn_epoch)
            step_fn = self._get_step(freeze_bn)

            # num_accum loader batches make one step; a trailing partial
            # group at the epoch's end is dropped
            accum_buf = []
            for batch in self.train_loader.epoch(epoch):
                accum_buf.append(batch)
                if len(accum_buf) < self.num_accum:
                    continue
                if self.num_accum == 1:
                    batch = accum_buf[0]
                else:
                    batch = {k: torch.cat([b[k] for b in accum_buf]) for k in ("image", "depth")}
                accum_buf = []
                # a gspmd step takes each rank's rows of each microbatch itself
                if self.spmd == "shard_map":
                    batch = shard_batch(self.mesh, batch)
                self.state, logs = step_fn(self.state, batch, generator)
                self.global_step += 1
                log_buf.append(logs)

                if self.global_step % self.print_freq == 0:
                    # one read from the card for the whole window
                    *losses, grad_norm = torch.stack(
                        [lg["loss"] for lg in log_buf] + [log_buf[-1]["grad_norm"]]).tolist()
                    for loss in losses:
                        loss_avg.append(loss)
                    log_buf.clear()
                    dprint(f"{time_log()}\n"
                           f"epoch {epoch} step {self.global_step} "
                           f"loss {loss_avg.get_value():.4f} "
                           f"grad_norm {grad_norm:.4f} "
                           f"({timer.elapsed_ms() / self.print_freq:.0f} ms/step)")
                    if is_primary():
                        self.run.log({"train/loss": loss_avg.get_value(),
                                      "train/grad_norm": grad_norm,
                                      "step": self.global_step})
                    loss_avg.reset()
                    timer.reset()

                if self.global_step % self.valid_freq == 0:
                    metrics = self.validate()
                    dprint(f"[valid @ {self.global_step}] {metrics}")
                    value = metrics.get("abs_rel")
                    best = value is not None and (self.best_value is None
                                                  or value < self.best_value)
                    if best:
                        self.best_value = value
                    # every rank holds the same state; rank 0 logs and saves it
                    if is_primary():
                        self.run.log({f"valid/{k}": v for k, v in metrics.items()})
                        if best:
                            ckpt.save_checkpoint(ckpt_dir, self.state, self.global_step,
                                                 best_value=value)
                            dprint(f"saved best checkpoint (abs_rel={value:.4f})")

                if max_steps is not None and self.global_step >= max_steps:
                    return metrics or self.validate()

        return metrics or self.validate()


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description="mde_tpu_torch training driver")
    p.add_argument("--opt", required=True, help="path to experiment JSON")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 activations (f32 params)")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--predict", metavar="DIR", default=None,
                   help="write uint16 PNG predictions (KITTI submission "
                        "format) for the eval/benchmark split and exit")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)

    opt = parse(args.opt)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    trainer = Trainer(opt, dtype=dtype, device=args.device)
    trainer.init_state()
    if args.predict:
        return trainer.predict(args.predict)
    if args.eval_only:
        # every rank holds the same state: rank 0 alone evaluates
        metrics = trainer.validate() if is_primary() else {}
        dprint(f"[eval] {metrics}")
        return metrics
    return trainer.fit(max_steps=args.max_steps)


if __name__ == "__main__":
    main()
