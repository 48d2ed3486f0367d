"""Batch loader: host decode threads, then the card (``mde_tpu/data/loader.py``).

Decode runs in a thread pool and stacking in a one-thread pool; those
threads touch numpy only. The thread that iterates ``epoch`` pins each
stacked host batch, copies it to the card with ``non_blocking=True`` and
queues the augmentation (train) or the eval normalisation (test) there,
one batch ahead of the one it hands out, so that a batch's copy and
augmentation are queued behind the step that runs before it. Nothing here
reads a value back from the card.

The augmentation of an epoch draws from one ``torch.Generator`` on the
loader's device, seeded ``seed * 100003 + epoch`` (the JAX package's seed
formula); the shuffle from ``np.random.RandomState(seed + epoch)``, as
there.
"""

from __future__ import annotations

import collections
import concurrent.futures
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

from ..models import resolve_device
from .augment import AugmentConfig, device_augment_batch, normalize_eval_batch
from .dataset import DepthDataset


class DataLoader:
    def __init__(self,
                 dataset: DepthDataset,
                 batch_size: int,
                 shuffle: bool = False,
                 num_workers: int = 4,
                 drop_last: bool = True,
                 device_augment: bool = True,
                 seed: int = 0,
                 prefetch: int = 2,
                 host_only: bool = False,
                 device: Optional[Union[str, torch.device]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.device_augment = device_augment and dataset.mode == "train"
        # eval/predict decode raw [0,1] images and normalize on the card;
        # only host-parity *training* (host_augment) goes through
        # __getitem__, which returns already-normalized images
        self.eval_raw = dataset.mode != "train"
        self.seed = seed
        self.prefetch = prefetch
        # host_only: yield the stacked host batches (numpy), with no copy to
        # the card: the host pipeline alone
        self.host_only = host_only
        # the card unless the caller asks for the CPU; none for host batches
        self.device = None if host_only else resolve_device(device)

        spec = dataset.spec
        self.aug_cfg = AugmentConfig(
            out_height=spec.height, out_width=spec.width,
            degree=spec.degree if spec.do_random_rotate else 0.0,
            data_type=spec.data_type,
            clip_depth=dataset.clip_depth,
            height_drop=tuple(dataset.height_drop),
            width_drop=tuple(dataset.width_drop),
            drop_edge=dataset.drop_edge,
        )

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(idx)
        return idx

    def _stack(self, samples) -> Dict[str, np.ndarray]:
        if self.device_augment or self.eval_raw:
            images = np.stack([s[0] for s in samples])
            depths = np.stack([s[1] for s in samples])
            focals = np.asarray([s[2] for s in samples], np.float32)
        else:
            images = np.stack([s["image"] for s in samples])
            depths = np.stack([s["depth"] for s in samples])
            focals = np.asarray([s["focal"] for s in samples], np.float32)
        return {"image": images, "depth": depths, "focal": focals}

    def _to_device(self, host, generator: torch.Generator):
        """Host batch -> device batch, queued on the card (nothing waits)."""
        def copy(array):
            t = torch.from_numpy(array)
            if self.device.type == "cuda":
                t = t.pin_memory()
            return t.to(self.device, non_blocking=True)

        images, depths = copy(host["image"]), copy(host["depth"])
        if self.device_augment:
            images, depths = device_augment_batch(self.aug_cfg, generator, images, depths)
        elif self.eval_raw:
            images = normalize_eval_batch(images)
        # else: host-parity train batches arrive from __getitem__ already
        # ImageNet-normalized
        return {"image": images, "depth": depths, "focal": host["focal"]}

    def epoch(self, epoch: int = 0) -> Iterator[Dict]:
        """Yield the batches of one epoch: on the card (host numpy batches
        with ``host_only``). Decode runs on the worker pool, stacking on
        its own thread, and the copy and augmentation of the next batch
        are queued before this one is handed out."""
        indices = self._epoch_indices(epoch)
        nb = len(self)
        generator = None
        if not self.host_only:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(self.seed * 100003 + epoch)
        load = self.dataset.load_raw \
            if (self.device_augment or self.eval_raw) \
            else self.dataset.__getitem__

        with concurrent.futures.ThreadPoolExecutor(self.num_workers) as pool, \
                concurrent.futures.ThreadPoolExecutor(1) as stack_pool:
            pending = collections.deque()   # stacked-host-batch futures

            def assemble(futs):
                return self._stack([f.result() for f in futs])

            def submit(b):
                lo = b * self.batch_size
                sel = indices[lo:lo + self.batch_size]
                if len(sel) < self.batch_size and self.drop_last:
                    return None
                futs = [pool.submit(load, int(i)) for i in sel]
                # a separate 1-thread pool, so it can never starve the decoders
                return stack_pool.submit(assemble, futs)

            for b in range(min(self.prefetch, nb)):
                f = submit(b)
                if f:
                    pending.append(f)
            next_b = min(self.prefetch, nb)

            device_buf = collections.deque()  # batches queued on the card
            while pending or device_buf:
                # keep one batch ahead on the device
                while pending and len(device_buf) < 2:
                    host = pending.popleft().result()
                    if next_b < nb:
                        nf = submit(next_b)
                        if nf:
                            pending.append(nf)
                        next_b += 1
                    device_buf.append(host if self.host_only
                                      else self._to_device(host, generator))
                yield device_buf.popleft()

    def __iter__(self):
        return self.epoch(0)
