"""mde_tpu_torch: the PyTorch and CUDA port of ``mde_tpu``.

A package of its own beside the JAX package, which stays the reference: it
imports ``torch`` and nothing of JAX or ``mde_tpu``. Its kernels are written
by hand for Hopper (``ops/kernels/csrc``); each has a plain PyTorch version
beside it, which runs for tensors on the CPU. Entry points run on the card
unless the caller asks for the CPU.

Ported so far: the flagship ``oda2_red_order_swin2`` and ``oda2_ksa_reg``
(``models.build_model``, ``serve.Predictor``), their train and eval steps
(``train.step``, with the losses, the optimizer and the metrics), whose
backward passes run through the kernels' backward kernels, and the driver's
path: the config (``core.config``), the data pipeline (``data``: splits, a
PNG codec, the dataset, augmentation on the card, the loader), native
checkpoints (``core.checkpoint``) and ``train.driver`` (``Trainer`` fit,
validate, predict, resume; ``python -m mde_tpu_torch.train.driver``).
ROADMAP.md lists the rest.
"""
