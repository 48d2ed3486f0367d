"""mde_tpu_torch: the PyTorch and CUDA port of ``mde_tpu``.

A package of its own beside the JAX package, which stays the reference: it
imports ``torch`` and nothing of JAX or ``mde_tpu``. Its kernels are written
by hand for Hopper (``ops/kernels/csrc``); each has a plain PyTorch version
beside it, which runs for tensors on the CPU. Entry points run on the card
unless the caller asks for the CPU.

Ported so far: the flagship ``oda2_red_order_swin2`` forward
(``models.build_model``, ``serve.Predictor``) and its train and eval steps
(``train.step.make_train_step``, ``make_eval_step``, with the losses, the
optimizer and the metrics), whose backward passes run through the kernels'
backward kernels. ROADMAP.md lists the rest.
"""
