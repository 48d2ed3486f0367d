"""Data parallelism over ``torch.distributed`` (``mde_tpu/parallel/``)."""
