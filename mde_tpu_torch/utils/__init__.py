"""Utilities of the port (``mde_tpu/utils``): wandb logging, depth colouring,
golden-image comparison, profiling and the flagship's FLOP model."""
