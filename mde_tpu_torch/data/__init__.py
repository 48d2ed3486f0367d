"""Data pipeline of the port (``mde_tpu/data``): splits, a PNG codec, the
dataset, augmentation on the card, the loader."""
