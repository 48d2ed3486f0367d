"""Utilities of the port (``mde_tpu/utils``): wandb logging and depth colouring."""
