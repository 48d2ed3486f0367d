"""Operators of the port (counterpart of ``mde_tpu/ops``)."""
