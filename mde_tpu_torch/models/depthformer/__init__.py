"""Depthformer v1-v5 (``mde_tpu/models/depthformer``)."""
