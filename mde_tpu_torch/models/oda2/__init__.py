"""ODA2 model families of the port (counterpart of ``mde_tpu/models/oda2``)."""
