"""AdaBins (``mde_tpu/models/adabins``)."""
