"""The benchmark of the PyTorch and CUDA port (``mde_tpu_torch``) on one
H100: ``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``."""
