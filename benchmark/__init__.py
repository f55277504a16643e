"""The benchmark of the PyTorch and CUDA port (``pedoni_tpu_torch``):
``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``."""
