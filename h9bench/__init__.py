"""The benchmark of the PyTorch and CUDA port (``hybrid9_tpu_torch``):
``python3 h9bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``.  See ``harness.py``."""
