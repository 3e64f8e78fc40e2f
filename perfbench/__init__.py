"""The benchmark of the PyTorch/CUDA port (``repro_torch``): see
``harness.py``; run as ``python3 perfbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``."""
