"""Plain PyTorch references of what the benchmark's cells train: the
models (``sr``, ``qwen3``), the federated rounds (``fl``), the traffic
worked out again from the seed (``data``), the control precisions
(``lowp``) and the comparison (``compare``).  Nothing here imports the
program or the JAX package."""
