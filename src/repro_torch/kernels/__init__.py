"""Hand-written Hopper kernels of the port, their plain PyTorch versions,
and the wrappers that route between them (CPU tensor -> plain version,
CUDA tensor -> kernel)."""
