"""End to end: the seconds from the process's start to the window's:
imports, the CUDA context, ``build_engine``, the weights, the warm-up
rounds (and, in a checkout's first run, K1's nvcc build)."""


def read(run):
    return run.setup_s
