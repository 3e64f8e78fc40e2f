"""The benchmark's command:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  It keeps every build and kernel cache inside
the checkout (the port's nvcc libraries in
``src/repro_torch/kernels/_build/``, PyTorch's and Triton's under
``.bench_cache/``), puts ``src`` and the checkout's root on the path, and
hands over to :func:`perfbench.harness.main`.
"""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

if __name__ == "__main__":
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    # The checkout's root and its ``src`` in place of this script's folder,
    # whose subfolders (``metrics``, ``work``, ...) are no top-level
    # packages.
    sys.path[:1] = [str(ROOT / "src"), str(ROOT)]
    from perfbench.harness import main
    raise SystemExit(main(t_process=T_PROCESS))
