"""Test-suite bootstrap.

``hypothesis`` is an optional dependency: several suites use it for property
tests, but clean environments (CI base images, the benchmark container) may
not ship it.  Install the deterministic fallback shim under the
``hypothesis`` module name before any test module imports it, so the whole
suite collects and runs either way.
"""

import os
import sys
import types

sys.path.insert(0, os.path.dirname(__file__))

try:
    import hypothesis  # noqa: F401  (real library wins when present)
except ImportError:
    import _hypothesis_stub as _stub

    mod = types.ModuleType("hypothesis")
    mod.given = _stub.given
    mod.settings = _stub.settings
    mod.strategies = _stub.strategies
    mod.__stub__ = True
    st_mod = types.ModuleType("hypothesis.strategies")
    for name in ("integers", "floats", "lists", "sampled_from"):
        setattr(st_mod, name, getattr(_stub.strategies, name))
    mod.strategies = st_mod
    sys.modules["hypothesis"] = mod
    sys.modules["hypothesis.strategies"] = st_mod


def pytest_configure(config):
    # Tests of the PyTorch port that need the CUDA card; they skip (with a
    # reason) on a machine without one.  Run them on the card with
    # ``python -m pytest -m cuda tests/test_torch_cuda.py``.
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")
