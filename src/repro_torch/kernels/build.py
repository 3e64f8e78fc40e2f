"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled with
``nvcc`` for ``sm_90a`` (``NVCC_FLAGS`` plus the kernel's own flags in
``SOURCES``) into ``lib<name>-<digest>.so`` under ``_build/``
(listed in ``.gitignore``) at first use, then loaded with ``ctypes``.  The
digest covers the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited kernel rebuilds and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per missing library and waits for
all of them, so several kernels build in parallel.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "NVCC_FLAGS", "BUILD_DIR", "nvcc_path", "build_all",
           "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# name -> (source, the kernel's own flags).  K1 and K2 are held bitwise to
# their plain versions, so nvcc may not contract their multiply-adds; K3-K5
# are held to a tolerance and keep nvcc's default contraction.
SOURCES = {"fedavg_accum": ("fedavg_accum.cu", ("--fmad=false",)),
           "dequant_merge": ("dequant_merge.cu", ("--fmad=false",)),
           "rmsnorm": ("rmsnorm.cu", ()),
           "flash_attention": ("flash_attention.cu", ()),
           "ssd": ("ssd.cu", ())}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "compiled on the machine with the card")
    return found


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + SOURCES[name][1]


def _target(name: str) -> Path:
    src = (CSRC / SOURCES[name][0]).read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names=None) -> dict[str, dict]:
    """Compile every named kernel whose library is missing, all at once.

    Returns ``{name: {"path", "seconds", "log", "cached"}}``; ``log`` is
    nvcc's output (``-Xptxas=-v``: registers, shared memory, spills).
    Raises with nvcc's output if any build fails.
    """
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: dict[str, dict] = {}
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            out[name] = {"path": str(target), "seconds": 0.0, "log": "",
                         "cached": True}
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *_flags(name), "-o", str(tmp),
               str(CSRC / SOURCES[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    failed = []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, target)
        out[name] = {"path": str(target), "seconds": seconds, "log": log,
                     "cached": False}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_all([name])[name]["path"])
            _LIBS[name] = lib
        return lib
