"""Build the CUDA sources under ``csrc/`` into shared libraries on first use.

Each source compiles with ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with :mod:`ctypes` — no PyTorch
headers, so a build takes seconds. Libraries land in ``build/repro_torch/``
at the root of the checkout, named by the hash of the source and the
shared headers (``csrc/*.cuh``), so an edited source rebuilds and an
unchanged one is loaded as it is.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()                 # guards _name_locks
_name_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}
# per source: {"seconds": build time (0.0 when loaded from the cache),
#              "log": nvcc's output, including ptxas' register report,
#              "path": the shared library}
build_info: dict[str, dict] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of repro_torch build on the machine with the GPU")
    return found


def _compile(src: Path, out: Path) -> str:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
    os.replace(tmp, out)          # atomic: a concurrent loader sees all or none
    return log


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` (built on first use).

    Each source has its own lock, so threads loading different sources run
    their ``nvcc`` builds at the same time."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cu"
        h = hashlib.sha256(src.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):      # shared includes
            h.update(header.read_bytes())
        digest = h.hexdigest()[:16]
        out = BUILD_DIR / f"lib{name}-{digest}.so"
        t0 = time.perf_counter()
        log = "" if out.is_file() else _compile(src, out)
        build_info[name] = {"seconds": time.perf_counter() - t0, "log": log,
                            "path": str(out)}
        lib = _libs[name] = ctypes.CDLL(str(out))
        return lib
