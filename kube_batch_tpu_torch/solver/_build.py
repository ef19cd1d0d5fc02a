"""Build and load the bid kernels (``csrc/bid.cu``).

``nvcc`` compiles the source into a shared library with a plain C
interface, loaded with ``ctypes``. The library goes into
``csrc/build/<hash>/`` (ignored by git), keyed on a hash of the source
and the flags, at first use; later calls in the process reuse it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "bid.cu"
BUILD_ROOT = CSRC / "build"
LIB_NAME = "libkbt_bid.so"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # Bit-equal keys: no implicit multiply-add contraction, IEEE
    # division (never --use_fast_math).
    "--fmad=false", "-prec-div=true",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, the usual install
    location, or the first on ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the bid kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / _digest() / LIB_NAME


def build() -> dict:
    """Compile the kernels if this source has no library yet. Returns
    ``{"path", "built", "seconds", "log"}``; ``log`` holds nvcc's
    ``-Xptxas -v`` report (registers, shared memory, spills)."""
    import time

    out = library_path()
    if out.is_file():
        return {"path": str(out), "built": False, "seconds": 0.0, "log": ""}
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{LIB_NAME}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}"
        )
    os.replace(tmp, out)
    (out.parent / "nvcc.log").write_text(log)
    return {"path": str(out), "built": True, "seconds": seconds, "log": log}


def load_library() -> ctypes.CDLL:
    """Build if needed, then load once per process with the C
    signatures declared."""
    with _lock:
        lib = _loaded.get("lib")
        if lib is not None:
            return lib
        build()
        lib = ctypes.CDLL(str(library_path()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.kbt_bid_dense.argtypes = [p] * 12 + [i, i, i, f, f, p]
        lib.kbt_bid_dense.restype = ctypes.c_int
        lib.kbt_bid_sparse.argtypes = [p] * 12 + [i, i, i, i, f, f, p]
        lib.kbt_bid_sparse.restype = ctypes.c_int
        _loaded["lib"] = lib
        return lib
