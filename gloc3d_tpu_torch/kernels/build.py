"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file compiles on first use into a shared library with a
plain C interface, under ``gloc3d_tpu_torch/_build/`` (listed in
.gitignore). The library name carries a hash of the source, so an edited
kernel rebuilds and concurrent builds never load a half-written file
(each writes a private temporary and renames it into place). ``load_all``
starts one nvcc per source at once. Nothing here runs at import time: the
CPU tests import every module of the port on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("segment_sum", "pillar_bin_sums", "knn_normals")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# seconds spent compiling and the compiler's -Xptxas -v report, per source
build_seconds: Dict[str, float] = {}
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _library_path(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def load_all(names: Sequence[str] = KERNELS) -> Dict[str, ctypes.CDLL]:
    """Compile every ``csrc/<name>.cu`` not built yet, one nvcc each, all
    started together, and return the loaded libraries by name."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        procs = {}
        for name in todo:
            so = _library_path(name)
            if os.path.exists(so):
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            src = os.path.join(CSRC, f"{name}.cu")
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, so, src, time.perf_counter())
        failed = []
        try:
            for name, (proc, tmp, so, src, t0) in procs.items():
                out, _ = proc.communicate(timeout=600)
                build_seconds[name] = time.perf_counter() - t0
                build_log[name] = out
                if proc.returncode != 0:
                    failed.append(f"nvcc failed on {src}:\n{out}")
                else:
                    os.replace(tmp, so)
        finally:  # a timeout leaves no compiler running
            for proc, *_ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if failed:
            raise RuntimeError("\n".join(failed))
        for name in todo:
            _libs[name] = ctypes.CDLL(_library_path(name))
        return {n: _libs[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library."""
    return load_all((name,))[name]
