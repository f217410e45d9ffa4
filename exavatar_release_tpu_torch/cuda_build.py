"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each library is one or more ``csrc/*.cu`` files with a plain C interface,
compiled at first use into ``build/kernels/`` at the root of the checkout
(listed in ``.gitignore``), under a name that hashes the sources, the
headers they share and the flags, so a changed source builds anew. ``build()`` starts one nvcc per missing
library, all together, and waits for them; ``load()`` builds if needed and
returns the ``ctypes.CDLL``. Nothing is built when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

LIBRARIES: Dict[str, tuple] = {
    "composite": ("csrc/composite.cu",),
    "composite_bwd": ("csrc/composite_bwd.cu",),
    "windows": ("csrc/windows.cu",),
    "binning": ("csrc/binning.cu",),
}
# included by the sources above; hashed into every library's name
HEADERS = ("csrc/composite_common.cuh", "csrc/composite_probes.cuh")

# -fmad=false, no fast math: the compositing thresholds (alpha >= 1/255,
# T < 1e-4) must see the same rounding as the plain PyTorch version.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    found = path if os.path.exists(path) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return found


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in LIBRARIES[name] + HEADERS:
        with open(os.path.join(_PKG, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Build every named library that is missing, one nvcc each, all started
    together. Returns {name: path}. Raises with nvcc's log on a failure;
    each build's log stays beside its library as ``.log``."""
    names = list(LIBRARIES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(os.path.join(_PKG, s) for s in LIBRARIES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        with open(paths[n][:-3] + ".log", "wb") as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append(f"{n}:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """nvcc's output (with -Xptxas -v resource usage) of the last build."""
    with open(library_path(name)[:-3] + ".log") as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(build([name])[name])
    return _loaded[name]
