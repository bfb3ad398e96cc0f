"""Build the hand-written CUDA kernels under ``csrc/`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into a shared library, which is loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds, not minutes).
Libraries land in ``torchacc_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source and the flags, so an
edited source rebuilds and an unchanged one is loaded as it is.

``build_all()`` starts one ``nvcc`` per source, all at once, and waits
for them together.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def kernel_sources() -> List[str]:
    """Names (file stems) of every kernel source under ``csrc/``."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        if os.path.exists(cand):
            path = cand
    if path is None:
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
            "CUDA kernels of torchacc_tpu_torch are compiled from "
            "csrc/ at first use and need the CUDA toolkit")
    return path


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str, out: str) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp, proc.out, proc.name = tmp, out, name
    return proc


def _finish(proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build csrc/{proc.name}.cu "
            f"(exit {proc.returncode}):\n{log}")
    os.replace(proc.tmp, proc.out)
    return log


def build_all(names: Iterable[str] = ()) -> Dict[str, str]:
    """Compile every listed source (default: all of ``csrc/``) that is
    not built yet, one ``nvcc`` each, all started together.  Returns
    ``{name: nvcc output}`` for the sources it compiled (the ``-Xptxas
    -v`` register and shared-memory report)."""
    names = list(names) or kernel_sources()
    with _lock:
        procs = [_start(n, _lib_path(n)) for n in names
                 if not os.path.exists(_lib_path(n))]
        logs = {}
        try:
            for p in procs:
                logs[p.name] = _finish(p)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not os.path.exists(path):
        build_all([name])
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(path)
            _loaded[name] = lib
    return lib
