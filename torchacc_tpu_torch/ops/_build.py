"""Build the hand-written CUDA kernels under ``csrc/`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into a shared library, which is loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds, not minutes).
Libraries land in ``torchacc_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds
and an unchanged one is loaded as it is.

``build_all()`` starts one ``nvcc`` per source, all at once, and waits
for them together.  A source listed in ``SPLIT`` is built once per value
of its macro instead (``flash_attention.cu`` once per head dim, with
``-DFLASH_HEAD_DIM=<d>``): each library holds that value's kernels, the
jobs run side by side, and ``load(name, value)`` loads the one a call
needs.  Without the macro the source builds whole.  ``load_host()`` builds host C++ (the sequence
packer, ``data/_native/pack.cc``) with ``g++`` into the same directory,
named the same way.  Nothing here runs at import time.
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

# sources built once per value of a macro: name -> (macro, values)
SPLIT = {"flash_attention": ("FLASH_HEAD_DIM", (32, 64, 80, 96, 128, 256))}

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


def _headers() -> List[str]:
    """Every shared header under ``csrc/``: a source may include any."""
    return sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))


def _hashed_path(name: str, sources: List[str], flags: List[str]) -> str:
    """``_build/lib<name>-<hash>.so``, the hash over the sources' names
    and contents and the flags."""
    h = hashlib.sha256()
    for path in sources:
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + b"\0" + fh.read())
    h.update(" ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _defines(name: str, value=None) -> List[str]:
    """The ``-D`` of the build of ``name`` for ``value`` of its ``SPLIT``
    macro (none for a whole build)."""
    return [] if value is None else [f"-D{SPLIT[name][0]}={value}"]


def _lib_path(name: str, value=None) -> str:
    return _hashed_path(name, [os.path.join(CSRC, f)
                               for f in [f"{name}.cu"] + _headers()],
                        NVCC_FLAGS + _defines(name, value))


def _jobs(name: str) -> List[tuple]:
    """``(name, value)`` of each library ``name`` builds into."""
    if name in SPLIT:
        return [(name, v) for v in SPLIT[name][1]]
    return [(name, None)]


def _label(name: str, value=None) -> str:
    return name if value is None else f"{name}[{value}]"


def _start(name: str, out: str, value=None) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *_defines(name, value), "-Xptxas", "-v",
           "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp, proc.out, proc.name = tmp, out, _label(name, value)
    return proc


def _finish(proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build csrc/{proc.name} "
            f"(exit {proc.returncode}):\n{log}")
    os.replace(proc.tmp, proc.out)
    return log


def build_all(names: Iterable = ()) -> Dict[str, str]:
    """Compile every listed source (default: all of ``csrc/``; a
    ``(name, value)`` pair is one library of a ``SPLIT`` source) that is
    not built yet, one ``nvcc`` each, all started together.  Returns
    ``{name or name[value]: nvcc output}`` for the libraries it compiled
    (the ``-Xptxas -v`` register and shared-memory report)."""
    jobs = [j for n in (list(names) or kernel_sources())
            for j in ([n] if isinstance(n, tuple) else _jobs(n))]
    with _lock:
        procs = [_start(n, _lib_path(n, v), v) for n, v in jobs
                 if not os.path.exists(_lib_path(n, v))]
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


def load(name: str, value=None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (for a ``SPLIT``
    source, its library of ``value``), built if needed."""
    key = _label(name, value)
    lib = _loaded.get(key)
    if lib is not None:
        return lib
    path = _lib_path(name, value)
    if not os.path.exists(path):
        build_all([(name, value)])
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            lib = ctypes.CDLL(path)
            _loaded[key] = lib
    return lib


HOST_FLAGS = ["-O3", "-shared", "-fPIC"]


def load_host(src: str) -> ctypes.CDLL:
    """The loaded library of the host C++ source ``src`` (a path),
    compiled by ``g++`` into ``_build/`` at first use and named by a hash
    of the source and the flags.  Raises where there is no ``g++`` or it
    fails."""
    name = os.path.splitext(os.path.basename(src))[0]
    lib = _loaded.get(src)
    if lib is not None:
        return lib
    out = _hashed_path(name, [src], HOST_FLAGS)
    with _lock:
        if not os.path.exists(out):
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError(f"g++ not found: {src} is compiled at "
                                   f"first use")
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            res = subprocess.run([gxx, *HOST_FLAGS, "-o", tmp, src],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"g++ failed to build {src} (exit "
                                   f"{res.returncode}):\n{res.stderr}")
            os.replace(tmp, out)
        lib = _loaded.get(src)
        if lib is None:
            lib = ctypes.CDLL(out)
            _loaded[src] = lib
    return lib
