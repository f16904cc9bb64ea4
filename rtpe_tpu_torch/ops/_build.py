"""Build and load the port's CUDA kernels.

Each ``rtpe_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o rtpe_tpu_torch/_build/lib<name>.so <name>.cu

(seconds per file: no PyTorch headers), then loaded with ``ctypes``.
The build directory is in ``.gitignore``; a library older than its
source or a shared header (``csrc/*.cuh``) is rebuilt.
:func:`build_all` starts one ``nvcc`` per source at once and waits for
all of them.
"""

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc "
                           "on PATH to build the port's CUDA kernels")
    return path


def _paths(name: str):
    return (os.path.join(CSRC, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _stale(name: str) -> bool:
    """The library is missing, or older than its source or any shared
    header (``csrc/*.cuh``)."""
    src, lib = _paths(name)
    if not os.path.exists(lib):
        return True
    deps = [src] + [os.path.join(CSRC, f) for f in os.listdir(CSRC)
                    if f.endswith(".cuh")]
    return os.path.getmtime(lib) < max(os.path.getmtime(p) for p in deps)


def _start(name: str, verbose: bool) -> subprocess.Popen:
    src, lib = _paths(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", tmp, src]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.rtpe_tmp, proc.rtpe_lib, proc.rtpe_name = tmp, lib, name
    return proc


def _finish(proc: subprocess.Popen) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {proc.rtpe_name}.cu:\n{out}")
    os.replace(proc.rtpe_tmp, proc.rtpe_lib)
    return out


def sources() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def build_all(verbose: bool = False,
              force: bool = False) -> Dict[str, str]:
    """Compile every stale kernel source in parallel; returns each
    compiler's output (``-Xptxas=-v`` register/smem report when
    ``verbose``)."""
    with _lock:
        procs = [_start(n, verbose) for n in sources()
                 if force or _stale(n)]
        return {p.rtpe_name: _finish(p) for p in procs}


def load(name: str, signatures: Optional[Dict[str, list]] = None
         ) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if stale.
    ``signatures`` maps each C function to its ``argtypes``; every one
    returns the ``cudaError_t`` of its launch as an int."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        if _stale(name):
            _finish(_start(name, verbose=False))
        lib = ctypes.CDLL(_paths(name)[1])
        for fn, argtypes in (signatures or {}).items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
