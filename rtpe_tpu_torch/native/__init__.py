"""The host's native (C++) helpers, with numpy / scipy fallbacks.

Port of ``rtpe_tpu/native``: the same three sources, unchanged, built
into one shared library and called through ``ctypes``:

* ``lap_solve(cost)``            square linear assignment (shortest
                                 augmenting paths, ``lap.cpp``), the
                                 host grouping's solver;
* ``native_rle_decode`` /        the COCO compressed-RLE codec
  ``native_rle_encode_counts``   (``rle.cpp``);
* ``native_bilinear_resize``     HWC float32 bilinear resize with torch's
                                 semantics (``resize.cpp``), the
                                 dataset's upsampling of the teacher maps.

The library is compiled at first use, never at import, with the JAX
package's command (``g++ -O3 -march=x86-64-v3 -shared -fPIC``, retried
without ``-march``), so that it computes what JAX's library computes bit
for bit.  It goes to ``rtpe_tpu_torch/_build/librtpe_native.so``
(gitignored) and is rebuilt when older than a source.  Each build writes
a temporary file of its own in that directory and renames it into place,
so processes that build at once leave one whole library.  ``ctypes.CDLL``
releases the GIL for each call, so the data pipeline's worker threads
overlap in these loops.

Without ``g++``, or when the build or the load fails, every function
falls back as the JAX package's does (``None`` for the codec and the
resize, whose callers then use numpy; scipy for ``lap_solve``), and a
``RuntimeWarning`` says so once.  :func:`available` says whether the
library loaded.
"""

import ctypes
import os
import subprocess
import tempfile
import threading
import warnings
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("lap.cpp", "rle.cpp", "resize.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
LIB_NAME = "librtpe_native.so"
CXX = "g++"
# -march=x86-64-v3 (AVX2 baseline), not -march=native: the library can
# outlive the host that built it, and a native-ISA binary then dies with
# SIGILL instead of falling back
ARCH_FLAGS = ("-march=x86-64-v3", None)

_lock = threading.RLock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False
_WARNED = False


def lib_path() -> str:
    return os.path.join(BUILD_DIR, LIB_NAME)


def _stale() -> bool:
    """The library is missing or older than one of its sources."""
    lib = lib_path()
    if not os.path.exists(lib):
        return True
    newest = max(os.path.getmtime(os.path.join(_HERE, s)) for s in SOURCES)
    return os.path.getmtime(lib) < newest


def build(verbose: bool = False) -> bool:
    """Compile the library into :data:`BUILD_DIR` with ``g++``.  Returns
    success.  The compiler writes a temporary file of this call's own,
    which is then renamed over the library."""
    global _LIB_TRIED
    src = [os.path.join(_HERE, s) for s in SOURCES]
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{LIB_NAME}.", suffix=".tmp",
                               dir=BUILD_DIR)
    os.close(fd)
    try:
        for arch in ARCH_FLAGS:
            cmd = [CXX, "-O3", "-shared", "-fPIC", "-o", tmp] + src
            if arch:
                cmd.insert(2, arch)
            try:
                res = subprocess.run(cmd, capture_output=True, text=True)
            except FileNotFoundError:
                return False
            if res.returncode == 0:
                os.chmod(tmp, 0o755)
                os.replace(tmp, lib_path())
                with _lock:
                    _LIB_TRIED = False
                return True
            if verbose:
                print(res.stderr)
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _declare(lib: ctypes.CDLL) -> None:
    dbl, i32 = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int)
    i64, u8 = (ctypes.POINTER(ctypes.c_longlong),
               ctypes.POINTER(ctypes.c_ubyte))
    f32 = ctypes.POINTER(ctypes.c_float)
    sigs = {
        "lap_solve": [dbl, ctypes.c_int, i32, i32],
        "rle_decode_counts": [ctypes.c_char_p, ctypes.c_int, i64,
                              ctypes.c_int],
        "rle_decode_mask": [i64, ctypes.c_int, u8, ctypes.c_longlong],
        "rle_encode_mask": [u8, ctypes.c_longlong, i64, ctypes.c_int],
        "bilinear_resize_hwc": [f32, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, f32, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


def _fallback(why: str) -> None:
    global _WARNED
    if not _WARNED:
        _WARNED = True
        warnings.warn(f"rtpe_tpu_torch.native: {why}; the host helpers "
                      "fall back to numpy / scipy", RuntimeWarning,
                      stacklevel=3)


def _load_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if stale; ``None`` (and one
    warning) when it cannot be built or loaded."""
    global _LIB, _LIB_TRIED
    with _lock:
        if _LIB_TRIED:
            return _LIB
        if _stale() and not build():
            _LIB_TRIED = True
            _fallback(f"{CXX} could not build {lib_path()}")
            return None
        _LIB_TRIED = True
        try:
            lib = ctypes.CDLL(lib_path())
            _declare(lib)
        except (OSError, AttributeError) as exc:
            _fallback(f"{lib_path()} does not load ({exc})")
            return None
        _LIB = lib
        return _LIB


def available() -> bool:
    """Whether the native library is built and loaded (building it on
    the first call)."""
    return _load_lib() is not None


def native_rle_decode(counts_str: bytes, h: int, w: int):
    """C++ RLE decode; returns the (h, w) uint8 mask, or None when the
    native library is unavailable or the counts overflow."""
    lib = _load_lib()
    if lib is None:
        return None
    max_counts = len(counts_str) + 4
    counts = np.zeros(max_counts, dtype=np.int64)
    n = lib.rle_decode_counts(
        counts_str, len(counts_str),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        max_counts)
    if n < 0:
        return None
    flat = np.zeros(h * w, dtype=np.uint8)
    lib.rle_decode_mask(
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), n,
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), h * w)
    return flat.reshape((w, h)).T


def native_rle_encode_counts(mask):
    """C++ run-length pass over the column-major mask; returns the int
    counts list (the first run is of zeros), or None."""
    lib = _load_lib()
    if lib is None:
        return None
    flat = np.ascontiguousarray(np.asarray(mask, np.uint8).T.reshape(-1))
    max_counts = flat.size + 2
    counts = np.zeros(max_counts, dtype=np.int64)
    n = lib.rle_encode_mask(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), flat.size,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        max_counts)
    if n < 0:
        return None
    return counts[:n].tolist()


def lap_solve(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal-cost square assignment.

    :param cost: (k, k) float64 cost matrix.
    :returns: (rows, cols) int arrays, rows == arange(k); scipy's
      ``linear_sum_assignment`` when the library is unavailable or its
      solve fails.
    """
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    k = cost.shape[0]
    assert cost.shape == (k, k), "lap_solve needs a square matrix"
    lib = _load_lib()
    if lib is not None:
        rows = np.arange(k, dtype=np.int32)
        cols = np.zeros(k, dtype=np.int32)
        rc = lib.lap_solve(
            cost.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), k,
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        if rc == 0:
            return rows.astype(np.int64), cols.astype(np.int64)
    from scipy.optimize import linear_sum_assignment
    rows, cols = linear_sum_assignment(cost)
    return rows, cols


def native_bilinear_resize(x_hwc: np.ndarray, out_hw,
                           align_corners: bool = True):
    """C++ bilinear HWC float32 resize; returns None when the library is
    unavailable."""
    lib = _load_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x_hwc, dtype=np.float32)
    ih, iw, c = x.shape
    oh, ow = int(out_hw[0]), int(out_hw[1])
    out = np.empty((oh, ow, c), np.float32)
    rc = lib.bilinear_resize_hwc(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ih, iw, c,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), oh, ow,
        int(bool(align_corners)))
    return out if rc == 0 else None
