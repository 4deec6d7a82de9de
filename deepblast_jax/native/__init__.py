"""Native (C) runtime components, compiled on demand with the system
toolchain and loaded via ctypes.

The only hot host-side loop in the product is the greedy traceback walk
(reference: deepblast/nw.py:401-444): O(n+m) Python-level cell reads per
pair dominate the host postprocess of a large decode batch.
``ctraceback.c`` is the same walk in C (~1000x per-cell); the Python walk
in :mod:`deepblast_jax.ops.dp` remains the oracle and fallback.

Set ``DEEPBLAST_NO_NATIVE=1`` to force the Python fallback (tests cover
parity of both paths).
"""

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ctraceback.c")
_LIB = None
_TRIED = False


def _build_lib():
    """Compile ctraceback.c into a cache dir keyed by source hash."""
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    cachedir = os.environ.get("DEEPBLAST_NATIVE_CACHE",
                              os.path.join(_HERE, "_build"))
    os.makedirs(cachedir, exist_ok=True)
    sopath = os.path.join(cachedir, f"ctraceback-{tag}.so")
    if not os.path.exists(sopath):
        cc = os.environ.get("CC", "cc")
        tmp = sopath + f".tmp{os.getpid()}"
        subprocess.run(
            [cc, "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, sopath)  # atomic under concurrent builders
    return sopath


def get_lib():
    """The loaded CDLL, or ``None`` if disabled or the build failed."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("DEEPBLAST_NO_NATIVE"):
        return None
    try:
        lib = ctypes.CDLL(_build_lib())
    except (OSError, subprocess.SubprocessError):
        return None
    i64, i32p, f32p, f64p = (ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
                             ctypes.POINTER(ctypes.c_float),
                             ctypes.POINTER(ctypes.c_double))
    lib.traceback_affine_f32.restype = i64
    lib.traceback_affine_f32.argtypes = [f32p, i64, i64, i64, i64, i32p, i64]
    lib.traceback_affine_f64.restype = i64
    lib.traceback_affine_f64.argtypes = [f64p, i64, i64, i64, i64, i32p, i64]
    _LIB = lib
    return _LIB


def _as_states(out, cnt):
    # tolist + map(tuple) is ~8x the naive per-element loop; the states
    # list (API: [(i, j, state), ...]) dominates walk cost otherwise
    return list(map(tuple, out[:cnt].tolist()))


def traceback_affine(base, si, sj, n, m):
    """C walk over ``cell(i, j) = base[i*si + j*sj]`` (1-D contiguous
    ``base`` of float32/float64).  Returns the states list, or ``None``
    if the native lib is unavailable (caller falls back to Python)."""
    lib = get_lib()
    if lib is None:
        return None
    base = np.ascontiguousarray(base)
    if base.dtype == np.float32:
        fn, cp = lib.traceback_affine_f32, ctypes.POINTER(ctypes.c_float)
    elif base.dtype == np.float64:
        fn, cp = lib.traceback_affine_f64, ctypes.POINTER(ctypes.c_double)
    else:
        return None
    cap = n + m + 1
    out = np.empty((cap, 3), np.int32)
    cnt = fn(base.ctypes.data_as(cp), si, sj, n, m,
             out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
    if cnt < 0:  # pragma: no cover - cap is the proven worst case
        return None
    return _as_states(out, cnt)
