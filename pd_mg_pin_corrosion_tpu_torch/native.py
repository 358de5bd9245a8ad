"""ctypes bindings for the native runtime library (native/pdcorr_native.cpp).

(PyTorch port: a copy of ``pd_mg_pin_corrosion_tpu/native.py``; both
packages load the same ``native/libpdcorr_native.so``.)

Builds the shared library on first use (g++ via the Makefile) and caches it;
every entry point has a NumPy fallback so the framework runs without a
toolchain. Covers the host-side runtime hot paths the port uses that are
native C++ in the reference: VTK ASCII serialization and Voronoi grain
assignment (grains.cpp:56-70). (The library's AMR cell-list entry point
has no caller in this slice.)
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_LIB = None
_TRIED = False


def _native_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "native")


def get_lib():
    """Load (building if necessary) the native library, or None."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    nd = _native_dir()
    so = os.path.join(nd, "libpdcorr_native.so")
    if not os.path.exists(so):
        try:
            subprocess.run(["make", "-C", nd], check=True,
                           capture_output=True, timeout=120)
        except Exception as e:  # no toolchain / build failure -> fallback
            print(f"[native] build skipped ({type(e).__name__}); "
                  "using NumPy fallbacks", file=sys.stderr)
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:
        print(f"[native] load failed ({e}); using NumPy fallbacks",
              file=sys.stderr)
        return None

    lib.fmt_doubles.restype = ctypes.c_int64
    lib.fmt_doubles.argtypes = [ctypes.POINTER(ctypes.c_double),
                                ctypes.c_int64, ctypes.c_char_p]
    lib.fmt_vec3.restype = ctypes.c_int64
    lib.fmt_vec3.argtypes = [ctypes.POINTER(ctypes.c_double),
                             ctypes.c_int64, ctypes.c_char_p]
    lib.fmt_ints.restype = ctypes.c_int64
    lib.fmt_ints.argtypes = [ctypes.POINTER(ctypes.c_int64),
                             ctypes.c_int64, ctypes.c_char_p]
    lib.voronoi_assign.restype = None
    _LIB = lib
    return _LIB


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


# ---------------------------------------------------------------------------
# ASCII serialization
# ---------------------------------------------------------------------------

def fmt_scalar_block(vals: np.ndarray) -> str:
    """One '%.9g' value per 10-space-indented line."""
    vals = np.ascontiguousarray(vals, np.float64)
    lib = get_lib()
    if lib is None:
        return "\n".join("          " + ("%.9g" % v) for v in vals) + "\n"
    buf = ctypes.create_string_buffer(32 * len(vals) + 1)
    n = lib.fmt_doubles(_dptr(vals), len(vals), buf)
    return buf.raw[:n].decode()


def fmt_vec3_block(vals: np.ndarray) -> str:
    vals = np.ascontiguousarray(vals, np.float64)
    assert vals.shape[1] == 3
    lib = get_lib()
    if lib is None:
        return "\n".join(
            "          " + " ".join("%.9g" % v for v in row) for row in vals
        ) + "\n"
    buf = ctypes.create_string_buffer(96 * len(vals) + 1)
    n = lib.fmt_vec3(_dptr(vals), len(vals), buf)
    return buf.raw[:n].decode()


def fmt_int_block(vals: np.ndarray) -> str:
    vals = np.ascontiguousarray(vals, np.int64)
    lib = get_lib()
    if lib is None:
        return "\n".join("          %d" % v for v in vals) + "\n"
    buf = ctypes.create_string_buffer(32 * len(vals) + 1)
    n = lib.fmt_ints(vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                     len(vals), buf)
    return buf.raw[:n].decode()


# ---------------------------------------------------------------------------
# Voronoi
# ---------------------------------------------------------------------------

def voronoi_assign(pos: np.ndarray, seeds: np.ndarray):
    """Nearest-seed index per point, or None when native is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, np.float64)
    seeds = np.ascontiguousarray(seeds, np.float64)
    out = np.zeros(len(pos), np.int32)
    lib.voronoi_assign(_dptr(pos), ctypes.c_int64(len(pos)),
                       ctypes.c_int(pos.shape[1]), _dptr(seeds),
                       ctypes.c_int64(len(seeds)),
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out
