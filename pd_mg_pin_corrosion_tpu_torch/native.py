"""ctypes bindings for the native runtime library (native/pdcorr_native.cpp).

(PyTorch port of ``pd_mg_pin_corrosion_tpu/native.py``.)

Builds the shared library from ``native/pdcorr_native.cpp`` and the port's
``csrc/voronoi_fma.cpp`` on first use, into ``build/native/`` under a name
keyed to the sources and flags, and caches it; every entry point has a
NumPy fallback so the framework runs without a toolchain. Covers the
host-side runtime hot paths the port uses that are native C++ in the
reference: VTK ASCII serialization, the gather AMR backend's cell-list
neighbour search (grid.cpp:660-808) and Voronoi grain assignment
(grains.cpp:56-70).

Grain assignment calls ``voronoi_assign_fma``, not the shared source's
``voronoi_assign``: seeds are lattice nodes, so the rounding of the squared
distance decides the grain of every node equidistant from two seeds, and
``d2 += dd * dd`` rounds as the compiler contracts and vectorizes it. At the
3D flagship the JAX package's ``native/Makefile`` build gives 19,507
grain-boundary flags with g++ 13.3 on an x86-64 host with AVX, a scalar
build without contraction (and the NumPy fallback, which rounds each
square) 19,503, and the explicit fused multiply-add 19,497 on every host,
the count of the banked flagship run; the mass loss moves by 4e-4 to 7e-3
relative between them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np

_LIB = None
_TRIED = False

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = (os.path.join(_ROOT, "native", "pdcorr_native.cpp"),
           os.path.join(_ROOT, "pd_mg_pin_corrosion_tpu_torch", "csrc",
                        "voronoi_fma.cpp"))
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")


def _library_path() -> str:
    h = hashlib.sha1(" ".join(CXXFLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(_ROOT, "build", "native",
                        f"libpd_torch_native_{h.hexdigest()[:12]}.so")


def _build(library: str) -> bool:
    """Compile SOURCES into ``library``; False (and a note) if it cannot."""
    os.makedirs(os.path.dirname(library), exist_ok=True)
    tmp = f"{library}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", tmp, *SOURCES]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        print(f"[native] build skipped ({type(e).__name__}); "
              "using NumPy fallbacks", file=sys.stderr)
        return False
    os.replace(tmp, library)
    return True


def get_lib():
    """Load (building if necessary) the native library, or None."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    library = _library_path()
    if not os.path.exists(library) and not _build(library):
        return None
    try:
        lib = ctypes.CDLL(library)
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
    _i32p = ctypes.POINTER(ctypes.c_int32)
    _f64p = ctypes.POINTER(ctypes.c_double)
    lib.cell_list_neighbors_2d.restype = ctypes.c_int64
    lib.cell_list_neighbors_2d.argtypes = [
        _f64p, ctypes.POINTER(ctypes.c_uint8), _f64p, _f64p, _i32p,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        _i32p, _i32p, _f64p, _f64p, _f64p]
    lib.voronoi_assign_fma.restype = None
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
# AMR cell-list neighbour search
# ---------------------------------------------------------------------------

def cell_list_neighbors_2d(pos, node_type, dx_local, delta_local, grid_level):
    """(nbr_idx, nbr_dist, nbr_evec, nbr_vol): the padded neighbour arrays
    of an unstructured 2D grid, K = max(8, the largest degree rounded up to
    a multiple of 8), invalid slots idx = self, dist = 1, evec = 0, vol = 0;
    or None without the native library (the caller falls back to its
    Python builder). Two calls: the degrees, then the fill."""
    lib = get_lib()
    if lib is None:
        return None

    N = len(node_type)
    pos = np.ascontiguousarray(pos, np.float64)
    node_type = np.ascontiguousarray(node_type, np.uint8)
    dx_local = np.ascontiguousarray(dx_local, np.float64)
    delta_local = np.ascontiguousarray(delta_local, np.float64)
    grid_level = np.ascontiguousarray(grid_level, np.int32)
    counts = np.zeros(N, np.int32)

    def i32(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    def call(mode, K, nbr_idx, nbr_dist, nbr_evec, nbr_vol):
        return lib.cell_list_neighbors_2d(
            _dptr(pos), node_type.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            _dptr(dx_local), _dptr(delta_local), i32(grid_level), N, mode, K,
            i32(counts), i32(nbr_idx), _dptr(nbr_dist), _dptr(nbr_evec),
            _dptr(nbr_vol))

    null_i, null_d = np.zeros(1, np.int32), np.zeros(1)
    kmax = int(call(0, 0, null_i, null_d, null_d, null_d))
    K = max(8, ((kmax + 7) // 8) * 8)

    nbr_idx = np.tile(np.arange(N, dtype=np.int32)[:, None], (1, K))
    nbr_dist = np.ones((N, K))
    nbr_evec = np.zeros((N, K, 2))
    nbr_vol = np.zeros((N, K))
    call(1, K, nbr_idx, nbr_dist, nbr_evec, nbr_vol)
    return nbr_idx, nbr_dist, nbr_evec, nbr_vol


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
    lib.voronoi_assign_fma(_dptr(pos), ctypes.c_int64(len(pos)),
                       ctypes.c_int(pos.shape[1]), _dptr(seeds),
                       ctypes.c_int64(len(seeds)),
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out
