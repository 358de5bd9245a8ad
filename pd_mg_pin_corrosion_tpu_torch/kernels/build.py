"""Build, load and launch helpers for the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all of
them started together, and the objects are linked into ONE shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
loaded with ``ctypes``. The build happens at first use, into
``build/torch_kernels/`` beside the package, under a file name keyed on a
hash of the sources and flags, so an edited source always rebuilds and an
unchanged one is reused. Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"

# -fmad=false: no a*b+c contraction, so each kernel reproduces its plain
# PyTorch twin's roundings exactly (the twins are separate mul/add ops).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC")


@dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    seconds: float   # build (or load) time of this process's first use
    built: bool      # False when a cached library was loaded
    log: str         # nvcc output (ptxas register / spill report)


_LIBRARY: KernelLibrary | None = None


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "pd_mg_pin_corrosion_tpu_torch cannot be built")
    return nvcc


def _source_key(sources, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for f in sources:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
    lib.pd_ns2d.restype = i32
    lib.pd_ns2d.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32,
                            i32, f32, f32, f32, f32, f32, vp, vp, i32, vp]
    lib.pd_ns2d_geometry.restype = None
    lib.pd_ns2d_geometry.argtypes = [ctypes.POINTER(ctypes.c_int * 8)]
    lib.pd_matvec2d.restype = i32
    lib.pd_matvec2d.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, vp, i32,
                                vp]
    lib.pd_ns3d.restype = i32
    lib.pd_ns3d.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32,
                            i32, i32, f32, f32, f32, f32, f32, vp, vp, i32,
                            vp]
    lib.pd_ns3d_geometry.restype = None
    lib.pd_ns3d_geometry.argtypes = [ctypes.POINTER(ctypes.c_int * 10)]
    for name in ("pd_matvec3d_f32", "pd_matvec3d_bf16"):
        getattr(lib, name).restype = i32
        getattr(lib, name).argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, i32,
                                       i32, i32, i32, i32, vp, i32, vp]
    lib.pd_slots3d_f64.restype = i32
    lib.pd_slots3d_f64.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, i32, i32,
                                   i32, vp, i32, vp]
    lib.pd_basis_dots.restype = i32
    lib.pd_basis_dots.argtypes = [vp, i64, vp, i32, i64, i32, i32, i32, vp,
                                  vp, vp, i32, vp]
    lib.pd_basis_axpy.restype = i32
    lib.pd_basis_axpy.argtypes = [vp, vp, i64, vp, i32, i64, i32, i32, vp,
                                  i32, vp]
    lib.pd_ard2d.restype = i32
    lib.pd_ard2d.argtypes = [vp, vp, vp, vp, vp, vp, f32, vp, vp, vp, i32,
                             i32, i32, i32, f32, f32, f32, f32, f32, f32, vp,
                             i32, vp]
    lib.pd_ard2d_geometry.restype = None
    lib.pd_ard2d_geometry.argtypes = [ctypes.POINTER(ctypes.c_int * 8)]
    lib.pd_ns3d_chunked.restype = i32
    lib.pd_ns3d_chunked.argtypes = [i32, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                                    vp, i32, i32, i32, i32, i32, i32, i32,
                                    f32, f32, f32, f32, f32, vp, vp, i32, vp]
    lib.pd_ns3d_chunked_geometry.restype = i32
    lib.pd_ns3d_chunked_geometry.argtypes = [
        i32, i32, ctypes.POINTER(ctypes.c_int * 10)]
    f64 = ctypes.c_double
    lib.pd_gmres_qr_begin.restype = i32
    lib.pd_gmres_qr_begin.argtypes = [i32, vp, vp, f64, f64, f64, f64, i64,
                                      i64, i64, i64, i64, i64, i64, i32, vp]
    lib.pd_gmres_qr.restype = i32
    lib.pd_gmres_qr.argtypes = [i32, i32, i32, vp, vp, vp, vp, vp, vp, i32,
                                i32, vp]
    lib.pd_cycle_qr.restype = i32
    lib.pd_cycle_qr.argtypes = [i32, vp, vp, vp, vp, i64,
                                ctypes.POINTER(f64), i32, i32, vp]
    lib.pd_cycle_qr_layout.restype = None
    lib.pd_cycle_qr_layout.argtypes = [ctypes.POINTER(i32)]
    consts = ctypes.POINTER(f32)
    lib.pd_pack3d_count.restype = i32
    lib.pd_pack3d_count.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, i32, i32,
                                    i32, i32, consts, vp, vp, vp, vp, vp, vp,
                                    vp, vp, i32, vp]
    lib.pd_pack3d_fill.restype = i32
    lib.pd_pack3d_fill.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, consts,
                                   vp, vp, vp, vp, i64, vp, vp, vp, vp, i32,
                                   vp]
    lib.pd_pack3d_dense.restype = i32
    lib.pd_pack3d_dense.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp, vp,
                                    vp, vp, i64, vp, vp, vp, vp, i32, vp]
    lib.pd_cg_runtime_version.restype = i32
    lib.pd_cg_runtime_version.argtypes = []
    lib.pd_cg_create.restype = i32
    lib.pd_cg_create.argtypes = [ctypes.POINTER(vp)]
    lib.pd_cg_add_copy.restype = i32
    lib.pd_cg_add_copy.argtypes = [vp, vp, vp, i32, ctypes.POINTER(vp)]
    lib.pd_cg_add_if.restype = i32
    lib.pd_cg_add_if.argtypes = [vp, vp, vp, ctypes.POINTER(vp),
                                 ctypes.POINTER(vp)]
    lib.pd_cg_add_switch.restype = i32
    lib.pd_cg_add_switch.argtypes = [vp, vp, vp, i32, ctypes.POINTER(vp), vp]
    lib.pd_cg_add_while.restype = i32
    lib.pd_cg_add_while.argtypes = [vp, vp, vp, ctypes.POINTER(vp),
                                    ctypes.POINTER(vp),
                                    ctypes.POINTER(ctypes.c_ulonglong)]
    lib.pd_cg_add_set.restype = i32
    lib.pd_cg_add_set.argtypes = [vp, vp, ctypes.c_ulonglong, vp,
                                  ctypes.POINTER(vp)]
    lib.pd_cg_instantiate.restype = i32
    lib.pd_cg_instantiate.argtypes = [vp, ctypes.POINTER(vp), i32]
    lib.pd_cg_launch.restype = i32
    lib.pd_cg_launch.argtypes = [vp, i32, vp]
    lib.pd_cg_destroy.restype = i32
    lib.pd_cg_destroy.argtypes = [vp, vp]
    lib.pd_cuda_error_string.restype = ctypes.c_char_p
    lib.pd_cuda_error_string.argtypes = [i32]


def load() -> KernelLibrary:
    """The kernel library, building it first if needed. Raises on any
    build or load failure — there is no fallback."""
    global _LIBRARY
    if _LIBRARY is None:
        _LIBRARY = build_library()
    return _LIBRARY


def build_library(defines=()) -> KernelLibrary:
    """Build (or reuse) and load the library compiled with the extra
    ``-D`` macros ``defines`` (``"NAME=value"`` strings). The port's
    wrappers use the one without any (``load``); a tuning sweep builds
    variants of the sources' ``#ifndef`` constants beside it."""
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    sources = sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))
    key = _source_key(sources, flags)
    out_dir = BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"libpd_torch_kernels_{key}.so"
    t0 = time.time()
    built, log = False, ""
    if not so.exists():
        log = _compile_and_link(sources, flags, out_dir, so)
        (out_dir / f"build_{key}.log").write_text(log)
        built = True
    lib = ctypes.CDLL(str(so))
    _declare(lib)
    return KernelLibrary(lib, so, time.time() - t0, built, log)


def _run(cmds) -> str:
    """Run the commands all at once; their joined output, or raise with it
    if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {p.returncode}):\n"
                               f"{' '.join(c)}\n{out}")
    return "".join(outs)


def _compile_and_link(sources, flags, out_dir: Path, so: Path) -> str:
    """One nvcc per .cu source, in parallel, then one link into ``so``."""
    nvcc = find_nvcc()
    cu = [s for s in sources if s.suffix == ".cu"]
    tag = f"{so.stem}.{os.getpid()}"
    objs = [out_dir / f".{tag}.{s.stem}.o" for s in cu]
    log = _run([[nvcc, *flags, "-c", "-o", str(o), str(s)]
                for s, o in zip(cu, objs)])
    tmp = out_dir / f".{tag}.so.tmp"
    log += _run([[nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                  "-o", str(tmp), *(str(o) for o in objs)]])
    os.replace(tmp, so)
    for o in objs:
        o.unlink()
    return log


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = load().lib.pd_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}: {msg})")


# ---------------------------------------------------------------------------
# wrapper helpers
# ---------------------------------------------------------------------------

def use_plain(name: str, *tensors) -> bool:
    """The device rule every wrapper follows: tensors on the CPU take the
    plain PyTorch version; CUDA float32 tensors launch the kernel; anything
    else raises (CUDA float64 parity runs call the plain version at the
    call site, never through a wrapper)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in tensors:
        if t.is_floating_point() and t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32, got "
                            f"{t.dtype} (f64 runs use the plain version)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input")
    return False


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
