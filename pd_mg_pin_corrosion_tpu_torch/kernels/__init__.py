"""Hand-written CUDA kernels of the port (counterpart of the JAX package's
``pallas_kernels.py``), each beside its plain PyTorch twin.

Every wrapper follows one rule (``build.use_plain``): CPU tensors take the
plain version, CUDA float32 tensors launch the kernel or raise — there is no
fallback that hides a failed build or launch. Each wrapper counts its own
launches in a plain integer attribute, ``wrapper.launches`` (per weight
type or form where one wrapper launches several instantiations of its
kernel: ``KernelInfo.counter``). A replay of a captured CUDA graph
(``solvers.FlowRunner``, ``ops.gmres.GmresRunner``) adds the launches its
capture recorded (``add_launch_counts``): a graph with conditional nodes
once per run of each body, as the device's trip counters report.
"""

from __future__ import annotations

import contextlib
import gc
from dataclasses import dataclass

from .ard2d import (ard2d, ard2d_geometry, ard2d_plain, ard2d_staged_plain,
                    ard2d_staging)
from .basis import (basis_axpy, basis_axpy_plain, basis_dots,
                    basis_dots_plain, basis_dots_walk_plain, dots_grid,
                    pitched_basis, reserve_dots_scratch)
from .cycle_loop import cycle_qr, cycle_qr_plain
from .device_loop import gmres_qr, gmres_qr_plain
from .matvec2d import matvec2d, matvec2d_plain
from .matvec3d import (PackedStencil, matvec3d, matvec3d_packed_plain,
                       matvec3d_plain, pack3d, pack3d_alloc, pack3d_dense,
                       pack3d_plain, pack_stencil,
                       slots3d_f64, slots3d_f64_packed_plain,
                       slots3d_f64_plain, unpack_stencil)
from .ns2d import (Ns2dTables, ns2d, ns2d_geometry, ns2d_plain,
                   ns2d_staged_plain, ns2d_staging, ns2d_tables)
from .ns3d import (Ns3dTables, ns3d, ns3d_geometry, ns3d_plain,
                   ns3d_staged_plain, ns3d_staging, ns3d_tables)
from .ns3d_chunked import (BZ_RUNGS, Ns3dChunkedTables, compute_actconv,
                           group_chunks, ns3d_chunked, ns3d_chunked_geometry,
                           ns3d_chunked_plain, ns3d_chunked_staged_plain,
                           ns3d_chunked_tables, ns3d_jstat, ns3d_jstat_plain)


@dataclass(frozen=True)
class KernelInfo:
    name: str
    wrapper: object
    source: str     # CUDA source, relative to the repo root
    replaces: str   # file:line of the TPU (Pallas) kernel body it replaces
    counter: str = "launches"   # the wrapper attribute counting its launches


KERNELS = (
    KernelInfo("ns2d", ns2d,
               "pd_mg_pin_corrosion_tpu_torch/csrc/ns2d.cu",
               "pd_mg_pin_corrosion_tpu/pallas_kernels.py:97"),
    KernelInfo("matvec2d", matvec2d,
               "pd_mg_pin_corrosion_tpu_torch/csrc/matvec2d.cu",
               "pd_mg_pin_corrosion_tpu/pallas_kernels.py:704"),
    KernelInfo("basis_dots", basis_dots,
               "pd_mg_pin_corrosion_tpu_torch/csrc/basis.cu",
               "pd_mg_pin_corrosion_tpu/pallas_kernels.py:1323"),
    KernelInfo("basis_axpy", basis_axpy,
               "pd_mg_pin_corrosion_tpu_torch/csrc/basis.cu",
               "pd_mg_pin_corrosion_tpu/pallas_kernels.py:1368"),
    KernelInfo("ns3d", ns3d,
               "pd_mg_pin_corrosion_tpu_torch/csrc/ns3d.cu",
               "pd_mg_pin_corrosion_tpu/pallas_kernels.py:413"),
    KernelInfo("matvec3d", matvec3d,
               "pd_mg_pin_corrosion_tpu_torch/csrc/matvec3d.cu",
               "pd_mg_pin_corrosion_tpu/pallas_kernels.py:804"),
    KernelInfo("matvec3d_bf16", matvec3d,
               "pd_mg_pin_corrosion_tpu_torch/csrc/matvec3d.cu",
               "pd_mg_pin_corrosion_tpu/pallas_kernels.py:804",
               "launches_bf16"),
    KernelInfo("slots3d_f64", slots3d_f64,
               "pd_mg_pin_corrosion_tpu_torch/csrc/matvec3d.cu",
               "pd_mg_pin_corrosion_tpu/pallas_kernels.py:982"),
    KernelInfo("ard2d", ard2d,
               "pd_mg_pin_corrosion_tpu_torch/csrc/ard2d.cu",
               "pd_mg_pin_corrosion_tpu/pallas_kernels.py:1130"),
    *(KernelInfo(f"ns3d_chunked_{form}", ns3d_chunked,
                 "pd_mg_pin_corrosion_tpu_torch/csrc/ns3d_chunked.cu",
                 "scripts/exp_ns3d_chunked.py:81", f"launches_{form}")
      for form in ("xla", "factored", "jconv")),
    KernelInfo("ns3d_jstat", ns3d_jstat,
               "pd_mg_pin_corrosion_tpu_torch/csrc/ns3d_chunked.cu",
               "scripts/exp_ns3d_chunked.py:392"),
    # no Pallas kernel: the JAX package's Givens update, exit test and
    # back-substitution run in XLA inside its GMRES while_loops
    KernelInfo("gmres_qr", gmres_qr,
               "pd_mg_pin_corrosion_tpu_torch/csrc/gmres_qr.cu",
               "pd_mg_pin_corrosion_tpu/ops/gmres.py:186"),
    # no Pallas kernel: the JAX package's fused cycles decide their
    # micro-ops and flow segments in XLA (coupled_cycles_chunk's
    # while_loop and switch)
    KernelInfo("cycle_qr", cycle_qr,
               "pd_mg_pin_corrosion_tpu_torch/csrc/cycle_qr.cu",
               "pd_mg_pin_corrosion_tpu/coupling.py:382"),
    # no Pallas kernel: the JAX package's 3D matvec streams the dense W
    # its fused cycles assemble in XLA (coupled_cycles_chunk)
    KernelInfo("pack3d", pack3d,
               "pd_mg_pin_corrosion_tpu_torch/csrc/pack3d.cu",
               "pd_mg_pin_corrosion_tpu/coupling.py:283"),
)


def launch_counts() -> dict:
    return {k.name: getattr(k.wrapper, k.counter) for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        setattr(k.wrapper, k.counter, 0)


@contextlib.contextmanager
def no_collection():
    """Python's cycle collector run once, then held off until the block
    ends: the block captures a CUDA graph. A collection inside it could
    free a dead kit's runners, whose graphs' destruction (a call no global
    capture permits) invalidates the capture."""
    gc.collect()
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def add_launch_counts(counts: dict) -> None:
    """Add ``counts`` ({name: launches}) to the wrappers' counters: what a
    replay of a CUDA graph launched, which no wrapper saw."""
    for k in KERNELS:
        n = counts.get(k.name)
        if n:
            setattr(k.wrapper, k.counter, getattr(k.wrapper, k.counter) + n)
