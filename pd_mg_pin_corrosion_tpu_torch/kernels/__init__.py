"""Hand-written CUDA kernels of the port (counterpart of the JAX package's
``pallas_kernels.py``), each beside its plain PyTorch twin.

Every wrapper follows one rule (``build.use_plain``): CPU tensors take the
plain version, CUDA float32 tensors launch the kernel or raise — there is no
fallback that hides a failed build or launch. Each wrapper counts its own
launches in a plain integer attribute, ``wrapper.launches``.
"""

from __future__ import annotations

from dataclasses import dataclass

from .basis import basis_axpy, basis_axpy_plain, basis_dots, basis_dots_plain
from .matvec2d import matvec2d, matvec2d_plain
from .matvec3d import matvec3d, matvec3d_plain, slots3d_f64, slots3d_f64_plain
from .ns2d import ns2d, ns2d_plain
from .ns3d import ns3d, ns3d_plain


@dataclass(frozen=True)
class KernelInfo:
    name: str
    wrapper: object
    source: str     # CUDA source, relative to the repo root
    replaces: str   # file:line of the TPU (Pallas) kernel body it replaces


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
    KernelInfo("slots3d_f64", slots3d_f64,
               "pd_mg_pin_corrosion_tpu_torch/csrc/matvec3d.cu",
               "pd_mg_pin_corrosion_tpu/pallas_kernels.py:982"),
)


def launch_counts() -> dict:
    return {k.name: k.wrapper.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.wrapper.launches = 0
