"""PyTorch/CUDA port of the peridynamic Mg-pin corrosion framework.

A second package beside the JAX reference ``pd_mg_pin_corrosion_tpu``,
with the same module names so each counterpart is easy to find. It imports
``torch`` and never ``jax``; its hot kernels are hand-written CUDA C++ for
Hopper (``csrc/``, bound in ``kernels/``), each with a plain PyTorch twin
that runs on the CPU.

It runs the structured grid's implicit and explicit transport paths in 2D
and 3D, and two-level AMR with either backend (``amr_blocks``, the dense
blocks; ``amr`` / ``unstructured``, the gather backend), through one
coupling loop (``cli.main`` -> ``CoupledSolver.run``, ops from
``dispatch.ops_for``), with checkpoint/resume.
"""

import torch

# Full-f32 matmuls and convolutions everywhere: TF32 keeps ~3 decimal
# digits, and reduced-precision mirror products already stalled 3D flow
# convergence once in the reference package (docs/PARITY.md, "3D" (b)).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import Config  # noqa: E402
from .fields import State, initialize_state, state_from_numpy  # noqa: E402
from .grid import (FICTITIOUS, FLUID, INLET, OUTLET, OUTSIDE,  # noqa: E402
                   SOLID_MG, WALL, Grid, build_grid, build_stencil)
from .kit import Kit, build_kit  # noqa: E402

__version__ = "0.1.0"
