"""gpufluidsimulator_torch — the PyTorch/CUDA port of gpufluidsimulator_tpu.

WCSPH on the rank-planar cell grid, with the reference's TPU kernels
rewritten by hand in CUDA C++ for Hopper (``csrc/``, built with nvcc at
first use).  Entry points run on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``, which selects each kernel's plain PyTorch
version.  The package imports neither JAX nor ``gpufluidsimulator_tpu``.
"""

__version__ = "0.1.0"

from .models.params import SimParams           # noqa: F401
from .models.state import State, make_state    # noqa: F401
from .models import scenes                     # noqa: F401
from .models.solver import FluidSim, run, step, rollout  # noqa: F401
