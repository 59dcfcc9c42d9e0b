"""latticeboltzmann_tpu — a D2Q9 Lattice-Boltzmann (BGK) framework in JAX.

Built from scratch in JAX/XLA/Pallas with the full capability set of the
reference C implementation (jodavies/latticeboltzmann): fused
collide-and-stream, bounce-back walls, channel forcing, float32/float64/
bfloat16 precision parameterization, multi-device lattice sharding with
overlapped halo exchange, and the reference's diagnostics
(Reynolds number, MLUPS/bandwidth self-report, field snapshots, flow movie).
"""

from .core.spec import LatticeConfig, E, W, OPPOSITE, NSPEEDS, FLOP_PER_SITE
from .core import geometry
from .models.engine import Simulation, available_backends, initial_state

__version__ = "0.1.0"

__all__ = [
    "LatticeConfig",
    "Simulation",
    "geometry",
    "available_backends",
    "initial_state",
    "E",
    "W",
    "OPPOSITE",
    "NSPEEDS",
    "FLOP_PER_SITE",
    "__version__",
]
