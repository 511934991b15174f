"""Instance builders (counterparts of ``cotengra_tpu/models``)."""

from .circuits import rand_circuit_tn
from .instances import Contraction, lattice_equation, rand_equation

__all__ = [
    "Contraction", "lattice_equation", "rand_circuit_tn", "rand_equation",
]
