"""cotengra_tpu_torch: the PyTorch / CUDA port of cotengra_tpu's
execution.

It stands alone: it imports neither ``cotengra_tpu`` nor JAX. It carries
its own copies of what execution needs from the JAX package - the
execution side of the contraction tree (``tree``), plan loading
(``utils.io.load_tree``), the instance builders (``models``), the
executor defaults (``config``), the host-side lowering and step
planning (``ops``) - and runs planned trees on torch tensors, with
hand-written CUDA kernels for in-place gate chains and for matmuls with
a fused max|out| (exponent stripping). Planning new trees (path search,
slicing search) is not ported yet: plans come from saved files or
explicit paths.

Entry points take an explicit ``device=``; ``"cuda"`` without a card
raises.
"""

__version__ = "0.1.0"

from ._device import resolve_device
from .convert import to_plane_array, to_plane_tensors, to_tensors
from .models import lattice_equation, rand_circuit_tn
from .ops import (
    benchmark_tree,
    contract_core,
    contract_slice,
    contract_slices,
    contract_tree,
    gather_slices,
    gen_output_chunks,
    make_contractor,
    make_full_contractor,
    make_grouped_contractor,
    slice_arrays,
)
from .ops.preprocess import absorb_simple_tensors
from .tree import ContractionTree
from .utils.io import load_tree

__all__ = [
    "ContractionTree",
    "absorb_simple_tensors",
    "benchmark_tree",
    "contract_core",
    "contract_slice",
    "contract_slices",
    "contract_tree",
    "gather_slices",
    "gen_output_chunks",
    "lattice_equation",
    "load_tree",
    "make_contractor",
    "make_full_contractor",
    "make_grouped_contractor",
    "rand_circuit_tn",
    "resolve_device",
    "slice_arrays",
    "to_plane_array",
    "to_plane_tensors",
    "to_tensors",
]
