"""cotengra_tpu_torch: the PyTorch / CUDA port of cotengra_tpu.

It stands alone: it imports neither ``cotengra_tpu`` nor JAX. It carries
its own copies of what it needs from the JAX package - the contraction
tree (``tree``), plan loading (``utils.io.load_tree``), the instance
builders (``models``), the executor defaults (``config``), the
host-side lowering and step planning (``ops``), the basic path finders
(``pathfinders``), and the ``einsum`` / ``array_contract`` / ``ncon``
front end with its presets (``interface``, ``presets``) - and runs
trees on torch tensors, with hand-written CUDA kernels for in-place
gate chains and for matmuls with a fused max|out| (exponent stripping).
The hyper-optimizer and slicing search are not ported yet: ``"auto"``
plans hard contractions with random-greedy.

Entry points run on the card (``device="cuda"``, the default) unless
the caller passes ``device="cpu"``; without a card ``"cuda"`` raises.
"""

__version__ = "0.1.0"

from ._device import resolve_device
from .convert import to_plane_array, to_plane_tensors, to_tensors
from .interface import (
    Via,
    array_contract,
    array_contract_expression,
    array_contract_path,
    array_contract_tree,
    einsum,
    einsum_expression,
    einsum_tree,
    list_presets,
    ncon,
    register_preset,
)
from .models import lattice_equation, rand_circuit_tn, rand_equation
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
from .pathfinders.base import PathOptimizer
from .pathfinders.basic import (
    GreedyOptimizer,
    OptimalOptimizer,
    RandomGreedyOptimizer,
    optimize_greedy,
    optimize_optimal,
    optimize_random_greedy_track_flops,
    optimize_simplify,
)
from .pathfinders.edgesort import EdgeSortOptimizer, optimize_edgesort
from .pathfinders.random import RandomOptimizer, optimize_random
from .presets import (
    AutoHQOptimizer,
    AutoOptimizer,
    auto_hq_optimize,
    auto_optimize,
    estimate_optimal_hardness,
    register_builtin_presets,
)
from .tree import (
    ContractionTree,
    SliceInfo,
    edge_path_to_linear,
    edge_path_to_ssa,
    linear_to_ssa,
    ssa_to_linear,
)
from .utils.eqs import hash_contraction
from .utils.io import load_tree
from .utils.symbols import get_symbol

register_builtin_presets()

# the reference's aliases (``cotengra.__init__``)
contract = einsum
contract_expression = einsum_expression

# ready-made optimizer instances
greedy_optimize = GreedyOptimizer()
optimal_optimize = OptimalOptimizer()
optimal_outer_optimize = OptimalOptimizer(search_outer=True)

__all__ = [
    "AutoHQOptimizer",
    "AutoOptimizer",
    "ContractionTree",
    "EdgeSortOptimizer",
    "GreedyOptimizer",
    "OptimalOptimizer",
    "PathOptimizer",
    "RandomGreedyOptimizer",
    "RandomOptimizer",
    "SliceInfo",
    "Via",
    "absorb_simple_tensors",
    "array_contract",
    "array_contract_expression",
    "array_contract_path",
    "array_contract_tree",
    "auto_hq_optimize",
    "auto_optimize",
    "benchmark_tree",
    "contract",
    "contract_core",
    "contract_expression",
    "contract_slice",
    "contract_slices",
    "contract_tree",
    "edge_path_to_linear",
    "edge_path_to_ssa",
    "einsum",
    "einsum_expression",
    "einsum_tree",
    "estimate_optimal_hardness",
    "gather_slices",
    "gen_output_chunks",
    "get_symbol",
    "greedy_optimize",
    "hash_contraction",
    "lattice_equation",
    "linear_to_ssa",
    "list_presets",
    "load_tree",
    "make_contractor",
    "make_full_contractor",
    "make_grouped_contractor",
    "ncon",
    "optimal_optimize",
    "optimal_outer_optimize",
    "optimize_edgesort",
    "optimize_greedy",
    "optimize_optimal",
    "optimize_random",
    "optimize_random_greedy_track_flops",
    "optimize_simplify",
    "rand_circuit_tn",
    "rand_equation",
    "register_builtin_presets",
    "register_preset",
    "resolve_device",
    "slice_arrays",
    "ssa_to_linear",
    "to_plane_array",
    "to_plane_tensors",
    "to_tensors",
]
