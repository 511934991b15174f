"""cotengra_tpu_torch: the PyTorch / CUDA port of cotengra_tpu.

It stands alone: it imports neither ``cotengra_tpu`` nor JAX. It carries
its own copies of what it needs from the JAX package - the contraction
tree (``tree``), plan loading (``utils.io.load_tree``), the instance
builders (``models``), the executor defaults (``config``), the
host-side lowering and step planning (``ops``), the basic path finders
(``pathfinders``), the ``einsum`` / ``array_contract`` / ``ncon``
front end with its presets (``interface``, ``presets``), and the
compressed (chi-capped) planner: the hypergraph (``hypergraph``), the
objectives with the compressed cost model (``scoring``),
``ContractionTreeCompressed`` (``tree_compressed``), the compressed path
finders and refiners (``pathfinders.compressed``, ``windowed_opt``,
``compressed_bb``), and the sliced planner: the tree's incremental
bookkeeping with slicing and subtree reconfiguration (``tree``),
``SliceFinder`` (``slicing``), the labels partitioner and simulated
annealing (``pathfinders.labels``, ``annealing``), host pools
(``parallel``) and the hyper-optimizer with its samplers and presets
(``hyper``), which ``"auto"`` runs on hard contractions, with the native
planning library (``ops.native``: host C++ greedy, random-greedy,
optimal DP, compressed replay and the ``ctgpart`` partitioner,
``pathfinders.partition``, built with ``g++`` at first use) - and runs trees
on torch tensors, with hand-written CUDA kernels for in-place gate
chains and for matmuls with a fused max|out| (exponent stripping), and
sums slices over the ranks of a ``torch.distributed`` group, one process
per card (``parallel.mesh``).
Compressed trees run through ``contract_compressed`` (``ops.compressed``:
QR and SVD bond truncation with ``torch.linalg``).

Entry points run on the card (``device="cuda"``, the default) unless
the caller passes ``device="cpu"``; without a card ``"cuda"`` raises.
"""

__version__ = "0.1.0"

from ._device import resolve_device
from .convert import to_plane_array, to_plane_tensors, to_tensors
from .hypergraph import HyperGraph, get_hypergraph
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
from .config import (
    default_implementation,
    default_options,
    get_default_implementation,
    set_default_implementation,
)
from .models import (
    lattice_equation,
    make_arrays_from_eq,
    make_arrays_from_inputs,
    make_rand_size_dict_from_inputs,
    make_shapes_from_inputs,
    networkx_graph_to_equation,
    perverse_equation,
    rand_circuit_tn,
    rand_equation,
    rand_tree,
    randreg_equation,
    tree_equation,
)
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
from .scoring import (
    ComboObjective,
    FlopsObjective,
    LimitObjective,
    SizeObjective,
    WriteObjective,
    get_score_fn,
)
from .slicing import ContractionCosts, SliceFinder
from .tree import (
    ContractionTree,
    SliceInfo,
    edge_path_to_linear,
    edge_path_to_ssa,
    linear_to_ssa,
    ssa_to_linear,
)
from .tree_compressed import ContractionTreeCompressed
from .utils.eqs import hash_contraction
from .utils.io import (
    hash_contraction_b,
    load_instance,
    load_tree,
    save_instance,
    save_tree,
)
from .utils.symbols import get_symbol, get_symbol_map

register_builtin_presets()

from .hyper import (  # noqa: E402
    HyperCompressedOptimizer,
    HyperOptimizer,
    ReusableHyperCompressedOptimizer,
    ReusableHyperOptimizer,
    ReusableRandomGreedyOptimizer,
    UniformOptimizer,
    get_hyper_space,
    hyper_compressed_optimize,
    list_hyper_functions,
    register_hyper_function,
    register_hyper_optlib,
)
from .hyper import register_hyper_presets as _register_hyper_presets  # noqa: E402,E501

_register_hyper_presets()

# the reference's aliases (``cotengra.__init__``)
contract = einsum
contract_expression = einsum_expression

# ready-made optimizer instances
greedy_optimize = GreedyOptimizer()
optimal_optimize = OptimalOptimizer()
optimal_outer_optimize = OptimalOptimizer(search_outer=True)


def hyper_optimize(inputs, output, size_dict, memory_limit=None, **opts):
    """One-shot hyper-optimized linear path: a fresh
    :class:`HyperOptimizer` (``memory_limit`` slices to that size)."""
    if memory_limit is not None:
        opts.setdefault("slicing_opts", {"target_size": memory_limit})
    opt = HyperOptimizer(**opts)
    return opt.search(inputs, output, size_dict).get_path()

# the reference's module aliases (``cotengra.__init__``)
from .pathfinders import basic as path_basic  # noqa: E402
from .pathfinders import basic as path_greedy  # noqa: E402
from .pathfinders import compressed as path_compressed_greedy  # noqa: E402
from .pathfinders import windowed_opt as path_compressed  # noqa: E402
from .pathfinders import compressed_bb as path_compressed_branchbound  # noqa: E402,E501
from .pathfinders import labels as path_labels  # noqa: E402
from .hyper import optlibs as hyper_cmaes  # noqa: E402
from .hyper import optlibs as hyper_nevergrad  # noqa: E402
from .hyper import optlibs as hyper_optuna  # noqa: E402
from .hyper import optlibs as hyper_skopt  # noqa: E402
from .hyper import simplex as hyper_neldermead  # noqa: E402
from .hyper import simplex as hyper_sbplx  # noqa: E402
from .hyper import space as hyper_es  # noqa: E402
from .hyper import space as hyper_random  # noqa: E402

__all__ = [
    "AutoHQOptimizer",
    "AutoOptimizer",
    "ComboObjective",
    "ContractionCosts",
    "ContractionTree",
    "ContractionTreeCompressed",
    "EdgeSortOptimizer",
    "FlopsObjective",
    "GreedyOptimizer",
    "HyperCompressedOptimizer",
    "HyperGraph",
    "HyperOptimizer",
    "LimitObjective",
    "OptimalOptimizer",
    "PathOptimizer",
    "RandomGreedyOptimizer",
    "RandomOptimizer",
    "ReusableHyperCompressedOptimizer",
    "ReusableHyperOptimizer",
    "ReusableRandomGreedyOptimizer",
    "SizeObjective",
    "SliceFinder",
    "SliceInfo",
    "UniformOptimizer",
    "Via",
    "WriteObjective",
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
    "default_implementation",
    "default_options",
    "edge_path_to_linear",
    "edge_path_to_ssa",
    "einsum",
    "einsum_expression",
    "einsum_tree",
    "estimate_optimal_hardness",
    "gather_slices",
    "gen_output_chunks",
    "get_default_implementation",
    "get_hyper_space",
    "get_hypergraph",
    "get_score_fn",
    "get_symbol",
    "get_symbol_map",
    "greedy_optimize",
    "hash_contraction",
    "hash_contraction_b",
    "hyper_cmaes",
    "hyper_compressed_optimize",
    "hyper_es",
    "hyper_neldermead",
    "hyper_nevergrad",
    "hyper_optimize",
    "hyper_optuna",
    "hyper_random",
    "hyper_sbplx",
    "hyper_skopt",
    "lattice_equation",
    "linear_to_ssa",
    "list_hyper_functions",
    "list_presets",
    "load_instance",
    "load_tree",
    "make_arrays_from_eq",
    "make_arrays_from_inputs",
    "make_contractor",
    "make_full_contractor",
    "make_grouped_contractor",
    "make_rand_size_dict_from_inputs",
    "make_shapes_from_inputs",
    "ncon",
    "networkx_graph_to_equation",
    "optimal_optimize",
    "optimal_outer_optimize",
    "optimize_edgesort",
    "optimize_greedy",
    "optimize_optimal",
    "optimize_random",
    "optimize_random_greedy_track_flops",
    "optimize_simplify",
    "path_basic",
    "path_compressed",
    "path_compressed_branchbound",
    "path_compressed_greedy",
    "path_greedy",
    "path_labels",
    "perverse_equation",
    "rand_circuit_tn",
    "rand_equation",
    "rand_tree",
    "randreg_equation",
    "register_builtin_presets",
    "register_hyper_function",
    "register_hyper_optlib",
    "register_preset",
    "resolve_device",
    "save_instance",
    "save_tree",
    "set_default_implementation",
    "slice_arrays",
    "ssa_to_linear",
    "to_plane_array",
    "to_plane_tensors",
    "to_tensors",
    "tree_equation",
]
