"""Path finders (counterpart of ``cotengra_tpu/pathfinders``: ``base``,
``basic``, ``edgesort``, ``random``, the partitioners ``labels`` and
``partition`` (ctgpart, the native multilevel one), the tree refiner
``annealing``, and the compressed ``compressed``, ``windowed_opt``,
``compressed_bb``, the optional ``kahypar`` and ``igraph`` partitioners,
the tree-decomposition adapters ``external`` over ``linegraph``, and the
experimental ``mcts``). The hyper-optimizer that drives them is
``cotengra_tpu_torch.hyper``."""

from .base import PathOptimizer
from .basic import (
    GreedyOptimizer,
    OptimalOptimizer,
    RandomGreedyOptimizer,
    optimize_greedy,
    optimize_optimal,
    optimize_random_greedy_track_flops,
    optimize_simplify,
)

__all__ = [
    "GreedyOptimizer",
    "OptimalOptimizer",
    "PathOptimizer",
    "RandomGreedyOptimizer",
    "optimize_greedy",
    "optimize_optimal",
    "optimize_random_greedy_track_flops",
    "optimize_simplify",
]
