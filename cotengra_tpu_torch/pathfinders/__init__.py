"""Path finders (counterpart of ``cotengra_tpu/pathfinders``: ``base``,
``basic``, ``edgesort``, ``random``, and the compressed ``compressed``,
``windowed_opt``, ``compressed_bb``). The hyper-optimizer and the other
path finders are not ported yet."""

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
