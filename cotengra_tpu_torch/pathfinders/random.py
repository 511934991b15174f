"""Uniform random pairing, the baseline path finder (counterpart of
``cotengra_tpu/pathfinders/random.py``)."""

from ..utils.misc import get_rng
from .base import PathOptimizer


def ssa_random(inputs, output, size_dict, seed=None):
    rng = get_rng(seed)
    nodes = list(range(len(inputs)))
    ssa = len(inputs)
    path = []
    while len(nodes) > 1:
        i, j = rng.sample(range(len(nodes)), 2)
        a, b = nodes[i], nodes[j]
        for k in sorted((i, j), reverse=True):
            nodes.pop(k)
        path.append((a, b))
        nodes.append(ssa)
        ssa += 1
    return path


def optimize_random(inputs, output, size_dict, seed=None, use_ssa=False):
    path = ssa_random(inputs, output, size_dict, seed=seed)
    if use_ssa:
        return path
    from ..tree import ssa_to_linear

    return ssa_to_linear(path, len(inputs))


class RandomOptimizer(PathOptimizer):
    def __init__(self, seed=None):
        self.seed = seed

    def ssa_path(self, inputs, output, size_dict):
        return ssa_random(inputs, output, size_dict, seed=self.seed)
