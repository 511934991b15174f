"""ncon-style sorted-edge elimination (counterpart of
``cotengra_tpu/pathfinders/edgesort.py``): contract indices in sorted
label order."""

from .base import PathOptimizer


def ssa_edgesort(inputs, output, size_dict):
    out_set = set(output)
    edges = sorted(
        {ix for term in inputs for ix in term if ix not in out_set},
        key=str,
    )
    # current ssa node -> the indices it holds
    term_inds = {i: set(term) for i, term in enumerate(inputs)}
    ssa = len(inputs)
    path = []
    for ix in edges:
        holders = [i for i, inds in term_inds.items() if ix in inds]
        if len(holders) < 2:
            continue
        merged = set()
        for i in holders:
            merged |= term_inds.pop(i)
        path.append(tuple(holders))
        term_inds[ssa] = merged
        ssa += 1
    # whatever is left is contracted together
    remaining = list(term_inds)
    if len(remaining) > 1:
        path.append(tuple(remaining))
    return path


def optimize_edgesort(inputs, output, size_dict, use_ssa=False):
    path = ssa_edgesort(inputs, output, size_dict)
    if use_ssa:
        return path
    from ..tree import ssa_to_linear

    return ssa_to_linear(path, len(inputs))


class EdgeSortOptimizer(PathOptimizer):
    def ssa_path(self, inputs, output, size_dict):
        return ssa_edgesort(inputs, output, size_dict)
