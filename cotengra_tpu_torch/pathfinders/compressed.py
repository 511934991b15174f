"""Pathfinders specialized for *compressed* contraction (counterpart of
``cotengra_tpu/pathfinders/compressed.py``): the cost of a candidate
contraction is its post-compression (chi-capped) size, and good orders
look like sweeps over the network surface.

- ``greedy_compressed_ssa``: greedy pair selection scored on compressed
  candidate size, subgraph balance and centrality, with Gumbel
  temperature;
- ``greedy_span_ssa``: spanning-tree-like sweep orders outward from (or
  inward to) the most/least central node.

With a seed and a temperature they draw the JAX package's Gumbel
numbers and return its paths.
"""

import heapq
import itertools
import math

from ..hypergraph import HyperGraph
from ..utils.misc import GumbelBatchedGenerator, get_rng


def _auto_chi(size_dict):
    return max(size_dict.values(), default=2) ** 2


def greedy_compressed_ssa(
    inputs,
    output,
    size_dict,
    chi="auto",
    coeff_size_compressed=1.0,
    coeff_size=0.0,
    coeff_subgraph=0.0,
    coeff_centrality=0.0,
    temperature=0.0,
    seed=None,
):
    """Greedy compressed-aware contraction order (SSA path)."""
    if chi == "auto":
        chi = _auto_chi(size_dict)
    rng = get_rng(seed)
    gumbel = GumbelBatchedGenerator(rng)

    hg = HyperGraph(inputs, output, size_dict)
    cent = hg.simple_centrality()
    subsize = {i: 1 for i in hg.nodes}
    n = len(inputs)
    ssa_of = {i: i for i in range(n)}
    ssa = n
    path = []

    counter = itertools.count()
    queue = []

    def score(i, j):
        s = 0.0
        if coeff_size_compressed:
            s += coeff_size_compressed * math.log2(
                max(hg.candidate_contraction_size(i, j, chi=chi), 1)
            )
        if coeff_size:
            s += coeff_size * math.log2(
                max(hg.node_size(i) * hg.node_size(j), 1)
            )
        if coeff_subgraph:
            s += coeff_subgraph * math.log2(
                subsize[i] + subsize[j]
            )
        if coeff_centrality:
            s += coeff_centrality * abs(cent[i] - cent[j])
        if temperature:
            s -= temperature * gumbel()
        return s

    def push(i, j):
        heapq.heappush(queue, (score(i, j), next(counter), i, j))

    seen_pairs = set()
    for i in hg.nodes:
        for j in hg.neighbors(i):
            key = (min(i, j), max(i, j))
            if key not in seen_pairs:
                seen_pairs.add(key)
                push(*key)

    while queue:
        _, _, i, j = heapq.heappop(queue)
        if not (hg.has_node(i) and hg.has_node(j)):
            continue
        k = hg.contract(i, j)
        hg.compress(chi, edges=hg.get_node(k))
        path.append((ssa_of.pop(i), ssa_of.pop(j)))
        ssa_of[k] = ssa
        ssa += 1
        cent[k] = (cent[i] + cent[j]) / 2
        subsize[k] = subsize.pop(i) + subsize.pop(j)
        for nb in hg.neighbors(k):
            push(k, nb)

    # disconnected remainder
    remaining = sorted(hg.nodes, key=hg.node_size)
    while len(remaining) > 1:
        i, j = remaining[0], remaining[1]
        k = hg.contract(i, j)
        path.append((ssa_of.pop(i), ssa_of.pop(j)))
        ssa_of[k] = ssa
        ssa += 1
        remaining = sorted(hg.nodes, key=hg.node_size)

    return path


def greedy_span_ssa(
    inputs,
    output,
    size_dict,
    start="max",
    coeff_connectivity=1.0,
    coeff_ndim=0.0,
    coeff_distance=0.0,
    coeff_next_centrality=0.0,
    temperature=0.0,
    seed=None,
):
    """Spanning sweep order: grow a single contracted region outward from
    a seed chosen by centrality (SSA path).
    """
    rng = get_rng(seed)
    gumbel = GumbelBatchedGenerator(rng)

    hg = HyperGraph(inputs, output, size_dict)
    cent = hg.simple_centrality()
    n = len(inputs)

    if start == "max":
        seed_node = max(hg.nodes, key=lambda i: cent[i])
    elif start == "min":
        seed_node = min(hg.nodes, key=lambda i: cent[i])
    else:
        seed_node = rng.choice(list(hg.nodes))

    dist = hg.simple_distance([seed_node])
    ssa_of = {i: i for i in range(n)}
    ssa = n
    path = []
    region = seed_node

    while hg.get_num_nodes() > 1:
        nbs = hg.neighbors(region)
        if not nbs:
            # disconnected: jump to the closest remaining node
            others = [i for i in hg.nodes if i != region]
            nxt = min(others, key=lambda i: dist.get(i, 0))
        else:

            def nb_score(j):
                s = 0.0
                if coeff_connectivity:
                    s += coeff_connectivity * math.log2(
                        max(hg.bond_size(region, j), 1)
                    )
                if coeff_ndim:
                    s -= coeff_ndim * len(hg.get_node(j))
                if coeff_distance:
                    s -= coeff_distance * dist.get(j, 0)
                if coeff_next_centrality:
                    s += coeff_next_centrality * cent[j]
                if temperature:
                    s += temperature * gumbel()
                return s

            nxt = max(nbs, key=nb_score)

        k = hg.contract(region, nxt)
        path.append((ssa_of.pop(region), ssa_of.pop(nxt)))
        ssa_of[k] = ssa
        ssa += 1
        region = k

    return path


def optimize_greedy_compressed(
    inputs, output, size_dict, use_ssa=False, **kwargs
):
    path = greedy_compressed_ssa(inputs, output, size_dict, **kwargs)
    if use_ssa:
        return path
    from ..tree import ssa_to_linear

    return ssa_to_linear(path, len(inputs))


def optimize_greedy_span(
    inputs, output, size_dict, use_ssa=False, **kwargs
):
    path = greedy_span_ssa(inputs, output, size_dict, **kwargs)
    if use_ssa:
        return path
    from ..tree import ssa_to_linear

    return ssa_to_linear(path, len(inputs))
