"""Dependency-free graph-partition path finder (counterpart of
``cotengra_tpu/pathfinders/labels.py``): label-propagation community
detection with population balancing, plugged into a recursive-bisection
tree builder (``partition_tree_build``) or a bottom-up agglomerative one
(``partition_tree_build_agglom``).

This is the always-available partition method of the hyper-optimizer's
default method set; another partitioner plugs in through the same
``partition_fn`` interface.
"""

import collections
import math

from ..tree import ContractionTree
from ..utils.misc import get_rng


def label_propagation_partition(
    subset,
    inputs,
    size_dict,
    parts=2,
    maxiter=20,
    balance_pow=2.0,
    seed=None,
):
    """Partition the ``subset`` of input positions into up to ``parts``
    groups by weighted label propagation with a population penalty.

    Returns a membership list aligned with ``subset``.
    """
    rng = get_rng(seed)
    subset = list(subset)
    pos = {i: p for p, i in enumerate(subset)}
    n = len(subset)

    # adjacency within the subset, weighted by log2 bond size
    adj = [collections.defaultdict(float) for _ in range(n)]
    ix_holders = collections.defaultdict(list)
    for i in subset:
        for ix in inputs[i]:
            ix_holders[ix].append(pos[i])
    for ix, holders in ix_holders.items():
        if len(holders) < 2:
            continue
        w = max(math.log2(size_dict.get(ix, 2)), 0.1)
        for a in range(len(holders)):
            for b in range(a + 1, len(holders)):
                pa, pb = holders[a], holders[b]
                adj[pa][pb] += w
                adj[pb][pa] += w

    # seed labels: `parts` random distinct nodes, everyone else unlabeled
    labels = [-1] * n
    seeds = rng.sample(range(n), min(parts, n))
    for lbl, s in enumerate(seeds):
        labels[s] = lbl

    # grow from seeds: unlabeled nodes adopt strongest neighboring label
    target = n / parts
    order = list(range(n))
    for it in range(maxiter):
        rng.shuffle(order)
        changed = 0
        counts = collections.Counter(
            l for l in labels if l >= 0
        )
        for p in order:
            votes = collections.defaultdict(float)
            for q, w in adj[p].items():
                if labels[q] >= 0:
                    votes[labels[q]] += w
            if not votes:
                continue
            # population balancing: penalize oversized groups
            def score(lbl):
                c = counts.get(lbl, 0)
                return votes[lbl] / (1.0 + (c / target) ** balance_pow)

            new = max(votes, key=score)
            if new != labels[p]:
                if labels[p] >= 0:
                    counts[labels[p]] -= 1
                counts[new] = counts.get(new, 0) + 1
                labels[p] = new
                changed += 1
        if changed == 0 and all(l >= 0 for l in labels):
            break

    # any stragglers (disconnected): assign to smallest group
    counts = collections.Counter(l for l in labels if l >= 0)
    for p in range(n):
        if labels[p] < 0:
            lbl = min(
                range(parts), key=lambda k: counts.get(k, 0)
            )
            labels[p] = lbl
            counts[lbl] = counts.get(lbl, 0) + 1

    # remap to dense 0..k-1
    remap = {}
    out = []
    for l in labels:
        if l not in remap:
            remap[l] = len(remap)
        out.append(remap[l])
    return out


def partition_tree_build(
    inputs,
    output,
    size_dict,
    partition_fn,
    parts=2,
    cutoff=16,
    parts_decay=0.5,
    sub_optimize="greedy",
    seed=None,
    check=False,
):
    """Build a ContractionTree by recursive partitioning: split the set of
    inputs top-down with ``partition_fn`` until below ``cutoff``, then
    solve the small groups directly.
    """
    rng = get_rng(seed)
    tree = ContractionTree(inputs, output, size_dict)

    def solve(subset, level):
        if len(subset) == 1:
            return tree.leaf(subset[0])
        if len(subset) <= cutoff:
            return tree.contract_nodes(
                [tree.leaf(i) for i in subset], optimize=sub_optimize,
                check=check,
            )
        # dynamic number of parts, decaying with depth
        k = max(2, int(parts * parts_decay**level)) if parts_decay else parts
        k = min(k, len(subset) // 2)
        membership = partition_fn(
            subset, inputs, size_dict, parts=k,
            seed=rng.randrange(2**32),
        )
        groups = collections.defaultdict(list)
        for i, m in zip(subset, membership):
            groups[m].append(i)
        if len(groups) == 1:
            # partition failed to split - fall back to direct solve in
            # two halves
            half = len(subset) // 2
            groups = {0: subset[:half], 1: subset[half:]}
        subnodes = [
            solve(group, level + 1) for group in groups.values()
        ]
        return tree.contract_nodes(
            subnodes, optimize=sub_optimize, check=check
        )

    solve(list(range(len(inputs))), 0)
    return tree


def partition_tree_build_agglom(
    inputs,
    output,
    size_dict,
    partition_fn,
    groupsize=4,
    sub_optimize="greedy",
    seed=None,
    check=False,
):
    """Bottom-up agglomerative tree building: repeatedly partition the
    current (coarse) nodes into many small groups and contract each group.
    """
    rng = get_rng(seed)
    tree = ContractionTree(inputs, output, size_dict)
    current = [tree.leaf(i) for i in range(len(inputs))]

    while len(current) > 1:
        k = max(2, len(current) // groupsize)
        if len(current) <= groupsize or k < 2:
            tree.contract_nodes(
                current, optimize=sub_optimize, check=check
            )
            break
        # coarse terms = effective legs of each current node
        coarse_terms = [tuple(tree.get_legs(n)) for n in current]
        membership = partition_fn(
            list(range(len(coarse_terms))),
            coarse_terms,
            size_dict,
            parts=k,
            seed=rng.randrange(2**32),
        )
        groups = collections.defaultdict(list)
        for n, m in zip(current, membership):
            groups[m].append(n)
        nxt = []
        for group in groups.values():
            if len(group) == 1:
                nxt.append(group[0])
            else:
                nxt.append(
                    tree.contract_nodes(
                        group, optimize=sub_optimize, check=check
                    )
                )
        if len(nxt) == len(current):
            # no progress - merge the two smallest
            nxt.sort(key=tree.get_size)
            merged = tree.contract_nodes_pair(nxt[0], nxt[1])
            nxt = [merged] + nxt[2:]
        current = nxt

    return tree


def optimize_labels(
    inputs,
    output,
    size_dict,
    parts=2,
    cutoff=16,
    balance_pow=2.0,
    maxiter=20,
    sub_optimize="greedy",
    seed=None,
    use_ssa=False,
):
    """Full labels-partition pathfinder entry point."""

    def partition_fn(subset, inputs_, size_dict_, parts, seed):
        return label_propagation_partition(
            subset,
            inputs_,
            size_dict_,
            parts=parts,
            maxiter=maxiter,
            balance_pow=balance_pow,
            seed=seed,
        )

    tree = partition_tree_build(
        inputs,
        output,
        size_dict,
        partition_fn,
        parts=parts,
        cutoff=cutoff,
        sub_optimize=sub_optimize,
        seed=seed,
    )
    if use_ssa:
        return tree.get_ssa_path()
    return tree.get_path()


def optimize_labels_agglom(
    inputs,
    output,
    size_dict,
    groupsize=4,
    balance_pow=2.0,
    maxiter=20,
    sub_optimize="greedy",
    seed=None,
    use_ssa=False,
):
    """Agglomerative (bottom-up) labels-partition pathfinder."""

    def partition_fn(subset, terms, size_dict_, parts, seed):
        return label_propagation_partition(
            subset,
            terms,
            size_dict_,
            parts=parts,
            maxiter=maxiter,
            balance_pow=balance_pow,
            seed=seed,
        )

    tree = partition_tree_build_agglom(
        inputs,
        output,
        size_dict,
        partition_fn,
        groupsize=groupsize,
        sub_optimize=sub_optimize,
        seed=seed,
    )
    if use_ssa:
        return tree.get_ssa_path()
    return tree.get_path()
