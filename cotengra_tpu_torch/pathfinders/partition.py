"""The native multilevel hypergraph partitioner ("ctgpart") as a path
finder (counterpart of ``cotengra_tpu/pathfinders/partition.py``).

It fills the kahypar slot of cotengra
(``cotengra/pathfinders/path_kahypar.py:50-146``) with
``ctg_partition`` of the native library (``ops/native/kernels.cpp``):
heavy-connectivity-matching coarsening, greedy region-growing initial
bisection, 2-way hyperedge FM refinement, recursive k-way. The path is
built by recursive k-section (``labels.partition_tree_build``) or
bottom-up agglomeration (``labels.partition_tree_build_agglom``), and
the hyper search spaces are the reference's (``path_kahypar.py:154-165``).

Where the library does not build, the partitioner raises its build
error: unlike the JAX package, which then runs label propagation in its
place, a method the caller named does not turn into another one. The
hyper-optimizer's default methods take ``labels`` instead there
(``hyper/driver.py::_default_methods``).
"""

import functools
import math

from ..utils.misc import get_rng
from .labels import partition_tree_build, partition_tree_build_agglom


def ctgpart_available():
    from ..ops import native

    return native.is_available()


def ctgpart_partition(
    subset,
    inputs,
    size_dict,
    parts=2,
    imbalance=0.1,
    seed=None,
    weight_edges="log",
    **kwargs,
):
    """Partition ``subset`` of input positions with the native
    multilevel partitioner, returning a membership list. Each index
    shared by two or more of the subset's terms is a hyperedge, weighted
    by ``weight_edges``: ``"log"`` (log2 of its size, at least 1),
    ``"linear"`` (its size) or anything else (1)."""
    from ..ops import native

    rng = get_rng(seed)
    pos = {i: p for p, i in enumerate(subset)}
    n = len(subset)

    ix_holders = {}
    for i in subset:
        for ix in inputs[i]:
            ix_holders.setdefault(ix, []).append(pos[i])
    pins = []
    eptr = [0]
    edge_weights = []
    for ix, holders in ix_holders.items():
        holders = sorted(set(holders))
        if len(holders) < 2:
            continue
        pins.extend(holders)
        eptr.append(len(pins))
        d = max(size_dict.get(ix, 2), 2)
        if weight_edges == "log":
            edge_weights.append(max(math.log2(d), 1.0))
        elif weight_edges == "linear":
            edge_weights.append(float(d))
        else:
            edge_weights.append(1.0)
    if not edge_weights:
        return [p % parts for p in range(n)]

    membership = native.partition(
        eptr,
        pins,
        edge_weights,
        [1.0] * n,
        parts,
        imbalance,
        rng.randrange(2**62),
    )
    return [int(m) for m in membership]


def optimize_ctgpart(
    inputs,
    output,
    size_dict,
    parts=2,
    cutoff=16,
    imbalance=0.1,
    weight_edges="log",
    sub_optimize="greedy",
    seed=None,
    use_ssa=False,
    agglom=False,
    groupsize=4,
    parts_decay=0.5,
):
    """A contraction path by recursive native-partitioner k-section (or,
    with ``agglom``, bottom-up agglomeration into groups of about
    ``groupsize``). Raises the library's build error where it is
    unavailable."""
    from ..ops import native

    native.library()
    fn = functools.partial(
        ctgpart_partition, imbalance=imbalance, weight_edges=weight_edges
    )

    def partition_fn(subset, inputs_, size_dict_, parts, seed):
        return fn(subset, inputs_, size_dict_, parts=parts, seed=seed)

    if agglom:
        tree = partition_tree_build_agglom(
            inputs, output, size_dict, partition_fn,
            groupsize=groupsize, sub_optimize=sub_optimize, seed=seed,
        )
    else:
        tree = partition_tree_build(
            inputs, output, size_dict, partition_fn, parts=parts,
            cutoff=cutoff, sub_optimize=sub_optimize, seed=seed,
            parts_decay=parts_decay,
        )
    return tree.get_ssa_path() if use_ssa else tree.get_path()


def _ssa_ctgpart(inputs, output, size_dict, **params):
    return optimize_ctgpart(inputs, output, size_dict, use_ssa=True, **params)


def register_ctgpart_hyper_methods():
    """Register ``ctgpart``, ``ctgpart-balanced`` and ``ctgpart-agglom``
    in the hyper registry, with the reference's kahypar spaces
    (``path_kahypar.py:154-165``)."""
    from ..hyper import register_hyper_function

    register_hyper_function(
        "ctgpart",
        _ssa_ctgpart,
        space={
            "parts": {"type": "INT", "min": 2, "max": 16},
            "imbalance": {"type": "FLOAT", "min": 0.01, "max": 1.0},
            "cutoff": {"type": "INT", "min": 10, "max": 40},
            "weight_edges": {
                "type": "STRING",
                "options": ["log", "linear"],
            },
            "parts_decay": {"type": "FLOAT", "min": 0.0, "max": 1.0},
        },
    )
    register_hyper_function(
        "ctgpart-balanced",
        _ssa_ctgpart,
        space={
            "imbalance": {"type": "FLOAT", "min": 0.001, "max": 0.05},
            "cutoff": {"type": "INT", "min": 10, "max": 40},
        },
        constants={"parts": 2},
    )
    register_hyper_function(
        "ctgpart-agglom",
        _ssa_ctgpart,
        space={
            "groupsize": {"type": "INT", "min": 2, "max": 16},
            "imbalance": {"type": "FLOAT", "min": 0.01, "max": 0.1},
        },
        constants={"agglom": True},
    )
    return True
