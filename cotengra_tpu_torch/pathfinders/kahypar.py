"""KaHyPar multilevel hypergraph partitioner adapter (counterpart of
``cotengra_tpu/pathfinders/kahypar.py``). Optional: it partitions only
where the ``kahypar`` package is installed, and its methods register
without it (a trial then raises ``ImportError``, which the
hyper-optimizer's ``on_trial_error`` policy handles). The partition
trees are built by ``labels.partition_tree_build`` and its agglomerative
variant.
"""

import functools

try:
    import kahypar as _kahypar

    HAS_KAHYPAR = True
except ImportError:
    _kahypar = None
    HAS_KAHYPAR = False

from ..utils.misc import get_rng
from .labels import partition_tree_build, partition_tree_build_agglom


def kahypar_available():
    return HAS_KAHYPAR


def kahypar_partition(
    subset,
    inputs,
    size_dict,
    parts=2,
    imbalance=0.01,
    mode="recursive",
    objective="cut",
    seed=None,
    **kwargs,
):
    """Partition ``subset`` of input positions with kahypar, returning a
    membership list.
    """
    if not HAS_KAHYPAR:
        raise ImportError("kahypar is not installed")
    rng = get_rng(seed)
    import math

    pos = {i: p for p, i in enumerate(subset)}
    n = len(subset)

    # hyperedges: indices shared by >= 2 subset members
    ix_holders = {}
    for i in subset:
        for ix in inputs[i]:
            ix_holders.setdefault(ix, []).append(pos[i])
    hyperedges = []
    edge_weights = []
    pins = []
    eptr = [0]
    for ix, holders in ix_holders.items():
        if len(holders) < 2:
            continue
        pins.extend(holders)
        eptr.append(len(pins))
        edge_weights.append(
            max(1, int(math.log2(max(size_dict.get(ix, 2), 2))))
        )
    if not edge_weights:
        return [p % parts for p in range(n)]

    node_weights = [1] * n
    hypergraph = _kahypar.Hypergraph(
        n, len(edge_weights), eptr, pins, parts, edge_weights, node_weights
    )
    context = _kahypar.Context()
    context.loadINIconfiguration(_default_profile(mode, objective))
    context.setK(parts)
    context.setSeed(rng.randrange(2**31))
    context.setEpsilon(imbalance * parts)
    context.suppressOutput(True)
    _kahypar.partition(hypergraph, context)
    return [hypergraph.blockID(v) for v in range(n)]


@functools.lru_cache(maxsize=None)
def _default_profile(mode, objective):
    import os

    import kahypar

    algo = "KaHyPar" if mode == "recursive" else "kKaHyPar"
    profile = f"{objective}_r{algo}_sea20.ini"
    base = os.path.join(
        os.path.dirname(kahypar.__file__), "config"
    )
    path = os.path.join(base, profile)
    if not os.path.exists(path):
        # fall back to any shipped ini
        for fn in os.listdir(base):
            if fn.endswith(".ini"):
                return os.path.join(base, fn)
    return path


def optimize_kahypar(
    inputs,
    output,
    size_dict,
    parts=2,
    cutoff=16,
    imbalance=0.01,
    mode="recursive",
    sub_optimize="greedy",
    seed=None,
    use_ssa=False,
    agglom=False,
    groupsize=4,
):
    fn = functools.partial(
        kahypar_partition, imbalance=imbalance, mode=mode
    )

    def partition_fn(subset, inputs_, size_dict_, parts, seed):
        return fn(
            subset, inputs_, size_dict_, parts=parts, seed=seed
        )

    if agglom:
        tree = partition_tree_build_agglom(
            inputs, output, size_dict, partition_fn,
            groupsize=groupsize, sub_optimize=sub_optimize, seed=seed,
        )
    else:
        tree = partition_tree_build(
            inputs, output, size_dict, partition_fn, parts=parts,
            cutoff=cutoff, sub_optimize=sub_optimize, seed=seed,
        )
    return tree.get_ssa_path() if use_ssa else tree.get_path()


def register_kahypar_hyper_methods():
    """Register the kahypar methods unconditionally, as the JAX package
    does: a trial without the kahypar package raises ``ImportError`` at
    search time (``kahypar_partition`` guards), which the hyper driver's
    ``on_trial_error`` policy handles."""
    from ..hyper import register_hyper_function

    def _ssa_kahypar(inputs, output, size_dict, **params):
        return optimize_kahypar(
            inputs, output, size_dict, use_ssa=True, **params
        )

    register_hyper_function(
        "kahypar",
        _ssa_kahypar,
        space={
            "parts": {"type": "INT", "min": 2, "max": 16},
            "imbalance": {"type": "FLOAT", "min": 0.01, "max": 1.0},
            "cutoff": {"type": "INT", "min": 10, "max": 40},
            "mode": {
                "type": "STRING",
                "options": ["recursive", "direct"],
            },
        },
    )
    register_hyper_function(
        "kahypar-balanced",
        _ssa_kahypar,
        space={
            "imbalance": {"type": "FLOAT", "min": 0.001, "max": 0.05},
            "cutoff": {"type": "INT", "min": 10, "max": 40},
        },
        constants={"parts": 2, "mode": "recursive"},
    )
    register_hyper_function(
        "kahypar-agglom",
        _ssa_kahypar,
        space={
            "groupsize": {"type": "INT", "min": 2, "max": 16},
            "imbalance": {"type": "FLOAT", "min": 0.01, "max": 0.1},
        },
        constants={"agglom": True},
    )
    return True
