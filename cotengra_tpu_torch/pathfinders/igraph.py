"""igraph community-detection path finders (counterpart of
``cotengra_tpu/pathfinders/igraph.py``). Optional: active only where
python-igraph is installed; without it the methods still register and a
trial raises ``ImportError``.

Two families:

- *membership* methods (spinglass / infomap / labelprop / multilevel /
  eigenvector): produce partition labels, plugged into the recursive
  divide builder;
- *dendrogram* methods (betweenness / walktrap / fastgreedy): their merge
  sequence IS an ssa path directly.
"""

try:
    import igraph as _ig

    HAS_IGRAPH = True
except ImportError:
    _ig = None
    HAS_IGRAPH = False

from .labels import partition_tree_build


def igraph_available():
    return HAS_IGRAPH


def _build_graph(subset, inputs, size_dict):
    import math

    pos = {i: p for p, i in enumerate(subset)}
    edges = {}
    for i in subset:
        for ix in inputs[i]:
            edges.setdefault(ix, []).append(pos[i])
    g_edges = []
    weights = []
    for ix, holders in edges.items():
        if len(holders) < 2:
            continue
        w = max(math.log2(max(size_dict.get(ix, 2), 2)), 0.1)
        for a in range(len(holders)):
            for b in range(a + 1, len(holders)):
                g_edges.append((holders[a], holders[b]))
                weights.append(w)
    g = _ig.Graph(len(subset), g_edges)
    g.es["weight"] = weights
    return g


def igraph_partition(
    subset, inputs, size_dict, parts=2, method="multilevel", seed=None
):
    if not HAS_IGRAPH:
        raise ImportError("igraph is not installed")
    g = _build_graph(subset, inputs, size_dict)
    w = g.es["weight"]
    if method == "spinglass":
        vc = g.community_spinglass(weights=w, spins=parts)
    elif method == "infomap":
        vc = g.community_infomap(edge_weights=w)
    elif method == "labelprop":
        vc = g.community_label_propagation(weights=w)
    elif method == "multilevel":
        vc = g.community_multilevel(weights=w)
    elif method == "eigenvector":
        vc = g.community_leading_eigenvector(clusters=parts, weights=w)
    else:
        raise ValueError(method)
    return vc.membership


def igraph_dendrogram_ssa(
    inputs, output, size_dict, method="walktrap", seed=None
):
    """Community dendrogram merges as an ssa path."""
    if not HAS_IGRAPH:
        raise ImportError("igraph is not installed")
    subset = list(range(len(inputs)))
    g = _build_graph(subset, inputs, size_dict)
    w = g.es["weight"]
    if method == "betweenness":
        dend = g.community_edge_betweenness(weights=w)
    elif method == "walktrap":
        dend = g.community_walktrap(weights=w)
    elif method == "fastgreedy":
        dend = g.community_fastgreedy(weights=w)
    else:
        raise ValueError(method)
    ssa_path = [tuple(pair) for pair in dend.merges]
    # merges may not connect everything - autocomplete handles the rest
    return ssa_path


def optimize_igraph(
    inputs,
    output,
    size_dict,
    method="multilevel",
    parts=2,
    cutoff=16,
    sub_optimize="greedy",
    seed=None,
    use_ssa=False,
):
    from ..tree import ContractionTree

    if not HAS_IGRAPH:
        raise ImportError(
            "python-igraph is required for the "
            f"{method!r} pathfinder but is not installed"
        )
    if method in ("betweenness", "walktrap", "fastgreedy"):
        ssa_path = igraph_dendrogram_ssa(
            inputs, output, size_dict, method=method
        )
        tree = ContractionTree.from_path(
            inputs, output, size_dict, ssa_path=ssa_path
        )
    else:

        def partition_fn(subset, inputs_, size_dict_, parts, seed):
            return igraph_partition(
                subset, inputs_, size_dict_, parts=parts,
                method=method, seed=seed,
            )

        tree = partition_tree_build(
            inputs, output, size_dict, partition_fn, parts=parts,
            cutoff=cutoff, sub_optimize=sub_optimize, seed=seed,
        )
    return tree.get_ssa_path() if use_ssa else tree.get_path()


def register_igraph_hyper_methods():
    """Register the igraph methods unconditionally, as the JAX package
    does: a trial without python-igraph installed raises ``ImportError``
    at search time, which the hyper driver's ``on_trial_error`` policy
    handles."""
    from ..hyper import register_hyper_function

    for method in (
        "spinglass",
        "infomap",
        "labelprop",
        "multilevel",
        "eigenvector",
        "betweenness",
        "walktrap",
        "fastgreedy",
    ):

        def _ssa(inputs, output, size_dict, _m=method, **params):
            return optimize_igraph(
                inputs, output, size_dict, method=_m, use_ssa=True,
                **params,
            )

        space = (
            {
                "parts": {"type": "INT", "min": 2, "max": 8},
                "cutoff": {"type": "INT", "min": 10, "max": 40},
            }
            if method
            in ("spinglass", "multilevel", "infomap", "labelprop",
                "eigenvector")
            else {}
        )
        register_hyper_function(method, _ssa, space=space)
    return True
