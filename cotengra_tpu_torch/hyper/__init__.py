"""Hyper-optimization (counterpart of ``cotengra_tpu/hyper``): the method
registry with the built-in methods (``greedy``, ``random-greedy``,
``edgesort``, ``labels``, ``labels-agglom``, the native partitioner's
``ctgpart``, ``ctgpart-balanced`` and ``ctgpart-agglom``,
``greedy-compressed``, ``greedy-span``), the samplers, the driver, and
the ``hyper`` presets, and ``HyperMultiOptimizer`` for batches of index
configurations (``tree_multi.py``).
"""

import functools

from .driver import (
    HyperOptimizer,
    ReusableHyperOptimizer,
    ReusableRandomGreedyOptimizer,
    get_hyper_space,
    list_hyper_functions,
    register_hyper_function,
    run_trial,
)
from .space import (
    EvolutionOptLib,
    HyperOptLib,
    RandomOptLib,
    get_optlib,
    register_hyper_optlib,
)
from .optlibs import (
    NelderMeadOptLib,
    SubplexOptLib,
    register_optional_optlibs,
)

register_optional_optlibs()

# -- built-in hyper methods ---------------------------------------------------


def _hyper_ssa_greedy(inputs, output, size_dict, **params):
    from ..pathfinders.basic import optimize_greedy

    return optimize_greedy(
        inputs, output, size_dict, use_ssa=True, **params
    )


register_hyper_function(
    "greedy",
    _hyper_ssa_greedy,
    space={
        "costmod": {"type": "FLOAT", "min": 0.1, "max": 4.0},
        "temperature": {"type": "FLOAT_EXP", "min": 0.001, "max": 1.0},
    },
)


def _hyper_ssa_random_greedy(
    inputs, output, size_dict, ntrials=32, costmod_max=4.0,
    temperature_max=1.0,
):
    from ..pathfinders.basic import optimize_random_greedy_track_flops

    path, _ = optimize_random_greedy_track_flops(
        inputs,
        output,
        size_dict,
        ntrials=ntrials,
        costmod=(0.1, costmod_max),
        temperature=(0.001, temperature_max),
        use_ssa=True,
    )
    return path


register_hyper_function(
    "random-greedy",
    _hyper_ssa_random_greedy,
    space={
        "ntrials": {"type": "INT", "min": 8, "max": 64},
        # the per-batch sampling ranges are themselves the tunables
        "costmod_max": {"type": "FLOAT", "min": 1.0, "max": 6.0},
        "temperature_max": {"type": "FLOAT_EXP", "min": 0.01, "max": 2.0},
    },
)


def _hyper_ssa_edgesort(inputs, output, size_dict, **params):
    from ..pathfinders.edgesort import optimize_edgesort

    return optimize_edgesort(inputs, output, size_dict, use_ssa=True)


register_hyper_function("edgesort", _hyper_ssa_edgesort, space={})


def _hyper_ssa_labels(inputs, output, size_dict, **params):
    from ..pathfinders.labels import optimize_labels

    return optimize_labels(
        inputs, output, size_dict, use_ssa=True, **params
    )


def _hyper_ssa_labels_agglom(inputs, output, size_dict, **params):
    from ..pathfinders.labels import optimize_labels_agglom

    return optimize_labels_agglom(
        inputs, output, size_dict, use_ssa=True, **params
    )


register_hyper_function(
    "labels-agglom",
    _hyper_ssa_labels_agglom,
    space={
        "groupsize": {"type": "INT", "min": 2, "max": 12},
        "balance_pow": {"type": "FLOAT", "min": 0.5, "max": 4.0},
    },
)


register_hyper_function(
    "labels",
    _hyper_ssa_labels,
    space={
        "parts": {"type": "INT", "min": 2, "max": 8},
        "cutoff": {"type": "INT", "min": 8, "max": 40},
        "balance_pow": {"type": "FLOAT", "min": 0.5, "max": 4.0},
        "maxiter": {"type": "INT", "min": 8, "max": 30},
        "sub_optimize": {
            "type": "STRING",
            "options": ["greedy", "auto"],
        },
    },
)


# the native multilevel partitioner (the kahypar slot)
from ..pathfinders.partition import register_ctgpart_hyper_methods  # noqa: E402,E501

register_ctgpart_hyper_methods()


def _hyper_ssa_greedy_compressed(inputs, output, size_dict, **params):
    from ..pathfinders.compressed import greedy_compressed_ssa

    return greedy_compressed_ssa(inputs, output, size_dict, **params)


register_hyper_function(
    "greedy-compressed",
    _hyper_ssa_greedy_compressed,
    space={
        "coeff_size_compressed": {"type": "FLOAT", "min": 0.5, "max": 2.0},
        "coeff_size": {"type": "FLOAT", "min": -0.5, "max": 0.5},
        "coeff_subgraph": {"type": "FLOAT", "min": -0.5, "max": 0.5},
        "coeff_centrality": {"type": "FLOAT", "min": -1.0, "max": 1.0},
        "temperature": {"type": "FLOAT_EXP", "min": 0.001, "max": 1.0},
    },
)


def _hyper_ssa_greedy_span(inputs, output, size_dict, **params):
    from ..pathfinders.compressed import greedy_span_ssa

    return greedy_span_ssa(inputs, output, size_dict, **params)


register_hyper_function(
    "greedy-span",
    _hyper_ssa_greedy_span,
    space={
        "start": {"type": "STRING", "options": ["max", "min"]},
        "coeff_connectivity": {"type": "FLOAT", "min": 0.0, "max": 2.0},
        "coeff_ndim": {"type": "FLOAT", "min": -1.0, "max": 1.0},
        "coeff_distance": {"type": "FLOAT", "min": -1.0, "max": 1.0},
        "coeff_next_centrality": {
            "type": "FLOAT", "min": -1.0, "max": 1.0,
        },
        "temperature": {"type": "FLOAT_EXP", "min": 0.001, "max": 1.0},
    },
)


class UniformOptimizer(HyperOptimizer):
    """Uniform random sampling over methods/params (no learning) - useful
    as a control and in tests.
    """

    def __init__(self, **kwargs):
        kwargs.setdefault("optlib", "random")
        super().__init__(**kwargs)


class HyperCompressedOptimizer(HyperOptimizer):
    """Hyper-optimizer over *compressed* contraction trees: methods
    default to the compressed pathfinders, trees are built as
    ``ContractionTreeCompressed``, scored by a compressed objective, and
    refined by windowed order-annealing.
    """

    compressed = True

    def __init__(self, chi=None, methods=None, minimize=None, **kwargs):
        from ..tree_compressed import ContractionTreeCompressed

        if methods is None:
            methods = ["greedy-compressed", "greedy-span"]
        if minimize is None:
            if chi is None or chi == "auto":
                minimize = "peak-compressed"
            else:
                minimize = f"peak-compressed-{chi}"
        super().__init__(methods=methods, minimize=minimize, **kwargs)
        self.tree_class = ContractionTreeCompressed


class HyperMultiOptimizer(HyperOptimizer):
    """Hyper-optimizer for one network contracted over a batch of
    ``numconfigs`` configurations of the indices ``varmults``: trials
    build ``ContractionTreeMulti`` trees scored by the multi objective
    of ``strategy`` (``"uniform"``, ``"dense"`` or ``"linear"``)."""

    multicontraction = True

    def __init__(
        self,
        varmults=None,
        numconfigs=1,
        strategy="uniform",
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.multi_opts = {
            "varmults": tuple(varmults or ()),
            "numconfigs": numconfigs,
            "strategy": strategy,
        }


class ReusableHyperCompressedOptimizer(ReusableHyperOptimizer):
    """Disk-cached wrapper around HyperCompressedOptimizer."""

    def _search_and_pack(self, inputs, output, size_dict):
        opt = HyperCompressedOptimizer(**self.opt_kwargs)
        self.last_opt = opt
        tree = opt.search(inputs, output, size_dict)
        return {
            "ssa_path": tree.get_ssa_path(),
            "sliced_inds": (),
            "score": opt.best_score,
            "flops": opt.best["flops"],
        }, tree

    def _unpack(self, record, inputs, output, size_dict):
        from ..tree_compressed import ContractionTreeCompressed

        return ContractionTreeCompressed.from_path(
            inputs, output, size_dict, ssa_path=record["ssa_path"]
        )


# -- presets ------------------------------------------------------------------


def hyper_optimize(inputs, output, size_dict, get="tree", **opts):
    opt = HyperOptimizer(**opts)
    tree = opt.search(inputs, output, size_dict)
    if get == "tree":
        return tree
    return tree.get_path()


def hyper_compressed_optimize(
    inputs, output, size_dict, get="tree", **opts
):
    opt = HyperCompressedOptimizer(**opts)
    tree = opt.search(inputs, output, size_dict)
    if get == "tree":
        return tree
    return tree.get_path()


def register_hyper_presets():
    from ..interface import register_preset
    from ..pathfinders.compressed import (
        optimize_greedy_compressed,
        optimize_greedy_span,
    )
    from ..tree_compressed import ContractionTreeCompressed

    register_preset(
        "hyper",
        functools.partial(hyper_optimize, get="path"),
        functools.partial(hyper_optimize, get="tree"),
    )
    register_preset(
        "hyper-compressed",
        functools.partial(hyper_compressed_optimize, get="path"),
        functools.partial(hyper_compressed_optimize, get="tree"),
    )

    def _gc_tree(inputs, output, size_dict):
        return ContractionTreeCompressed.from_path(
            inputs,
            output,
            size_dict,
            ssa_path=_hyper_ssa_greedy_compressed(
                inputs, output, size_dict
            ),
        )

    def _gs_tree(inputs, output, size_dict):
        return ContractionTreeCompressed.from_path(
            inputs,
            output,
            size_dict,
            ssa_path=_hyper_ssa_greedy_span(inputs, output, size_dict),
        )

    register_preset(
        "greedy-compressed", optimize_greedy_compressed, _gc_tree
    )
    register_preset("greedy-span", optimize_greedy_span, _gs_tree)
    register_preset(
        "hyper-256",
        functools.partial(hyper_optimize, get="path", max_repeats=256),
        functools.partial(hyper_optimize, get="tree", max_repeats=256),
    )
    register_preset(
        "hyper-greedy",
        functools.partial(
            hyper_optimize, get="path", methods=["greedy"]
        ),
        functools.partial(
            hyper_optimize, get="tree", methods=["greedy"]
        ),
    )
    # method-pinned variants are registered unconditionally: using one
    # whose dependency is absent (kahypar, igraph) fails at search time
    for name, method, kw in (
        ("hyper-labels", "labels", {}),
        ("hyper-kahypar", "kahypar", {}),
        ("hyper-balanced", "kahypar-balanced", {"max_repeats": 16}),
        ("hyper-spinglass", "spinglass", {}),
        ("hyper-betweenness", "betweenness", {}),
    ):
        register_preset(
            name,
            functools.partial(
                hyper_optimize, get="path", methods=[method], **kw
            ),
            functools.partial(
                hyper_optimize, get="tree", methods=[method], **kw
            ),
        )


__all__ = [
    "EvolutionOptLib",
    "HyperCompressedOptimizer",
    "HyperMultiOptimizer",
    "get_hyper_space",
    "get_optlib",
    "hyper_optimize",
    "HyperOptimizer",
    "HyperOptLib",
    "hyper_compressed_optimize",
    "list_hyper_functions",
    "NelderMeadOptLib",
    "RandomOptLib",
    "register_hyper_function",
    "register_hyper_optlib",
    "register_hyper_presets",
    "ReusableHyperCompressedOptimizer",
    "ReusableHyperOptimizer",
    "ReusableRandomGreedyOptimizer",
    "run_trial",
    "SubplexOptLib",
    "UniformOptimizer",
]
