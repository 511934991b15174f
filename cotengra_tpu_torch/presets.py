"""Built-in optimize presets (counterpart of ``cotengra_tpu/presets.py``):
``auto`` / ``auto-hq`` pick optimal DP for small contractions (hardness
``n^2 * sqrt(k)`` under a cutoff) and otherwise a thread-local
hyper-optimizer search (``hyper.HyperOptimizer``, stopping at
``max_time="rate:1e9"`` / ``"rate:1e8"``, each trial reconfigured);
plus ``greedy``, ``optimal`` (``dp``), ``optimal-outer``,
``random-greedy{,-128}``, ``simplify``, ``edgesort`` and ``random``; and
the compressed ``greedy-compressed`` and ``greedy-span``, whose tree
functions return a ``ContractionTreeCompressed``. The ``hyper`` presets
are registered by ``hyper.register_hyper_presets``.

As in the reference, ``auto`` falls back to 32 trials of random-greedy
only if the hyper-optimizer cannot be imported.
"""

import functools
import threading

from .interface import register_preset
from .pathfinders.basic import (
    optimize_greedy,
    optimize_optimal,
    optimize_random_greedy_track_flops,
    optimize_simplify,
)
from .pathfinders.compressed import (
    greedy_compressed_ssa,
    greedy_span_ssa,
    optimize_greedy_compressed,
    optimize_greedy_span,
)
from .pathfinders.edgesort import optimize_edgesort
from .pathfinders.random import optimize_random
from .tree import ContractionTree
from .tree_compressed import ContractionTreeCompressed


def estimate_optimal_hardness(inputs):
    """Cheap estimate of how hard exact DP would be: ``n^2 * k^0.5``,
    with n terms and k distinct indices."""
    n = len(inputs)
    k = len({ix for term in inputs for ix in term})
    return n**2 * k**0.5


class AutoOptimizer:
    """Optimal DP (minimizing ``minimize``) if the contraction's hardness
    is under ``optimal_cutoff``, otherwise a (thread-local)
    hyper-optimizer search with an early-stopping rate."""

    def __init__(
        self,
        optimal_cutoff=250,
        minimize="combo",
        methods=None,
        max_time="rate:1e9",
        max_repeats=128,
        **hyperoptimizer_opts,
    ):
        self.optimal_cutoff = optimal_cutoff
        self.minimize = minimize
        self.hyperoptimizer_opts = dict(
            methods=methods,
            max_time=max_time,
            max_repeats=max_repeats,
            minimize=minimize,
            reconf_opts={},
            parallel=False,
            **hyperoptimizer_opts,
        )
        self._local = threading.local()

    def _get_hyperoptimizer(self):
        try:
            return self._local.opt
        except AttributeError:
            from .hyper import HyperOptimizer

            self._local.opt = HyperOptimizer(**self.hyperoptimizer_opts)
            return self._local.opt

    def search(self, inputs, output, size_dict):
        if estimate_optimal_hardness(inputs) < self.optimal_cutoff:
            ssa_path = optimize_optimal(
                inputs, output, size_dict, minimize=self.minimize,
                use_ssa=True,
            )
            return ContractionTree.from_path(
                inputs, output, size_dict, ssa_path=ssa_path
            )
        try:
            opt = self._get_hyperoptimizer()
            return opt.search(inputs, output, size_dict)
        except ImportError:
            # the hyper-optimizer is not importable: random-greedy
            ssa_path, _ = optimize_random_greedy_track_flops(
                inputs, output, size_dict, ntrials=32, use_ssa=True
            )
            return ContractionTree.from_path(
                inputs, output, size_dict, ssa_path=ssa_path
            )

    def __call__(self, inputs, output, size_dict):
        return self.search(inputs, output, size_dict).get_path()


class AutoHQOptimizer(AutoOptimizer):
    """``AutoOptimizer`` for harder or repeated contractions: a higher
    optimal cutoff (650) and a slower stopping rate (``"rate:1e8"``)."""

    def __init__(self, **kwargs):
        kwargs.setdefault("optimal_cutoff", 650)
        kwargs.setdefault("max_time", "rate:1e8")
        kwargs.setdefault("max_repeats", 128)
        super().__init__(**kwargs)


auto_optimize = AutoOptimizer(optimal_cutoff=250, max_time="rate:1e9")
auto_hq_optimize = AutoHQOptimizer()


def _random_greedy(inputs, output, size_dict, ntrials=32, **kwargs):
    path, _ = optimize_random_greedy_track_flops(
        inputs, output, size_dict, ntrials=ntrials, **kwargs
    )
    return path


def _tree_of(fn):
    @functools.wraps(fn)
    def tree_fn(inputs, output, size_dict):
        return ContractionTree.from_path(
            inputs, output, size_dict, path=fn(inputs, output, size_dict)
        )

    return tree_fn


def _compressed_tree_of(ssa_fn):
    @functools.wraps(ssa_fn)
    def tree_fn(inputs, output, size_dict):
        return ContractionTreeCompressed.from_path(
            inputs, output, size_dict,
            ssa_path=ssa_fn(inputs, output, size_dict),
        )

    return tree_fn


def register_builtin_presets():
    greedy_fn = functools.partial(optimize_greedy, use_ssa=False)
    register_preset("greedy", greedy_fn, _tree_of(greedy_fn))

    optimal_fn = functools.partial(optimize_optimal, use_ssa=False)
    register_preset(("optimal", "dp"), optimal_fn, _tree_of(optimal_fn))

    optimal_outer_fn = functools.partial(
        optimize_optimal, use_ssa=False, search_outer=True
    )
    register_preset(
        "optimal-outer", optimal_outer_fn, _tree_of(optimal_outer_fn)
    )

    rg = functools.partial(_random_greedy, ntrials=32)
    register_preset("random-greedy", rg, _tree_of(rg))
    rg128 = functools.partial(_random_greedy, ntrials=128)
    register_preset("random-greedy-128", rg128, _tree_of(rg128))

    simplify_fn = functools.partial(optimize_simplify, use_ssa=False)
    register_preset("simplify", simplify_fn, _tree_of(simplify_fn))

    register_preset(
        "edgesort", optimize_edgesort, _tree_of(optimize_edgesort)
    )
    register_preset("random", optimize_random, _tree_of(optimize_random))

    register_preset(
        "greedy-compressed", optimize_greedy_compressed,
        _compressed_tree_of(greedy_compressed_ssa),
    )
    register_preset(
        "greedy-span", optimize_greedy_span,
        _compressed_tree_of(greedy_span_ssa),
    )

    register_preset("auto", auto_optimize, auto_optimize.search)
    register_preset("auto-hq", auto_hq_optimize, auto_hq_optimize.search)
