"""Contraction trees for *compressed* (bond-truncated, chi-capped)
contraction (counterpart of ``cotengra_tpu/tree_compressed.py``).

``ContractionTreeCompressed`` swaps every cost method for its compressed
variant (computed by hypergraph replay with ``compress()`` steps), defaults
the traversal to *surface order* (the order of the generating path, which
is what a compressed sweep follows), and defaults the objective to
``peak-compressed``.

Exact pairwise execution of such a tree is intentionally refused - a
compressed contraction requires truncation (QR/SVD) between steps;
``contract_compressed`` runs it (``ops/compressed.py``), on the card
unless given ``device="cpu"``.
"""

import functools
import math

from .tree import ContractionTree


class ContractionTreeCompressed(ContractionTree):
    def __init__(
        self,
        inputs,
        output,
        size_dict,
        children=None,
        objective="peak-compressed",
    ):
        super().__init__(
            inputs, output, size_dict, children, objective=objective
        )

    @classmethod
    def from_path(
        cls,
        inputs,
        output,
        size_dict,
        *,
        path=None,
        ssa_path=None,
        optimize="greedy",
        objective="peak-compressed",
    ):
        return super().from_path(
            inputs,
            output,
            size_dict,
            path=path,
            ssa_path=ssa_path,
            optimize=optimize,
            objective=objective,
        )

    def get_default_objective(self):
        return self._objective

    # -- swap exact cost methods for compressed ones ------------------------

    total_flops = ContractionTree.total_flops_compressed
    total_write = ContractionTree.total_write_compressed
    max_size = ContractionTree.max_size_compressed
    peak_size = ContractionTree.peak_size_compressed
    total_cost = ContractionTree.total_cost_compressed
    contraction_width = ContractionTree.contraction_width_compressed

    total_flops_exact = ContractionTree.total_flops
    total_write_exact = ContractionTree.total_write
    max_size_exact = ContractionTree.max_size
    peak_size_exact = ContractionTree.peak_size

    def total_combo_compressed(self, chi=None, order="surface_order",
                               compress_late=None, factor=None, log=None):
        if factor is None:
            factor = self.get_default_combo_factor()
        return self.total_cost_compressed(
            chi, order, compress_late, factor=factor, log=log
        )

    def contract_stats(self, force=False):
        # keep exact stats available for structural bookkeeping
        return ContractionTree.contract_stats(self, force=force)

    def describe(self, info="normal", join=" "):
        stats = self.compressed_contract_stats()
        if info == "normal":
            return join.join(
                (
                    f"log10[FLOPs]={math.log10(max(stats.flops, 1)):.2f}",
                    f"log2[SIZE]={math.log2(max(stats.max_size, 1)):.2f}",
                )
            )
        return join.join(
            (
                f"log10[FLOPS]={math.log10(max(stats.flops, 1)):.2f}",
                f"log2[SIZE]={math.log2(max(stats.max_size, 1)):.2f}",
                f"log2[PEAK]={math.log2(max(stats.peak_size, 1)):.2f}",
                f"log2[WRITE]={math.log2(max(stats.write, 1)):.2f}",
            )
        )

    def get_contractor(self, *args, **kwargs):
        raise NotImplementedError(
            "ContractionTreeCompressed models *approximate* (bond "
            "truncated) contraction costs - exact pairwise execution "
            "would be exponential. Use tree.contract_compressed(arrays, "
            "chi=...) for approximate execution, or export the order "
            "with tree.get_path()."
        )

    def contract(self, *args, **kwargs):
        return self.get_contractor()

    def contract_core(self, *args, **kwargs):
        return self.get_contractor()

    def contract_compressed(self, arrays, chi=None, **kwargs):
        """Approximately contract ``arrays`` with chi-capped bond
        truncation (QR+SVD); see ``ops.compressed.contract_compressed``
        (on the card unless given ``device="cpu"``)."""
        from .ops.compressed import contract_compressed

        return contract_compressed(self, arrays, chi=chi, **kwargs)

    # -- refinement over contraction orders ----------------------------------

    def _rebuild_from_ssa(self, ssa_path, minimize, inplace):
        rtree = self.__class__.from_path(
            self.inputs,
            self.output,
            self.size_dict,
            ssa_path=ssa_path,
            objective=minimize,
        )
        if inplace:
            self._adopt(rtree)
            self.__dict__.pop("_surface_seq", None)
            return self
        return rtree

    def windowed_reconfigure(
        self,
        minimize=None,
        order_only=False,
        window_size=20,
        max_iterations=100,
        max_window_tries=1000,
        score_temperature=0.0,
        queue_temperature=1.0,
        scorer=None,
        queue_scorer=None,
        seed=None,
        inplace=False,
        progbar=False,
        **kwargs,
    ):
        """Refine the compressed contraction path with window-localized
        best-first branch-and-bound: re-optimize short windows of the
        surface-order chain against fixed boundary states, either
        re-ordering the existing subtree steps (``order_only=True``) or
        rebuilding window structure freely
        (``pathfinders/windowed_opt.py``).
        """
        from .pathfinders.windowed_opt import WindowedOptimizer

        if minimize is None:
            minimize = self.get_default_objective()
        wo = WindowedOptimizer(
            self.inputs,
            self.output,
            self.size_dict,
            minimize=minimize,
            ssa_path=self.get_ssa_path("surface_order"),
            seed=seed,
        )
        wo.refine(
            window_size=window_size,
            max_iterations=max_iterations,
            order_only=order_only,
            max_window_tries=max_window_tries,
            score_temperature=score_temperature,
            queue_temperature=queue_temperature,
            scorer=scorer,
            queue_scorer=queue_scorer,
            progbar=progbar,
            **kwargs,
        )
        return self._rebuild_from_ssa(
            wo.get_ssa_path(), minimize, inplace
        )

    windowed_reconfigure_ = functools.partialmethod(
        windowed_reconfigure, inplace=True
    )

    def simulated_anneal(
        self,
        minimize=None,
        tfinal=0.0001,
        tstart=0.01,
        tsteps=50,
        numiter=50,
        select="descend",
        seed=None,
        inplace=False,
        progbar=False,
        **kwargs,
    ):
        """Annealed local rewrites of the *compressed* contraction
        chain: Metropolis sweeps proposing associativity rewrites of
        adjacent step pairs (``pathfinders/windowed_opt.py``).
        """
        from .pathfinders.windowed_opt import WindowedOptimizer

        if minimize is None:
            minimize = self.get_default_objective()
        wo = WindowedOptimizer(
            self.inputs,
            self.output,
            self.size_dict,
            minimize=minimize,
            ssa_path=self.get_ssa_path("surface_order"),
            seed=seed,
        )
        wo.anneal(
            tfinal=tfinal,
            tstart=tstart,
            tsteps=tsteps,
            numiter=numiter,
            select=select,
            progbar=progbar,
            **kwargs,
        )
        return self._rebuild_from_ssa(
            wo.get_ssa_path(), minimize, inplace
        )

    simulated_anneal_ = functools.partialmethod(
        simulated_anneal, inplace=True
    )

    def compressed_reconfigure(
        self,
        minimize=None,
        order_only=False,
        max_nodes="auto",
        max_time=None,
        local_score=None,
        exploration_power=0.0,
        best_score=None,
        inplace=False,
        progbar=False,
        **kwargs,
    ):
        """Exhaustive branch-and-bound re-optimization of the whole
        compressed contraction, seeded (and bounded) by the current
        path; ``order_only=True`` restricts the search to re-ordering
        the current merges (``pathfinders/compressed_bb.py``).
        """
        from .pathfinders.compressed_bb import CompressedExhaustive

        if minimize is None:
            minimize = self.get_default_objective()
        if max_nodes == "auto":
            max_nodes = (
                max(10_000, self.N**2)
                if max_time is None
                else float("inf")
            )
        opt = CompressedExhaustive(
            minimize=minimize,
            local_score=local_score,
            max_nodes=max_nodes,
            max_time=max_time,
            exploration_power=exploration_power,
            best_score=best_score,
            progbar=progbar,
            **kwargs,
        )
        opt.setup(self.inputs, self.output, self.size_dict)
        opt.explore_path(
            self.get_ssa_path("surface_order"), restrict=order_only
        )
        opt.run(self.inputs, self.output, self.size_dict)
        return self._rebuild_from_ssa(
            opt.ssa_path, minimize, inplace
        )

    compressed_reconfigure_ = functools.partialmethod(
        compressed_reconfigure, inplace=True
    )

    def __repr__(self):
        return f"<{self.__class__.__name__}(N={self.N})>"

    def __str__(self):
        return (
            f"<{self.__class__.__name__}(N={self.N}, "
            f"{self.describe('normal', join=', ')})>"
        )
