"""Dynamic slicing (counterpart of ``cotengra_tpu/slicing.py``): choose
indices to sum over explicitly, trading a flops overhead for smaller
intermediates.

- :class:`ContractionCosts`: a flat snapshot of a tree's contractions with
  *incremental* per-index flop/write reduction tallies, supporting
  O(#touching contractions) ``remove(ix)``.
- :class:`SliceFinder`: repeated greedy trials choosing the next index by
  ``objective.score_slice_index`` plus Gumbel temperature noise, with
  forbidden (output) index handling and ``allow_outer`` modes, terminating
  on any of ``target_size`` / ``target_overhead`` / ``target_slices``.

The executor runs the chosen slices one after another or in batches
(``ops/executor.py``, ``ops/slices.py``). Pure Python on the host; the
same tree and seed choose the same indices as the reference.
"""

from .scoring import parse_minimize
from .utils.misc import GumbelBatchedGenerator, get_rng


class ContractionCosts:
    """Flat cost model of a contraction tree for fast what-if slicing."""

    __slots__ = (
        "size_dict",
        "cons",  # list of dicts: involved (set), legs (set), flops, size
        "ix_cons",  # ix -> list of contraction ids touching it
        "flop_reductions",
        "write_reductions",
        "nslices",
        "original_flops",
        "total_flops",
        "total_write",
        "max_size",
        "forbidden",
    )

    def __init__(self):
        self.size_dict = {}
        self.cons = []
        self.ix_cons = {}
        self.flop_reductions = {}
        self.write_reductions = {}
        self.nslices = 1
        self.original_flops = 0
        self.total_flops = 0
        self.total_write = 0
        self.max_size = 1

    @classmethod
    def from_contraction_tree(cls, tree, forbidden=()):
        self = cls()
        self.size_dict = tree.size_dict
        self.forbidden = frozenset(forbidden)
        for p, l, r in tree.traverse():
            cid = len(self.cons)
            involved = set(tree.get_involved(p))
            legs = set(tree.get_legs(p))
            flops = tree.get_flops(p)
            size = tree.get_size(p)
            self.cons.append(
                {
                    "involved": involved,
                    "legs": legs,
                    "flops": flops,
                    "size": size,
                }
            )
            for ix in involved:
                self.ix_cons.setdefault(ix, []).append(cid)
            self.total_flops += flops
            self.total_write += size
            self.max_size = max(self.max_size, size)
        self.original_flops = self.total_flops
        for ix in self.ix_cons:
            self._recompute_reductions(ix)
        return self

    def _recompute_reductions(self, ix):
        d = self.size_dict[ix]
        fr = 0
        wr = 0
        for cid in self.ix_cons.get(ix, ()):
            con = self.cons[cid]
            fr += con["flops"] * (1 - 1.0 / d)
            if ix in con["legs"]:
                wr += con["size"] * (1 - 1.0 / d)
        self.flop_reductions[ix] = fr
        self.write_reductions[ix] = wr

    def copy(self):
        new = ContractionCosts()
        new.size_dict = self.size_dict
        new.cons = [c.copy() for c in self.cons]
        new.ix_cons = {k: list(v) for k, v in self.ix_cons.items()}
        new.flop_reductions = dict(self.flop_reductions)
        new.write_reductions = dict(self.write_reductions)
        new.nslices = self.nslices
        new.original_flops = self.original_flops
        new.total_flops = self.total_flops
        new.total_write = self.total_write
        new.max_size = self.max_size
        new.forbidden = self.forbidden
        return new

    @property
    def sliceable(self):
        return [
            ix for ix in self.ix_cons if ix not in self.forbidden
        ]

    @property
    def overhead(self):
        """Flops overhead factor of the current slicing."""
        return self.nslices * self.total_flops / self.original_flops

    def remove(self, ix):
        """Slice index ``ix``: scale the flops/size of every touching
        contraction down by its dimension and multiply the slice count up,
        incrementally updating the per-index reduction tallies.
        """
        d = self.size_dict[ix]
        self.nslices *= d
        touched_other = set()
        for cid in self.ix_cons.pop(ix):
            con = self.cons[cid]
            old_f = con["flops"]
            new_f = old_f // d
            con["flops"] = new_f
            self.total_flops += new_f - old_f
            con["involved"].discard(ix)

            if ix in con["legs"]:
                old_s = con["size"]
                new_s = old_s // d
                con["size"] = new_s
                self.total_write += new_s - old_s
                con["legs"].discard(ix)

            touched_other.update(con["involved"])

        # tallies of co-involved indices must be refreshed
        for jx in touched_other:
            self._recompute_reductions(jx)
        self.flop_reductions.pop(ix, None)
        self.write_reductions.pop(ix, None)
        # max size may have shrunk - recompute lazily (cheap: one pass)
        self.max_size = max((c["size"] for c in self.cons), default=1)
        return self

    def __repr__(self):
        return (
            f"<ContractionCosts(flops={self.total_flops:.3e}, "
            f"size={self.max_size:.3e}, nslices={self.nslices})>"
        )


class SliceFinder:
    """Find a good set of indices to slice.

    Parameters
    ----------
    tree : ContractionTree
    target_size : int, optional
        Slice until the largest intermediate is at most this size.
    target_overhead : float, optional
        Don't exceed this flops overhead factor.
    target_slices : int, optional
        Slice until the number of slices is at least this.
    minimize : str or Objective, optional
        Which objective scores candidate indices.
    allow_outer : bool or "only", optional
        Whether output indices may be sliced ("only" = slice only output
        indices, for chunked output generation).
    temperature : float, optional
        Gumbel noise scale for trial diversity.
    max_repeats : int, optional
        Number of independent greedy trials.
    seed : int, optional
    """

    def __init__(
        self,
        tree,
        target_size=None,
        target_overhead=None,
        target_slices=None,
        minimize=None,
        allow_outer=True,
        temperature=0.01,
        max_repeats=16,
        seed=None,
    ):
        if all(
            t is None
            for t in (target_size, target_overhead, target_slices)
        ):
            raise ValueError(
                "Need at least one of target_size, target_overhead, "
                "target_slices."
            )
        self.tree = tree
        self.target_size = target_size
        self.target_overhead = target_overhead
        self.target_slices = target_slices
        if minimize is None:
            minimize = tree.get_default_objective()
        self.objective = parse_minimize(minimize)
        self.temperature = temperature
        self.max_repeats = max_repeats
        self.rng = get_rng(seed)

        output_inds = set(tree.output)
        if allow_outer == "only":
            forbidden = {
                ix for ix in tree.size_dict if ix not in output_inds
            }
        elif allow_outer:
            forbidden = set()
        else:
            forbidden = output_inds
        # never re-slice already sliced indices
        forbidden |= set(tree.sliced_inds)
        self.costs = ContractionCosts.from_contraction_tree(
            tree, forbidden=forbidden
        )
        self.best = None  # (score_tuple, inds, costs)

    def _targets_met(self, costs):
        if (
            self.target_size is not None
            and costs.max_size > self.target_size
        ):
            return False
        if (
            self.target_slices is not None
            and costs.nslices < self.target_slices
        ):
            return False
        return True

    def _trial_score(self, costs):
        """Lexicographic quality of a finished trial: meet targets, then
        least total (sliced) flops, then fewest slices.
        """
        return (
            not self._targets_met(costs),
            costs.nslices * costs.total_flops,
            costs.nslices,
        )

    def trial(self, temperature=None):
        if temperature is None:
            temperature = self.temperature
        gumbel = GumbelBatchedGenerator(self.rng)
        costs = self.costs.copy()
        inds = []

        while not self._targets_met(costs):
            cands = [
                ix
                for ix in costs.flop_reductions
                if ix not in costs.forbidden
            ]
            if not cands:
                break

            def score(ix):
                s = self.objective.score_slice_index(costs, ix)
                if temperature:
                    s += temperature * gumbel()
                return s

            ix = max(cands, key=score)

            if self.target_overhead is not None:
                # peek: would overhead exceed the target?
                d = costs.size_dict[ix]
                est = (
                    costs.nslices
                    * d
                    * (
                        costs.total_flops
                        - costs.flop_reductions[ix]
                    )
                    / costs.original_flops
                )
                if est > self.target_overhead and inds:
                    break

            costs.remove(ix)
            inds.append(ix)

        return costs, tuple(inds)

    def search(self, max_repeats=None):
        """Run trials and return ``(best_costs, best_inds)``."""
        if max_repeats is None:
            max_repeats = self.max_repeats
        for _ in range(max_repeats):
            costs, inds = self.trial()
            score = self._trial_score(costs)
            if self.best is None or score < self.best[0]:
                self.best = (score, inds, costs)
        return self.best[2], self.best[1]

    def __repr__(self):
        return f"<SliceFinder(best={self.best})>"
