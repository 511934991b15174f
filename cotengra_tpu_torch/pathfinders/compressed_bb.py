"""Exhaustive best-first / branch-and-bound search over *compressed*
contraction orders (counterpart of
``cotengra_tpu/pathfinders/compressed_bb.py``).

Unlike the window-localized refinement (:mod:`.windowed_opt`), this
explores the full space of contraction sequences of a chi-capped
contraction, with three prunes:

- **bound**: any partial sequence whose tracker score already exceeds
  the best complete score is dropped (compressed trackers accumulate
  monotonically);
- **subset dedup**: two sequences reaching the same partial partition of
  the leaves are interchangeable - only the cheaper one survives;
- **ordering**: a ``local_score(step, tracker)`` priority drives the
  frontier; the default is depth-first by memory saved, while
  ``exploration_power > 0`` switches to score-vs-completeness balance.

``explore_path`` seeds the frontier with a known path (installing its
score as the initial bound), optionally *restricting* the search to the
path's own merges so only their order is optimized.

The search state is this package's native idiom: each hypergraph node
carries an **int bitmask** of the original leaves merged into it (the
same encoding :class:`~cotengra_tpu_torch.tree.ContractionTree` uses
for its nodes), partial partitions are deduplicated as frozensets of
those bitmask ints, and frontier entries live directly in the heap (no
id-indirection table). The scoring protocol is shared with the tree via
:func:`~cotengra_tpu_torch.scoring.tracked_contract_step`.
"""

import heapq
import itertools
import math

from ..hypergraph import HyperGraph
from ..scoring import parse_minimize, tracked_contract_step
from ..tree import ssa_to_linear

__all__ = ("CompressedExhaustive", "CompressedTreeRefiner")


def _tracker_score(tracker):
    try:
        return tracker.score
    except NotImplementedError:
        return tracker.combo_score


class _State:
    """One point in the search space: a partially contracted hypergraph,
    the leaf-bitmask each of its nodes represents, the SSA merges taken
    to get here, and the running cost tracker."""

    __slots__ = ("hg", "masks", "path", "tracker")

    def __init__(self, hg, masks, path, tracker):
        self.hg = hg
        self.masks = masks
        self.path = path
        self.tracker = tracker

    @property
    def complete(self):
        return self.hg.get_num_nodes() == 1

    def candidate_pairs(self):
        """Distinct directly-bonded node pairs, deterministically
        ordered (a pair sharing several indices appears once)."""
        seen = set()
        for ix in sorted(self.hg.edges):
            nodes = self.hg.edges[ix]
            if len(nodes) == 2:
                pair = (nodes[0], nodes[1])
                if pair not in seen:
                    seen.add(pair)
                    yield pair


class CompressedExhaustive:
    """Search all compressed contraction orders with pruning.

    Parameters
    ----------
    minimize : str or Objective
        Compressed objective (a plain exact name like ``"flops"`` is
        promoted to its ``-compressed`` variant).
    max_nodes : int, optional
        Stop (keeping the best complete path found) after this many
        state expansions.
    max_time : float, optional
        Wall-clock budget in seconds.
    local_score : callable ``(step, tracker) -> key``, optional
        Frontier priority; smaller explores earlier.
    exploration_power : float, optional
        With no explicit ``local_score``: 0 gives depth-first by memory
        saved; > 0 orders by ``score / (step+1)**(1/power)``.
    best_score : float, optional
        Initial upper bound.
    progbar : bool, optional
    """

    def __init__(
        self,
        minimize,
        max_nodes=float("inf"),
        max_time=None,
        local_score=None,
        exploration_power=0.0,
        best_score=None,
        progbar=False,
    ):
        if isinstance(minimize, str) and "compressed" not in minimize:
            minimize = minimize + "-compressed"
        self.objective = parse_minimize(minimize)
        chi = getattr(self.objective, "chi", "auto")
        self.chi = chi
        self.compress_late = bool(
            getattr(self.objective, "compress_late", False)
        )
        self.best_score = (
            float("inf") if best_score is None else abs(best_score)
        )
        self.best_ssa_path = None
        self.max_nodes = max_nodes
        self.max_time = max_time
        self.exploration_power = exploration_power
        self.progbar = progbar
        self.allow = None
        self.root = None

        if local_score is None:
            if exploration_power <= 0:

                def local_score(step, tracker):
                    # depth-first, preferring merges that free memory
                    return -step, tracker.last.live_delta

            else:

                def local_score(step, tracker):
                    return _tracker_score(tracker) / (step + 1) ** (
                        1 / self.exploration_power
                    )

        self.local_score = local_score

    # -- state management ---------------------------------------------------

    def setup(self, inputs, output, size_dict):
        """Prepare the search space for one specific contraction."""
        if self.root is not None:
            return
        hg = HyperGraph(inputs, output, size_dict)
        if self.chi in (None, "auto"):
            self.chi = max(size_dict.values(), default=2) ** 2
        get = getattr(
            self.objective, "get_compressed_stats_tracker", None
        )
        if get is not None:
            tracker = get(hg)
        else:
            from ..scoring import CompressedStatsTracker

            tracker = CompressedStatsTracker(hg, self.chi)
        self.root = _State(
            hg, {i: 1 << i for i in hg.nodes}, (), tracker
        )
        # heap entries: (priority, insertion tick, state)
        self._tick = itertools.count()
        self._frontier = [
            (self.local_score(0, tracker), next(self._tick), self.root)
        ]
        self._preferred = []
        # best score yet seen per partial partition of the leaves
        self._best_per_partition = {}

    def _try_merge(self, state, i, j, preferred=False):
        """Fork ``state`` by contracting its nodes ``i`` and ``j``;
        queue and return the child state, or None if pruned."""
        mij = state.masks[i] | state.masks[j]
        if self.allow is not None and mij not in self.allow:
            return None

        hg = state.hg.copy()
        tracker = state.tracker.copy()
        ij = tracked_contract_step(
            hg, tracker, i, j, self.chi, self.compress_late
        )

        score = _tracker_score(tracker)
        if score >= self.best_score:
            return None

        masks = {
            k: m for k, m in state.masks.items() if k != i and k != j
        }
        masks[ij] = mij

        # subset dedup: of all routes reaching the same partial
        # partition of the leaves, only the cheapest survives
        partition = frozenset(masks.values())
        if score >= self._best_per_partition.get(
            partition, float("inf")
        ):
            return None
        self._best_per_partition[partition] = score

        child = _State(
            hg,
            masks,
            state.path + ((i, j) if i < j else (j, i),),
            tracker,
        )
        if preferred:
            self._preferred.append(child)
        else:
            heapq.heappush(
                self._frontier,
                (
                    self.local_score(len(child.path), tracker),
                    next(self._tick),
                    child,
                ),
            )
        return child

    def explore_path(self, ssa_path, high_priority=True, restrict=False):
        """Seed the frontier with a known SSA path (must call
        :meth:`setup` first). ``restrict=True`` limits the whole search
        to this path's merges (order-only optimization)."""
        state = self.root
        if restrict and self.allow is None:
            self.allow = set()
        for i, j in ssa_path:
            if restrict:
                self.allow.add(state.masks[i] | state.masks[j])
            state = self._try_merge(
                state, i, j, preferred=high_priority
            )
            if state is None:
                return

    # -- main loop ----------------------------------------------------------

    def run(self, inputs, output, size_dict):
        self.setup(inputs, output, size_dict)

        if self.max_time is not None:
            import time

            deadline = time.monotonic() + self.max_time
        else:
            deadline = None

        if self.progbar:
            import tqdm

            pbar = tqdm.tqdm()
        else:
            pbar = None

        expansions = 0
        try:
            while self._preferred or self._frontier:
                if self._preferred:
                    state = self._preferred.pop()
                else:
                    _, _, state = heapq.heappop(self._frontier)

                if state.complete:
                    score = _tracker_score(state.tracker)
                    if score < self.best_score:
                        self.best_score = score
                        self.best_ssa_path = state.path
                        if pbar is not None:
                            pbar.set_description(
                                f"best:{score:.3f} "
                                f"frontier:{len(self._frontier)}",
                                refresh=False,
                            )
                    continue

                # the bound may have tightened since this state queued
                if _tracker_score(state.tracker) >= self.best_score:
                    continue

                for i, j in state.candidate_pairs():
                    self._try_merge(state, i, j)

                expansions += 1
                if pbar is not None:
                    pbar.update()
                if self.best_ssa_path is not None and (
                    expansions > self.max_nodes
                    or (
                        deadline is not None
                        and time.monotonic() >= deadline
                    )
                ):
                    break
        except KeyboardInterrupt:
            pass
        finally:
            if pbar is not None:
                pbar.close()

    # -- export -------------------------------------------------------------

    @property
    def ssa_path(self):
        return self.best_ssa_path

    @property
    def path(self):
        return ssa_to_linear(
            self.best_ssa_path, len(self.best_ssa_path) + 1
        )

    def search(self, inputs, output, size_dict):
        """Run and return the best ``ContractionTreeCompressed``."""
        from ..tree_compressed import ContractionTreeCompressed

        self.run(inputs, output, size_dict)
        return ContractionTreeCompressed.from_path(
            inputs, output, size_dict, ssa_path=self.ssa_path
        )

    def __call__(self, inputs, output, size_dict):
        self.run(inputs, output, size_dict)
        return self.path


class CompressedTreeRefiner:
    """Iteratively refine a population of compressed trees, spending
    doubling-then-halving time budgets where refinement keeps paying
    off.

    Parameters
    ----------
    trees : dict[key, ContractionTreeCompressed]
    minimize : str or Objective
    max_refine_time : int, optional
        Per-tree budget cap (seconds, doubling schedule).
    """

    def __init__(
        self,
        trees,
        minimize="peak-compressed",
        max_refine_time=8,
        progbar=False,
    ):
        self.trees = trees
        self.minimize = minimize
        self.max_refine_time = max_refine_time
        self.progbar = progbar
        self._times = dict.fromkeys(trees, 2)
        self._scores = []
        self.finished = {}
        for key, tree in trees.items():
            self._push(key, self._score(tree))

    def _score(self, tree):
        return math.log2(max(1, tree.peak_size()))

    def _push(self, key, score):
        if self._times[key] <= self.max_refine_time:
            heapq.heappush(self._scores, (-score, key))
        else:
            self.finished[key] = score

    def refine(self, num_its=None):
        if num_its is None:
            num_its = len(self.trees)
        its = range(num_its)
        if self.progbar:
            import tqdm

            its = tqdm.tqdm(its)
        for _ in its:
            if not self._scores:
                break
            nscore, key = heapq.heappop(self._scores)
            old = -nscore
            tree = self.trees[key]
            budget = self._times[key]
            tree = tree.compressed_reconfigure(
                minimize=self.minimize,
                max_time=budget,
                order_only=True,
            )
            tree = tree.compressed_reconfigure(
                minimize=self.minimize,
                max_time=budget,
                order_only=False,
            )
            new = self._score(tree)
            if new >= old:
                self._times[key] *= 2
            else:
                self.trees[key] = tree
                self._times[key] = max(2, self._times[key] // 2)
            self._push(key, new)
        return self.trees
