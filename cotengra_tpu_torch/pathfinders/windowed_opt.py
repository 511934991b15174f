"""Window-localized refinement of *compressed* contraction paths
(counterpart of ``cotengra_tpu/pathfinders/windowed_opt.py``).

A chi-capped (compressed) contraction is order-sensitive in a way exact
contraction is not: truncation after each step changes every later bond
size, so the path is best modeled as a linear *chain* of intermediate
states. This module refines such chains by

- ``optimize_window``: exhaustive best-first branch-and-bound
  re-optimization of a short window ``[ci, cf)`` of the chain, either
  re-ordering the existing subtree steps (``order_only=True``) or
  rebuilding the window's structure from scratch against the boundary
  states (``order_only=False``);
- ``refine``: repeatedly applying ``optimize_window`` at random centers
  weighted by where the chain's memory footprint peaks;
- ``anneal``: Metropolis sweeps over adjacent step pairs, proposing the
  standard associativity rewrites ``((AB)C) <-> ((AC)B) <-> (A(BC))``
  (and order swaps for independent pairs).

Chain states snapshot a bit-keyed :class:`~cotengra_tpu_torch.hypergraph
.HyperGraph` plus a compressed-stats tracker, replayed with exactly the
same hook order as ``ContractionTree.compressed_contract_stats`` so
scores agree with the tree-level cost methods. With the same seed the
refinements draw the JAX package's random numbers and return its paths.
"""

import heapq
import itertools
import math

from ..hypergraph import HyperGraph
from ..scoring import (
    CompressedStatsTracker,
    parse_minimize,
    tracked_contract_step,
)
from ..utils.misc import GumbelBatchedGenerator, get_rng

__all__ = (
    "WindowedOptimizer",
    "ssa_path_to_bit_path",
    "bit_path_to_ssa_path",
)


def ssa_path_to_bit_path(ssa_path):
    """SSA pairs -> ``(p, l, r)`` bitmask triples (leaf i = ``1 << i``)."""
    n = len(ssa_path) + 1
    bit = {i: 1 << i for i in range(n)}
    out = []
    for si, sj in ssa_path:
        l, r = bit[si], bit[sj]
        p = l | r
        bit[len(bit)] = p
        out.append((p, l, r))
    return tuple(out)


def bit_path_to_ssa_path(bit_path):
    """Inverse of :func:`ssa_path_to_bit_path`."""
    n = len(bit_path) + 1
    ssa = {1 << i: i for i in range(n)}
    out = []
    for p, l, r in bit_path:
        out.append((ssa[l], ssa[r]))
        ssa[p] = len(ssa)
    return tuple(out)


class _SubtreeWindow:
    """Re-contraction state of a window that must REPRODUCE the original
    subtree structure (order-only refinement): the same ``(p, l, r)``
    merges, in any valid order.

    ``ready`` holds parents whose two children are both currently open
    (available to contract next).
    """

    __slots__ = ("split", "above", "open", "ready")

    def __init__(self, triples=()):
        self.split = {}   # parent -> (l, r)
        self.above = {}   # child -> parent
        self.open = set()  # currently-contractible frontier
        self.ready = {}   # parent -> (l, r), both children open
        for p, l, r in triples:
            self.add(p, l, r)

    def add(self, p, l, r):
        self.split[p] = (l, r)
        self.above[l] = p
        self.above[r] = p
        if l not in self.split:
            self.open.add(l)
        if r not in self.split:
            self.open.add(r)
        if l in self.open and r in self.open:
            self.ready[p] = (l, r)

    def copy(self):
        new = object.__new__(_SubtreeWindow)
        new.split = self.split.copy()
        new.above = self.above.copy()
        new.open = self.open.copy()
        new.ready = self.ready.copy()
        return new

    @property
    def candidates(self):
        return self.ready

    def contract(self, p):
        l, r = self.ready.pop(p)
        del self.split[p]
        del self.above[l]
        del self.above[r]
        self.open.discard(l)
        self.open.discard(r)
        self.open.add(p)
        gp = self.above.get(p)
        if gp is not None:
            sib = next(c for c in self.split[gp] if c != p)
            if sib in self.open:
                self.ready[gp] = self.split[gp]
        return l, r


class _FreeWindow:
    """Re-contraction state of a window free to choose ANY structure
    consistent with the boundary hypergraph states: the initial state's
    extra nodes must merge (connected pairs only) into the final state's
    extra nodes.
    """

    __slots__ = ("pairs",)

    def __init__(self, hg_start, hg_end):
        # group the window's consumed nodes under the root (bitmask
        # superset) each must end up inside
        groups = {
            p: [] for p in hg_end.nodes if p not in hg_start.nodes
        }
        for l in hg_start.nodes:
            if l in hg_end.nodes:
                continue
            for p in groups:
                if l & p == l:
                    groups[p].append(l)
                    break
        self.pairs = {}
        for members in groups.values():
            if len(members) == 2:
                a, b = members
                self.pairs[a | b] = (a, b)
                continue
            for a, b in itertools.combinations(members, 2):
                ea = hg_start.get_node(a)
                if not set(ea).isdisjoint(hg_start.get_node(b)):
                    self.pairs[a | b] = (a, b)

    def copy(self):
        new = object.__new__(_FreeWindow)
        new.pairs = self.pairs.copy()
        return new

    @property
    def candidates(self):
        return self.pairs

    def contract(self, p):
        l, r = self.pairs.pop(p)
        for po, (lo, ro) in tuple(self.pairs.items()):
            if lo in (l, r):
                del self.pairs[po]
                self.pairs[po | p] = (p, ro)
            elif ro in (l, r):
                del self.pairs[po]
                self.pairs[po | p] = (lo, p)
        return l, r


class ChainState:
    """One link of the chain: hypergraph + tracker AFTER ``plr``."""

    __slots__ = ("hg", "plr", "chi", "compress_late", "tracker")

    @classmethod
    def first(cls, inputs, output, size_dict, objective):
        self = cls.__new__(cls)
        self.hg = HyperGraph(
            {1 << i: term for i, term in enumerate(inputs)},
            output,
            size_dict,
        )
        self.plr = None
        chi = getattr(objective, "chi", "auto")
        if chi in (None, "auto"):
            chi = max(size_dict.values(), default=2) ** 2
        self.chi = chi
        self.compress_late = bool(
            getattr(objective, "compress_late", False)
        )
        get = getattr(objective, "get_compressed_stats_tracker", None)
        if get is not None:
            self.tracker = get(self.hg)
        else:
            self.tracker = CompressedStatsTracker(self.hg, chi)
        return self

    def next(self, p, l, r):
        """Replay one contraction step (hook order matches
        ``ContractionTree.compressed_contract_stats``)."""
        new = object.__new__(ChainState)
        hg = self.hg.copy()
        tracker = self.tracker.copy()
        tracked_contract_step(
            hg, tracker, l, r, self.chi, self.compress_late, node=p
        )
        new.hg = hg
        new.plr = (p, l, r)
        new.chi = self.chi
        new.compress_late = self.compress_late
        new.tracker = tracker
        return new


def _tracker_score(tracker):
    try:
        return tracker.score
    except NotImplementedError:
        return tracker.combo_score


class WindowedOptimizer:
    """Refine a compressed contraction chain by window re-optimization
    and annealed local rewrites (see module docstring).

    Parameters
    ----------
    inputs, output, size_dict
        The contraction equation.
    minimize : str or Objective
        Compressed objective; its tracker supplies ``.score``.
    ssa_path : sequence of (int, int)
        The starting path.
    seed : int, optional
    """

    def __init__(
        self, inputs, output, size_dict, minimize, ssa_path, seed=None
    ):
        self.objective = parse_minimize(minimize)
        state = ChainState.first(
            inputs, output, size_dict, self.objective
        )
        self.chain = [state]
        for p, l, r in ssa_path_to_bit_path(ssa_path):
            state = state.next(p, l, r)
            self.chain.append(state)
        self.rng = get_rng(seed)
        self.gumbel = GumbelBatchedGenerator(self.rng)

    # -- scoring ------------------------------------------------------------

    @property
    def tracker(self):
        return self.chain[-1].tracker

    def score(self):
        return _tracker_score(self.tracker)

    def describe(self):
        return self.tracker.describe()

    # -- window branch-and-bound --------------------------------------------

    def optimize_window(
        self,
        ci,
        cf,
        order_only=False,
        max_window_tries=1000,
        score_temperature=0.0,
        queue_temperature=1.0,
        scorer=None,
        queue_scorer=None,
    ):
        """Best-first branch-and-bound re-optimization of chain steps
        ``[ci, cf)`` against fixed boundary states."""
        if scorer is None:

            def scorer(states, T=0.0):
                # primary: objective score at the window end (with
                # optional Gumbel noise); tiebreak on combo cost
                return (
                    _tracker_score(states[-1].tracker)
                    - (T * self.gumbel() if T else 0.0),
                    states[-1].tracker.combo_score,
                )

        if queue_scorer is None:

            def queue_scorer(states, T):
                # favor deeper partial rewrites first, noisily
                return (
                    -len(states),
                    _tracker_score(states[-1].tracker)
                    - (T * self.gumbel() if T else 0.0),
                )

        if order_only:
            window = _SubtreeWindow(
                self.chain[c].plr for c in range(ci + 1, cf)
            )
        else:
            window = _FreeWindow(
                self.chain[ci].hg, self.chain[cf - 1].hg
            )

        best = scorer([self.chain[c] for c in range(ci, cf)])
        tick = itertools.count()
        start = (self.chain[ci],)
        frontier = [
            (queue_scorer(start, queue_temperature), next(tick),
             window, start)
        ]
        tries = 0

        while frontier and tries < max_window_tries:
            _, _, win, states = heapq.heappop(frontier)
            for p in win.candidates:
                nwin = win.copy()
                l, r = nwin.contract(p)
                nstates = states + (states[-1].next(p, l, r),)
                score = scorer(nstates, score_temperature)
                if score >= best:
                    # bound: a prefix already worse than the best
                    # complete rewrite cannot improve (scores are
                    # monotone under the accumulating trackers)
                    tries += 1
                elif nwin.candidates:
                    heapq.heappush(
                        frontier,
                        (
                            queue_scorer(nstates, queue_temperature),
                            next(tick),
                            nwin,
                            nstates,
                        ),
                    )
                else:
                    # complete improving rewrite: install it
                    for c, st in enumerate(nstates[1:], ci + 1):
                        self.chain[c] = st
                    best = score
                    tries += 1

        # splice the (possibly changed) window costs into the suffix
        for c in range(cf, len(self.chain)):
            self.chain[c].tracker.update_score(
                self.chain[c - 1].tracker
            )

    def refine(
        self,
        window_size=20,
        max_iterations=100,
        order_only=False,
        max_window_tries=1000,
        score_temperature=0.01,
        queue_temperature=1.0,
        scorer=None,
        queue_scorer=None,
        progbar=False,
        **kwargs,
    ):
        """Repeatedly :meth:`optimize_window` at random centers,
        sampled where the chain's live memory footprint is largest."""
        wl = window_size // 2
        wr = window_size - wl
        n = len(self.chain)
        its = range(max_iterations)
        if progbar:
            import tqdm

            its = tqdm.tqdm(its)
        for _ in its:
            weights = [
                st.tracker.total_size for st in self.chain
            ]
            (wc,) = self.rng.choices(range(n), weights=weights)
            wc = min(max(wl, wc), n - wr)
            self.optimize_window(
                wc - wl,
                wc + wr,
                order_only=order_only,
                max_window_tries=max_window_tries,
                score_temperature=score_temperature,
                queue_temperature=queue_temperature,
                scorer=scorer,
                queue_scorer=queue_scorer,
                **kwargs,
            )
            if progbar:
                its.set_description(
                    self.describe(), refresh=False
                )

    # -- annealed local rewrites --------------------------------------------

    def anneal(
        self,
        tfinal=0.0001,
        tstart=0.01,
        tsteps=50,
        numiter=50,
        select="descend",
        progbar=False,
    ):
        """Metropolis sweeps over adjacent chain pairs, proposing
        associativity rewrites (dependent pairs) or order swaps
        (independent pairs)."""
        n = len(self.chain)
        if select == "descend":
            order = list(range(n - 2, 0, -1))
        elif select == "ascend":
            order = list(range(1, n - 1))
        elif select in ("random", "bounce"):
            order = list(range(1, n - 1))
        else:
            raise ValueError(f"unknown select mode: {select}")

        if progbar:
            import tqdm

            pbar = tqdm.tqdm(total=tsteps * numiter)
        else:
            pbar = None

        # log-spaced temperature ladder
        lo, hi = math.log(tfinal), math.log(tstart)
        temps = [
            math.exp(hi + (lo - hi) * k / max(tsteps - 1, 1))
            for k in range(tsteps)
        ]
        try:
            for temp in temps:
                for _ in range(numiter):
                    if select == "random":
                        self.rng.shuffle(order)
                    elif select == "bounce":
                        order.reverse()
                    for k in order:
                        self._pair_move(k, temp)
                    # re-chain global accumulators after a sweep
                    for c in range(1, n):
                        self.chain[c].tracker.update_score(
                            self.chain[c - 1].tracker
                        )
                    if pbar is not None:
                        pbar.update()
                        pbar.set_description(
                            f"T={temp:.3g} {self.describe()}",
                            refresh=False,
                        )
        finally:
            if pbar is not None:
                pbar.close()

    def _pair_move(self, k, temp):
        """Propose a rewrite of chain steps ``k`` and ``k+1``."""
        base = self.chain[k - 1]
        s1 = self.chain[k]
        s2 = self.chain[k + 1]
        pa, la, ra = s1.plr
        pb, lb, rb = s2.plr

        if pa in (lb, rb):
            # dependent: ((a b) c) — rewrite associativity
            c = rb if pa == lb else lb
            a, b = la, ra
            if self.rng.random() < 0.5:
                x = a | c
                n1 = base.next(x, a, c)
                n2 = n1.next(pb, x, b)
            else:
                x = b | c
                n1 = base.next(x, b, c)
                n2 = n1.next(pb, x, a)
        else:
            # independent: swap execution order
            n1 = base.next(pb, lb, rb)
            n2 = n1.next(pa, la, ra)

        cur = max(
            _tracker_score(s1.tracker), _tracker_score(s2.tracker)
        )
        new = max(
            _tracker_score(n1.tracker), _tracker_score(n2.tracker)
        )
        dE = new - cur
        if dE <= 0 or (
            temp > 0
            and math.log(self.rng.random() or 1e-300) < -dE / temp
        ):
            self.chain[k] = n1
            self.chain[k + 1] = n2

    # -- export -------------------------------------------------------------

    def get_bit_path(self):
        return tuple(st.plr for st in self.chain[1:])

    def get_ssa_path(self):
        return bit_path_to_ssa_path(self.get_bit_path())
