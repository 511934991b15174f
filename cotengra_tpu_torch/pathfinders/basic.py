"""Core path finders (counterpart of ``cotengra_tpu/pathfinders/basic.py``):
graph simplification, greedy, batched random-greedy with flops tracking,
and optimal bitmask dynamic programming.

Algorithms (all published):

- greedy pairwise contraction with a tunable local score
  ``size(ab)/costmod - (size(a)+size(b))*costmod`` and Boltzmann/Gumbel
  temperature noise;
- optimal dynamic programming over connected subgraphs with a doubling
  ``cost_cap`` sieve, after arXiv:1304.6112 / Phys. Rev. E 90, 033315;
- pre-simplification: size-1 index stripping, batch-index removal,
  single-term reductions, scalar folding, hadamard deduplication.

Each finder takes ``accel``, as the reference's: ``"auto"`` (the
default) runs the port's native C++ library (``ops/native``) where
``g++`` builds it and the pure-Python version below elsewhere; ``True``
requires the library and raises its build error; ``False`` and ``None``
run pure Python. Given the same inputs and seed, each finder returns the
reference's path with the same ``accel``.

Internal representation: each current term is a *sorted tuple* of
``(index_id, count)`` pairs; an index is contracted away exactly when its
accumulated count reaches its total appearance count. This is the same
counting model the ContractionTree uses, so costs agree exactly.
"""

import functools
import heapq
import itertools
import math
import operator

from ..utils.misc import GumbelBatchedGenerator, get_rng
from .base import PathOptimizer

DEFAULT_MAX_NEIGHBORS = 16


# -- legs helpers (sorted (ix, count) tuples) --------------------------------


def _merge_legs(a, b, appearances):
    """Sorted-merge two legs tuples, dropping indices whose total count
    reaches their appearance count (i.e. contracted indices).
    """
    out = []
    ia = ib = 0
    na, nb = len(a), len(b)
    while ia < na and ib < nb:
        xa, ca = a[ia]
        xb, cb = b[ib]
        if xa < xb:
            out.append((xa, ca))
            ia += 1
        elif xa > xb:
            out.append((xb, cb))
            ib += 1
        else:
            c = ca + cb
            if c != appearances[xa]:
                out.append((xa, c))
            ia += 1
            ib += 1
    out.extend(a[ia:])
    out.extend(b[ib:])
    return tuple(out)


def _legs_size(legs, sizes):
    s = 1
    for ix, _ in legs:
        s *= sizes[ix]
    return s


def _pair_flops(a, b, sizes):
    """Operation count of contracting terms with legs ``a`` and ``b`` =
    product over the union of involved indices.
    """
    f = 1
    seen = set()
    for ix, _ in a:
        f *= sizes[ix]
        seen.add(ix)
    for ix, _ in b:
        if ix not in seen:
            f *= sizes[ix]
    return f


# -- DP cost functions --------------------------------------------------------
#
# A DP entry's score combines its two parts' scores with the cost of the
# step that joins them, a function of ``c`` (the product of the sizes of
# every index involved) and ``s`` (that of the indices kept): the sum
# for "flops" (c), "write" (s), "combo" (c + f s) and "limit"
# (max(c, f s)); the max for "max" (c) and "size" (s).


@functools.lru_cache(maxsize=128)
def dp_cost_fn(minimize):
    """Resolve a minimize string into ``(additive, step)`` for the optimal
    DP: ``step(c, s)`` is one contraction's cost, added to the parts'
    scores if ``additive``, else maxed with them. Accepts 'flops', 'max',
    'size', 'write', 'combo[-f]', 'limit[-f]'.
    """
    if minimize == "flops":
        return True, lambda c, s: c
    if minimize == "max":
        return False, lambda c, s: c
    if minimize == "size":
        return False, lambda c, s: s
    if minimize == "write":
        return True, lambda c, s: s
    name, _, fstr = minimize.partition("-")
    factor = int(fstr) if fstr.isdigit() else float(fstr) if fstr else 64
    if name == "combo":
        return True, lambda c, s: c + factor * s
    if name == "limit":
        return True, lambda c, s: max(c, factor * s)
    raise ValueError(f"Can't parse minimize={minimize!r} for optimal DP.")


def _bits(mask):
    """The positions of a bitmask's set bits."""
    while mask:
        low = mask & -mask
        yield low.bit_length() - 1
        mask ^= low


# -- the mutable planning graph ------------------------------------------------


class PlanGraph:
    """Mutable multigraph state shared by the greedy and optimal searches,
    with in-built simplification, SSA path accumulation and flops tracking.
    """

    __slots__ = (
        "terms",
        "edge_nodes",
        "appearances",
        "sizes",
        "ssa",
        "ssa_path",
        "track_flops",
        "flops",
        "flops_limit",
    )

    def __init__(
        self,
        inputs,
        output,
        size_dict,
        track_flops=False,
        flops_limit=float("inf"),
    ):
        indmap = {}
        self.appearances = []
        self.sizes = []
        self.terms = {}
        self.edge_nodes = {}

        for i, term in enumerate(inputs):
            legs = []
            for ind in term:
                d = size_dict[ind]
                if d == 1:
                    continue  # size-1 indices are free - drop immediately
                ix = indmap.get(ind)
                if ix is None:
                    ix = indmap[ind] = len(self.sizes)
                    self.sizes.append(d)
                    self.appearances.append(1)
                    self.edge_nodes[ix] = {i: None}
                else:
                    self.appearances[ix] += 1
                    self.edge_nodes[ix][i] = None
                legs.append((ix, 1))
            legs.sort()
            self.terms[i] = tuple(legs)

        for ind in output:
            ix = indmap.get(ind)
            if ix is not None:
                self.appearances[ix] += 1

        self.ssa = len(self.terms)
        self.ssa_path = []
        self.track_flops = track_flops
        self.flops = 0
        self.flops_limit = flops_limit

    def copy(self):
        new = PlanGraph.__new__(PlanGraph)
        new.terms = self.terms.copy()
        new.edge_nodes = {k: v.copy() for k, v in self.edge_nodes.items()}
        new.appearances = self.appearances
        new.sizes = self.sizes
        new.ssa = self.ssa
        new.ssa_path = list(self.ssa_path)
        new.track_flops = self.track_flops
        new.flops = self.flops
        new.flops_limit = self.flops_limit
        return new

    # -- mutation helpers --

    def _detach(self, i):
        legs = self.terms.pop(i)
        for ix, _ in legs:
            nodes = self.edge_nodes.get(ix)
            if nodes is not None:
                nodes.pop(i, None)
                if not nodes:
                    del self.edge_nodes[ix]
        return legs

    def _attach(self, legs):
        i = self.ssa
        self.ssa += 1
        self.terms[i] = legs
        for ix, _ in legs:
            self.edge_nodes.setdefault(ix, {})[i] = None
        return i

    def drop_index(self, ix):
        for i in self.edge_nodes.pop(ix):
            self.terms[i] = tuple(
                (jx, c) for jx, c in self.terms[i] if jx != ix
            )

    def contract(self, i, j, new_legs=None):
        ilegs = self._detach(i)
        jlegs = self._detach(j)
        if self.track_flops:
            self.flops += _pair_flops(ilegs, jlegs, self.sizes)
        if new_legs is None:
            new_legs = _merge_legs(ilegs, jlegs, self.appearances)
        k = self._attach(new_legs)
        self.ssa_path.append((i, j))
        return k

    def neighbors(self, i, max_degree=0):
        seen = {i}
        for ix, _ in self.terms[i]:
            nodes = self.edge_nodes[ix]
            if max_degree and len(nodes) > max_degree:
                continue  # effectively a batch index - skip
            for j in nodes:
                if j not in seen:
                    seen.add(j)
                    yield j

    # -- simplifications --

    def simplify_batch(self):
        """Remove indices appearing in every term - they only scale cost by
        a constant but make the graph fully connected.
        """
        n = len(self.terms)
        for ix in [
            ix for ix, nodes in self.edge_nodes.items() if len(nodes) >= n
        ]:
            self.drop_index(ix)

    def simplify_single_terms(self):
        """Fold traces / diagonals / reductions of single terms: any term
        with a repeated index entry (diag) or an index whose count equals
        its total appearances (reduction/trace) gets a single-node ssa step.
        """
        appearances = self.appearances
        for i in list(self.terms):
            legs = self.terms[i]
            foldable = False
            prev = None
            for ix, c in legs:
                if ix == prev or c == appearances[ix]:
                    foldable = True
                    break
                prev = ix
            if not foldable:
                continue
            old_legs = self._detach(i)
            # merge duplicate entries (sorted), dropping fully-reduced ones
            merged = []
            for ix, c in old_legs:
                if merged and merged[-1][0] == ix:
                    merged[-1][1] += c
                else:
                    merged.append([ix, c])
            new_legs = tuple(
                (ix, c) for ix, c in merged if c != appearances[ix]
            )
            self._attach(new_legs)
            self.ssa_path.append((i,))

    def simplify_scalars(self):
        """Multiply all scalar terms together, then into the smallest
        remaining term.
        """
        scalars = [i for i, legs in self.terms.items() if not legs]
        if not scalars:
            return
        others = [
            (len(legs), i) for i, legs in self.terms.items() if legs
        ]
        if others:
            scalars.append(min(others)[1])
        cur = scalars[0]
        for nxt in scalars[1:]:
            cur = self.contract(cur, nxt)

    def simplify_hadamard(self):
        """Contract terms with identical index-sets first (their pairwise
        contraction is elementwise, essentially free).
        """
        groups = {}
        for i, legs in self.terms.items():
            groups.setdefault(frozenset(ix for ix, _ in legs), []).append(i)
        for group in groups.values():
            while len(group) > 1:
                group.append(self.contract(group.pop(), group.pop()))

    def simplify(self):
        self.simplify_batch()
        again = True
        while again:
            self.simplify_single_terms()
            self.simplify_scalars()
            before = self.ssa
            self.simplify_hadamard()
            again = before != self.ssa

    def connected_components(self):
        remaining = set(self.terms)
        comps = []
        while remaining:
            seed_node = remaining.pop()
            comp = {seed_node}
            stack = [seed_node]
            while stack:
                for j in self.neighbors(stack.pop()):
                    if j not in comp:
                        comp.add(j)
                        stack.append(j)
            remaining -= comp
            comps.append(sorted(comp))
        comps.sort()
        return comps

    # -- greedy ------------------------------------------------------------

    def optimize_greedy(
        self,
        costmod=1.0,
        temperature=0.0,
        max_neighbors=DEFAULT_MAX_NEIGHBORS,
        seed=None,
    ):
        """Heap-driven greedy contraction within each connected component.
        Returns False if ``flops_limit`` was exceeded (early abort).
        """
        if temperature == 0.0:

            def score(sa, sb, sab):
                return sab / costmod - (sa + sb) * costmod

        else:
            gumbel = GumbelBatchedGenerator(seed)

            def score(sa, sb, sab):
                x = sab / costmod - (sa + sb) * costmod
                if x > 0:
                    return math.log(x) - temperature * gumbel()
                if x < 0:
                    return -math.log(-x) - temperature * gumbel()
                return -temperature * gumbel()

        sizes = self.sizes
        node_size = {
            i: _legs_size(legs, sizes) for i, legs in self.terms.items()
        }

        queue = []
        cands = {}
        c = itertools.count()

        def push(i, j):
            klegs = _merge_legs(
                self.terms[i], self.terms[j], self.appearances
            )
            ksize = _legs_size(klegs, sizes)
            s = score(node_size[i], node_size[j], ksize)
            cid = next(c)
            cands[cid] = (i, j, ksize, klegs)
            heapq.heappush(queue, (s, cid))

        for nodes in self.edge_nodes.values():
            if max_neighbors and len(nodes) > max_neighbors:
                continue
            for i, j in itertools.combinations(nodes, 2):
                push(i, j)

        while queue:
            _, cid = heapq.heappop(queue)
            i, j, ksize, klegs = cands.pop(cid)
            if i not in self.terms or j not in self.terms:
                continue
            k = self.contract(i, j, new_legs=klegs)
            if self.track_flops and self.flops >= self.flops_limit:
                return False
            node_size[k] = ksize
            for l in self.neighbors(k, max_degree=max_neighbors):
                push(k, l)
            if len(queue) >= 2**14:
                # prune stale candidates
                live = [
                    (s, cid)
                    for s, cid in queue
                    if cands[cid][0] in self.terms
                    and cands[cid][1] in self.terms
                ]
                dead = {cid for _, cid in queue} - {cid for _, cid in live}
                for cid in dead:
                    cands.pop(cid, None)
                heapq.heapify(live)
                queue = live
        return True

    # -- optimal DP -----------------------------------------------------------

    def optimize_optimal_connected(
        self, where, minimize="flops", cost_cap=2, search_outer=False
    ):
        """Exact DP over the connected component ``where``: enumerate
        contractions of all connected subgraphs in order of size, sieved by
        a doubling cost cap (arXiv:1304.6112).
        """
        additive, step = dp_cost_fn(minimize)
        appearances, sizes = self.appearances, self.sizes
        nterms = len(where)
        # best[m][bitset] = (legs, score, bitpath)
        best = [{} for _ in range(nterms + 1)]
        bit_to_node = {}
        # a subset's legs do not depend on how it was split: kept once per
        # subset, with the bitmask of their indices
        legs_of, mask_of = {}, {}
        for b, node in enumerate(where):
            bit = 1 << b
            bit_to_node[bit] = node
            legs = self.terms[node]
            best[1][bit] = (legs, 0, ())
            legs_of[bit] = legs
            mask_of[bit] = functools.reduce(
                operator.or_, (1 << ix for ix, _ in legs), 0
            )
        # the product of the sizes of a bitmask's indices, by size class
        by_size = {}
        for ix in _bits(functools.reduce(operator.or_, mask_of.values(), 0)):
            by_size[sizes[ix]] = by_size.get(sizes[ix], 0) | (1 << ix)
        by_size = tuple(by_size.items())

        def size_of(mask):
            p = 1
            for d, md in by_size:
                k = (mask & md).bit_count()
                if k:
                    p *= d**k
            return p

        def join(bi, bj):
            """The legs of ``bi | bj`` and the step's own cost, or None
            for an outer product (unless ``search_outer``)."""
            mi, mj = mask_of[bi], mask_of[bj]
            if not (mi & mj or search_outer):
                return None
            bk = bi | bj
            if bk not in legs_of:
                counts = dict(legs_of[bi])
                for x, c in legs_of[bj]:
                    counts[x] = counts.get(x, 0) + c
                legs = tuple(
                    (x, c) for x, c in sorted(counts.items())
                    if c != appearances[x]
                )
                legs_of[bk] = legs
                mask_of[bk] = functools.reduce(
                    operator.or_, (1 << x for x, _ in legs), 0
                )
            return legs_of[bk], step(size_of(mi | mj), size_of(mask_of[bk]))

        # Each round re-runs the whole sieve at a doubled cost cap, keeping
        # the tables. Two shortcuts leave every table exactly as the plain
        # rounds leave it: each pair is joined once (``joined``: (bi, bj)
        # -> the legs and the step's own cost, or None), and after a round
        # that changed no table the cap jumps past the rounds that would
        # accept nothing, to the first doubling that reaches the least
        # score it turned away.
        joined = {}
        while not best[nterms]:
            changed = False
            least_refused = math.inf
            for m in range(2, nterms + 1):
                best_m = best[m]
                for k in range(1, m // 2 + 1):
                    if k != m - k:
                        pairs = itertools.product(
                            best[k].items(), best[m - k].items()
                        )
                    else:
                        pairs = itertools.combinations(best[k].items(), 2)
                    for (bi, (_, si, pi)), (bj, (_, sj, pj)) in pairs:
                        if bi & bj:
                            continue
                        try:
                            res = joined[bi, bj]
                        except KeyError:
                            res = joined[bi, bj] = join(bi, bj)
                        if res is None:
                            continue
                        legs, cost = res
                        if additive:
                            new_score = si + sj + cost
                        else:
                            new_score = max(si, sj, cost)
                        if new_score > cost_cap:
                            if new_score < least_refused:
                                least_refused = new_score
                            continue
                        bk = bi | bj
                        cur = best_m.get(bk)
                        if cur is None or new_score < cur[1]:
                            best_m[bk] = (legs, new_score, (*pi, *pj, (bi, bj)))
                            changed = True
            cost_cap *= 2
            if not changed and least_refused < math.inf:
                while cost_cap < least_refused:
                    cost_cap *= 2

        ((_, _, bitpath),) = best[nterms].values()
        for bi, bj in bitpath:
            k = self.contract(bit_to_node[bi], bit_to_node[bj])
            bit_to_node[bi | bj] = k

    def optimize_optimal(self, minimize="flops", cost_cap=2, search_outer=False):
        for where in self.connected_components():
            if len(where) > 1:
                self.optimize_optimal_connected(
                    where,
                    minimize=minimize,
                    cost_cap=cost_cap,
                    search_outer=search_outer,
                )

    def finalize(self):
        """Contract any remaining disconnected pieces, smallest first, and
        return the accumulated ssa path.
        """
        if len(self.terms) > 1:
            by_size = [
                (_legs_size(legs, self.sizes), i)
                for i, legs in self.terms.items()
            ]
            heapq.heapify(by_size)
            while len(by_size) > 1:
                _, i = heapq.heappop(by_size)
                _, j = heapq.heappop(by_size)
                k = self.contract(i, j)
                heapq.heappush(
                    by_size, (_legs_size(self.terms[k], self.sizes), k)
                )
        return self.ssa_path


# -- public entry points -------------------------------------------------------


def optimize_simplify(inputs, output, size_dict, use_ssa=False):
    """Just simplify (fold single terms, scalars, hadamards) then contract
    remaining terms by size.
    """
    g = PlanGraph(inputs, output, size_dict)
    g.simplify()
    path = g.finalize()
    if use_ssa:
        return path
    from ..tree import ssa_to_linear

    return ssa_to_linear(path, len(inputs))


def optimize_greedy(
    inputs,
    output,
    size_dict,
    costmod=1.0,
    temperature=0.0,
    max_neighbors=DEFAULT_MAX_NEIGHBORS,
    simplify=True,
    seed=None,
    use_ssa=False,
    accel="auto",
):
    """Greedy contraction path. Signature-compatible with the reference's
    ``optimize_greedy`` (``path_basic.py:1038``, native ``cotengrust``).
    """
    native = _get_native(accel)
    if native is not None:
        return native.optimize_greedy(
            inputs,
            output,
            size_dict,
            costmod=costmod,
            temperature=temperature,
            max_neighbors=max_neighbors,
            simplify=simplify,
            seed=seed,
            use_ssa=use_ssa,
        )
    g = PlanGraph(inputs, output, size_dict)
    if simplify:
        g.simplify()
    g.optimize_greedy(
        costmod=costmod,
        temperature=temperature,
        max_neighbors=max_neighbors,
        seed=seed,
    )
    path = g.finalize()
    if use_ssa:
        return path
    from ..tree import ssa_to_linear

    return ssa_to_linear(path, len(inputs))


def optimize_random_greedy_track_flops(
    inputs,
    output,
    size_dict,
    ntrials=1,
    costmod=(0.1, 4.0),
    temperature=(0.001, 1.0),
    max_neighbors=DEFAULT_MAX_NEIGHBORS,
    simplify=True,
    seed=None,
    accel="auto",
    use_ssa=False,
):
    """Batched random-greedy search directly tracking the best flops - no
    tree construction per trial. Returns ``(path, log10(flops))``.

    ``costmod`` is sampled uniformly and ``temperature`` log-uniformly from
    their ranges per trial (pass scalars to fix them).
    """
    native = _get_native(accel)
    if native is not None:
        return native.optimize_random_greedy_track_flops(
            inputs,
            output,
            size_dict,
            ntrials=ntrials,
            costmod=costmod,
            temperature=temperature,
            max_neighbors=max_neighbors,
            simplify=simplify,
            seed=seed,
            use_ssa=use_ssa,
        )
    rng = get_rng(seed)
    if isinstance(costmod, (int, float)):
        costmod = (costmod, costmod)
    if isinstance(temperature, (int, float)):
        temperature = (temperature, temperature)

    g0 = PlanGraph(inputs, output, size_dict, track_flops=True)
    if simplify:
        g0.simplify()

    best_path = None
    best_flops = float("inf")

    for _ in range(ntrials):
        g = g0.copy()
        g.flops_limit = best_flops
        cm = rng.uniform(*costmod)
        lo, hi = temperature
        if lo == hi:
            tp = lo
        else:
            tp = math.exp(
                rng.uniform(math.log(max(lo, 1e-9)), math.log(max(hi, 1e-9)))
            )
        ok = g.optimize_greedy(
            costmod=cm,
            temperature=tp,
            max_neighbors=max_neighbors,
            seed=rng,
        )
        if not ok:
            continue
        g.finalize()
        if g.flops < best_flops:
            best_flops = g.flops
            best_path = g.ssa_path

    if best_path is None:
        # all trials aborted (shouldn't happen with inf start) - fall back
        g = g0.copy()
        g.optimize_greedy(max_neighbors=max_neighbors, seed=rng)
        best_path = g.finalize()
        best_flops = g.flops

    log10_flops = math.log10(max(best_flops, 1))
    if use_ssa:
        return best_path, log10_flops
    from ..tree import ssa_to_linear

    return ssa_to_linear(best_path, len(inputs)), log10_flops


def optimize_optimal(
    inputs,
    output,
    size_dict,
    minimize="flops",
    cost_cap=2,
    search_outer=False,
    simplify=True,
    use_ssa=False,
    accel="auto",
):
    """Optimal contraction path by dynamic programming (exponential time -
    use for <= ~16 effective terms, or more with the native kernel).
    """
    native = _get_native(accel)
    if native is not None:
        return native.optimize_optimal(
            inputs,
            output,
            size_dict,
            minimize=minimize,
            cost_cap=cost_cap,
            search_outer=search_outer,
            simplify=simplify,
            use_ssa=use_ssa,
        )
    inputs = tuple(map(tuple, inputs))
    sizes = tuple(
        (ix, size_dict[ix])
        for ix in dict.fromkeys(ix for term in inputs for ix in term)
    )
    path = list(_optimal_ssa_path(
        inputs, tuple(output), sizes, minimize, cost_cap, search_outer,
        simplify,
    ))
    if use_ssa:
        return path
    from ..tree import ssa_to_linear

    return ssa_to_linear(path, len(inputs))


@functools.lru_cache(maxsize=2**14)
def _optimal_ssa_path(inputs, output, sizes, minimize, cost_cap,
                      search_outer, simplify):
    """The pure-Python optimal DP's SSA path, kept per contraction:
    subtree reconfiguration re-solves the same small subtrees after every
    slicing step, and the answer is a function of its arguments alone.
    (The native DP answers as fast as the cache, so it has none.)"""
    g = PlanGraph(inputs, output, dict(sizes))
    if simplify:
        g.simplify()
    g.optimize_optimal(
        minimize=minimize, cost_cap=cost_cap, search_outer=search_outer
    )
    return tuple(g.finalize())


# -- native acceleration hook ---------------------------------------------------


def _get_native(accel):
    """The native library module for ``accel``, or ``None`` for pure
    Python: ``"auto"`` takes the library where it builds, ``True``
    requires it (raising its build error), ``False`` and ``None`` never
    take it."""
    if accel is False or accel is None:
        return None
    from ..ops import native

    if accel is True:
        native.library()
        return native
    if accel == "auto":
        return native if native.is_available() else None
    raise ValueError(f"Unknown accel={accel!r}")


# -- optimizer classes -----------------------------------------------------------


class GreedyOptimizer(PathOptimizer):
    """Greedy optimizer with fixed parameters."""

    def __init__(
        self,
        costmod=1.0,
        temperature=0.0,
        max_neighbors=DEFAULT_MAX_NEIGHBORS,
        simplify=True,
        accel="auto",
        seed=None,
    ):
        self.costmod = costmod
        self.temperature = temperature
        self.max_neighbors = max_neighbors
        self.simplify = simplify
        self.accel = accel
        self.seed = seed

    def ssa_path(self, inputs, output, size_dict):
        return optimize_greedy(
            inputs,
            output,
            size_dict,
            costmod=self.costmod,
            temperature=self.temperature,
            max_neighbors=self.max_neighbors,
            simplify=self.simplify,
            seed=self.seed,
            use_ssa=True,
            accel=self.accel,
        )


class RandomGreedyOptimizer(PathOptimizer):
    """Batched random-greedy optimizer tracking best flops directly.

    Attributes
    ----------
    best_ssa_path : list[tuple[int]]
    best_flops : float
        log10 of the best total flops found.
    """

    def __init__(
        self,
        max_repeats=32,
        costmod=(0.1, 4.0),
        temperature=(0.001, 1.0),
        max_neighbors=DEFAULT_MAX_NEIGHBORS,
        simplify=True,
        accel="auto",
        parallel=False,
        seed=None,
    ):
        self.max_repeats = max_repeats
        self.costmod = costmod
        self.temperature = temperature
        self.max_neighbors = max_neighbors
        self.simplify = simplify
        self.accel = accel
        self.parallel = parallel
        self.seed = seed
        self.best_ssa_path = None
        self.best_flops = float("inf")

    def ssa_path(self, inputs, output, size_dict):
        rng = get_rng(self.seed)

        from ..parallel.pools import parse_parallel_arg, submit

        pool = parse_parallel_arg(self.parallel)
        if pool is None:
            nbatch, per = 1, self.max_repeats
        else:
            nbatch = getattr(pool, "_max_workers", 8) or 8
            per = max(1, self.max_repeats // nbatch)

        jobs = []
        for _ in range(nbatch):
            kwargs = dict(
                ntrials=per,
                costmod=self.costmod,
                temperature=self.temperature,
                max_neighbors=self.max_neighbors,
                simplify=self.simplify,
                seed=rng.randrange(2**32),
                accel=self.accel,
                use_ssa=True,
            )
            if pool is None:
                jobs.append(
                    optimize_random_greedy_track_flops(
                        inputs, output, size_dict, **kwargs
                    )
                )
            else:
                jobs.append(
                    submit(
                        pool,
                        optimize_random_greedy_track_flops,
                        inputs,
                        output,
                        size_dict,
                        **kwargs,
                    )
                )

        for job in jobs:
            if pool is not None:
                job = job.result()
            path, log10_flops = job
            if log10_flops < self.best_flops:
                self.best_flops = log10_flops
                self.best_ssa_path = path

        return self.best_ssa_path


class OptimalOptimizer(PathOptimizer):
    """Optimal DP optimizer."""

    def __init__(
        self,
        minimize="flops",
        cost_cap=2,
        search_outer=False,
        simplify=True,
        accel="auto",
    ):
        self.minimize = minimize
        self.cost_cap = cost_cap
        self.search_outer = search_outer
        self.simplify = simplify
        self.accel = accel

    def ssa_path(self, inputs, output, size_dict):
        return optimize_optimal(
            inputs,
            output,
            size_dict,
            minimize=self.minimize,
            cost_cap=self.cost_cap,
            search_outer=self.search_outer,
            simplify=self.simplify,
            use_ssa=True,
            accel=self.accel,
        )
