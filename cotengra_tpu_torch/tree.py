"""The execution side of the contraction tree (counterpart of
``cotengra_tpu/tree.py``).

A binary tree over the N input tensors. Each node is a subset of inputs
encoded as an int bitmask (leaf ``i`` is ``1 << i``). A node's legs are
the outer indices of its subtree with their appearance counts: index
``ix`` is kept iff it appears fewer times inside the subtree than in
total (inputs containing it, plus one if it is in the output). Sliced
indices are dropped everywhere.

This is what the executor reads: the structure (``children``,
``traverse``), legs, slicing (``remove_ind``, ``sliced_inds``,
``multiplicity``, ``slice_key``), shapes and flop counts, with the
reference's semantics and orders, so that trees from the same plan
lower to the same steps. Legs are recomputed plainly (cached until the
slicing changes) where the reference updates them incrementally. Trees
come from a saved plan (``utils.io.load_tree``), an explicit path
(``ContractionTree.from_path``, which finishes an incomplete path with
the basic path finders, ``pathfinders/basic.py``) or the front end
(``interface.py``). Slicing search and reconfiguration are not here.

For the compressed (chi-capped) cost model, ``traverse`` and
``get_ssa_path`` also take an order (a callable, or
``"surface_order"``: the order in which contractions were added), and
``compressed_contract_stats`` replays the contraction on a
``HyperGraph`` with ``compress`` steps (pure Python; the reference's
native replay is not ported), behind the ``*_compressed`` cost methods
that ``tree_compressed.ContractionTreeCompressed`` swaps in.

``contraction_cores`` caches the contractors built for the tree
(``ops/executor.py::_cached_full``), keyed by every option that shapes
them; changing the tree's structure or slicing empties it.
"""

import functools
import heapq
import itertools
import math
from dataclasses import dataclass
from typing import Optional

from .scoring import DEFAULT_COMBO_FACTOR, parse_minimize
from .utils.misc import prod


@dataclass(order=True, frozen=True)
class SliceInfo:
    """A sliced index. Ordering puts output-sliced (``inner=False``)
    indices first, so that slice enumeration is [output chunks x inner
    sum]."""

    inner: bool
    ind: str
    size: int
    project: Optional[int]


def get_slice_strides(sliced_inds):
    """Mixed-radix strides for decoding a flat slice id into per-index
    assignments, given the ordered ``sliced_inds`` dict."""
    infos = list(sliced_inds.values())
    strides = [1] * len(infos)
    for i in range(len(infos) - 2, -1, -1):
        strides[i] = strides[i + 1] * infos[i + 1].size
    return strides


def legs_union(legs_seq):
    """Merge legs dicts, summing appearance counts."""
    merged = {}
    for legs in legs_seq:
        for ix, c in legs.items():
            merged[ix] = merged.get(ix, 0) + c
    return merged


def linear_to_ssa(path, n=None):
    """Convert a linear (shrinking-list) path to SSA ids."""
    if n is None:
        n = sum(len(step) for step in path) - len(path) + 1
    ids = list(range(n))
    ssa = n
    out = []
    for step in path:
        step = tuple(step)
        out.append(tuple(ids[i] for i in step))
        for i in sorted(step, reverse=True):
            ids.pop(i)
        ids.append(ssa)
        ssa += 1
    return tuple(out)


class ContractionTree:
    """Binary contraction tree over ``inputs``.

    Parameters
    ----------
    inputs : sequence[sequence[str]]
        Index labels of each input tensor.
    output : sequence[str]
        Output index labels.
    size_dict : dict[str, int]
        Size of each index.
    children : dict[int, (int, int)], optional
        The tree: parent bitmask -> (left, right), in the order the plan
        lists them (which ``traverse`` keeps among nodes of one size).
    objective : str or Objective, optional
        Default objective for refinement operations on this tree.
    """

    def __init__(self, inputs, output, size_dict, children=None,
                 objective="flops"):
        self.inputs = tuple(map(tuple, inputs))
        self.output = tuple(output)
        self.size_dict = dict(size_dict)
        self.N = len(self.inputs)
        self.root = (1 << self.N) - 1
        # total appearance count of each index (+1 if in output)
        self.appearances = {}
        for term in self.inputs:
            for ix in term:
                self.appearances[ix] = self.appearances.get(ix, 0) + 1
        for ix in self.output:
            self.appearances[ix] = self.appearances.get(ix, 0) + 1
        self.children = dict(children or {})
        self.sliced_inds = {}
        self.multiplicity = 1
        self._legs = {}
        self.contraction_cores = {}
        self._objective = parse_minimize(objective)

    def set_default_objective(self, objective):
        self._objective = parse_minimize(objective)

    def get_default_objective(self):
        return self._objective

    def get_default_combo_factor(self):
        return getattr(self._objective, "factor", DEFAULT_COMBO_FACTOR)

    def gen_leaves(self):
        for i in range(self.N):
            yield 1 << i

    def is_complete(self):
        """Whether the tree joins every input: N - 1 contractions up to
        the root (a single input is complete alone)."""
        if self.N == 1:
            return True
        return len(self.children) == self.N - 1 and self.root in self.children

    def copy(self):
        new = type(self)(
            self.inputs, self.output, self.size_dict, self.children,
            objective=self._objective,
        )
        new.sliced_inds = dict(self.sliced_inds)
        new.multiplicity = self.multiplicity
        return new

    # -- legs, sizes, flops ----------------------------------------------

    def get_legs(self, node):
        """The outer indices of ``node``'s subtree, with counts of
        appearances within it."""
        try:
            return self._legs[node]
        except KeyError:
            pass
        if node == self.root and self.N > 1:
            legs = {ix: 0 for ix in self.output if ix not in self.sliced_inds}
        elif node.bit_count() == 1:
            counts = {}
            for ix in self.inputs[node.bit_length() - 1]:
                counts[ix] = counts.get(ix, 0) + 1
            legs = {
                ix: c
                for ix, c in counts.items()
                if c < self.appearances[ix] and ix not in self.sliced_inds
            }
        else:
            legs = {
                ix: c
                for ix, c in self.get_involved(node).items()
                if c < self.appearances[ix]
            }
        self._legs[node] = legs
        return legs

    def get_involved(self, node):
        """The indices involved in forming ``node``: the union of its
        children's legs, counts summed. Empty for leaves."""
        if node.bit_count() == 1:
            return {}
        l, r = self.children[node]
        return legs_union((self.get_legs(l), self.get_legs(r)))

    def get_flops(self, node):
        """Operation count of the pairwise contraction forming ``node``
        (the product of the sizes of every involved index)."""
        if node.bit_count() == 1:
            return 0
        return prod(self.size_dict[ix] for ix in self.get_involved(node))

    def total_flops(self, dtype=None, log=None):
        """Flops over all slices; ``dtype`` counts a real (x2) or complex
        (x4) multiply-add."""
        C = self.multiplicity * sum(self.get_flops(p) for p in self.children)
        if dtype is None:
            pass
        elif "float" in dtype:
            C *= 2
        elif "complex" in dtype:
            C *= 4
        else:
            raise ValueError(f"Unknown dtype {dtype}")
        if log is not None:
            C = math.log(max(C, 1), log)
        return C

    def total_write(self, log=None):
        """Elements written over all slices: every intermediate's size."""
        W = self.multiplicity * sum(map(self.get_size, self.children))
        if log is not None:
            W = math.log(max(W, 1), log)
        return W

    def combo_cost(self, factor=DEFAULT_COMBO_FACTOR, combine=sum, log=None):
        t = self.multiplicity * sum(
            combine((self.get_flops(p), factor * self.get_size(p)))
            for p in self.children
        )
        if log is not None:
            t = math.log(max(t, 1), log)
        return t

    def contract_stats(self, force=False):
        """``{"flops", "write", "size"}``, as the objectives read them
        (each at least 1), exact even where a subclass swaps in other
        cost methods. Computed afresh; ``force`` is the reference's
        signature, whose totals are incremental."""
        return {
            "flops": max(ContractionTree.total_flops(self), 1),
            "write": max(ContractionTree.total_write(self), 1),
            "size": max(ContractionTree.max_size(self), 1),
        }

    def get_shapes(self):
        return tuple(
            tuple(self.size_dict[ix] for ix in term) for term in self.inputs
        )

    def get_size(self, node):
        """Number of elements of ``node``'s tensor."""
        return prod(self.size_dict[ix] for ix in self.get_legs(node))

    def max_size(self, log=None):
        """The largest intermediate (per slice), in elements."""
        if self.N == 1:
            size = self.get_size(self.root)
        else:
            size = max(map(self.get_size, self.children), default=0) or 1
        if log is not None:
            size = math.log(max(size, 1), log)
        return size

    def peak_size(self, order=None, log=None):
        """Peak concurrent memory over the contraction in traversal
        order (per slice, in elements), counting both inputs and the
        output of each step as live together."""
        tot = sum(self.get_size(1 << i) for i in range(self.N))
        peak = tot
        for p, l, r in self.traverse(order=order):
            tot += self.get_size(p)
            peak = max(peak, tot)
            tot -= self.get_size(l) + self.get_size(r)
        if log is not None:
            peak = math.log(max(peak, 1), log)
        return peak

    @property
    def nslices(self):
        return self.multiplicity

    @property
    def nchunks(self):
        """Number of output chunks produced by output-sliced indices."""
        return prod(
            si.size for si in self.sliced_inds.values() if not si.inner
        )

    # -- construction from paths -----------------------------------------

    def contract_nodes_pair(self, l, r):
        """Contract nodes ``l`` and ``r`` into their parent ``l | r``."""
        parent = l | r
        self.children.pop(parent, None)
        self.children[parent] = (
            (l, r) if l.bit_count() >= r.bit_count() else (r, l)
        )
        self.__dict__.pop("_surface_seq", None)
        self._legs.clear()
        self.contraction_cores.clear()
        return parent

    def contract_nodes(self, nodes, optimize="greedy"):
        """Contract ``nodes`` into one parent; more than two are joined
        in the order that ``optimize`` (``"greedy"`` or ``"optimal"``)
        finds for their sub-contraction."""
        nodes = list(nodes)
        if len(nodes) == 1:
            return nodes[0]
        if len(nodes) == 2:
            return self.contract_nodes_pair(*nodes)
        sub_inputs = [tuple(self.get_legs(n)) for n in nodes]
        grand = 0
        for n in nodes:
            grand |= n
        if grand == self.root and self.N > 1:
            sub_output = tuple(
                ix for ix in self.output if ix not in self.sliced_inds
            )
        else:
            merged = legs_union(self.get_legs(n) for n in nodes)
            sub_output = tuple(
                ix for ix, c in merged.items() if c < self.appearances[ix]
            )
        ssa_path = _find_sub_path(
            sub_inputs, sub_output, self.size_dict, optimize
        )
        pool = list(nodes)
        for step in ssa_path:
            parent = pool[step[0]]
            for s in step[1:]:
                parent = self.contract_nodes_pair(parent, pool[s])
            pool.append(parent)
        return pool[-1]

    @classmethod
    def from_path(cls, inputs, output, size_dict, *, path=None,
                  ssa_path=None, optimize="greedy", objective="flops"):
        """Build a tree from a contraction path: exactly one of ``path``
        (linear, opt_einsum style) or ``ssa_path``. Multi-way steps are
        binarized left to right. A path that leaves several top nodes
        (disconnected pieces, or a partial path) is completed as the
        reference's ``autocomplete`` does: two are contracted, more are
        joined in the order ``optimize`` finds (see ``contract_nodes``).
        """
        if (path is None) == (ssa_path is None):
            raise ValueError("Specify exactly one of path, ssa_path.")
        tree = cls(inputs, output, size_dict, objective=objective)
        if path is not None:
            ssa_path = linear_to_ssa(path, tree.N)
        pool = [1 << i for i in range(tree.N)]
        for step in ssa_path:
            parent = pool[step[0]]
            for s in step[1:]:
                parent = tree.contract_nodes_pair(parent, pool[s])
            pool.append(parent)
        if tree.N > 1 and tree.root not in tree.children:
            below = {c for lr in tree.children.values() for c in lr}
            tops = [
                n
                for n in itertools.chain(
                    tree.children, (1 << i for i in range(tree.N))
                )
                if n not in below
            ]
            tree.contract_nodes(tops, optimize=optimize)
        return tree

    # -- paths -----------------------------------------------------------

    def get_ssa_path(self, order=None):
        """The tree as an SSA path, in the default traversal order or any
        ``traverse`` ``order``."""
        ssa = {1 << i: i for i in range(self.N)}
        path = []
        for c, (p, l, r) in enumerate(self.traverse(order), self.N):
            path.append((ssa[l], ssa[r]))
            ssa[p] = c
        return tuple(path)

    def get_path(self):
        """The tree as a linear (opt_einsum style) path."""
        return ssa_to_linear(self.get_ssa_path(), self.N)

    # -- traversal -------------------------------------------------------

    def traverse(self, order=None):
        """Generate ``(parent, left, right)`` bottom up.

        With no ``order``: by subtree size, children before parents, plan
        order among equal sizes (the reference's default order, which the
        lowering relies on). With a callable ``order`` (or
        ``"surface_order"``): contractions sorted by ``order(node)``
        among those whose children are done.
        """
        if order is None:
            for parent in sorted(self.children, key=int.bit_count):
                l, r = self.children[parent]
                yield parent, l, r
            return

        if isinstance(order, str):
            order = self._resolve_order(order)

        parent_map = self._parent_map()
        ready = []
        counts = {}
        seq = itertools.count()
        for parent, (l, r) in self.children.items():
            need = (l.bit_count() > 1) + (r.bit_count() > 1)
            counts[parent] = need
            if need == 0:
                heapq.heappush(ready, (order(parent), next(seq), parent))
        while ready:
            _, _, parent = heapq.heappop(ready)
            l, r = self.children[parent]
            yield parent, l, r
            gp = parent_map.get(parent)
            if gp is not None:
                counts[gp] -= 1
                if counts[gp] == 0:
                    heapq.heappush(ready, (order(gp), next(seq), gp))

    def _parent_map(self):
        pm = {}
        for parent, (l, r) in self.children.items():
            pm[l] = parent
            pm[r] = parent
        return pm

    def surface_order(self, node):
        """Ordering key of the 'surface order': the order in which
        contractions were added to the tree (that of the generating
        path), the natural sweep order of a compressed contraction."""
        try:
            return self._surface_seq[node]
        except (AttributeError, KeyError):
            self._surface_seq = {n: i for i, n in enumerate(self.children)}
            return self._surface_seq.get(node, len(self._surface_seq))

    def _resolve_order(self, order):
        if order == "surface_order":
            return self.surface_order
        return order

    def _adopt(self, other):
        """Take over another tree's structure and state (same inputs)."""
        self.children = other.children
        self._legs = other._legs
        self.sliced_inds = other.sliced_inds
        self.multiplicity = other.multiplicity
        self.contraction_cores = {}

    # -- compressed (chi-capped) cost model ------------------------------

    def get_hypergraph(self, accel=False):
        from .hypergraph import get_hypergraph

        return get_hypergraph(
            self.inputs, self.output, self.size_dict, accel=accel
        )

    def get_default_chi(self):
        return max(self.size_dict.values(), default=2) ** 2

    def get_default_compress_late(self):
        return False

    def compressed_contract_stats(
        self,
        chi=None,
        order="surface_order",
        compress_late=None,
        tracker_cls=None,
        accel="auto",
    ):
        """Replay the contraction on a hypergraph with chi-capped
        ``compress()`` steps and return the stats tracker (flops, write,
        max_size, peak_size). The replay is pure Python: ``accel=True``
        (the reference's native engine) raises."""
        from .scoring import CompressedStatsTracker, tracked_contract_step

        if chi is None or chi == "auto":
            chi = self.get_default_chi()
        if compress_late is None:
            compress_late = self.get_default_compress_late()
        if tracker_cls is None:
            tracker_cls = CompressedStatsTracker

        hg = self.get_hypergraph(accel=accel)
        tree_map = dict(zip(self.gen_leaves(), range(hg.get_num_nodes())))
        tracker = tracker_cls(hg, chi)
        for p, l, r in self.traverse(self._resolve_order(order)):
            tree_map[p] = tracked_contract_step(
                hg, tracker, tree_map[l], tree_map[r], chi, compress_late
            )
        return tracker

    def total_flops_compressed(self, chi=None, order="surface_order",
                               compress_late=None, log=None):
        C = self.compressed_contract_stats(chi, order, compress_late).flops
        if log is not None:
            C = math.log(max(C, 1), log)
        return C

    def total_write_compressed(self, chi=None, order="surface_order",
                               compress_late=None, log=None):
        W = self.compressed_contract_stats(chi, order, compress_late).write
        if log is not None:
            W = math.log(max(W, 1), log)
        return W

    def max_size_compressed(self, chi=None, order="surface_order",
                            compress_late=None, log=None):
        S = self.compressed_contract_stats(
            chi, order, compress_late
        ).max_size
        if log is not None:
            S = math.log(max(S, 1), log)
        return S

    def peak_size_compressed(self, chi=None, order="surface_order",
                             compress_late=None, log=None):
        P = self.compressed_contract_stats(
            chi, order, compress_late
        ).peak_size
        if log is not None:
            P = math.log(max(P, 1), log)
        return P

    def total_cost_compressed(self, chi=None, order="surface_order",
                              compress_late=None,
                              factor=DEFAULT_COMBO_FACTOR, log=None):
        stats = self.compressed_contract_stats(chi, order, compress_late)
        t = stats.flops + factor * stats.write
        if log is not None:
            t = math.log(max(t, 1), log)
        return t

    def contraction_width_compressed(self, chi=None,
                                     order="surface_order",
                                     compress_late=None, log=2):
        return self.max_size_compressed(chi, order, compress_late, log=log)

    # -- slicing ---------------------------------------------------------

    def remove_ind(self, ind, project=None, inplace=False):
        """Slice (or, with ``project``, fix) ``ind`` out of the tree."""
        tree = self if inplace else self.copy()
        if ind in tree.sliced_inds:
            raise ValueError(f"Index {ind} already sliced.")
        d = tree.size_dict[ind]
        if project is None:
            si = SliceInfo(ind not in tree.output, ind, d, None)
            tree.multiplicity *= d
        else:
            si = SliceInfo(ind not in tree.output, ind, 1, project)
        tree.sliced_inds = {
            s.ind: s for s in sorted((*tree.sliced_inds.values(), si))
        }
        tree._legs.clear()
        tree.contraction_cores.clear()
        return tree

    remove_ind_ = functools.partialmethod(remove_ind, inplace=True)

    def slice_key(self, i):
        """Decode flat slice id ``i`` into ``{ind: value}`` assignments
        (mixed-radix, output-sliced indices first)."""
        key = {}
        strides = get_slice_strides(self.sliced_inds)
        for (ind, si), stride in zip(self.sliced_inds.items(), strides):
            if si.project is None:
                key[ind] = (i // stride) % si.size
            else:
                key[ind] = si.project
        return key

    # -- execution (``ops/executor.py``) ---------------------------------

    def get_contractor(self, device="cuda", **kwargs):
        """The cached single-slice contractor (``make_contractor``)."""
        from .ops.executor import _cached_core

        return _cached_core(self, device, **kwargs)

    def contract(self, arrays, device="cuda", **kwargs):
        """Contract over all slices (``contract_tree``)."""
        from .ops.executor import contract_tree

        return contract_tree(self, arrays, device, **kwargs)

    def contract_core(self, arrays, device="cuda", **kwargs):
        """Contract one slice's inputs (``contract_core``)."""
        from .ops.executor import contract_core

        return contract_core(self, arrays, device, **kwargs)

    def contract_slice(self, arrays, i, device="cuda", **kwargs):
        """Contract slice ``i`` of the full inputs (``contract_slice``)."""
        from .ops.executor import contract_slice

        return contract_slice(self, arrays, i, device, **kwargs)


def ssa_to_linear(ssa_path, n=None):
    """Convert an SSA path to linear (shrinking-list) form."""
    if n is None:
        n = sum(len(step) for step in ssa_path) - len(ssa_path) + 1
    ids = list(range(n))
    out = []
    ssa = n
    for step in ssa_path:
        pos = tuple(ids.index(s) for s in step)
        out.append(tuple(sorted(pos)))
        for i in sorted(pos, reverse=True):
            ids.pop(i)
        ids.append(ssa)
        ssa += 1
    return tuple(out)


def edge_path_to_ssa(edge_path, inputs):
    """An edge-elimination order -> an SSA path: eliminating an index
    contracts, pairwise in SSA order, every current term holding it; a
    disconnected remainder is contracted left to right."""
    live = dict(enumerate(frozenset(term) for term in inputs))
    ssa = len(live)
    path = []
    for ix in edge_path:
        group = sorted(i for i, term in live.items() if ix in term)
        while len(group) >= 2:
            a, b = group[0], group[1]
            path.append((a, b))
            live[ssa] = live.pop(a) | live.pop(b)
            group = [ssa] + group[2:]
            ssa += 1
    rest = sorted(live)
    while len(rest) >= 2:
        a, b = rest[0], rest[1]
        path.append((a, b))
        live[ssa] = live.pop(a) | live.pop(b)
        rest = sorted(rest[2:] + [ssa])
        ssa += 1
    return tuple(path)


def edge_path_to_linear(edge_path, inputs):
    """An edge-elimination order -> a linear path."""
    return ssa_to_linear(edge_path_to_ssa(edge_path, inputs), len(inputs))


def _find_sub_path(sub_inputs, sub_output, size_dict, optimize):
    """The SSA path of a sub-contraction by ``optimize``, ``"greedy"``
    or ``"optimal"``."""
    from .pathfinders.basic import optimize_greedy, optimize_optimal

    if optimize == "optimal":
        return optimize_optimal(
            sub_inputs, sub_output, size_dict, use_ssa=True
        )
    if optimize == "greedy":
        return optimize_greedy(sub_inputs, sub_output, size_dict, use_ssa=True)
    raise ValueError(f"Unknown sub-optimize {optimize!r}.")
