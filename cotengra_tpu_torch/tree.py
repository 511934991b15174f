"""The contraction tree: the planner's central data structure and what
the executor reads (counterpart of ``cotengra_tpu/tree.py``).

A binary tree over the N input tensors. Each node is a subset of inputs
encoded as an int bitmask (leaf ``i`` is ``1 << i``). A node's legs are
the outer indices of its subtree with their appearance counts: index
``ix`` is kept iff it appears fewer times inside the subtree than in
total (inputs containing it, plus one if it is in the output). Sliced
indices are dropped everywhere.

As in the reference, every node caches its legs, involved indices, size
and flops, and the totals (flops, write, the sizes as a ``MaxCounter``)
are kept up to date incrementally as nodes are contracted, removed and
re-tracked and as indices are sliced (``remove_ind``) or restored
(``restore_ind``). On that bookkeeping run the planner's refinements,
with the reference's semantics and orders (``children`` insertion order,
leg order), so that the same plan lowers to the same steps:

- slicing: ``slice`` (``slicing.SliceFinder``), ``unslice_rand``,
  ``unslice_all``, ``slice_and_reconfigure`` and its forest variant;
- subtree reconfiguration: ``subtree_reconfigure`` (small subtrees
  re-solved by ``OptimalOptimizer``) and its forest variant, with
  ``parallel`` pools (``parallel/pools.py``);
- ``simulated_anneal`` and ``parallel_temper``
  (``pathfinders/annealing.py``).

Trees come from a saved plan (``utils.io.load_tree``), an explicit path
(``ContractionTree.from_path``, which finishes an incomplete path with
the basic path finders, ``pathfinders/basic.py``), the front end
(``interface.py``) or the hyper-optimizer (``hyper/``).

For the compressed (chi-capped) cost model, ``traverse`` and
``get_ssa_path`` also take an order (a callable, or
``"surface_order"``: the order in which contractions were added), and
``compressed_contract_stats`` replays the contraction on a
``HyperGraph`` with ``compress`` steps (in the native library,
``ops/native``, where it builds; else in pure Python), behind the
``*_compressed`` cost methods that
``tree_compressed.ContractionTreeCompressed`` swaps in.

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
from .utils.misc import MaxCounter, compute_size_by_dict, get_rng, prod
from .utils.symbols import get_symbol_map, inds_to_eq


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


def node_from_single(i):
    return 1 << i


def node_get_single_el(node):
    return node.bit_length() - 1


def node_members(node):
    """Iterate the leaf indices in a bitmask node."""
    while node:
        low = node & -node
        yield low.bit_length() - 1
        node ^= low


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
    """Binary contraction tree over ``inputs``, with cached cost info.

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

        # per-node caches
        self._legs = {}
        self._involved = {}
        self._size = {}
        self._flops = {}

        # incremental totals
        self._tracked = False
        self._tot_flops = 0
        self._tot_write = 0
        self._sizes = MaxCounter()

        # slicing state
        self.sliced_inds = {}
        self.sliced_inputs = frozenset()
        self.multiplicity = 1

        self._objective = parse_minimize(objective)
        self.already_optimized = {}
        self.contraction_cores = {}

    # -- basic structure ---------------------------------------------------

    def set_default_objective(self, objective):
        self._objective = parse_minimize(objective)

    def get_default_objective(self):
        return self._objective

    def get_default_combo_factor(self):
        return getattr(self._objective, "factor", DEFAULT_COMBO_FACTOR)

    def node_to_terms(self, node):
        return [self.get_legs(1 << i) for i in node_members(node)]

    def gen_leaves(self):
        for i in range(self.N):
            yield 1 << i

    def leaf(self, i):
        return 1 << i

    def input_to_node(self, i):
        return 1 << i

    def is_leaf(self, node):
        return node.bit_count() == 1

    def node_extent(self, node):
        return node.bit_count()

    def get_leaves(self, node):
        return tuple(node_members(node))

    def is_complete(self):
        # a complete binary tree over N leaves has N - 1 internal nodes,
        # but a root over a single leaf is also complete
        if self.N == 1:
            return True
        return len(self.children) == self.N - 1 and self.root in self.children

    def copy(self):
        new = object.__new__(type(self))
        new.inputs = self.inputs
        new.output = self.output
        new.size_dict = self.size_dict.copy()
        new.N = self.N
        new.root = self.root
        new.appearances = self.appearances.copy()
        new.children = self.children.copy()
        new._legs = self._legs.copy()
        new._involved = self._involved.copy()
        new._size = self._size.copy()
        new._flops = self._flops.copy()
        new._tracked = self._tracked
        new._tot_flops = self._tot_flops
        new._tot_write = self._tot_write
        new._sizes = self._sizes.copy()
        new.sliced_inds = dict(self.sliced_inds)
        new.sliced_inputs = self.sliced_inputs
        new.multiplicity = self.multiplicity
        new._objective = self._objective
        new.already_optimized = {}
        new.contraction_cores = {}
        return new

    # -- cached node properties --------------------------------------------

    def compute_leaf_legs(self, i):
        """Effective legs of leaf ``i``: unique indices with their in-term
        multiplicities, dropping sliced indices and indices whose appearances
        are all within this single term (folded by preprocessing).
        """
        counts = {}
        for ix in self.inputs[i]:
            counts[ix] = counts.get(ix, 0) + 1
        return {
            ix: c
            for ix, c in counts.items()
            if (c < self.appearances[ix]) and (ix not in self.sliced_inds)
        }

    def get_legs(self, node):
        """The effective outer indices of ``node``'s subtree, with counts of
        appearances within the subtree.
        """
        try:
            return self._legs[node]
        except KeyError:
            pass
        if node == self.root and self.N > 1:
            legs = {
                ix: 0 for ix in self.output if ix not in self.sliced_inds
            }
        elif node.bit_count() == 1:
            legs = self.compute_leaf_legs(node_get_single_el(node))
        else:
            involved = self.get_involved(node)
            legs = {
                ix: c
                for ix, c in involved.items()
                if c < self.appearances[ix]
            }
        self._legs[node] = legs
        return legs

    def get_involved(self, node):
        """All indices involved in forming ``node`` = union of children's
        legs (with summed counts). Zero for leaves.
        """
        try:
            return self._involved[node]
        except KeyError:
            pass
        if node.bit_count() == 1:
            involved = {}
        else:
            try:
                l, r = self.children[node]
                involved = legs_union((self.get_legs(l), self.get_legs(r)))
            except KeyError:
                involved = legs_union(self.node_to_terms(node))
        self._involved[node] = involved
        return involved

    def get_size(self, node):
        try:
            return self._size[node]
        except KeyError:
            pass
        size = compute_size_by_dict(self.get_legs(node), self.size_dict)
        self._size[node] = size
        return size

    def get_flops(self, node):
        """Operation count of the single pairwise contraction forming
        ``node`` (= product of sizes of all involved indices).
        """
        try:
            return self._flops[node]
        except KeyError:
            pass
        if node.bit_count() == 1:
            flops = 0
        else:
            flops = compute_size_by_dict(
                self.get_involved(node), self.size_dict
            )
        self._flops[node] = flops
        return flops

    def get_centrality(self, node):
        """The mean of the leaves' ``HyperGraph.simple_centrality``."""
        cents = self.get_hypergraph().simple_centrality()
        ls = self.get_leaves(node)
        return sum(cents[i] for i in ls) / len(ls)

    # -- structural mutation -----------------------------------------------

    def _forget(self, node):
        self._legs.pop(node, None)
        self._involved.pop(node, None)
        self._size.pop(node, None)
        self._flops.pop(node, None)

    def _remove_node(self, node):
        """Remove ``node``'s cached info and its children-entry, untracking
        its cost contributions.
        """
        if self._tracked and node.bit_count() > 1:
            # remove contributions (forces computation if absent)
            self._tot_flops -= self.get_flops(node)
            size = self.get_size(node)
            self._tot_write -= size
            self._sizes.discard(size)
        self._forget(node)
        self.children.pop(node, None)

    def _track_node(self, node):
        if self._tracked and node.bit_count() > 1:
            self._tot_flops += self.get_flops(node)
            size = self.get_size(node)
            self._tot_write += size
            self._sizes.add(size)

    def contract_nodes_pair(self, l, r, check=False):
        """Contract nodes ``l`` and ``r``, creating (and returning) their
        parent ``l | r``.
        """
        if check and (l & r):
            raise ValueError("Nodes overlap.")
        parent = l | r
        if parent in self.children:
            if check:
                raise ValueError("Parent already has children.")
            # re-pairing an existing node: its flops depend on the split,
            # so untrack the old entry first
            self._remove_node(parent)
        self.children[parent] = (
            (l, r) if l.bit_count() >= r.bit_count() else (r, l)
        )
        self.__dict__.pop("_surface_seq", None)
        self.contraction_cores.clear()
        self._track_node(parent)
        return parent

    def contract_nodes(self, nodes, optimize="auto", check=False):
        """Contract an arbitrary number of ``nodes`` in the tree to form a
        new parent, using ``optimize`` to find the binary sub-order if there
        are more than two.
        """
        nodes = list(nodes)
        if len(nodes) == 1:
            return nodes[0]
        if len(nodes) == 2:
            return self.contract_nodes_pair(*nodes, check=check)

        # build the effective sub-contraction
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
                ix
                for ix, c in merged.items()
                if c < self.appearances[ix]
            )

        ssa_path = _find_sub_path(
            sub_inputs, sub_output, self.size_dict, optimize
        )

        # replay the ssa path on the actual nodes
        pool = list(nodes)
        for ssa_step in ssa_path:
            group = [pool[s] for s in ssa_step]
            merged_node = group[0]
            # binarize multi-way steps left-to-right
            for other in group[1:]:
                merged_node = self.contract_nodes_pair(
                    merged_node, other, check=check
                )
            pool.append(merged_node)
        return pool[-1]

    # -- construction from paths -------------------------------------------

    @classmethod
    def from_path(cls, inputs, output, size_dict, *, path=None,
                  ssa_path=None, edge_path=None, autocomplete="auto",
                  check=False, optimize="greedy", objective="flops",
                  **kwargs):
        """Build a tree from a contraction path: exactly one of ``path``
        (linear, opt_einsum style), ``ssa_path`` or ``edge_path`` (a
        sequence of indices to eliminate). Multi-way steps are binarized
        left to right. A path that leaves several top nodes (disconnected
        pieces, or a partial path) is completed as the reference's
        ``autocomplete`` does: two are contracted, more are joined in the
        order ``optimize`` finds (see ``contract_nodes``).
        """
        nspecs = sum(p is not None for p in (path, ssa_path, edge_path))
        if nspecs != 1:
            raise ValueError(
                "Specify exactly one of path, ssa_path, edge_path."
            )
        tree = cls(inputs, output, size_dict, objective=objective, **kwargs)
        if edge_path is not None:
            tree._build_from_edge_path(edge_path, check=check)
        else:
            if path is not None:
                ssa_path = linear_to_ssa(path, tree.N)
            pool = [1 << i for i in range(tree.N)]
            for step in ssa_path:
                parent = pool[step[0]]
                for s in step[1:]:
                    parent = tree.contract_nodes_pair(
                        parent, pool[s], check=check
                    )
                pool.append(parent)
        if autocomplete == "auto":
            autocomplete = not tree.is_complete()
        if autocomplete:
            tree.autocomplete(optimize=optimize)
        return tree

    def _build_from_edge_path(self, edge_path, check=False):
        # map: index -> set of current nodes containing it
        node_of_input = {i: 1 << i for i in range(self.N)}
        # current top-level nodes
        current = set(node_of_input.values())

        def nodes_with(ix):
            found = []
            for n in current:
                for i in node_members(n):
                    if ix in self.inputs[i]:
                        found.append(n)
                        break
            return found

        for ix in edge_path:
            group = nodes_with(ix)
            if len(group) < 2:
                continue
            parent = self.contract_nodes(group, check=check)
            current.difference_update(group)
            current.add(parent)

    def autocomplete(self, optimize="greedy"):
        """Contract any remaining disconnected top-level nodes into the
        root (they arise from disconnected subgraphs or partial paths).
        """
        # find current top-level nodes: nodes that are not children of any
        # other node
        child_nodes = set()
        for l, r in self.children.values():
            child_nodes.add(l)
            child_nodes.add(r)
        tops = [
            n
            for n in itertools.chain(self.children, self.gen_leaves())
            if n not in child_nodes and n != self.root
        ]
        # also incomplete subtrees
        if self.root in self.children and len(tops) == 0:
            return self
        if self.root not in self.children and self.N > 1:
            if len(tops) >= 2:
                self.contract_nodes(tops, optimize=optimize)
        return self

    # -- traversal ---------------------------------------------------------

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

    def descend(self, mode="dfs"):
        """Generate ``(parent, left, right)`` top-down, depth first
        (``"dfs"``) or breadth first (any other mode)."""
        queue = [self.root]
        while queue:
            node = queue.pop(-1 if mode == "dfs" else 0)
            if node in self.children:
                l, r = self.children[node]
                yield node, l, r
                if l.bit_count() > 1:
                    queue.append(l)
                if r.bit_count() > 1:
                    queue.append(r)

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

    # -- cost statistics ---------------------------------------------------

    def contract_stats(self, force=False):
        if force or not self._tracked:
            self._tot_flops = 0
            self._tot_write = 0
            self._sizes = MaxCounter()
            self._tracked = True  # so get_* don't double count
            for node in self.children:
                self._tot_flops += self.get_flops(node)
                size = self.get_size(node)
                self._tot_write += size
                self._sizes.add(size)
        return {
            "flops": max(self.multiplicity * self._tot_flops, 1),
            "write": max(self.multiplicity * self._tot_write, 1),
            "size": max(self._sizes.max() or 1, 1),
        }

    def total_flops(self, dtype=None, log=None):
        self.contract_stats()
        C = self.multiplicity * self._tot_flops
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
        self.contract_stats()
        W = self.multiplicity * self._tot_write
        if log is not None:
            W = math.log(max(W, 1), log)
        return W

    def combo_cost(self, factor=DEFAULT_COMBO_FACTOR, combine=sum, log=None):
        t = 0
        for p in self.children:
            t += combine((self.get_flops(p), factor * self.get_size(p)))
        t *= self.multiplicity
        if log is not None:
            t = math.log(max(t, 1), log)
        return t

    total_cost = combo_cost

    def max_size(self, log=None):
        if self.N == 1:
            size = self.get_size(self.root)
        else:
            self.contract_stats()
            size = self._sizes.max() or 1
        if log is not None:
            size = math.log(max(size, 1), log)
        return size

    def peak_size(self, order=None, log=None):
        """Peak concurrent memory over the (ordered) contraction,
        assuming both inputs and the output of each step coexist.
        """
        tot = sum(self.get_size(n) for n in self.gen_leaves())
        peak = tot
        for p, l, r in self.traverse(order=order):
            tot += self.get_size(p)
            peak = max(peak, tot)
            tot -= self.get_size(l) + self.get_size(r)
        if log is not None:
            peak = math.log(max(peak, 1), log)
        return peak

    def max_contraction_size(self, log=None):
        """The largest sum of a step's output and operand sizes."""
        Y = max(
            self.get_size(p) + self.get_size(l) + self.get_size(r)
            for p, (l, r) in self.children.items()
        )
        if log is not None:
            Y = math.log(Y, log)
        return Y

    def peak_optimized_order(self):
        """A traversal order (a rank callable for ``traverse``,
        ``peak_size`` and lowering) that lowers the peak concurrent
        memory: at each node the child whose depth-first peak exceeds
        its held size by more is evaluated first. The children stay as
        they are (the lowering's pair steps depend on left and right).

        Returns ``None`` when this depth-first schedule does not beat
        the default order's peak (which may interleave subtrees, as no
        depth-first order can)."""
        peak = {}
        first_right = {}
        for p, l, r in self.traverse():
            sl, sr = self.get_size(l), self.get_size(r)
            pl, pr = peak.get(l, sl), peak.get(r, sr)
            hold = sl + sr + self.get_size(p)
            plr = max(pl, sl + pr, hold)  # evaluate l before r
            prl = max(pr, sr + pl, hold)  # evaluate r before l
            first_right[p] = prl < plr
            peak[p] = min(plr, prl)
        # the chosen depth-first schedule as post-order ranks
        rank = {}
        stack = [(self.root, False)]
        while stack:
            node, emit = stack.pop()
            if emit:
                rank[node] = len(rank)
                continue
            if node not in self.children:
                continue
            l, r = self.children[node]
            stack.append((node, True))
            # the child evaluated first is pushed last, to pop first
            if first_right[node]:
                stack.extend(((l, False), (r, False)))
            else:
                stack.extend(((r, False), (l, False)))
        order = rank.__getitem__
        if self.peak_size(order=order) >= self.peak_size():
            return None
        return order

    def contraction_cost(self, log=None):
        return self.total_flops(dtype=None, log=log)

    def contraction_width(self, log=2):
        return self.max_size(log=log)

    def contraction_scaling(self):
        return max(
            (len(self.get_involved(n)) for n in self.children), default=0
        )

    def arithmetic_intensity(self):
        return self.total_flops() / self.total_write()

    def naive_cost(self, log=None):
        """The cost of one einsum over every index at once."""
        if log is None:
            return self.multiplicity * prod(
                self.size_dict[ix] for ix in self.appearances
            )
        return sum(
            math.log(self.size_dict[ix], log) for ix in self.appearances
        ) + math.log(max(self.multiplicity, 1), log)

    def speedup(self, log=None):
        if log is None:
            return self.naive_cost() / self.contraction_cost()
        return self.naive_cost(log=log) - self.contraction_cost(log=log)

    @property
    def nslices(self):
        return self.multiplicity

    @property
    def nchunks(self):
        """Number of output chunks produced by output-sliced indices."""
        return prod(
            si.size for si in self.sliced_inds.values() if not si.inner
        )

    # -- paths -------------------------------------------------------------

    def get_eq(self):
        return inds_to_eq(self.inputs, self.output)

    def get_shapes(self):
        return tuple(
            tuple(self.size_dict[ix] for ix in term) for term in self.inputs
        )

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

    path = get_path
    ssa_path = get_ssa_path

    # -- compressed (chi-capped) cost model --------------------------------

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
        max_size, peak_size). With ``accel`` (default ``"auto"``) the
        replay runs in the native library where it builds, as the
        reference's does; the tracker then holds those four stats only."""
        from .scoring import CompressedStatsTracker, tracked_contract_step

        if chi is None or chi == "auto":
            chi = self.get_default_chi()
        if compress_late is None:
            compress_late = self.get_default_compress_late()
        if tracker_cls is None:
            tracker_cls = CompressedStatsTracker

        native = _get_native_replay(accel)
        if native is not None:
            return self._native_compressed_stats(
                native, chi, order, compress_late, tracker_cls
            )

        hg = self.get_hypergraph(accel=False)
        tree_map = dict(zip(self.gen_leaves(), range(hg.get_num_nodes())))
        tracker = tracker_cls(hg, chi)
        for p, l, r in self.traverse(self._resolve_order(order)):
            tree_map[p] = tracked_contract_step(
                hg, tracker, tree_map[l], tree_map[r], chi, compress_late
            )
        return tracker

    def _native_compressed_stats(self, native, chi, order, compress_late,
                                 tracker_cls):
        tree_map = dict(zip(self.gen_leaves(), range(self.N)))
        pairs = []
        for nid, (p, l, r) in enumerate(
            self.traverse(self._resolve_order(order)), self.N
        ):
            pairs.append(tree_map[l])
            pairs.append(tree_map[r])
            tree_map[p] = nid
        flops, write, max_size, peak_size = native.compressed_stats(
            self.inputs,
            [ix for ix in self.output if ix not in self.sliced_inds],
            self.size_dict,
            pairs,
            chi,
            compress_late,
        )
        from .scoring import _NULL_STEP

        tracker = tracker_cls.__new__(tracker_cls)
        tracker.chi = chi
        tracker.flops = flops
        tracker.write = write
        tracker.max_size = max_size
        tracker.peak_size = peak_size
        tracker.total_size = 0
        tracker.last = _NULL_STEP
        tracker.secondary_weight = 1e-3
        tracker.factor = None
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

    # -- slicing -----------------------------------------------------------

    def remove_ind(self, ind, project=None, inplace=False):
        """Slice (or project) ``ind`` out of the tree, incrementally
        updating every node's cached legs/size/flops.
        """
        tree = self if inplace else self.copy()
        if ind in tree.sliced_inds:
            raise ValueError(f"Index {ind} already sliced.")

        tree.contract_stats()
        d = tree.size_dict[ind]
        if project is None:
            si = SliceInfo(ind not in tree.output, ind, d, None)
            tree.multiplicity *= d
        else:
            si = SliceInfo(ind not in tree.output, ind, 1, project)

        tree.sliced_inds = {
            s.ind: s for s in sorted((*tree.sliced_inds.values(), si))
        }

        # patch every populated cache entry
        for node in list(tree._legs):
            if node.bit_count() == 1:
                i = node_get_single_el(node)
                if ind in tree.inputs[i]:
                    tree._forget(node)
            elif node == tree.root and tree.N > 1:
                legs = tree._legs[node]
                if ind in legs:
                    tree._legs[node] = {
                        ix: c for ix, c in legs.items() if ix != ind
                    }
                    if node in tree._size:
                        old = tree._size[node]
                        new = old // d
                        tree._size[node] = new
                        if node in tree.children:
                            tree._sizes.discard(old)
                            tree._sizes.add(new)
                            tree._tot_write += new - old

        for node in list(tree._involved):
            if node.bit_count() == 1 or node not in tree.children:
                continue
            involved = tree._involved[node]
            if ind not in involved:
                continue
            tree._involved[node] = {
                ix: c for ix, c in involved.items() if ix != ind
            }
            old_f = tree.get_flops(node)
            new_f = old_f // d
            tree._flops[node] = new_f
            tree._tot_flops += new_f - old_f

            legs = tree.get_legs(node)
            if ind in legs and node != tree.root:
                tree._legs[node] = {
                    ix: c for ix, c in legs.items() if ix != ind
                }
                old_s = tree.get_size(node)
                new_s = old_s // d
                tree._size[node] = new_s
                tree._sizes.discard(old_s)
                tree._sizes.add(new_s)
                tree._tot_write += new_s - old_s

        for i, term in enumerate(tree.inputs):
            if ind in term:
                tree.sliced_inputs = tree.sliced_inputs | frozenset([i])

        tree.already_optimized.clear()
        tree.contraction_cores.clear()
        return tree

    remove_ind_ = functools.partialmethod(remove_ind, inplace=True)

    def restore_ind(self, ind, inplace=False):
        """Unslice ``ind``, rebuilding the affected cached info."""
        tree = self if inplace else self.copy()
        si = tree.sliced_inds.pop(ind)
        tree.contract_stats()
        if si.project is None:
            tree.multiplicity //= si.size

        # forget leaves containing the index
        for i, term in enumerate(tree.inputs):
            if ind in term:
                tree._forget(1 << i)
                if all(ix not in tree.sliced_inds for ix in term):
                    tree.sliced_inputs = tree.sliced_inputs - frozenset([i])

        # re-add dependent intermediates bottom up
        for p, l, r in list(tree.traverse()):
            if ind in tree.get_legs(l) or ind in tree.get_legs(r):
                tree._remove_node(p)
                tree.children[p] = (l, r)
                tree._track_node(p)

        tree.already_optimized.clear()
        tree.contraction_cores.clear()
        return tree

    restore_ind_ = functools.partialmethod(restore_ind, inplace=True)

    def unslice_rand(self, seed=None, inplace=False):
        rng = get_rng(seed)
        ix = rng.choice(tuple(self.sliced_inds))
        return self.restore_ind(ix, inplace=inplace)

    unslice_rand_ = functools.partialmethod(unslice_rand, inplace=True)

    def unslice_all(self, inplace=False):
        tree = self if inplace else self.copy()
        for ind in tuple(tree.sliced_inds):
            tree.restore_ind_(ind)
        return tree

    unslice_all_ = functools.partialmethod(unslice_all, inplace=True)

    def slice(self, inplace=False, **slicefinder_opts):
        """Run the :class:`~cotengra_tpu_torch.slicing.SliceFinder` on this
        tree and remove the chosen indices.
        """
        from .slicing import SliceFinder

        tree = self if inplace else self.copy()
        sf = SliceFinder(tree, **slicefinder_opts)
        for ix in sf.search()[1]:
            tree.remove_ind_(ix)
        return tree

    slice_ = functools.partialmethod(slice, inplace=True)

    def slice_and_reconfigure(
        self,
        target_size,
        step_size=2,
        temperature=0.01,
        minimize=None,
        allow_outer=True,
        max_repeats=16,
        reconf_opts=None,
        progbar=False,
        inplace=False,
    ):
        """Interleave slicing and subtree reconfiguration until the tree's
        ``max_size`` is below ``target_size``.
        """
        tree = self if inplace else self.copy()
        reconf_opts = {} if reconf_opts is None else dict(reconf_opts)
        reconf_opts.setdefault("minimize", minimize)

        if progbar:
            import tqdm

            pbar = tqdm.tqdm(desc="slice+reconf")
        else:
            pbar = None
        while tree.max_size() > target_size:
            tree.slice_(
                temperature=temperature,
                target_slices=step_size,
                minimize=minimize,
                allow_outer=allow_outer,
                max_repeats=max_repeats,
            )
            tree.subtree_reconfigure_(**reconf_opts)
            if pbar is not None:
                pbar.update()
                pbar.set_description(
                    f"nslices={tree.multiplicity} "
                    f"log2[S]={tree.max_size(log=2):.1f}"
                )
        if pbar is not None:
            pbar.close()
        return tree

    slice_and_reconfigure_ = functools.partialmethod(
        slice_and_reconfigure, inplace=True
    )

    # -- subtree reconfiguration -------------------------------------------

    def get_subtree(self, node, size, search="bfs", seed=None):
        """Collect a subtree rooted at ``node`` with up to ``size``
        effective leaves (which may themselves be internal nodes).

        Returns
        -------
        sub_leaves : tuple[node]
        removed : tuple[node]
            Interior nodes of the subtree (excluding ``node``) that would be
            removed by re-solving it.
        """
        rng = get_rng(seed) if search == "random" else None
        frontier = list(self.children[node])
        branches = []
        while len(frontier) < size:
            expandable = [f for f in frontier if f in self.children]
            if not expandable:
                break
            if search == "bfs":
                pick = max(expandable, key=int.bit_count)
            elif search == "dfs":
                pick = expandable[-1]
            else:
                pick = rng.choice(expandable)
            frontier.remove(pick)
            frontier.extend(self.children[pick])
            branches.append(pick)
        return tuple(frontier), tuple(branches)

    def subtree_reconfigure(
        self,
        subtree_size=8,
        subtree_search="bfs",
        weight_what="flops",
        weight_pwr=2,
        select="max",
        maxiter=500,
        seed=None,
        minimize=None,
        inplace=False,
        progbar=False,
    ):
        """Locally improve the tree by repeatedly re-solving small subtrees
        optimally (``OptimalOptimizer``).
        """
        tree = self if inplace else self.copy()
        objective = parse_minimize(
            minimize if minimize is not None else tree._objective
        )
        minimize_key = objective.get_dynamic_programming_minimize()
        rng = get_rng(seed)

        from .pathfinders.basic import OptimalOptimizer

        sub_optimize = OptimalOptimizer(minimize=minimize_key)

        tree.contract_stats()

        if progbar:
            import tqdm

            pbar = tqdm.tqdm(total=maxiter, desc="reconfigure")
        else:
            pbar = None

        for _ in range(maxiter):
            if pbar is not None:
                pbar.update()
                pbar.set_description(
                    f"log10[F]={tree.total_flops(log=10):.2f}"
                )
            # candidate sub-roots: internal nodes with enough leaves below
            candidates = [n for n in tree.children if n.bit_count() > 2]
            if not candidates:
                break

            def local_score(n):
                return objective.cost_local_tree_node(tree, n)

            if select == "max":
                candidates.sort(key=local_score, reverse=True)
            elif select == "min":
                candidates.sort(key=local_score)
            else:  # 'random'
                rng.shuffle(candidates)

            improved = False
            for node in candidates:
                sub_leaves, branches = tree.get_subtree(
                    node, subtree_size, search=subtree_search, seed=rng
                )
                if len(sub_leaves) < 3:
                    continue
                key = (node, frozenset(sub_leaves))
                if key in tree.already_optimized:
                    continue
                tree.already_optimized[key] = True

                # old interior of this subtree (including its root's entry)
                old_interior = {
                    n: tree.children[n] for n in (*branches, node)
                }
                current_cost = sum(
                    objective.cost_local_tree_node(tree, n)
                    for n in old_interior
                )

                for n in old_interior:
                    tree._remove_node(n)
                before = set(tree.children)
                tree.contract_nodes(sub_leaves, optimize=sub_optimize)
                new_interior = [
                    n for n in tree.children if n not in before
                ]
                new_cost = sum(
                    objective.cost_local_tree_node(tree, n)
                    for n in new_interior
                )

                if new_cost < current_cost - 1e-12:
                    improved = True
                    break
                # revert to the old subtree: restore ALL children entries
                # before re-tracking, so cost recomputation sees the full
                # subtree structure
                for n in new_interior:
                    tree._remove_node(n)
                for n, ch in old_interior.items():
                    tree.children[n] = ch
                for n in old_interior:
                    tree._track_node(n)

            if not improved:
                break

        if pbar is not None:
            pbar.close()
        tree.contraction_cores.clear()
        return tree

    subtree_reconfigure_ = functools.partialmethod(
        subtree_reconfigure, inplace=True
    )

    def subtree_reconfigure_forest(
        self,
        num_trees=8,
        num_restarts=10,
        restart_fraction=0.5,
        subtree_maxiter=100,
        subtree_size=10,
        minimize=None,
        seed=None,
        parallel=False,
        progbar=False,
        inplace=False,
    ):
        """Population ('forest') variant of subtree reconfiguration: evolve
        ``num_trees`` independently randomized reconfigurations per round,
        prune to the best and restart.
        """
        from .parallel.pools import parse_parallel_arg, submit

        objective = parse_minimize(
            minimize if minimize is not None else self._objective
        )
        rng = get_rng(seed)
        pool = parse_parallel_arg(parallel)

        def tree_score(t):
            from .scoring import ensure_basic_quantities

            trial = {"tree": t}
            ensure_basic_quantities(trial)
            return objective(trial)

        population = [self.copy()]
        for _ in range(num_restarts):
            # breed: randomized reconfigure jobs from current population
            jobs = []
            for k in range(num_trees):
                parent = population[k % len(population)]
                opts = dict(
                    subtree_size=subtree_size,
                    maxiter=subtree_maxiter,
                    select=rng.choice(["max", "min", "random"]),
                    subtree_search=rng.choice(["bfs", "dfs", "random"]),
                    seed=rng.randrange(2**32),
                    minimize=minimize,
                )
                if pool is None:
                    jobs.append(parent.subtree_reconfigure(**opts))
                else:
                    jobs.append(
                        submit(
                            pool, _reconfigure_job, parent, opts
                        )
                    )
            if pool is not None:
                jobs = [j.result() for j in jobs]
            population.extend(jobs)
            population.sort(key=tree_score)
            keep = max(1, int(num_trees * restart_fraction))
            del population[keep:]

        best = population[0]
        if tree_score(best) > tree_score(self):
            best = self
        if inplace:
            if best is not self:
                self._adopt(best)
            return self
        return best.copy() if best is self else best

    subtree_reconfigure_forest_ = functools.partialmethod(
        subtree_reconfigure_forest, inplace=True
    )

    def slice_and_reconfigure_forest(
        self,
        target_size,
        step_size=2,
        num_trees=8,
        num_restarts=10,
        restart_fraction=0.5,
        reconf_opts=None,
        minimize=None,
        seed=None,
        parallel=False,
        progbar=False,
        inplace=False,
    ):
        """Forest variant of slice-and-reconfigure: a population explores
        different slicing choices in parallel, pruned each round.
        """
        from .parallel.pools import parse_parallel_arg, submit

        objective = parse_minimize(
            minimize if minimize is not None else self._objective
        )
        rng = get_rng(seed)
        pool = parse_parallel_arg(parallel)
        reconf_opts = dict(reconf_opts or {})
        reconf_opts.setdefault("minimize", minimize)

        def tree_score(t):
            from .scoring import ensure_basic_quantities

            trial = {"tree": t}
            ensure_basic_quantities(trial)
            return objective(trial)

        population = [self.copy()]
        while any(t.max_size() > target_size for t in population):
            jobs = []
            for k in range(num_trees):
                parent = population[k % len(population)]
                opts = dict(
                    target_size=target_size,
                    step_size=step_size,
                    temperature=0.01 * 10 ** rng.uniform(-1, 1),
                    max_repeats=8,
                    reconf_opts=reconf_opts,
                    minimize=minimize,
                )
                if pool is None:
                    jobs.append(
                        _slice_reconf_step(parent, opts, rng.randrange(2**32))
                    )
                else:
                    jobs.append(
                        submit(
                            pool,
                            _slice_reconf_step,
                            parent,
                            opts,
                            rng.randrange(2**32),
                        )
                    )
            if pool is not None:
                jobs = [j.result() for j in jobs]
            population = sorted(jobs, key=tree_score)
            keep = max(1, int(num_trees * restart_fraction))
            del population[keep:]

        best = population[0]
        if inplace:
            self._adopt(best)
            return self
        return best

    slice_and_reconfigure_forest_ = functools.partialmethod(
        slice_and_reconfigure_forest, inplace=True
    )

    def _adopt(self, other):
        """Take over another tree's structure and state (same inputs)."""
        self.children = other.children
        self._legs = other._legs
        self._involved = other._involved
        self._size = other._size
        self._flops = other._flops
        self._tracked = other._tracked
        self._tot_flops = other._tot_flops
        self._tot_write = other._tot_write
        self._sizes = other._sizes
        self.sliced_inds = other.sliced_inds
        self.sliced_inputs = other.sliced_inputs
        self.multiplicity = other.multiplicity
        self.already_optimized = {}
        self.contraction_cores = {}

    def simulated_anneal(self, inplace=False, **opts):
        """Simulated-annealing refinement (see
        :func:`~cotengra_tpu_torch.pathfinders.annealing.simulated_anneal_tree`).
        """
        from .pathfinders.annealing import simulated_anneal_tree

        return simulated_anneal_tree(self, inplace=inplace, **opts)

    simulated_anneal_ = functools.partialmethod(
        simulated_anneal, inplace=True
    )

    def parallel_temper(self, inplace=False, **opts):
        """Parallel-tempering refinement (see
        :func:`~cotengra_tpu_torch.pathfinders.annealing.parallel_temper_tree`).
        """
        from .pathfinders.annealing import parallel_temper_tree

        return parallel_temper_tree(self, inplace=inplace, **opts)

    parallel_temper_ = functools.partialmethod(
        parallel_temper, inplace=True
    )

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

    # -- execution (``ops/executor.py``) -----------------------------------

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

    def contract_sharded(self, arrays, mesh=None, **kwargs):
        """Contract with the slice sum sharded over the ranks of a
        process group (``parallel.mesh.contract_sharded``), the
        counterpart of the reference's ``contract_mpi``."""
        from .parallel.mesh import contract_sharded

        return contract_sharded(self, arrays, mesh=mesh, **kwargs)

    contract_mpi = contract_sharded

    def extract_contractions(self, order=None):
        """The tree lowered to its flat step list
        (``ops.lowering.extract_contractions``)."""
        from .ops.lowering import extract_contractions

        return extract_contractions(self, order=order)

    def slice_arrays(self, arrays, i):
        """The inputs of slice ``i`` (``ops.executor.slice_arrays``)."""
        from .ops.executor import slice_arrays

        return slice_arrays(self, arrays, i)

    def gather_slices(self, slices, **kwargs):
        """Sum and reassemble per-slice results
        (``ops.executor.gather_slices``)."""
        from .ops.executor import gather_slices

        return gather_slices(self, slices, **kwargs)

    def benchmark(self, arrays=None, dtype="float32", device="cuda",
                  **kwargs):
        """Seconds per full contraction on ``device`` and the rate it
        implies (``ops.executor.benchmark_tree``: best of ``repeats``,
        synchronizing a CUDA device before the clock is read)."""
        from .ops.executor import benchmark_tree

        return benchmark_tree(
            self, device=device, arrays=arrays, dtype=dtype, **kwargs
        )

    # -- reports -----------------------------------------------------------

    def print_contractions(self, sort=None, show_brackets=True):
        """Print every contraction step: its indices, output size and
        flops; ``sort="flops"`` lists the costliest first."""
        symmap = get_symbol_map(list(self.inputs) + [tuple(self.output)])
        steps = list(self.traverse())
        if sort == "flops":
            steps.sort(key=lambda plr: -self.get_flops(plr[0]))
        for i, (p, l, r) in enumerate(steps):
            l_str = "".join(symmap.get(ix, "?") for ix in self.get_legs(l))
            r_str = "".join(symmap.get(ix, "?") for ix in self.get_legs(r))
            p_str = "".join(symmap.get(ix, "?") for ix in self.get_legs(p))
            print(
                f"({i + 1:>3}) {l_str or '·'},{r_str or '·'}->"
                f"{p_str or '·'}  "
                f"size=2^{math.log2(max(self.get_size(p), 1)):.1f} "
                f"flops=10^{math.log10(max(self.get_flops(p), 1)):.2f}"
            )

    def describe(self, info="normal", join=" "):
        """The tree's costs in one line: ``"normal"`` (flops and largest
        size), ``"full"`` (also combo cost, peak and slices) or
        ``"concise"`` (the same, abbreviated)."""
        self.contract_stats()
        if info == "normal":
            return join.join(
                (
                    f"log10[FLOPs]={self.total_flops(log=10):.2f}",
                    f"log2[SIZE]={self.max_size(log=2):.2f}",
                )
            )
        if info == "full":
            s = [
                f"log10[FLOPS]={self.total_flops(log=10):.2f}",
                f"log10[COMBO]={self.combo_cost(log=10):.2f}",
                f"log2[SIZE]={self.max_size(log=2):.2f}",
                f"log2[PEAK]={self.peak_size(log=2):.2f}",
            ]
            if self.sliced_inds:
                s.append(f"NSLICES={self.multiplicity:.2f}")
            return join.join(s)
        if info == "concise":
            s = [
                f"F={self.total_flops(log=10):.2f}",
                f"C={self.combo_cost(log=10):.2f}",
                f"S={self.max_size(log=2):.2f}",
                f"P={self.peak_size(log=2):.2f}",
            ]
            if self.sliced_inds:
                s.append(f"$={self.multiplicity:.2f}")
            return join.join(s)
        raise ValueError(info)

    def __repr__(self):
        if self.is_complete():
            return f"<{self.__class__.__name__}(N={self.N})>"
        return (
            f"<{self.__class__.__name__}(N={self.N}, "
            f"branches={len(self.children)}, complete=False)>"
        )

    def __str__(self):
        if not self.is_complete():
            return repr(self)
        return (
            f"<{self.__class__.__name__}(N={self.N}, "
            f"{self.describe('concise', join=', ')})>"
        )


def _reconfigure_job(tree, opts):
    """Top-level (picklable) forest-reconfigure worker."""
    return tree.subtree_reconfigure(**opts)


def _slice_reconf_step(tree, opts, seed):
    """Top-level (picklable) forest slice-and-reconfigure worker: one
    slicing step + repair on a copy.
    """
    t = tree.copy()
    opts = dict(opts)
    target_size = opts.pop("target_size")
    step_size = opts.pop("step_size")
    reconf_opts = opts.pop("reconf_opts")
    if t.max_size() > target_size:
        t.slice_(
            target_slices=step_size,
            temperature=opts.get("temperature", 0.01),
            max_repeats=opts.get("max_repeats", 8),
            minimize=opts.get("minimize"),
            seed=seed,
        )
        t.subtree_reconfigure_(
            **{k: v for k, v in reconf_opts.items() if v is not None}
        )
    return t


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


def is_ssa_path(path, n=None):
    """Heuristically detect whether ``path`` is in SSA form: ids are never
    reused in SSA form, and may exceed ``n - 1``.
    """
    flat = [s for step in path for s in step]
    if n is not None and any(s >= n for s in flat):
        return True
    return len(flat) == len(set(flat))


def _get_native_replay(accel):
    """The native library module for the compressed replay, or ``None``
    for pure Python: any true ``accel`` takes the library where it
    builds (as the reference's, ``True`` falls back rather than raise)."""
    if not accel:
        return None
    from .ops import native

    return native if native.is_available() else None


def _find_sub_path(sub_inputs, sub_output, size_dict, optimize):
    """The SSA path of a small sub-contraction by ``optimize``: a path
    optimizer (or path function), ``"auto"`` (optimal for up to 8 inputs,
    else greedy), ``"optimal"`` or ``"greedy"``."""
    if callable(optimize) and not isinstance(optimize, type):
        result = optimize(sub_inputs, sub_output, size_dict)
        return _as_ssa(result, len(sub_inputs))
    from .pathfinders.basic import optimize_greedy, optimize_optimal

    if optimize == "auto":
        optimize = "optimal" if len(sub_inputs) <= 8 else "greedy"
    if optimize == "optimal":
        return optimize_optimal(
            sub_inputs, sub_output, size_dict, use_ssa=True
        )
    if optimize == "greedy":
        return optimize_greedy(sub_inputs, sub_output, size_dict, use_ssa=True)
    raise ValueError(f"Unknown sub-optimize {optimize!r}.")


def _as_ssa(path, n):
    if is_ssa_path(path, n):
        return path
    return linear_to_ssa(path, n)
