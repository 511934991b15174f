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

``contraction_cores`` caches the contractors built for the tree
(``ops/executor.py::_cached_full``), keyed by every option that shapes
them; changing the tree's structure or slicing empties it.
"""

import functools
import itertools
import math
from dataclasses import dataclass
from typing import Optional

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
    """

    def __init__(self, inputs, output, size_dict, children=None):
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

    def is_complete(self):
        """Whether the tree joins every input: N - 1 contractions up to
        the root (a single input is complete alone)."""
        if self.N == 1:
            return True
        return len(self.children) == self.N - 1 and self.root in self.children

    def copy(self):
        new = ContractionTree(
            self.inputs, self.output, self.size_dict, self.children
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
                  ssa_path=None, optimize="greedy"):
        """Build a tree from a contraction path: exactly one of ``path``
        (linear, opt_einsum style) or ``ssa_path``. Multi-way steps are
        binarized left to right. A path that leaves several top nodes
        (disconnected pieces, or a partial path) is completed as the
        reference's ``autocomplete`` does: two are contracted, more are
        joined in the order ``optimize`` finds (see ``contract_nodes``).
        """
        if (path is None) == (ssa_path is None):
            raise ValueError("Specify exactly one of path, ssa_path.")
        tree = cls(inputs, output, size_dict)
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

    def get_ssa_path(self):
        """The tree as an SSA path, in the default traversal order."""
        ssa = {1 << i: i for i in range(self.N)}
        path = []
        for c, (p, l, r) in enumerate(self.traverse(), self.N):
            path.append((ssa[l], ssa[r]))
            ssa[p] = c
        return tuple(path)

    def get_path(self):
        """The tree as a linear (opt_einsum style) path."""
        return ssa_to_linear(self.get_ssa_path(), self.N)

    # -- traversal -------------------------------------------------------

    def traverse(self, order=None):
        """Generate ``(parent, left, right)`` bottom up, by subtree size:
        children before parents, plan order among equal sizes (the
        reference's default order, which the lowering relies on)."""
        if order is not None:
            raise ValueError(
                f"traverse order {order!r}: the port has the default only"
            )
        for parent in sorted(self.children, key=int.bit_count):
            l, r = self.children[parent]
            yield parent, l, r

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
