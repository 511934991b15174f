"""Hypergraph model of a tensor network / einsum (counterpart of
``cotengra_tpu/hypergraph.py``).

Nodes are tensors (keyed by int), edges are indices (keyed by label) and
may connect any number of nodes (hyper edges). The compressed cost model
(``scoring.py``) and the compressed path finders replay contractions on
it with ``contract`` and chi-capped ``compress`` steps. Pure Python on
the host, with the graph Laplacian, resistance distances and
centrality in numpy (``get_laplacian``, ``resistance_*``), simple
cycles (``compute_loops``) and the integer weights of a graph
partitioner (``compute_weights``); ``networkx`` is imported only inside
``to_networkx``.
"""

import itertools
import math

import numpy as np

from .utils.misc import prod


class HyperGraph:
    """A mutable hypergraph over the inputs of a contraction.

    Parameters
    ----------
    inputs : sequence[sequence[str]] or dict[int, sequence[str]]
        Index labels of each tensor.
    output : sequence[str], optional
        Output indices (treated as pinned to a virtual external node).
    size_dict : dict[str, int], optional
        Sizes of each index.
    """

    __slots__ = (
        "nodes",
        "edges",
        "output",
        "size_dict",
        "node_counter",
    )

    def __init__(self, inputs, output=None, size_dict=None):
        if isinstance(inputs, dict):
            self.nodes = {k: list(v) for k, v in inputs.items()}
        else:
            self.nodes = {i: list(term) for i, term in enumerate(inputs)}
        self.output = list(output) if output is not None else []
        self.size_dict = dict(size_dict) if size_dict is not None else {}

        self.edges = {}
        for i, term in self.nodes.items():
            for ix in term:
                self.edges.setdefault(ix, []).append(i)

        self.node_counter = max(self.nodes, default=-1) + 1

    def copy(self):
        new = object.__new__(HyperGraph)
        new.nodes = {k: list(v) for k, v in self.nodes.items()}
        new.edges = {k: list(v) for k, v in self.edges.items()}
        new.output = list(self.output)
        new.size_dict = self.size_dict.copy()
        new.node_counter = self.node_counter
        return new

    # -- basic queries ---------------------------------------------------

    def get_num_nodes(self):
        return len(self.nodes)

    num_nodes = property(get_num_nodes)

    def get_num_edges(self):
        return len(self.edges)

    num_edges = property(get_num_edges)

    def __len__(self):
        return len(self.nodes)

    def get_node(self, i):
        return self.nodes[i]

    def get_edge(self, ix):
        return self.edges[ix]

    def has_node(self, i):
        return i in self.nodes

    def has_edge(self, ix):
        return ix in self.edges

    def edge_size(self, ix):
        return self.size_dict.get(ix, 2)

    def node_size(self, i):
        """Size of the tensor at node ``i``."""
        return prod(map(self.edge_size, self.nodes[i]))

    def bond_size(self, i, j):
        """Product of sizes of indices shared by nodes ``i`` and ``j``."""
        ti = set(self.nodes[i])
        return prod(
            self.edge_size(ix) for ix in self.nodes[j] if ix in ti
        )

    def edges_size(self, es):
        """Combined (product) size of the edges ``es``."""
        return prod(map(self.edge_size, es))

    def total_node_size(self):
        return sum(map(self.node_size, self.nodes))

    def neighborhood_size(self, nodes):
        """Total size of all tensors in the immediate neighborhood of
        ``nodes`` (inclusive)."""
        hood = {
            nn
            for n in nodes
            for ix in self.nodes[n]
            for nn in self.edges[ix]
        }
        return sum(map(self.node_size, hood))

    def contract_pair_cost(self, i, j):
        """Cost of contracting nodes ``i``, ``j`` = product of the sizes
        of all involved indices."""
        return self.edges_size(set(self.nodes[i] + self.nodes[j]))

    def neighborhood_compress_cost(self, chi, nodes):
        """Estimated cost (QR-reduction dominated) of compressing all
        over-sized multibonds incident to ``nodes`` down to ``chi``.
        """
        region_edges = {ix for n in nodes for ix in self.nodes[n]}
        oset = set(self.output)
        incidences = {}
        for ix in region_edges:
            if ix in oset:
                continue
            e_nodes = frozenset(self.edges[ix])
            incidences.setdefault(e_nodes, []).append(ix)
        # bonds fully inside the region are about to be contracted anyway
        incidences.pop(frozenset(nodes), None)

        C = 0
        for e_nodes, group in incidences.items():
            da = self.edges_size(group)
            if da > chi:
                for node in e_nodes:
                    outer = [
                        ix for ix in self.nodes[node] if ix not in group
                    ]
                    db = self.edges_size(outer)
                    lo, hi = sorted((da, db))
                    C += lo**2 * hi
        return C

    def neighbors(self, i):
        """Unique neighboring nodes of ``i``."""
        seen = {i}
        out = []
        for ix in self.nodes[i]:
            for j in self.edges[ix]:
                if j not in seen:
                    seen.add(j)
                    out.append(j)
        return out

    def neighbor_edges(self, i):
        """Unique edges incident to neighbors of ``i`` (not ``i`` itself)."""
        seen = set(self.nodes[i])
        out = []
        for j in self.neighbors(i):
            for ix in self.nodes[j]:
                if ix not in seen:
                    seen.add(ix)
                    out.append(ix)
        return out

    def output_nodes(self):
        """Nodes carrying at least one output index."""
        oset = set(self.output)
        return [
            i for i, term in self.nodes.items() if any(ix in oset for ix in term)
        ]

    # -- mutation --------------------------------------------------------

    def add_node(self, inds, node=None):
        if node is None:
            node = self.node_counter
        self.node_counter = max(self.node_counter, node + 1)
        self.nodes[node] = list(inds)
        for ix in inds:
            self.edges.setdefault(ix, []).append(node)
        return node

    def remove_node(self, i):
        inds = self.nodes.pop(i)
        for ix in set(inds):
            e = self.edges[ix]
            self.edges[ix] = [j for j in e if j != i]
            if not self.edges[ix]:
                del self.edges[ix]
        return inds

    def remove_edge(self, ix):
        for i in self.edges.pop(ix):
            self.nodes[i] = [jx for jx in self.nodes[i] if jx != ix]

    def contract(self, i, j, node=None):
        """Contract nodes ``i`` and ``j``: the new node keeps every index
        that still appears elsewhere (other nodes or the output).
        """
        ti = self.remove_node(i)
        tj = self.remove_node(j)
        oset = set(self.output)
        keep = []
        seen = set()
        for ix in itertools.chain(ti, tj):
            if ix in seen:
                continue
            seen.add(ix)
            if ix in self.edges or ix in oset:
                keep.append(ix)
        return self.add_node(keep, node=node)

    def compress(self, chi, edges=None):
        """'Compress' multiedges: groups of indices incident to the same
        set of nodes are combined into a single bond whose size is capped
        at ``chi``. Models bond-truncation in approximate (compressed)
        contraction.
        """
        if edges is None:
            edges = list(self.edges)
        oset = set(self.output)
        groups = {}
        for ix in dict.fromkeys(edges):
            if ix in oset or ix not in self.edges:
                continue
            key = frozenset(self.edges[ix])
            groups.setdefault(key, []).append(ix)

        for group in groups.values():
            if len(group) > 1:
                new_size = prod(map(self.edge_size, group))
                keep, *rest = group
                for ix in rest:
                    self.remove_edge(ix)
                self.size_dict[keep] = min(new_size, chi)

    def candidate_contraction_size(self, i, j, chi=None):
        """Size of the tensor formed by contracting ``i, j``, optionally
        after chi-compression of its doubled bonds toward each neighbor.
        """
        ti, tj = self.nodes[i], self.nodes[j]
        shared = set(ti) & set(tj)
        oset = set(self.output)
        keep = []
        for ix in dict.fromkeys(itertools.chain(ti, tj)):
            if ix in shared and all(k in (i, j) for k in self.edges[ix]) and (
                ix not in oset
            ):
                continue
            keep.append(ix)
        if chi is None:
            return prod(map(self.edge_size, keep))
        # group kept indices by which neighbor they connect to, cap each
        groups = {}
        for ix in keep:
            others = tuple(
                sorted(k for k in self.edges.get(ix, ()) if k not in (i, j))
            )
            groups.setdefault(others or ("__out__",), []).append(ix)
        size = 1
        for others, group in groups.items():
            d = prod(map(self.edge_size, group))
            if others != ("__out__",):
                d = min(d, chi)
            size *= d
        return size

    # -- centrality / distance ------------------------------------------

    def simple_distance(self, region, p=2):
        """Approximate distance of every node from ``region`` via BFS
        (hyperedges treated as cliques).
        """
        dist = {i: 0 for i in region}
        queue = list(region)
        while queue:
            nxt = []
            for i in queue:
                for j in self.neighbors(i):
                    if j not in dist:
                        dist[j] = dist[i] + 1
                        nxt.append(j)
            queue = nxt
        maxd = max(dist.values(), default=0) + 1
        return {i: dist.get(i, maxd) for i in self.nodes}

    def simple_closeness(self, p=0.75, mu=0.5):
        """Smoothed closeness centrality in [0, 1] per node, computed by
        repeated neighbor-mean relaxation (cheap, hyperedge-aware).
        """
        # initialize with normalized degree
        deg = {i: len(self.neighbors(i)) for i in self.nodes}
        maxdeg = max(deg.values(), default=1) or 1
        c = {i: (deg[i] / maxdeg) ** p for i in self.nodes}
        for _ in range(max(2, int(len(self.nodes) ** 0.5))):
            new = {}
            for i in self.nodes:
                nbrs = self.neighbors(i)
                if nbrs:
                    m = sum(c[j] for j in nbrs) / len(nbrs)
                else:
                    m = c[i]
                new[i] = (1 - mu) * c[i] + mu * m
            c = new
        lo = min(c.values(), default=0.0)
        hi = max(c.values(), default=1.0)
        rng = (hi - lo) or 1.0
        return {i: (v - lo) / rng for i, v in c.items()}

    def simple_centrality(self, r=None, smoothness=2, **kwargs):
        """Centrality = smoothed closeness, the default measure used by the
        compressed-greedy pathfinders.
        """
        return self.simple_closeness(**kwargs)

    def get_laplacian(self):
        """Dense graph Laplacian of the clique expansion: each hyperedge
        adds weight ``1/(|e|-1)`` between every pair of its nodes (so a
        2-node edge adds exactly 1)."""
        nodes = list(self.nodes)
        pos = {i: p for p, i in enumerate(nodes)}
        n = len(nodes)
        lp = np.zeros((n, n))
        for members in self.edges.values():
            ms = [m for m in dict.fromkeys(members) if m in pos]
            k = len(ms)
            if k < 2:
                continue
            w = 1.0 / (k - 1)
            for a in range(k):
                ia = pos[ms[a]]
                for b in range(a + 1, k):
                    ib = pos[ms[b]]
                    lp[ia, ib] -= w
                    lp[ib, ia] -= w
                    lp[ia, ia] += w
                    lp[ib, ib] += w
        return lp

    def resistance_distances(self):
        """All-pairs effective resistance distances, from the inverse of
        the shifted Laplacian."""
        lp = self.get_laplacian()
        n = lp.shape[0]
        if n == 0:
            return lp
        lp = lp + 1.0 / n
        try:
            inv = np.linalg.inv(lp)
        except np.linalg.LinAlgError:
            inv = np.linalg.pinv(lp)
        d = np.diag(inv).copy()
        return d[:, None] + d[None, :] - 2 * inv

    def resistance_centrality(self, rescale=True):
        """Centrality as the negated total resistance distance to all
        other nodes, optionally rescaled into [0, 1]."""
        rd = self.resistance_distances()
        raw = -rd.sum(axis=1)
        cents = {i: float(v) for i, v in zip(self.nodes, raw)}
        if rescale and cents:
            lo = min(cents.values())
            hi = max(cents.values())
            rng = (hi - lo) or 1.0
            cents = {i: (v - lo) / rng for i, v in cents.items()}
        return cents

    def compute_loops(self, start=None, max_loop_length=None):
        """The simple cycles of at most ``max_loop_length`` (default 6)
        nodes, as sorted node tuples (small graphs)."""
        if max_loop_length is None:
            max_loop_length = 6
        loops = set()
        nodes = [start] if start is not None else list(self.nodes)
        for s in nodes:
            stack = [(s, (s,))]
            while stack:
                cur, path = stack.pop()
                for j in self.neighbors(cur):
                    if j == s and len(path) >= 3:
                        loops.add(tuple(sorted(path)))
                    elif j not in path and len(path) < max_loop_length:
                        if j > s:  # start at the least node: no duplicates
                            stack.append((j, path + (j,)))
        return sorted(loops)

    # -- partitioner support ---------------------------------------------

    def compute_weights(self, weight_nodes="const", weight_edges="log"):
        """Integer node and edge weights for graph partitioners:
        ``"const"`` (1 each) or ``"log"`` (1 + log2 of the size)."""
        if weight_nodes == "const":
            node_weights = [1 for _ in self.nodes]
        elif weight_nodes == "log":
            node_weights = [
                max(1, int(math.log2(max(self.node_size(i), 1)) + 1))
                for i in self.nodes
            ]
        else:
            raise ValueError(weight_nodes)

        if weight_edges == "const":
            edge_weights = {ix: 1 for ix in self.edges}
        elif weight_edges == "log":
            edge_weights = {
                ix: max(1, int(math.log2(max(self.edge_size(ix), 1)) + 1))
                for ix in self.edges
            }
        else:
            raise ValueError(weight_edges)

        return node_weights, edge_weights

    # -- export -----------------------------------------------------------

    def to_networkx(self, as_tree_leaves=False):
        """Export to a networkx graph; hyperedges become star-nodes."""
        import networkx as nx

        G = nx.Graph()
        for i in self.nodes:
            G.add_node(i, hyperedge=False)
        for ix, nodes in self.edges.items():
            if len(nodes) == 2:
                G.add_edge(*nodes, ind=ix, weight=self.edge_size(ix))
            else:
                hname = ("hyper", ix)
                G.add_node(hname, hyperedge=True)
                for i in nodes:
                    G.add_edge(hname, i, ind=ix, weight=self.edge_size(ix))
        return G

    def __repr__(self):
        return (
            f"<HyperGraph(|V|={self.get_num_nodes()}, "
            f"|E|={self.get_num_edges()})>"
        )


def get_hypergraph(inputs, output=None, size_dict=None, accel=False):
    """Single entry point for building hypergraphs. Every ``accel``
    (``False``, ``None``, ``"auto"``, ``True``) gives the Python one, as
    the reference's does: the native library replays whole contraction
    orders (``ContractionTree.compressed_contract_stats``) and has no
    hypergraph object of its own."""
    if accel not in (False, None, "auto", True):
        raise ValueError(f"Unknown accel={accel!r}")
    return HyperGraph(inputs, output, size_dict)
