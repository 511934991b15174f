"""Line-graph construction and PACE / CNF export for tree-decomposition
based path finding (counterpart of ``cotengra_tpu/pathfinders/linegraph.py``).

The *line graph* of a tensor network has one vertex per index; two indices
are adjacent iff they appear on a common tensor (or together in the
output). A tree decomposition / elimination order of the line graph is
exactly a contraction order of the indices (an 'edge path').
"""


class LineGraph:
    """Vertex-per-index graph of a contraction."""

    def __init__(self, inputs, output=()):
        self.inds = []
        seen = {}
        for term in inputs:
            for ix in term:
                if ix not in seen:
                    seen[ix] = len(self.inds)
                    self.inds.append(ix)
        for ix in output:
            if ix not in seen:
                seen[ix] = len(self.inds)
                self.inds.append(ix)
        self.ind_id = seen

        edges = set()

        def clique(term):
            ids = [seen[ix] for ix in term]
            for a in range(len(ids)):
                for b in range(a + 1, len(ids)):
                    i, j = ids[a], ids[b]
                    if i != j:
                        edges.add((min(i, j), max(i, j)))

        for term in inputs:
            clique(term)
        # output indices must be eliminated last - model by mutual clique
        clique(tuple(output))

        self.edges = sorted(edges)
        self.num_vertices = len(self.inds)

    def to_gr_str(self):
        """PACE-2017 .gr format (1-indexed)."""
        lines = [f"p tw {self.num_vertices} {len(self.edges)}"]
        for i, j in self.edges:
            lines.append(f"{i + 1} {j + 1}")
        return "\n".join(lines) + "\n"

    def to_cnf_str(self):
        """Weighted-ish CNF format consumed by quickbb."""
        lines = [f"p cnf {self.num_vertices} {len(self.edges)}"]
        for i, j in self.edges:
            lines.append(f"{i + 1} {j + 1} 0")
        return "\n".join(lines) + "\n"

    def vertex_to_ind(self, v):
        """Map a 0-indexed vertex id back to its index label."""
        return self.inds[v]


def td_str_to_elimination_order(td_text):
    """Parse a PACE .td (tree decomposition) output into a vertex
    elimination order (0-indexed).

    Strategy (standard): repeatedly strip leaf bags, eliminating the
    vertices unique to each leaf bag relative to its neighbor.
    """
    bags = {}
    adj = {}
    for line in td_text.splitlines():
        line = line.strip()
        if not line or line.startswith("c"):
            continue
        parts = line.split()
        if parts[0] == "s":
            continue
        if parts[0] == "b":
            bid = int(parts[1])
            bags[bid] = set(int(v) - 1 for v in parts[2:])
            adj.setdefault(bid, set())
        else:
            a, b = int(parts[0]), int(parts[1])
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set()).add(a)

    order = []
    eliminated = set()
    remaining = dict(bags)
    radj = {k: set(v) for k, v in adj.items()}

    while remaining:
        if len(remaining) == 1:
            (bid, bag), = remaining.items()
            for v in sorted(bag):
                if v not in eliminated:
                    order.append(v)
                    eliminated.add(v)
            break
        # take any leaf bag
        leaf = next(
            b for b in remaining if len(radj.get(b, ())) <= 1
        )
        nbrs = radj.get(leaf, set())
        nb_bag = remaining[next(iter(nbrs))] if nbrs else set()
        for v in sorted(remaining[leaf] - nb_bag):
            if v not in eliminated:
                order.append(v)
                eliminated.add(v)
        for nb in nbrs:
            radj[nb].discard(leaf)
        radj.pop(leaf, None)
        del remaining[leaf]

    return order


def elimination_order_to_edge_path(order, lg, output=()):
    """Convert a vertex elimination order on the line graph into an index
    ('edge') contraction path, skipping output indices.
    """
    out_set = set(output)
    return [
        lg.vertex_to_ind(v)
        for v in order
        if lg.vertex_to_ind(v) not in out_set
    ]
