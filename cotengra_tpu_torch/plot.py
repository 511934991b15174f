"""Visualization: contraction trees, per-step cost curves, slicing
trade-offs, hyper-optimizer trials, hypergraphs.

The port's copy of ``cotengra_tpu/plot.py``, with the same names,
arithmetic, draw order and artist styles, so that the same tree draws
the same figure in both packages: ``plot_tree`` (ring / tent / span
layouts), ``plot_tree_flat``, ``plot_tree_rubberband``,
``plot_tree_circuit`` (on :class:`~cotengra_tpu_torch.schematic.Drawing`),
``plot_contractions``, ``plot_slicings``, ``plot_trials``,
``plot_scatter``, ``plot_parameters_parallel``, ``plot_hypergraph``, the
altair ``*_alt`` variants, and the data exports ``tree_to_networkx``,
``tree_to_df`` and ``trials_to_df``. It runs on the host only: matplotlib,
networkx, pandas and altair are imported inside the functions that need
them, so the package imports without them and a plot raises the missing
package's ``ImportError``.
"""

import collections
import math

from .schematic import _convex_hull  # Andrew's monotone chain, no scipy


def _get_plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


# -- data exports -------------------------------------------------------------


def tree_to_networkx(tree):
    """Export the binary contraction tree as a networkx DiGraph with
    per-node ``size``/``flops``/``extent`` attributes.
    """
    import networkx as nx

    G = nx.DiGraph()
    for leaf in tree.gen_leaves():
        G.add_node(
            leaf,
            size=tree.get_size(leaf),
            flops=0,
            extent=1,
            leaf=True,
        )
    for p, l, r in tree.traverse():
        G.add_node(
            p,
            size=tree.get_size(p),
            flops=tree.get_flops(p),
            extent=p.bit_count(),
            leaf=False,
        )
        G.add_edge(l, p)
        G.add_edge(r, p)
    return G


def tree_to_df(tree):
    """Export per-contraction stats as a pandas DataFrame."""
    import pandas as pd

    rows = []
    peak = 0
    cum_flops = 0
    current = sum(tree.get_size(leaf) for leaf in tree.gen_leaves())
    for i, (p, l, r) in enumerate(tree.traverse()):
        f = tree.get_flops(p)
        s = tree.get_size(p)
        cum_flops += f
        current += s
        peak = max(peak, current)
        rows.append(
            {
                "step": i,
                "flops": f,
                "cum_flops": cum_flops,
                "size": s,
                "peak_size": peak,
                "extent": p.bit_count(),
                "log10_flops": math.log10(max(f, 1)),
                "log2_size": math.log2(max(s, 1)),
            }
        )
        current -= tree.get_size(l) + tree.get_size(r)
    return pd.DataFrame(rows)


# -- tree layouts -------------------------------------------------------------


def _leaf_angles(tree):
    """Order leaves by the tree structure (dfs) for tidy layouts."""
    order = []
    stack = [tree.root]
    while stack:
        node = stack.pop()
        if node.bit_count() == 1:
            order.append(node)
        elif node in tree.children:
            l, r = tree.children[node]
            stack.extend((l, r))
        else:
            order.extend(
                1 << i for i in range(tree.N) if (node >> i) & 1
            )
    return order


def _tree_positions(tree, layout="ring"):
    leaves = _leaf_angles(tree)
    n = len(leaves)
    pos = {}
    if layout == "ring":
        for k, leaf in enumerate(leaves):
            theta = 2 * math.pi * k / n
            pos[leaf] = (math.cos(theta), math.sin(theta))
    else:  # tent / span: leaves on a line
        for k, leaf in enumerate(leaves):
            pos[leaf] = (k / max(n - 1, 1), 0.0)

    # internal nodes at (shrunk) centroids of their leaves
    for p, l, r in tree.traverse():
        xs, ys = zip(*(pos[1 << i] for i in range(tree.N) if (p >> i) & 1))
        cx, cy = sum(xs) / len(xs), sum(ys) / len(ys)
        if layout == "ring":
            shrink = 1 - p.bit_count() / (tree.N + 1)
            pos[p] = (cx * shrink, cy * shrink)
        else:
            height = p.bit_count() / tree.N
            pos[p] = (cx, height)
    return pos


def plot_tree(
    tree,
    layout="ring",
    ax=None,
    figsize=(5, 5),
    edge_scale=1.0,
    node_scale=1.0,
    **kwargs,
):
    """Draw the contraction tree: edge widths ~ log2 tensor size, node
    sizes ~ log10 contraction cost.
    """
    plt = _get_plt()
    if ax is None:
        fig, ax = plt.subplots(figsize=figsize)
    else:
        fig = ax.get_figure()

    pos = _tree_positions(tree, layout=layout)
    for p, l, r in tree.traverse():
        for c in (l, r):
            x0, y0 = pos[p]
            x1, y1 = pos[c]
            w = edge_scale * (
                0.3 + 0.25 * math.log2(max(tree.get_size(c), 1))
            )
            ax.plot(
                [x0, x1], [y0, y1], "-", color="#888888",
                linewidth=w, zorder=1, solid_capstyle="round",
            )
    xs, ys, ss, cs = [], [], [], []
    for p in tree.children:
        x, y = pos[p]
        xs.append(x)
        ys.append(y)
        ss.append(
            node_scale
            * (5 + 8 * math.log10(max(tree.get_flops(p), 1)))
        )
        cs.append(math.log10(max(tree.get_flops(p), 1)))
    sc = ax.scatter(
        xs, ys, s=ss, c=cs, cmap="viridis", zorder=2, **kwargs
    )
    lx, ly = zip(*(pos[leaf] for leaf in tree.gen_leaves()))
    ax.scatter(lx, ly, s=8 * node_scale, color="#222222", zorder=3)
    ax.set_aspect("equal")
    ax.axis("off")
    return fig, ax


def plot_tree_ring(tree, **kwargs):
    return plot_tree(tree, layout="ring", **kwargs)


def plot_tree_tent(tree, **kwargs):
    return plot_tree(tree, layout="tent", **kwargs)


def plot_tree_span(tree, **kwargs):
    return plot_tree(tree, layout="span", **kwargs)


def plot_tree_flat(
    tree, ax=None, figsize=(6, 4), edge_scale=1.0, node_scale=1.0,
    **kwargs,
):
    """Flat dendrogram layout: leaves on a line, each contraction drawn
    at a height given by its position in the contraction ORDER (unlike
    the tent layout, whose heights are subtree extents).
    """
    plt = _get_plt()
    if ax is None:
        fig, ax = plt.subplots(figsize=figsize)
    else:
        fig = ax.get_figure()

    leaves = _leaf_angles(tree)
    n = len(leaves)
    pos = {
        leaf: (k / max(n - 1, 1), 0.0) for k, leaf in enumerate(leaves)
    }
    steps = list(tree.traverse())
    nsteps = max(len(steps), 1)
    for si, (p, l, r) in enumerate(steps):
        y = (si + 1) / nsteps
        x0, _ = pos[l]
        x1, _ = pos[r]
        x = 0.5 * (x0 + x1)
        pos[p] = (x, y)
        w = edge_scale * (
            0.3 + 0.25 * math.log2(max(tree.get_size(p), 1))
        )
        # dendrogram bracket: up from each child, across at y
        for c in (l, r):
            cx, cy = pos[c]
            ax.plot(
                [cx, cx], [cy, y], "-", color="#888888",
                linewidth=w, zorder=1, solid_capstyle="round",
            )
        ax.plot(
            [min(x0, x1), max(x0, x1)], [y, y], "-", color="#888888",
            linewidth=w, zorder=1, solid_capstyle="round",
        )
    xs, ys, ss, cs = [], [], [], []
    for p, l, r in steps:
        x, y = pos[p]
        xs.append(x)
        ys.append(y)
        ss.append(
            node_scale
            * (5 + 8 * math.log10(max(tree.get_flops(p), 1)))
        )
        cs.append(math.log10(max(tree.get_flops(p), 1)))
    ax.scatter(xs, ys, s=ss, c=cs, cmap="viridis", zorder=2, **kwargs)
    lx, ly = zip(*(pos[leaf] for leaf in leaves))
    ax.scatter(lx, ly, s=8 * node_scale, color="#222222", zorder=3)
    ax.axis("off")
    return fig, ax


def plot_tree_rubberband(
    tree, ax=None, figsize=(5, 5), order=None, max_bands=None,
    colormap="viridis", alpha=0.2, **kwargs,
):
    """Rubber-band view: the input hypergraph laid out with a spring
    embedding, with a translucent convex 'band' drawn around the leaves
    of every intermediate of the contraction tree - bands nest with
    contraction depth, visualizing how the tree groups the network.
    """
    import numpy as np

    plt = _get_plt()
    if ax is None:
        fig, ax = plt.subplots(figsize=figsize)
    else:
        fig = ax.get_figure()

    # spring layout of the input graph
    import networkx as nx

    G = nx.Graph()
    G.add_nodes_from(range(tree.N))
    ix_holders = {}
    for i, term in enumerate(tree.inputs):
        for ix in term:
            ix_holders.setdefault(ix, []).append(i)
    for ix, hs in ix_holders.items():
        hs = sorted(set(hs))
        for a in range(len(hs)):
            for b in range(a + 1, len(hs)):
                G.add_edge(hs[a], hs[b])
    xy = nx.spring_layout(G, seed=42)

    steps = list(tree.traverse(order=order))
    if max_bands is not None:
        steps = steps[-max_bands:]
    cmap = plt.get_cmap(colormap)
    nsteps = max(len(steps), 1)
    for si, (p, l, r) in enumerate(steps):
        members = [i for i in range(tree.N) if (p >> i) & 1]
        if len(members) < 2 or len(members) == tree.N:
            continue
        pts = [tuple(xy[i]) for i in members]
        hull = _convex_hull(pts)
        if len(hull) < 3:
            # pad a segment into a thin band
            (x0, y0), (x1, y1) = hull[0], hull[-1]
            dx, dy = y1 - y0, x0 - x1
            nrm = math.hypot(dx, dy) or 1.0
            e = 0.02
            hull = [
                (x0 + e * dx / nrm, y0 + e * dy / nrm),
                (x1 + e * dx / nrm, y1 + e * dy / nrm),
                (x1 - e * dx / nrm, y1 - e * dy / nrm),
                (x0 - e * dx / nrm, y0 - e * dy / nrm),
            ]
        # expand the hull slightly around its centroid
        cx = sum(x for x, _ in hull) / len(hull)
        cy = sum(y for _, y in hull) / len(hull)
        grow = 1.08
        hull = [
            (cx + grow * (x - cx), cy + grow * (y - cy))
            for x, y in hull
        ]
        poly = plt.Polygon(
            hull, closed=True, facecolor=cmap(si / nsteps),
            edgecolor=cmap(si / nsteps), alpha=alpha, zorder=1,
        )
        ax.add_patch(poly)
    # draw the graph itself
    for a, b in G.edges:
        ax.plot(
            [xy[a][0], xy[b][0]], [xy[a][1], xy[b][1]], "-",
            color="#555555", linewidth=0.8, zorder=2,
        )
    px, py = zip(*(xy[i] for i in range(tree.N)))
    ax.scatter(px, py, s=22, color="#222222", zorder=3, **kwargs)
    ax.set_aspect("equal")
    ax.axis("off")
    return fig, ax


def plot_parameters_parallel(opt, params=None, ax=None, figsize=(7, 3)):
    """Parallel-coordinates view of hyper-optimizer trial parameters,
    shaded by score."""
    plt = _get_plt()
    trials = [
        t
        for t in opt.trials
        if t.get("score", float("inf")) != float("inf")
        and t.get("params")
    ]
    if not trials:
        raise ValueError("no successful trials to plot")
    if params is None:
        params = sorted(
            {
                k
                for t in trials
                for k, v in t["params"].items()
                if isinstance(v, (int, float, bool))
            }
        )
    if ax is None:
        fig, ax = plt.subplots(figsize=figsize)
    else:
        fig = ax.get_figure()

    # normalize each axis to [0, 1]
    cols = {}
    for k in params:
        vals = [float(t["params"].get(k, 0.0)) for t in trials]
        lo, hi = min(vals), max(vals)
        rngv = (hi - lo) or 1.0
        cols[k] = [(v - lo) / rngv for v in vals]
    scores = [t["score"] for t in trials]
    smin, smax = min(scores), max(scores)
    srng = (smax - smin) or 1.0
    cmap = plt.get_cmap("viridis_r")
    for i, t in enumerate(trials):
        ys = [cols[k][i] for k in params]
        ax.plot(
            range(len(params)),
            ys,
            color=cmap(1 - (scores[i] - smin) / srng),
            alpha=0.6,
            linewidth=1,
        )
    ax.set_xticks(range(len(params)))
    ax.set_xticklabels(params, rotation=30, fontsize=7)
    ax.set_yticks([])
    return fig, ax


def plot_contractions(tree, ax=None, figsize=(6, 3), order=None):
    """Per-step curves: log10 flops, log2 written size, log2 peak."""
    plt = _get_plt()
    df = tree_to_df(tree)
    if ax is None:
        fig, ax = plt.subplots(figsize=figsize)
    else:
        fig = ax.get_figure()
    ax.plot(df["step"], df["log10_flops"], label="log10[FLOPS]")
    ax.plot(df["step"], df["log2_size"], label="log2[SIZE]")
    ax.plot(
        df["step"],
        [math.log2(max(p, 1)) for p in df["peak_size"]],
        label="log2[PEAK]",
        linestyle="--",
    )
    ax.set_xlabel("contraction")
    ax.legend(fontsize=7)
    return fig, ax


def plot_slicings(
    slice_finder, ax=None, figsize=(6, 3), color_scheme="viridis"
):
    """Scatter of the slicing trade-off frontier explored by a
    SliceFinder: number of slices vs total cost."""
    plt = _get_plt()
    if ax is None:
        fig, ax = plt.subplots(figsize=figsize)
    else:
        fig = ax.get_figure()
    # run a sweep of trials at increasing temperature
    xs, ys = [], []
    for _ in range(16):
        costs, _inds = slice_finder.trial()
        xs.append(max(costs.nslices, 1))
        ys.append(costs.nslices * costs.total_flops)
    ax.scatter(
        [math.log2(x) for x in xs],
        [math.log10(max(y, 1)) for y in ys],
        c=range(len(xs)),
        cmap=color_scheme,
    )
    ax.set_xlabel("log2[NSLICES]")
    ax.set_ylabel("log10[FLOPS]")
    return fig, ax


def plot_trials(opt, y="score", ax=None, figsize=(6, 3)):
    """Hyper-optimizer trial history, colored by method, with running
    best overlaid."""
    plt = _get_plt()
    if ax is None:
        fig, ax = plt.subplots(figsize=figsize)
    else:
        fig = ax.get_figure()
    methods = sorted({t["method"] for t in opt.trials})
    cmap = plt.get_cmap("tab10")
    series = collections.defaultdict(lambda: ([], []))
    best = []
    cur = float("inf")
    for i, t in enumerate(opt.trials):
        v = t.get(y, float("inf"))
        if v != float("inf"):
            xs, ys = series[t["method"]]
            xs.append(i)
            ys.append(v)
            cur = min(cur, v)
        best.append(cur)
    for k, m in enumerate(methods):
        xs, ys = series[m]
        ax.scatter(xs, ys, s=12, color=cmap(k % 10), label=m)
    ax.plot(range(len(best)), best, color="#333333", linewidth=1)
    ax.set_xlabel("trial")
    ax.set_ylabel(y)
    ax.legend(fontsize=7)
    return fig, ax


def plot_scatter(opt, x="size", y="flops", ax=None, figsize=(5, 4)):
    """Scatter of all trials in (log2 size, log10 flops) space."""
    plt = _get_plt()
    if ax is None:
        fig, ax = plt.subplots(figsize=figsize)
    else:
        fig = ax.get_figure()
    methods = sorted({t["method"] for t in opt.trials})
    cmap = plt.get_cmap("tab10")
    for k, m in enumerate(methods):
        xs = [
            math.log2(max(t[x], 1))
            for t in opt.trials
            if t["method"] == m and t.get(x, float("inf")) != float("inf")
        ]
        ys = [
            math.log10(max(t[y], 1))
            for t in opt.trials
            if t["method"] == m and t.get(y, float("inf")) != float("inf")
        ]
        ax.scatter(xs, ys, s=12, color=cmap(k % 10), label=m)
    ax.set_xlabel(f"log2[{x.upper()}]")
    ax.set_ylabel(f"log10[{y.upper()}]")
    ax.legend(fontsize=7)
    return fig, ax


def plot_hypergraph(hg, ax=None, figsize=(5, 5), **layout_opts):
    """Draw a hypergraph: tensors as dots, hyperedges as star nodes."""
    import networkx as nx

    plt = _get_plt()
    if ax is None:
        fig, ax = plt.subplots(figsize=figsize)
    else:
        fig = ax.get_figure()
    G = hg.to_networkx()
    pos = nx.spring_layout(G, seed=42, **layout_opts)
    hyper = [n for n, d in G.nodes(data=True) if d.get("hyperedge")]
    plain = [n for n, d in G.nodes(data=True) if not d.get("hyperedge")]
    nx.draw_networkx_edges(G, pos, ax=ax, alpha=0.5)
    nx.draw_networkx_nodes(
        G, pos, nodelist=plain, node_size=30, node_color="#4477aa",
        ax=ax,
    )
    if hyper:
        nx.draw_networkx_nodes(
            G, pos, nodelist=hyper, node_size=10,
            node_color="#cc6677", node_shape="s", ax=ax,
        )
    ax.axis("off")
    return fig, ax


def plot_tree_circuit(
    tree,
    edge_colormap="GnBu",
    edge_max_width=None,
    node_colormap="YlOrRd",
    node_max_size=None,
    figsize=None,
):
    """Draw the contraction tree as a circuit-like staircase diagram on
    a :class:`~cotengra_tpu_torch.schematic.Drawing` canvas: leaves
    along the diagonal, every contraction a node whose size/color
    encodes log2 flops, edges weighted/colored by log2 intermediate
    size.
    """
    import matplotlib as mpl

    from .schematic import Drawing

    if figsize is None:
        figsize = (tree.N**0.75, tree.N**0.75)
    d = Drawing(figsize=figsize)

    if edge_max_width is None:
        edge_max_width = max(math.log2(max(tree.max_size(), 2)), 1)
    enorm = mpl.colors.Normalize(0, edge_max_width, clip=True)
    if not isinstance(edge_colormap, mpl.colors.Colormap):
        edge_colormap = mpl.colormaps[edge_colormap]
    emap = mpl.cm.ScalarMappable(norm=enorm, cmap=edge_colormap)

    if node_max_size is None:
        node_max_size = max(
            math.log2(max(tree.get_flops(p), 2))
            for p in tree.children
        )
    nnorm = mpl.colors.Normalize(0, node_max_size, clip=True)
    if not isinstance(node_colormap, mpl.colors.Colormap):
        node_colormap = mpl.colormaps[node_colormap]
    nmap = mpl.cm.ScalarMappable(norm=nnorm, cmap=node_colormap)

    pos = {tree.root: (0, 0)}
    queue = [tree.root]
    while queue:
        p = queue.pop(0)
        px, py = pos[p]
        l, r = tree.children[p]
        # right branch steps down-left one, left branch clears the
        # whole right subtree horizontally
        pos[r] = (px - 1, py - 1)
        pos[l] = (px - tree.node_extent(r), py)

        for child, rot, va in ((l, -90, "center"), (r, -45, "top")):
            if not tree.is_leaf(child):
                queue.append(child)
            else:
                i = child.bit_length() - 1
                d.text(
                    pos[child],
                    f"{i}",
                    color=(0.5, 0.5, 0.5, 0.5),
                    fontsize=20 * tree.N**-0.25,
                    rotation=rot,
                    ha="right",
                    va=va,
                    family="monospace",
                )

        lw = math.log2(max(tree.get_size(l), 2))
        rw = math.log2(max(tree.get_size(r), 2))
        pc = math.log2(max(tree.get_flops(p), 2))
        d.line(
            pos[l], pos[p],
            color=emap.to_rgba(lw),
            linewidth=5 * lw / edge_max_width,
        )
        d.line(
            pos[r], pos[p],
            color=emap.to_rgba(rw),
            linewidth=5 * rw / edge_max_width,
        )
        d.circle(
            pos[p],
            color=nmap.to_rgba(pc),
            radius=0.3 * pc / node_max_size,
            linewidth=0,
        )
    return d.fig, d.ax


# -- altair (interactive) variants --------------------------------------------


def _get_alt():
    try:
        import altair as alt
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "The interactive *_alt plots require altair."
        ) from e
    return alt


def trials_to_df(opt):
    """Export hyper-optimizer trial telemetry as a pandas DataFrame."""
    import pandas as pd

    rows = []
    best = float("inf")
    for i, t in enumerate(opt.trials):
        flops = t.get("flops", float("inf"))
        score = t.get("score", float("inf"))
        if math.isfinite(score):
            best = min(best, score)
        rows.append(
            {
                "trial": i,
                "method": t.get("method", "?"),
                "score": score if math.isfinite(score) else None,
                "best_score": best if math.isfinite(best) else None,
                "log10_flops": (
                    math.log10(max(flops, 1))
                    if math.isfinite(flops)
                    else None
                ),
                "log2_size": (
                    math.log2(max(t.get("size", 1), 1))
                    if math.isfinite(t.get("size", float("inf")))
                    else None
                ),
                "time": t.get("time", None),
            }
        )
    return pd.DataFrame(rows)


def plot_trials_alt(opt, y="score", width=600, height=300):
    """Interactive altair version of :func:`plot_trials`."""
    alt = _get_alt()
    df = trials_to_df(opt)
    points = (
        alt.Chart(df)
        .mark_point(filled=True, size=30)
        .encode(
            x="trial:Q",
            y=alt.Y(f"{y}:Q", scale=alt.Scale(zero=False)),
            color="method:N",
            tooltip=list(df.columns),
        )
    )
    line = (
        alt.Chart(df)
        .mark_line(color="#333333", strokeWidth=1)
        .encode(x="trial:Q", y="best_score:Q")
    )
    return (points + line).properties(width=width, height=height)


def plot_scatter_alt(
    opt, x="log2_size", y="log10_flops", width=400, height=400
):
    """Interactive altair version of :func:`plot_scatter`."""
    alt = _get_alt()
    df = trials_to_df(opt)
    return (
        alt.Chart(df)
        .mark_point(filled=True, size=30)
        .encode(
            x=alt.X(f"{x}:Q", scale=alt.Scale(zero=False)),
            y=alt.Y(f"{y}:Q", scale=alt.Scale(zero=False)),
            color="method:N",
            tooltip=list(df.columns),
        )
        .properties(width=width, height=height)
        .interactive()
    )


def plot_contractions_alt(tree, width=600, height=300):
    """Interactive altair version of :func:`plot_contractions`."""
    alt = _get_alt()
    df = tree_to_df(tree)
    df = df.melt(
        id_vars=["step"],
        value_vars=["log10_flops", "log2_size"],
        var_name="quantity",
        value_name="value",
    )
    return (
        alt.Chart(df)
        .mark_line()
        .encode(
            x="step:Q",
            y="value:Q",
            color="quantity:N",
            tooltip=["step", "quantity", "value"],
        )
        .properties(width=width, height=height)
        .interactive()
    )


def plot_slicings_alt(slice_finder, width=500, height=300, trials=16):
    """Interactive altair version of :func:`plot_slicings`."""
    import pandas as pd

    alt = _get_alt()
    rows = []
    for k in range(trials):
        costs, _inds = slice_finder.trial()
        rows.append(
            {
                "trial": k,
                "log2_nslices": math.log2(max(costs.nslices, 1)),
                "log10_flops": math.log10(
                    max(costs.nslices * costs.total_flops, 1)
                ),
            }
        )
    df = pd.DataFrame(rows)
    return (
        alt.Chart(df)
        .mark_point(filled=True)
        .encode(
            x="log2_nslices:Q",
            y=alt.Y("log10_flops:Q", scale=alt.Scale(zero=False)),
            color="trial:Q",
            tooltip=list(df.columns),
        )
        .properties(width=width, height=height)
        .interactive()
    )


def _attach_plot_methods():
    """Bind the plotting methods onto the port's classes, as the JAX
    package binds them onto its own (``tree.plot_ring()``,
    ``opt.plot_trials()``, ``tree.to_df()``, ...)."""
    from .hyper import HyperOptimizer
    from .hypergraph import HyperGraph
    from .slicing import SliceFinder
    from .tree import ContractionTree

    ContractionTree.plot_tree = plot_tree
    ContractionTree.plot_ring = plot_tree_ring
    ContractionTree.plot_tent = plot_tree_tent
    ContractionTree.plot_span = plot_tree_span
    ContractionTree.plot_flat = plot_tree_flat
    ContractionTree.plot_rubberband = plot_tree_rubberband
    ContractionTree.plot_circuit = plot_tree_circuit
    ContractionTree.plot_contractions = plot_contractions
    ContractionTree.plot_contractions_alt = plot_contractions_alt
    ContractionTree.to_networkx = tree_to_networkx
    ContractionTree.to_df = tree_to_df
    HyperOptimizer.plot_trials = plot_trials
    HyperOptimizer.plot_trials_alt = plot_trials_alt
    HyperOptimizer.plot_scatter = plot_scatter
    HyperOptimizer.plot_scatter_alt = plot_scatter_alt
    HyperOptimizer.plot_parameters_parallel = plot_parameters_parallel
    SliceFinder.plot_slicings = plot_slicings
    SliceFinder.plot_slicings_alt = plot_slicings_alt
    HyperGraph.plot = plot_hypergraph
