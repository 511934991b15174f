"""The port's plots (``cotengra_tpu_torch/plot.py``) against the JAX
package's on the CPU (matplotlib on Agg): the same tree, hypergraph,
slice finder or trial list drawn by both packages gives the same
artists, compared with ``test_torch_schematic.drawn``: each line's data,
width and colour, each collection's offsets, sizes and colours, each
patch's vertices and colours, each text's position and string, the
axes' labels, ticks and limits. Values from tree statistics are equal
exactly; the spring layouts of ``plot_tree_rubberband`` and
``plot_hypergraph`` within 1e-12. ``tree_to_df`` and ``trials_to_df``
go through ``pandas.testing.assert_frame_equal``; ``tree_to_networkx``
compares nodes, edges and attributes in order.

The trees: greedy ``rand_equation`` trees (each package's own greedy,
and the reference's path in both, sliced and then reconfigured alike),
and the committed m10-t27 (182 leaves) and 7x7 lattice (49 leaves)
plans loaded by each package's ``load_tree``. The hyper-optimizer's
searches are not seeded alike across packages, so both packages plot one
list of trials: a seeded reference search's, kept to their plain numbers
and strings; a port search is checked separately to fill every key the
plots read. Slice finders are compared at ``temperature=0``.

One difference from the reference's tests: altair is not installed, so
the ``*_alt`` functions are held to the reference through a fake
``altair`` module (``install_fake_altair``) that records every chart
call with its arguments; the two packages' records and data frames are
compared, not rendered charts.

The reference's own plot tests (``tests/test_periphery.py``:
``test_tree_exports``, ``test_plot_smoke``,
``test_plot_flat_and_rubberband_distinct``) are carried over as tests
of the port."""

import json
import math
import sys
import types
from pathlib import Path

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg", force=True)
pd = pytest.importorskip("pandas")
nx = pytest.importorskip("networkx")

import matplotlib.pyplot as plt  # noqa: E402

import cotengra_tpu as ctg  # noqa: E402
from cotengra_tpu.hypergraph import HyperGraph as RefHyperGraph  # noqa: E402
import cotengra_tpu.pathfinders.basic as ref_basic  # noqa: E402
import cotengra_tpu.plot as ref_plot  # noqa: E402
import cotengra_tpu.tree as ref_tree_mod  # noqa: E402
from cotengra_tpu.slicing import SliceFinder as RefSliceFinder  # noqa: E402
from cotengra_tpu.utils.io import load_tree as ref_load_tree  # noqa: E402

import cotengra_tpu_torch as ctt  # noqa: E402
import cotengra_tpu_torch.pathfinders.basic as port_basic  # noqa: E402
import cotengra_tpu_torch.plot as plot  # noqa: E402
import cotengra_tpu_torch.tree as port_tree_mod  # noqa: E402
from cotengra_tpu_torch.slicing import SliceFinder  # noqa: E402
from test_torch_schematic import assert_same, drawn  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SPRING_ATOL = 1e-12


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


# -- the trees --------------------------------------------------------------------


def _pure_python():
    """Both packages' path finders and cost replays in pure Python, so
    that slicing and reconfiguration take the same steps."""
    mp = pytest.MonkeyPatch()
    for basic, tree_mod in ((ref_basic, ref_tree_mod),
                            (port_basic, port_tree_mod)):
        mp.setattr(basic, "_get_native", lambda accel: None)
        mp.setattr(tree_mod, "_get_native_replay", lambda a: None)
    return mp


def _absorbed(m):
    inputs, output, _, _, arrays = ctt.rand_circuit_tn(53, m, seed=42)
    inputs, arrays = ctt.absorb_simple_tensors(
        inputs, arrays, output, max_rank=2, max_absorb_size=2**12
    )
    size_dict = {
        ix: int(d) for t, a in zip(inputs, arrays) for ix, d in zip(t, a.shape)
    }
    return inputs, output, size_dict


def _plan_trees(plan):
    if plan.startswith("lattice"):
        with open(ROOT / "plans" / f"{plan}.json") as f:
            inst = json.load(f)["reference"]["instance"]
        inputs, output, _, size_dict = ctt.lattice_equation(
            inst["dims"], d_min=inst["d_min"]
        )
    else:
        inputs, output, size_dict = _absorbed(
            int(plan.split("_m")[1].split("_")[0])
        )
    path = str(ROOT / "plans" / f"{plan}.json")
    return (ctt.load_tree(path, inputs, output, size_dict),
            ref_load_tree(path, inputs, output, size_dict))


def _rand16():
    return ctg.rand_equation(16, 3, n_out=2, n_hyper_in=1, n_hyper_out=1,
                             d_min=2, d_max=4, seed=3)


def _trees_from_reference_path(stage):
    """Both packages' trees from the reference's greedy path of a seeded
    ``rand_equation``: as built, sliced alike, then reconfigured."""
    inputs, output, _, size_dict = _rand16()
    mp = _pure_python()
    try:
        ssa = ctg.optimize_greedy(inputs, output, size_dict, use_ssa=True)
        ref = ctg.ContractionTree.from_path(inputs, output, size_dict,
                                            ssa_path=ssa)
        tree = ctt.ContractionTree.from_path(inputs, output, size_dict,
                                             ssa_path=ssa)
        if stage != "built":
            target = max(tree.max_size() // 16, 2)
            tree.slice_(target_size=target, seed=7)
            ref.slice_(target_size=target, seed=7)
            assert [vars(v) for v in tree.sliced_inds.values()] == [
                vars(v) for v in ref.sliced_inds.values()
            ]
        if stage == "reconfigured":
            tree.subtree_reconfigure_(select="max", subtree_search="bfs")
            ref.subtree_reconfigure_(select="max", subtree_search="bfs")
    finally:
        mp.undo()
    return tree, ref


def _own_greedy_trees(seed, n=12):
    """Each package's own greedy tree of ``rand_equation(n, 3, seed)``."""
    inputs, output, _, size_dict = ctg.rand_equation(n, 3, seed=seed)
    return tuple(
        pkg.array_contract_tree(inputs, output, size_dict=size_dict,
                                optimize="greedy")
        for pkg in (ctt, ctg)
    )


TREE_CASES = {
    "greedy12": lambda: _own_greedy_trees(0),
    "greedy10-s2": lambda: _own_greedy_trees(2, 10),
    "rand16": lambda: _trees_from_reference_path("built"),
    "rand16-sliced": lambda: _trees_from_reference_path("sliced"),
    "rand16-reconfigured": lambda: _trees_from_reference_path("reconfigured"),
    "m10-t27": lambda: _plan_trees("sycamore53_m10_t27"),
    "lattice7x7": lambda: _plan_trees("lattice7x7_d16_s16"),
}
_TREES = {}


def _trees(case):
    if case not in _TREES:
        tree, ref = TREE_CASES[case]()
        # the trees the plots draw are one tree: the same children in
        # the same order, and the same contraction order
        assert list(tree.children.items()) == list(ref.children.items())
        assert list(tree.traverse()) == list(ref.traverse())
        _TREES[case] = tree, ref
    return _TREES[case]


def test_plan_trees_are_full_width():
    assert _trees("m10-t27")[0].N == 182
    assert _trees("lattice7x7")[0].N == 49


# -- the tree plots ---------------------------------------------------------------

# (function, keyword arguments, tolerance); ``ax=True`` draws on axes
# made by the test
TREE_PLOTS = [
    ("plot_tree", {}, 0),
    ("plot_tree", {"layout": "tent"}, 0),
    ("plot_tree", {"layout": "span", "edge_scale": 2.0, "node_scale": 0.5,
                   "alpha": 0.5}, 0),
    ("plot_tree", {"ax": True, "figsize": (3, 3)}, 0),
    ("plot_tree_ring", {}, 0),
    ("plot_tree_tent", {}, 0),
    ("plot_tree_span", {}, 0),
    ("plot_tree_flat", {}, 0),
    ("plot_tree_flat", {"edge_scale": 0.5, "node_scale": 2.0,
                        "marker": "s"}, 0),
    ("plot_tree_rubberband", {}, SPRING_ATOL),
    ("plot_tree_rubberband", {"order": "surface_order", "max_bands": 9,
                              "colormap": "magma", "alpha": 0.4},
     SPRING_ATOL),
    ("plot_tree_circuit", {}, 0),
    ("plot_tree_circuit", {"edge_colormap": "viridis", "edge_max_width": 9,
                           "node_colormap": "Reds", "node_max_size": 12,
                           "figsize": (4, 4)}, 0),
    ("plot_contractions", {}, 0),
]


def _draw(module, name, obj, kwargs):
    kwargs = dict(kwargs)
    if kwargs.pop("ax", False):
        kwargs["ax"] = plt.subplots(figsize=kwargs.pop("figsize"))[1]
    fig, ax = getattr(module, name)(obj, **kwargs)
    assert ax in fig.axes
    return drawn(fig)


# every variant on two small trees; each plot function with its
# defaults on the others (a t27 figure takes ~0.5 s a package to draw)
ALL_VARIANTS = ("greedy12", "rand16-reconfigured")
TREE_PLOT_CASES = [
    pytest.param(case, *p, id=f"{case}-{p[0]}-{k}")
    for case in TREE_CASES
    for k, p in enumerate(TREE_PLOTS)
    if case in ALL_VARIANTS or (not p[1] and p[0] != "plot_tree")
]


@pytest.mark.parametrize("case,name,kwargs,atol", TREE_PLOT_CASES)
def test_tree_plots_draw_as_the_reference(case, name, kwargs, atol):
    tree, ref = _trees(case)
    got = _draw(plot, name, tree, kwargs)
    exp = _draw(ref_plot, name, ref, kwargs)
    assert_same(got, exp, atol)
    lines, collections, patches = got[0][0][1:4]
    n = tree.N
    if name == "plot_tree_circuit":
        # on its Drawing: two edges and a circle a contraction, a label
        # a leaf
        assert len(lines) == 2 * (n - 1) and len(patches) == n - 1
        assert len(got[0][0][4]) == n
    elif name == "plot_tree_rubberband":
        assert len(collections) == 1 and patches
    elif name == "plot_contractions":
        assert [len(ln[1]) for ln in lines] == [n - 1] * 3
    elif name == "plot_tree_flat":
        assert len(lines) == 3 * (n - 1)
    else:
        assert len(lines) == 2 * (n - 1)
        assert [len(c[2]) for c in collections] == [n - 1, n]


def test_tree_layouts_match_the_reference():
    for case in ("m10-t27", "rand16-sliced"):
        tree, ref = _trees(case)
        assert plot._leaf_angles(tree) == ref_plot._leaf_angles(ref)
        for layout in ("ring", "tent", "span"):
            got = plot._tree_positions(tree, layout)
            exp = ref_plot._tree_positions(ref, layout)
            assert list(got.items()) == list(exp.items())
            assert len(got) == 2 * tree.N - 1
        pts = [got[leaf] for leaf in tree.gen_leaves()]
        assert plot._convex_hull(pts) == ref_plot._convex_hull(pts)


def test_tree_exports_match_the_reference():
    for case in ("greedy12", "rand16-sliced", "m10-t27", "lattice7x7"):
        tree, ref = _trees(case)
        pd.testing.assert_frame_equal(plot.tree_to_df(tree),
                                      ref_plot.tree_to_df(ref))
        G, R = plot.tree_to_networkx(tree), ref_plot.tree_to_networkx(ref)
        assert list(G.nodes(data=True)) == list(R.nodes(data=True))
        assert list(G.edges(data=True)) == list(R.edges(data=True))
        assert G.is_directed() and R.is_directed()


# -- hypergraphs and slice finders ------------------------------------------------

HYPERGRAPHS = {
    "rand12": lambda: ctg.rand_equation(12, 3, seed=0),
    "rand16-hyper": _rand16,
    "lattice4x4": lambda: ctg.lattice_equation([4, 4], d_min=2),
}


@pytest.mark.parametrize("layout_opts", [{}, {"k": 0.3, "iterations": 20}])
@pytest.mark.parametrize("case", list(HYPERGRAPHS))
def test_plot_hypergraph_draws_as_the_reference(case, layout_opts):
    inputs, output, _, size_dict = HYPERGRAPHS[case]()
    hg = ctt.get_hypergraph(inputs, output, size_dict)
    ref = ctg.get_hypergraph(inputs, output, size_dict)
    got = _draw(plot, "plot_hypergraph", hg, layout_opts)
    exp = _draw(ref_plot, "plot_hypergraph", ref, layout_opts)
    assert_same(got, exp, SPRING_ATOL)
    edges, *nodes = got[0][0][2]
    assert len(edges[9]) == len(hg.to_networkx().edges)
    assert len(nodes) == (2 if case == "rand16-hyper" else 1)


SLICINGS = [
    ("rand16", {"target_slices": 4}),
    ("rand16-reconfigured", {"target_size": 8}),
    ("m10-t27", {"target_size": 2**24}),
]


@pytest.mark.parametrize("case,opts", SLICINGS,
                         ids=[c[0] for c in SLICINGS])
def test_plot_slicings_draws_as_the_reference(case, opts):
    tree, ref = _trees(case)
    got = _draw(plot, "plot_slicings",
                SliceFinder(tree, temperature=0, **opts),
                {"color_scheme": "plasma"})
    exp = _draw(ref_plot, "plot_slicings",
                RefSliceFinder(ref, temperature=0, **opts),
                {"color_scheme": "plasma"})
    assert_same(got, exp)
    assert len(got[0][0][2][0][2]) == 16


# -- trials -----------------------------------------------------------------------

_PLAIN = (str, int, float, bool)
_TRIALS = []


def _reference_trials():
    """A seeded reference search's trials, kept to their plain numbers
    and strings, then a failed trial."""
    if not _TRIALS:
        inputs, output, _, size_dict = ctg.rand_equation(14, 3, seed=4)
        opt = ctg.HyperOptimizer(max_repeats=12, seed=0)
        opt.search(inputs, output, size_dict)
        for t in opt.trials:
            plain = {k: v for k, v in t.items() if isinstance(v, _PLAIN)}
            plain["params"] = {k: v for k, v in t["params"].items()
                               if isinstance(v, _PLAIN)}
            _TRIALS.append(plain)
        assert len({t["method"] for t in _TRIALS}) == 2
    return [dict(t, params=dict(t["params"])) for t in _TRIALS]


def _optimizers(failed=False):
    trials = _reference_trials()
    if failed:
        inf = float("inf")
        trials.insert(3, {"method": "greedy", "params": {"costmod": 1.0},
                          "score": inf, "flops": inf, "size": inf,
                          "write": inf, "time": 0.5})
    opt, ref = ctt.HyperOptimizer(), ctg.HyperOptimizer()
    opt.trials, ref.trials = trials, [dict(t) for t in trials]
    return opt, ref


TRIAL_PLOTS = [
    ("plot_trials", {}),
    ("plot_trials", {"y": "flops"}),
    ("plot_scatter", {}),
    ("plot_scatter", {"x": "write", "y": "score", "figsize": (3, 3)}),
    ("plot_parameters_parallel", {}),
    ("plot_parameters_parallel", {"params": ["temperature", "costmod"]}),
]


@pytest.mark.parametrize("failed", [False, True])
@pytest.mark.parametrize(
    "name,kwargs", TRIAL_PLOTS,
    ids=[f"{p[0]}-{k}" for k, p in enumerate(TRIAL_PLOTS)],
)
def test_trial_plots_draw_as_the_reference(name, kwargs, failed):
    opt, ref = _optimizers(failed)
    got = _draw(plot, name, opt, kwargs)
    assert_same(got, _draw(ref_plot, name, ref, kwargs))
    assert got[0][0][1] or got[0][0][2]


@pytest.mark.parametrize("failed", [False, True])
def test_trials_to_df_matches_the_reference(failed):
    opt, ref = _optimizers(failed)
    df = plot.trials_to_df(opt)
    pd.testing.assert_frame_equal(df, ref_plot.trials_to_df(ref))
    assert df["score"].isna().sum() == failed


def test_plot_parameters_parallel_refuses_no_trials_as_the_reference():
    for module, cls in ((plot, ctt.HyperOptimizer),
                        (ref_plot, ctg.HyperOptimizer)):
        with pytest.raises(ValueError, match="no successful trials"):
            module.plot_parameters_parallel(cls())


def test_port_search_fills_every_key_the_plots_read():
    inputs, output, _, size_dict = ctt.rand_equation(12, 3, seed=5)
    opt = ctt.HyperOptimizer(max_repeats=6, seed=1)
    opt.search(inputs, output, size_dict)
    assert len(opt.trials) == 6
    for t in opt.trials:
        assert {"method", "score", "params", "flops", "size", "write",
                "time"} <= set(t)
        assert math.isfinite(t["score"]) and t["params"]
    df = plot.trials_to_df(opt)
    assert not df[["score", "log10_flops", "log2_size", "time"]].isna().any(
        axis=None)
    for name, kwargs in TRIAL_PLOTS:
        fig, _ = getattr(opt, name)(**kwargs)
        assert drawn(fig)[0]


# -- altair -----------------------------------------------------------------------


class _FakeAltair(types.ModuleType):
    """Stands in for ``altair``: every call appends ``(name, args,
    kwargs)`` to ``log`` and charts return themselves."""

    def __init__(self):
        super().__init__("altair")
        self.log = []

    def Chart(self, data):
        return _FakeChart(self.log, data)

    def X(self, *args, **kwargs):
        return ("X", args, kwargs)

    def Y(self, *args, **kwargs):
        return ("Y", args, kwargs)

    def Scale(self, *args, **kwargs):
        return ("Scale", args, kwargs)


class _FakeChart:
    def __init__(self, log, data):
        self.log = log
        log.append(("Chart", (data,), {}))

    def __getattr__(self, name):
        if name not in ("mark_point", "mark_line", "encode", "properties",
                        "interactive"):
            raise AttributeError(name)

        def call(*args, **kwargs):
            self.log.append((name, args, kwargs))
            return self

        return call

    def __add__(self, other):
        self.log.append(("+", (), {}))
        return self


def install_fake_altair(monkeypatch):
    alt = _FakeAltair()
    monkeypatch.setitem(sys.modules, "altair", alt)
    return alt


def _assert_same_records(got, exp, where="log"):
    if isinstance(exp, pd.DataFrame):
        pd.testing.assert_frame_equal(got, exp)
    elif isinstance(exp, (list, tuple)):
        assert type(got) is type(exp) and len(got) == len(exp), where
        for k, (g, e) in enumerate(zip(got, exp)):
            _assert_same_records(g, e, f"{where}[{k}]")
    elif isinstance(exp, dict):
        assert list(got) == list(exp), where
        for k in exp:
            _assert_same_records(got[k], exp[k], f"{where}[{k!r}]")
    else:
        assert got == exp, f"{where}: {got!r} vs {exp!r}"


ALT_PLOTS = [
    ("plot_trials_alt", "trials", {}),
    ("plot_trials_alt", "trials", {"y": "log10_flops", "width": 300,
                                   "height": 100}),
    ("plot_scatter_alt", "trials", {}),
    ("plot_scatter_alt", "trials", {"x": "time", "y": "score"}),
    ("plot_contractions_alt", "tree", {}),
    ("plot_contractions_alt", "t27", {"width": 800}),
    ("plot_slicings_alt", "slicer", {}),
    ("plot_slicings_alt", "slicer", {"trials": 5, "height": 200}),
]


def _alt_inputs(kind):
    if kind == "trials":
        return _optimizers(failed=True)
    if kind == "slicer":
        tree, ref = _trees("rand16")
        return (SliceFinder(tree, target_slices=4, temperature=0),
                RefSliceFinder(ref, target_slices=4, temperature=0))
    return _trees("m10-t27" if kind == "t27" else "rand16-sliced")


@pytest.mark.parametrize(
    "name,kind,kwargs", ALT_PLOTS,
    ids=[f"{p[0]}-{k}" for k, p in enumerate(ALT_PLOTS)],
)
def test_altair_plots_record_as_the_reference(name, kind, kwargs,
                                              monkeypatch):
    alt = install_fake_altair(monkeypatch)
    obj, ref = _alt_inputs(kind)
    getattr(plot, name)(obj, **kwargs)
    got, alt.log = alt.log, []
    getattr(ref_plot, name)(ref, **kwargs)
    _assert_same_records(got, alt.log)
    assert got[0][0] == "Chart" and len(got[0][1][0])


def test_altair_plots_need_altair(monkeypatch):
    monkeypatch.setitem(sys.modules, "altair", None)
    opt, _ = _optimizers()
    with pytest.raises(ImportError, match="require altair"):
        plot.plot_trials_alt(opt)


# -- the methods ------------------------------------------------------------------


def test_methods_are_attached_as_in_the_reference():
    pairs = [(ctt.ContractionTree, ctg.ContractionTree),
             (ctt.HyperOptimizer, ctg.HyperOptimizer),
             (SliceFinder, RefSliceFinder),
             (ctt.HyperGraph, RefHyperGraph)]
    attached = 0
    for cls, ref_cls in pairs:
        for name in dir(ref_cls):
            fn = getattr(ref_cls, name)
            if getattr(fn, "__module__", None) != "cotengra_tpu.plot":
                continue
            port_fn = getattr(cls, name)
            assert port_fn is getattr(plot, fn.__name__), name
            attached += 1
    assert attached == 19


def test_top_level_names_are_the_plot_module_s():
    for name in ("plot_contractions", "plot_contractions_alt",
                 "plot_hypergraph", "plot_scatter", "plot_scatter_alt",
                 "plot_slicings", "plot_slicings_alt", "plot_tree",
                 "plot_tree_circuit", "plot_tree_ring", "plot_tree_span",
                 "plot_tree_tent", "plot_trials", "plot_trials_alt",
                 "tree_to_df", "tree_to_networkx"):
        assert getattr(ctt, name) is getattr(plot, name)
        assert (name in ctt.__all__) == (name in ctg.__all__)


def test_methods_draw_as_the_functions():
    tree, ref = _trees("greedy12")
    assert_same(drawn(tree.plot_ring()[0]), drawn(ref.plot_ring()[0]))
    assert_same(drawn(tree.plot_tent()[0]),
                drawn(plot.plot_tree(tree, layout="tent")[0]))
    pd.testing.assert_frame_equal(tree.to_df(), ref.to_df())


# -- the reference's tests, on the port ---------------------------------------------


def test_tree_exports():
    inputs, output, shapes, size_dict = ctt.rand_equation(12, 3, seed=0)
    tree = ctt.array_contract_tree(
        inputs, output, size_dict=size_dict, optimize="greedy"
    )
    G = tree.to_networkx()
    assert G.number_of_nodes() == 2 * tree.N - 1
    df = tree.to_df()
    assert len(df) == tree.N - 1
    assert df["cum_flops"].iloc[-1] == tree.total_flops()


def test_plot_smoke():
    inputs, output, shapes, size_dict = ctt.rand_equation(12, 3, seed=0)
    tree = ctt.array_contract_tree(
        inputs, output, size_dict=size_dict, optimize="greedy"
    )
    for layout in ("ring", "tent", "span"):
        fig, ax = tree.plot_tree(layout=layout)
        assert fig is not None
    tree.plot_contractions()

    opt = ctt.HyperOptimizer(max_repeats=4, seed=0)
    opt.search(inputs, output, size_dict)
    opt.plot_trials()
    opt.plot_scatter()

    hg = ctt.get_hypergraph(inputs, output, size_dict)
    hg.plot()

    sf = SliceFinder(tree, target_slices=4)
    sf.plot_slicings()


def test_plot_flat_and_rubberband_distinct():
    inputs, output, shapes, size_dict = ctt.rand_equation(10, 3, seed=0)
    tree = ctt.array_contract_tree(
        inputs, output, size_dict=size_dict, optimize="greedy"
    )
    fig1, ax1 = tree.plot_flat()
    fig2, ax2 = tree.plot_rubberband()
    fig3, ax3 = tree.plot_tent()
    # the flat layout is a dendrogram by contraction order: its node
    # heights differ from the tent layout's extent-based heights
    flat = np.asarray(ax1.collections[0].get_offsets())[:, 1]
    tent = np.asarray(ax3.collections[0].get_offsets())[:, 1]
    assert sorted(flat) != sorted(tent)
