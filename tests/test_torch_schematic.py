"""The port's drawing canvas (``cotengra_tpu_torch/schematic.py``)
against the JAX package's on the CPU (matplotlib on Agg): every public
function gives the same value, and every ``Drawing`` method draws the
same artists (each line's data, width and colour; each collection's
offsets, sizes and colours; each patch's vertices and colours; each
text's position and string; the axes' limits and ticks) and saves the
same PNG bytes. The reference's own tests of the module
(``tests/test_schematic.py``) are carried over as tests of the port.

The helpers ``drawn`` and ``assert_same`` are shared with
``test_torch_plot.py``."""

import math
import random

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg", force=True)

import matplotlib.pyplot as plt  # noqa: E402
from matplotlib.colors import to_rgba as mpl_to_rgba  # noqa: E402

import cotengra_tpu.schematic as ref_schematic  # noqa: E402

import cotengra_tpu_torch as ctt  # noqa: E402
import cotengra_tpu_torch.schematic as schematic  # noqa: E402
from cotengra_tpu_torch.schematic import (  # noqa: E402
    Drawing,
    _convex_hull,
    auto_colors,
    average_color,
    axonometric_project,
    coo_to_zorder,
    darken_color,
    get_color,
    hash_to_color,
    hash_to_nvalues,
    jitter_color,
    mod_sat,
    set_coloring_seed,
)


# -- what a figure draws --------------------------------------------------------


def _rgba(c):
    return None if c is None else tuple(mpl_to_rgba(c))


def _text(t):
    return ("text", tuple(t.get_position()), t.get_text(), _rgba(t.get_color()),
            t.get_fontsize(), t.get_rotation(), t.get_ha(), t.get_va(),
            tuple(t.get_fontfamily()), t.get_zorder(), t.get_alpha())


def _line(ln):
    return ("line", np.asarray(ln.get_xydata(), float), ln.get_linewidth(),
            _rgba(ln.get_color()), ln.get_alpha(), ln.get_linestyle(),
            ln.get_solid_capstyle(), ln.get_zorder(), ln.get_label())


def _collection(c):
    c.update_scalarmappable()  # face colours from the mapped values
    arr = c.get_array()
    segments = getattr(c, "get_segments", lambda: [])()
    return ("collection", type(c).__name__, np.asarray(c.get_offsets(), float),
            np.asarray(getattr(c, "get_sizes", list)(), float),
            np.asarray(c.get_facecolor(), float),
            np.asarray(c.get_edgecolor(), float),
            None if arr is None else np.asarray(arr, float),
            c.get_clim() if arr is not None else None,
            c.get_cmap().name if arr is not None else None,
            [np.asarray(s, float) for s in segments],
            [np.asarray(p.vertices, float) for p in c.get_paths()],
            np.asarray(c.get_linewidth(), float), c.get_alpha(),
            c.get_zorder(), c.get_label())


def _patch(p):
    path = p.get_path()
    verts = p.get_patch_transform().transform(path.vertices)
    return ("patch", type(p).__name__, np.asarray(verts, float),
            None if path.codes is None else np.asarray(path.codes),
            _rgba(p.get_facecolor()), _rgba(p.get_edgecolor()),
            p.get_linewidth(), p.get_alpha(), p.get_fill(), p.get_zorder())


def _axes(ax):
    legend = ax.get_legend()
    return (
        "axes",
        [_line(ln) for ln in ax.lines],
        [_collection(c) for c in ax.collections],
        [_patch(p) for p in ax.patches],
        [_text(t) for t in ax.texts],
        ax.get_xlabel(), ax.get_ylabel(), ax.get_title(),
        tuple(ax.get_xlim()), tuple(ax.get_ylim()),
        np.asarray(ax.get_xticks(), float), np.asarray(ax.get_yticks(), float),
        [t.get_text() for t in ax.get_xticklabels()],
        [t.get_text() for t in ax.get_yticklabels()],
        [(t.get_rotation(), t.get_fontsize()) for t in ax.get_xticklabels()],
        ax.get_aspect(), ax.axison,
        None if legend is None else [t.get_text() for t in legend.get_texts()],
    )


def drawn(fig):
    """Everything ``fig`` draws, artist by artist in the order added."""
    return (
        [_axes(ax) for ax in fig.axes],
        [_text(t) for t in fig.texts],
        _rgba(fig.get_facecolor()),
        tuple(fig.get_size_inches()),
    )


def assert_same(got, exp, atol=0.0, where="figure"):
    """``got`` equals ``exp`` leaf by leaf: exactly, or every number
    within ``atol``."""
    if isinstance(exp, (list, tuple)):
        assert isinstance(got, (list, tuple)), where
        assert len(got) == len(exp), f"{where}: {len(got)} vs {len(exp)}"
        for k, (g, e) in enumerate(zip(got, exp)):
            assert_same(g, e, atol, f"{where}[{k}]")
    elif isinstance(exp, np.ndarray):
        got = np.asarray(got)
        assert got.shape == exp.shape, f"{where}: {got.shape} vs {exp.shape}"
        if atol:
            np.testing.assert_allclose(got, exp, rtol=0, atol=atol,
                                       err_msg=where)
        else:
            np.testing.assert_array_equal(got, exp, err_msg=where)
    elif isinstance(exp, float) and not isinstance(got, str) and atol:
        assert abs(got - exp) <= atol, f"{where}: {got} vs {exp}"
    else:
        assert got == exp, f"{where}: {got!r} vs {exp!r}"


# -- the functions ----------------------------------------------------------------


def test_module_names_match_the_reference():
    def public(mod):
        return {n for n in vars(mod) if not n.startswith("_")
                and getattr(vars(mod)[n], "__module__", None) == mod.__name__}

    assert public(schematic) == public(ref_schematic)
    assert {n for n in dir(Drawing) if not n.startswith("_")} == {
        n for n in dir(ref_schematic.Drawing) if not n.startswith("_")
    }


COLORS = ["blue", "grey", "#123456", (0.2, 0.4, 0.6), (0.9, 0.1, 0.3, 0.5)]

FUNCTION_CASES = [
    *[("get_color", (c,), {}) for c in COLORS],
    ("get_color", ("red",), {"alpha": 0.5}),
    *[("to_rgba", (c,), {}) for c in COLORS],
    ("to_rgba", ("green",), {"alpha": 0.25}),
    *[("mod_sat", (c,), {"mod": m}) for c in COLORS for m in (None, 0.5, 3)],
    ("mod_sat", ("orange",), {"mod": 0.5, "alpha": 0.3}),
    *[("darken_color", (c,), {}) for c in COLORS],
    ("darken_color", ("purple",), {"factor": 0.25}),
    ("average_color", (COLORS,), {}),
    *[("auto_colors", (n,), {}) for n in (0, 1, 7, 12)],
    ("auto_colors", (5,), {"alpha": 0.5, "default_sequence": True}),
    ("auto_colors", (9,), {"default_sequence": True}),
    *[("hash_to_nvalues", (s, n), {}) for s in ("abc", "", "ind-7")
      for n in (1, 3, 5)],
    ("hash_to_nvalues", ("abc", 3), {"seed": 11}),
    ("hash_to_color", ("abc",), {}),
    ("hash_to_color", ("xyz",), {"hmin": 0.2, "hmax": 0.4, "smin": 0.1,
                                 "smax": 0.9, "vmin": 0.5, "vmax": 0.6}),
    ("simple_scale", (2, -3), {"xscale": 0.5, "yscale": 2}),
    *[("axonometric_project", coo, {}) for coo in
      [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1.5, -2, 0.25)]],
    ("axonometric_project", (1, 2, 3), {"a": 30, "b": 20, "xscale": 2,
                                        "yscale": 0.5, "zscale": 3}),
    ("coo_to_zorder", (1, 2, 3), {}),
    ("coo_to_zorder", (1, 2, 3), {"xscale": 2, "yscale": 3, "zscale": 4}),
    ("distance", ((0, 0), (3, 4)), {}),
    ("get_angle", ((1, 1), (-2, 0.5)), {}),
    ("mean", ([1, 2, 3.5],), {}),
    ("gen_points_around", ((1, -1),), {}),
    ("gen_points_around", ((0, 0),), {"radius": 0.3, "resolution": 7}),
    ("_convex_hull", ([(0, 0), (1, 0), (1, 1), (0, 1), (0.5, 0.5)],), {}),
    ("_convex_hull", ([(0, 0), (2, 1)],), {}),
    ("_convex_hull", (schematic.gen_points_around((0, 0), 1, 40)
                      + schematic.gen_points_around((3, 1), 0.5, 40),), {}),
]


@pytest.mark.parametrize(
    "name,args,kwargs", FUNCTION_CASES,
    ids=[f"{c[0]}-{k}" for k, c in enumerate(FUNCTION_CASES)],
)
def test_functions_match_the_reference(name, args, kwargs):
    got = getattr(schematic, name)(*args, **kwargs)
    exp = getattr(ref_schematic, name)(*args, **kwargs)
    assert_same(got, exp)


def test_smooth_closed_path_matches_the_reference():
    coos = [(0, 0), (1, 0.2), (1.5, 1), (0.3, 1.4)]
    for smoothing in (0.0, 0.5, 1.0):
        got = schematic._smooth_closed_path(coos, smoothing)
        exp = ref_schematic._smooth_closed_path(coos, smoothing)
        assert_same((got.vertices, got.codes), (exp.vertices, exp.codes))


@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_jitter_color_draws_from_random_as_the_reference(seed):
    got, exp = [], []
    for fn, out in ((jitter_color, got), (ref_schematic.jitter_color, exp)):
        random.seed(seed)
        out.extend(fn(c, factor=f) for c in COLORS for f in (0.05, 0.3))
    assert got == exp
    assert len(set(got)) > 1


def test_coloring_seed_is_the_package_s_own():
    try:
        set_coloring_seed(7)
        ref_schematic.set_coloring_seed(7)
        assert hash_to_color("ix") == ref_schematic.hash_to_color("ix")
        set_coloring_seed(8)
        assert ref_schematic._COLORING_SEED == [7]
        assert schematic._COLORING_SEED == [8]
        assert hash_to_color("ix") != ref_schematic.hash_to_color("ix")
        assert hash_to_nvalues("ix", 3) == ref_schematic.hash_to_nvalues(
            "ix", 3, seed=8
        )
    finally:
        set_coloring_seed(1)
        ref_schematic.set_coloring_seed(1)


# -- the canvas -------------------------------------------------------------------

PRESETS = {"wire": {"color": (1, 0, 0, 1), "linewidth": 2},
           "faint": {"alpha": 0.3, "zorder": 5}}

METHOD_CASES = [
    ("text", ((0, 0), "hello"), {}),
    ("text", ((1, 2, 3), "3d"), {"fontsize": 7, "preset": "faint"}),
    ("text_between", ((0, 0), (2, 1), "edge"), {}),
    ("text_between", ((2, 1), (0, -1), "back"), {}),
    ("label_ax", (0.5, 0.9, "axlabel"), {}),
    ("label_fig", (0.5, 0.99, "figlabel"), {"color": "blue"}),
    ("circle", ((1, 1),), {"radius": 0.3}),
    ("circle", ((1, 0, 2),), {"preset": "faint"}),
    ("wedge", ((2, 2), 0, 120), {}),
    ("wedge", ((0, 1, 1), 30, 300), {"radius": 0.5, "color": "green"}),
    ("dot", ((0.5, 0.5),), {}),
    ("dot", ((0.5, 0.5, 1),), {"color": "red"}),
    ("regular_polygon", ((1, 2),), {"n": 5}),
    *[("marker", ((3, 1),), {"marker": m, "radius": 0.1})
      for m in "o s v ^ < > D h".split()],
    ("square", ((2, 0),), {}),
    ("cube", ((0, 0, 0),), {}),
    ("cube", ((1, 2, 0),), {"length": 0.5, "preset": "wire"}),
    ("line", ((0, 0), (1, 1)), {"arrowhead": True, "text": "ln"}),
    ("line", ((0, 0, 0), (1, 1, 1)), {"preset": "wire"}),
    ("line", ((0, 0), (2, -1)), {"arrowhead": {"center": 0.8, "width": 0.2}}),
    ("line_offset", ((0, 1), (2, 1)), {"offset": 0.3}),
    ("line_offset", ((0, 0, 0), (1, 2, 1)), {"offset": -0.2,
                                            "midlength": 0.2}),
    ("arrowhead", ((0, 0), (2, 1)), {"reverse": True}),
    ("curve", ([(0, 0), (1, 0.5), (2, 0), (3, 1)],), {}),
    ("curve", ([(0, 0, 0), (1, 0.5, 1), (2, 0, 2)],), {"smoothing": 0.9,
                                                        "color": "red"}),
    ("shape", ([(0, 0), (1, 0), (0.5, 1)],), {}),
    ("shape", ([(0, 0, 0), (1, 0, 0), (1, 1, 1)],), {"color": "blue",
                                                     "closed": False}),
    ("rectangle", ((0, 0), (1, 2)), {}),
    ("rectangle", ((1, 1), (2, 3)), {"radius": 0.1}),
    ("rectangle", ((0, 0, 0), (1, 1, 1)), {"color": "pink"}),
    ("patch", ([(0, 0), (1, 0), (1, 1), (0, 1)],), {}),
    ("patch", ([(0, 0), (2, 0), (1, 1)],), {"color": "yellow",
                                            "smoothing": 0.2}),
    ("patch_around", ([(0, 0), (1, 1), (2, 0)],), {"radius": 0.4}),
    ("patch_around", ([(0, 0, 0), (1, 1, 1)],), {"resolution": 5}),
    ("patch_around_circles", ((0, 0), 0.5, (3, 0), 0.5), {}),
    ("patch_around_circles", ((0, 0), 0.5, (3, 1), 0.2), {"pinch": False,
                                                          "color": "red"}),
]

DRAWING_OPTS = [
    {"figsize": (3, 3)},
    {"figsize": (2, 4), "background": "white", "drawcolor": "blue",
     "shapecolor": (0.1, 0.2, 0.3, 1.0), "a": 30, "b": 25, "xscale": 2,
     "yscale": 0.5, "zscale": 1.5},
]


def _canvases(opts):
    return (Drawing(presets=PRESETS, **opts),
            ref_schematic.Drawing(presets=PRESETS, **opts))


@pytest.mark.parametrize("opts", range(len(DRAWING_OPTS)))
@pytest.mark.parametrize(
    "name,args,kwargs", METHOD_CASES,
    ids=[f"{c[0]}-{k}" for k, c in enumerate(METHOD_CASES)],
)
def test_drawing_methods_draw_as_the_reference(name, args, kwargs, opts):
    d, ref = _canvases(DRAWING_OPTS[opts])
    try:
        getattr(d, name)(*args, **kwargs)
        getattr(ref, name)(*args, **kwargs)
        got, exp = drawn(d.fig), drawn(ref.fig)
        assert_same(got, exp)
        assert d._lims == ref._lims
        # something was drawn
        ax = got[0][0]
        assert ax[1] or ax[3] or ax[4] or got[1]
    finally:
        plt.close(d.fig)
        plt.close(ref.fig)


def test_every_drawing_method_has_a_case():
    methods = {n for n in dir(Drawing) if not n.startswith("_")}
    assert methods - {c[0] for c in METHOD_CASES} == {"savefig"}


def test_drawings_save_the_same_png(tmp_path):
    d, ref = _canvases({"figsize": (2, 2), "background": (1, 1, 1, 1)})
    try:
        for canvas in (d, ref):
            canvas.circle((0, 0), radius=0.4)
            canvas.line((0, 0, 0), (1, 1, 1), arrowhead=True)
            canvas.patch_around([(0, 0), (1, 1)], radius=0.2)
            canvas.text((0.5, -0.5), "x")
        d.savefig(tmp_path / "port.png", dpi=40)
        ref.savefig(tmp_path / "ref.png", dpi=40)
        port_png = (tmp_path / "port.png").read_bytes()
        assert port_png == (tmp_path / "ref.png").read_bytes()
        assert port_png[:4] == b"\x89PNG"
    finally:
        plt.close(d.fig)
        plt.close(ref.fig)


def test_drawing_on_an_external_ax_matches_the_reference():
    figs = []
    try:
        out = []
        for cls in (Drawing, ref_schematic.Drawing):
            fig, ax = plt.subplots()
            figs.append(fig)
            d = cls(ax=ax)
            d.circle((100, 100))
            d.line((0, 0), (1, 2))
            out.append((drawn(fig), d.fig_owner, d._lims))
        assert_same(out[0], out[1])
        assert out[0][1] is False
    finally:
        for fig in figs:
            plt.close(fig)


# -- the reference's tests, on the port ---------------------------------------------


def test_axonometric_projection_axes():
    # the z axis projects straight up
    x0, y0 = axonometric_project(0, 0, 0)
    x1, y1 = axonometric_project(0, 0, 1)
    assert x1 == pytest.approx(x0)
    assert y1 == pytest.approx(y0 + 1)
    # x and y go opposite horizontal directions
    xa, _ = axonometric_project(1, 0, 0)
    xb, _ = axonometric_project(0, 1, 0)
    assert xa > 0 > xb


def test_zorder_monotone_toward_viewer():
    assert coo_to_zorder(1, 0, 0) > coo_to_zorder(0, 0, 0)
    assert coo_to_zorder(0, 1, 0) < coo_to_zorder(0, 0, 0)
    assert coo_to_zorder(0, 0, 1) > coo_to_zorder(0, 0, 0)


def test_color_utils():
    c = get_color("blue")
    assert len(c) == 4
    assert get_color("blue", alpha=0.5)[3] == 0.5
    d = darken_color(c)
    assert all(dc <= cc for dc, cc in zip(d[:3], c[:3]))
    a = average_color([c, get_color("red")])
    assert len(a) == 4
    assert len(jitter_color(c)) == 4
    assert len(mod_sat(c, 0.5)) == 4
    cols = auto_colors(7)
    assert len(cols) == 7
    assert len(set(cols)) == 7


def test_hash_to_color_deterministic():
    try:
        set_coloring_seed(42)
        c1 = hash_to_color("abc")
        c2 = hash_to_color("abc")
        assert c1 == c2
        assert hash_to_color("abd") != c1
        vals = hash_to_nvalues("xyz", 3)
        assert len(vals) == 3
        assert all(0 <= v < 1 for v in vals)
    finally:
        set_coloring_seed(1)


def test_convex_hull_square():
    pts = [(0, 0), (1, 0), (1, 1), (0, 1), (0.5, 0.5), (0.2, 0.8)]
    hull = _convex_hull(pts)
    assert sorted(hull) == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_drawing_primitives_smoke():
    d = Drawing(figsize=(3, 3))
    d.text((0, 0), "hello")
    d.text_between((0, 0), (2, 1), "edge")
    d.label_ax(0.5, 0.9, "axlabel")
    d.label_fig(0.5, 0.99, "figlabel")
    d.circle((1, 1), radius=0.3)
    d.wedge((2, 2), 0, 120)
    d.dot((0.5, 0.5))
    d.regular_polygon((1, 2), n=5)
    for m in "o s v ^ < > D h".split():
        d.marker((3, 1), marker=m, radius=0.1)
    d.square((2, 0))
    d.line((0, 0), (1, 1), arrowhead=True, text="ln")
    d.line_offset((0, 1), (2, 1), offset=0.3)
    d.curve([(0, 0), (1, 0.5), (2, 0), (3, 1)])
    d.shape([(0, 0), (1, 0), (0.5, 1)])
    d.rectangle((0, 0), (1, 2))
    d.rectangle((1, 1), (2, 3), radius=0.1)
    d.patch([(0, 0), (1, 0), (1, 1), (0, 1)])
    d.patch_around([(0, 0), (1, 1), (2, 0)], radius=0.4)
    d.patch_around_circles((0, 0), 0.5, (3, 0), 0.5)
    plt.close(d.fig)


def test_drawing_3d_coordinates_and_presets():
    d = Drawing(presets={"wire": {"color": (1, 0, 0, 1)}})
    ln = d.line((0, 0, 0), (1, 1, 1), preset="wire")
    assert ln.get_color() == (1, 0, 0, 1)
    d.cube((0, 0, 0))
    c = d.circle((1, 0, 0))
    # 3d coords get a depth-based zorder
    assert c.get_zorder() != 0 or ln.get_zorder() != 0
    plt.close(d.fig)


def test_drawing_external_ax_does_not_own_limits():
    fig, ax = plt.subplots()
    d = Drawing(ax=ax)
    assert not d.fig_owner
    d.circle((100, 100))
    plt.close(fig)


def _small_tree():
    inputs, output, shapes, size_dict = ctt.rand_equation(8, 3, seed=1)
    return ctt.array_contract_tree(
        inputs, output, size_dict=size_dict, optimize="greedy"
    )


def test_plot_tree_circuit_smoke():
    import matplotlib.patches as mp

    tree = _small_tree()
    fig, ax = tree.plot_circuit()
    # one circle per internal contraction
    ncircles = sum(isinstance(p, mp.Circle) for p in ax.patches)
    assert ncircles == len(tree.children)
    plt.close(fig)


def test_altair_variants(monkeypatch):
    # altair is not installed: the fake of test_torch_plot.py records the
    # chart calls (see its docstring)
    from test_torch_plot import install_fake_altair

    alt = install_fake_altair(monkeypatch)
    inputs, output, shapes, size_dict = ctt.rand_equation(10, 3, seed=2)
    opt = ctt.HyperOptimizer(max_repeats=4, seed=0)
    opt.search(inputs, output, size_dict)
    opt.plot_trials_alt()
    opt.plot_scatter_alt()
    tree = _small_tree()
    tree.plot_contractions_alt()
    assert [c[0] for c in alt.log].count("Chart") == 4


def test_trials_to_df():
    from cotengra_tpu_torch.plot import trials_to_df

    inputs, output, shapes, size_dict = ctt.rand_equation(10, 3, seed=2)
    opt = ctt.HyperOptimizer(max_repeats=4, seed=0)
    opt.search(inputs, output, size_dict)
    df = trials_to_df(opt)
    assert len(df) == 4
    assert df["best_score"].is_monotonic_decreasing
    assert math.isfinite(df["log10_flops"].iloc[0])
