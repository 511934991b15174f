"""Manual-drawing canvas for schematic diagrams (2D and pseudo-3D).

The port's copy of ``cotengra_tpu/schematic.py``, with the same names
and geometry, so that both packages draw the same figure: a
:class:`Drawing` wraps a matplotlib axes with

- optional axonometric projection - pass 3-coordinates anywhere a
  2-coordinate is accepted and they are projected with the classic
  (a, b)-angle axonometry, z-ordered by depth;
- named style *presets* merged under per-call kwargs;
- automatic figure-limit tracking;
- primitives: text, lines (with offsets/arrowheads), smooth curves,
  circles/wedges/dots/polygons/markers, cubes, rectangles, closed
  smooth patches and automatic blobs around element groups;
- the color utilities (``get_color``, ``auto_colors``, ``hash_to_color``
  etc.), with this package's own coloring seed.

matplotlib is imported inside the functions that draw, so the module
imports without it.
"""

import colorsys
import functools
import hashlib
import math

_COLORS_DEFAULT = {
    "blue": "#5ca1c2",
    "orange": "#d18146",
    "green": "#56ac6b",
    "red": "#c65c61",
    "purple": "#8c6bb1",
    "pink": "#c27ba0",
    "yellow": "#c2b25c",
    "grey": "#8d8d8d",
    "gray": "#8d8d8d",
}

_COLORING_SEED = [1]


def set_coloring_seed(seed):
    """Set the global seed used by :func:`hash_to_color`."""
    _COLORING_SEED[0] = seed


def hash_to_nvalues(s, nval, seed=None):
    """Hash string ``s`` to ``nval`` floats in [0, 1)."""
    if seed is None:
        seed = _COLORING_SEED[0]
    h = hashlib.sha256(f"{s}-{seed}".encode()).digest()
    step = len(h) // nval
    return tuple(
        int.from_bytes(h[i * step:(i + 1) * step], "big")
        / 256 ** step
        for i in range(nval)
    )


def hash_to_color(
    s, hmin=0.0, hmax=1.0, smin=0.3, smax=0.5, vmin=0.8, vmax=0.9
):
    """Deterministically map a string to an RGB color within the given
    hue/saturation/value ranges."""
    u, v, w = hash_to_nvalues(s, 3)
    return colorsys.hsv_to_rgb(
        hmin + u * (hmax - hmin),
        smin + v * (smax - smin),
        vmin + w * (vmax - vmin),
    )


def to_rgba(c, alpha=None):
    import matplotlib as mpl

    r, g, b, a = mpl.colors.to_rgba(c)
    if alpha is not None:
        a = alpha
    return (r, g, b, a)


def get_color(color, alpha=None):
    """Resolve a color: name from the built-in nice palette, or anything
    matplotlib understands."""
    c = _COLORS_DEFAULT.get(color, color)
    return to_rgba(c, alpha)


def mod_sat(c, mod=None, alpha=None):
    """Modify the saturation of a color by factor ``mod``."""
    r, g, b, a = to_rgba(c, alpha)
    h, s, v = colorsys.rgb_to_hsv(r, g, b)
    if mod is not None:
        s = min(max(s * mod, 0.0), 1.0)
    return colorsys.hsv_to_rgb(h, s, v) + (a,)


def darken_color(color, factor=2 / 3):
    r, g, b, a = to_rgba(color)
    return (r * factor, g * factor, b * factor, a)


def average_color(colors):
    """RMS-average a sequence of colors."""
    rgbas = [to_rgba(c) for c in colors]
    n = len(rgbas)
    return tuple(
        math.sqrt(sum(c[i] ** 2 for c in rgbas) / n) for i in range(4)
    )


def jitter_color(color, factor=0.05):
    """Randomly perturb hue/saturation/value slightly."""
    import random

    r, g, b, a = to_rgba(color)
    h, s, v = colorsys.rgb_to_hsv(r, g, b)
    h = (h + random.uniform(-factor / 2, factor / 2)) % 1.0
    s = min(max(s + random.uniform(-factor, factor), 0.0), 1.0)
    v = min(max(v + random.uniform(-factor, factor), 0.0), 1.0)
    return colorsys.hsv_to_rgb(h, s, v) + (a,)


def auto_colors(nc, alpha=None, default_sequence=False):
    """A sequence of ``nc`` visually-distinct colors."""
    if default_sequence and nc <= len(_COLORS_DEFAULT) - 1:
        names = ["blue", "orange", "green", "red", "purple", "pink",
                 "yellow", "grey"]
        return [get_color(names[i], alpha) for i in range(nc)]
    return [
        colorsys.hsv_to_rgb(i / max(nc, 1) * 0.85, 0.45, 0.85)
        + ((1.0 if alpha is None else alpha),)
        for i in range(nc)
    ]


# -- geometry helpers ---------------------------------------------------------


def simple_scale(i, j, xscale=1, yscale=1):
    return (i * xscale, j * yscale)


def axonometric_project(
    i, j, k, a=50, b=12, xscale=1, yscale=1, zscale=1
):
    """Project 3D ``(i, j, k)`` onto the plane with x-axis at angle
    ``a`` degrees and y-axis at angle ``b``."""
    i, j, k = i * xscale, j * yscale, k * zscale
    ca, sa = math.cos(math.radians(a)), math.sin(math.radians(a))
    cb, sb = math.cos(math.radians(b)), math.sin(math.radians(b))
    return (i * ca - j * cb, k + i * sa + j * sb)


def coo_to_zorder(i, j, k, xscale=1, yscale=1, zscale=1):
    """Map a 3D coordinate to a depth ordering: larger values are drawn
    on top (closer to the viewer)."""
    return i * xscale - j * yscale + k * zscale


def distance(pa, pb):
    return math.hypot(pb[0] - pa[0], pb[1] - pa[1])


def get_angle(pa, pb):
    return math.atan2(pb[1] - pa[1], pb[0] - pa[0])


def mean(xs):
    xs = list(xs)
    return sum(xs) / len(xs)


def gen_points_around(coo, radius=1.0, resolution=12):
    """Points on a circle around ``coo``."""
    x, y = coo
    return [
        (
            x + radius * math.cos(2 * math.pi * t / resolution),
            y + radius * math.sin(2 * math.pi * t / resolution),
        )
        for t in range(resolution)
    ]


def _convex_hull(points):
    """Andrew's monotone chain."""
    pts = sorted(set(points))
    if len(pts) <= 2:
        return list(pts)

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (
            b[0] - o[0]
        )

    lower, upper = [], []
    for p in pts:
        while (
            len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0
        ):
            lower.pop()
        lower.append(p)
    for p in reversed(pts):
        while (
            len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0
        ):
            upper.pop()
        upper.append(p)
    return lower[:-1] + upper[:-1]


def _smooth_closed_path(coos, smoothing=0.5):
    """A closed cubic-bezier matplotlib Path through ``coos``."""
    from matplotlib.path import Path

    n = len(coos)
    verts, codes = [coos[0]], [Path.MOVETO]
    for i in range(n):
        p0 = coos[(i - 1) % n]
        p1 = coos[i]
        p2 = coos[(i + 1) % n]
        p3 = coos[(i + 2) % n]
        # catmull-rom style tangents scaled by smoothing
        t1 = (
            (p2[0] - p0[0]) * smoothing / 3,
            (p2[1] - p0[1]) * smoothing / 3,
        )
        t2 = (
            (p3[0] - p1[0]) * smoothing / 3,
            (p3[1] - p1[1]) * smoothing / 3,
        )
        verts += [
            (p1[0] + t1[0], p1[1] + t1[1]),
            (p2[0] - t2[0], p2[1] - t2[1]),
            p2,
        ]
        codes += [Path.CURVE4, Path.CURVE4, Path.CURVE4]
    codes[-1] = Path.CURVE4
    verts.append(coos[0])
    codes.append(Path.CLOSEPOLY)
    return Path(verts, codes)


class Drawing:
    """Manual-drawing canvas (see module docstring). Coordinates may be
    2D or 3D tuples; 3D ones are axonometrically projected with angles
    ``a``/``b`` and z-ordered by depth.

    Parameters: ``background``, ``drawcolor``
    (lines/text default), ``shapecolor`` (fills default), projection
    angles/scales, named ``presets``, and an optional external ``ax``
    (in which case figure limits are not auto-adjusted).
    """

    def __init__(
        self,
        background=(0, 0, 0, 0),
        drawcolor=(0.14, 0.15, 0.16, 1.0),
        shapecolor=(0.45, 0.50, 0.55, 1.0),
        a=50,
        b=12,
        xscale=1,
        yscale=1,
        zscale=1,
        presets=None,
        ax=None,
        **kwargs,
    ):
        import matplotlib.pyplot as plt

        if ax is None:
            self.fig = plt.figure(**kwargs)
            self.fig.set_facecolor(background)
            self.ax = self.fig.add_subplot(111)
            self.fig_owner = True
        else:
            self.ax = ax
            self.fig = ax.figure
            self.fig_owner = False
        self.ax.set_axis_off()
        self.ax.set_aspect("equal")

        self.drawcolor = drawcolor
        self.shapecolor = shapecolor
        self.presets = dict(presets or {})
        self.presets.setdefault(None, {})
        self._lims = [None, None, None, None]  # xmin xmax ymin ymax

        self._project3 = functools.partial(
            axonometric_project,
            a=a, b=b, xscale=xscale, yscale=yscale, zscale=zscale,
        )
        self._project2 = functools.partial(
            simple_scale, xscale=xscale, yscale=yscale
        )
        self._zorder3 = functools.partial(
            coo_to_zorder, xscale=xscale, yscale=yscale, zscale=zscale
        )

    # -- plumbing ---------------------------------------------------

    def _proj(self, coo):
        """Project a 2D or 3D coordinate; returns ((x, y), zorder)."""
        if len(coo) == 2:
            return self._project2(*coo), None
        return self._project3(*coo), self._zorder3(*coo)

    def _style(self, preset, kwargs, color_key="color", default=None):
        style = dict(self.presets.get(preset, ()))
        style.update(kwargs)
        if default is not None:
            style.setdefault(color_key, default)
        zorder = style.pop("zorder", None)
        return style, zorder

    def _see(self, x, y, pad=0.0):
        if not self.fig_owner:
            return
        lims = self._lims
        if lims[0] is None or x - pad < lims[0]:
            lims[0] = x - pad
        if lims[1] is None or x + pad > lims[1]:
            lims[1] = x + pad
        if lims[2] is None or y - pad < lims[2]:
            lims[2] = y - pad
        if lims[3] is None or y + pad > lims[3]:
            lims[3] = y + pad
        dx = max(lims[1] - lims[0], 0.1)
        dy = max(lims[3] - lims[2], 0.1)
        m = 0.05 * max(dx, dy)
        self.ax.set_xlim(lims[0] - m, lims[1] + m)
        self.ax.set_ylim(lims[2] - m, lims[3] + m)

    # -- text -------------------------------------------------------

    def text(self, coo, text, preset=None, **kwargs):
        """Place text at (projected) ``coo``."""
        style, z = self._style(preset, kwargs, default=self.drawcolor)
        style.setdefault("ha", "center")
        style.setdefault("va", "center")
        (x, y), zp = self._proj(coo)
        t = self.ax.text(x, y, text, **style)
        if z is not None or zp is not None:
            t.set_zorder(z if z is not None else zp)
        self._see(x, y)
        return t

    def text_between(self, cooa, coob, text, preset=None, **kwargs):
        """Place text at the midpoint of ``cooa``-``coob``, rotated
        along the line."""
        (xa, ya), _ = self._proj(cooa)
        (xb, yb), _ = self._proj(coob)
        angle = math.degrees(get_angle((xa, ya), (xb, yb)))
        if angle > 90 or angle <= -90:
            angle += 180
        kwargs.setdefault("rotation", angle)
        kwargs.setdefault("rotation_mode", "anchor")
        return self.text(
            ((xa + xb) / 2, (ya + yb) / 2), text, preset=preset,
            **kwargs,
        )

    def label_ax(self, x, y, text, preset=None, **kwargs):
        """Text in axes-fraction coordinates."""
        style, _ = self._style(preset, kwargs, default=self.drawcolor)
        style.setdefault("ha", "center")
        style.setdefault("va", "center")
        return self.ax.text(
            x, y, text, transform=self.ax.transAxes, **style
        )

    def label_fig(self, x, y, text, preset=None, **kwargs):
        """Text in figure-fraction coordinates."""
        style, _ = self._style(preset, kwargs, default=self.drawcolor)
        style.setdefault("ha", "center")
        style.setdefault("va", "center")
        return self.fig.text(x, y, text, **style)

    # -- markers ----------------------------------------------------

    def _add_patch(self, patch, zorder):
        if zorder is not None:
            patch.set_zorder(zorder)
        self.ax.add_patch(patch)
        return patch

    def circle(self, coo, preset=None, **kwargs):
        """A circle at ``coo`` (default radius 0.25)."""
        import matplotlib.patches as mp

        style, z = self._style(preset, kwargs, default=self.shapecolor)
        r = style.pop("radius", 0.25)
        style.setdefault("linewidth", 1)
        style.setdefault("edgecolor", darken_color(style["color"]))
        style.setdefault("facecolor", style.pop("color"))
        (x, y), zp = self._proj(coo)
        c = mp.Circle((x, y), r, **style)
        self._see(x, y, pad=r)
        return self._add_patch(c, z if z is not None else zp)

    def wedge(self, coo, theta1, theta2, preset=None, **kwargs):
        """A filled wedge (angles in degrees) at ``coo``."""
        import matplotlib.patches as mp

        style, z = self._style(preset, kwargs, default=self.shapecolor)
        r = style.pop("radius", 0.25)
        style.setdefault("linewidth", 1)
        style.setdefault("edgecolor", darken_color(style["color"]))
        style.setdefault("facecolor", style.pop("color"))
        (x, y), zp = self._proj(coo)
        w = mp.Wedge((x, y), r, theta1, theta2, **style)
        self._see(x, y, pad=r)
        return self._add_patch(w, z if z is not None else zp)

    def dot(self, coo, preset=None, **kwargs):
        """A small filled circle."""
        kwargs.setdefault("radius", 0.05)
        kwargs.setdefault("linewidth", 0)
        style = dict(kwargs)
        style.setdefault("color", self.drawcolor)
        style.setdefault("edgecolor", style["color"])
        return self.circle(coo, preset=preset, **style)

    def regular_polygon(self, coo, preset=None, **kwargs):
        """A regular polygon (default ``n=3``, i.e. triangle)."""
        import matplotlib.patches as mp

        style, z = self._style(preset, kwargs, default=self.shapecolor)
        n = style.pop("n", 3)
        r = style.pop("radius", 0.25)
        orientation = style.pop("orientation", 0.0)
        style.setdefault("linewidth", 1)
        style.setdefault("edgecolor", darken_color(style["color"]))
        style.setdefault("facecolor", style.pop("color"))
        (x, y), zp = self._proj(coo)
        p = mp.RegularPolygon(
            (x, y), n, radius=r, orientation=orientation, **style
        )
        self._see(x, y, pad=r)
        return self._add_patch(p, z if z is not None else zp)

    def marker(self, coo, preset=None, **kwargs):
        """Generic marker dispatch: ``marker`` in the style picks one of
        ``o`` (circle), ``s`` (square), ``v``/``^``/``<``/``>``
        (triangles), ``D`` (diamond), ``h`` (hexagon)."""
        style = dict(self.presets.get(preset, ()))
        style.update(kwargs)
        m = style.pop("marker", "o")
        if m == "o":
            return self.circle(coo, **style)
        tri = {"^": 0.0, "<": 90.0, "v": 180.0, ">": 270.0}
        if m in tri:
            style.setdefault(
                "orientation", math.radians(tri[m])
            )
            style.setdefault("n", 3)
            return self.regular_polygon(coo, **style)
        if m == "s":
            style.setdefault("n", 4)
            style.setdefault("orientation", math.pi / 4)
            return self.regular_polygon(coo, **style)
        if m == "D":
            style.setdefault("n", 4)
            return self.regular_polygon(coo, **style)
        if m == "h":
            style.setdefault("n", 6)
            return self.regular_polygon(coo, **style)
        raise ValueError(f"Unknown marker {m!r}.")

    def square(self, coo, preset=None, **kwargs):
        kwargs.setdefault("n", 4)
        kwargs.setdefault("orientation", math.pi / 4)
        return self.regular_polygon(coo, preset=preset, **kwargs)

    def cube(self, coo, preset=None, **kwargs):
        """A wire-frame unit cube centered at 3D ``coo``."""
        style, _ = self._style(preset, kwargs, default=self.drawcolor)
        length = style.pop("length", 1.0)
        h = length / 2
        x, y, z = coo
        corners = [
            (x + sx * h, y + sy * h, z + sz * h)
            for sx in (-1, 1)
            for sy in (-1, 1)
            for sz in (-1, 1)
        ]
        lines = []
        for i, ca in enumerate(corners):
            for cb in corners[i + 1:]:
                # edges differ in exactly one coordinate
                if (
                    sum(abs(a - b) > 1e-12 for a, b in zip(ca, cb))
                    == 1
                ):
                    lines.append(self.line(ca, cb, **style))
        return lines

    # -- lines and curves -------------------------------------------

    def line(self, cooa, coob, preset=None, **kwargs):
        """A straight line between two (projected) points. Supports
        ``arrowhead=True/dict`` and ``text`` (via text_between)."""
        from matplotlib.lines import Line2D

        style, z = self._style(preset, kwargs, default=self.drawcolor)
        arrowhead = style.pop("arrowhead", None)
        text = style.pop("text", None)
        style.setdefault("solid_capstyle", "round")
        (xa, ya), za = self._proj(cooa)
        (xb, yb), zb = self._proj(coob)
        ln = Line2D([xa, xb], [ya, yb], **style)
        if z is None and za is not None and zb is not None:
            z = (za + zb) / 2
        if z is not None:
            ln.set_zorder(z)
        self.ax.add_line(ln)
        self._see(xa, ya)
        self._see(xb, yb)
        if arrowhead is not None:
            ah = {} if arrowhead is True else dict(arrowhead)
            ah.setdefault("color", style.get("color"))
            self.arrowhead(cooa, coob, **ah)
        if text is not None:
            self.text_between(cooa, coob, text)
        return ln

    def line_offset(
        self, cooa, coob, offset, midlength=0.5, preset=None, **kwargs
    ):
        """A line that bows away from the straight segment by
        ``offset`` (perpendicular), flat for ``midlength`` of its
        middle - useful for multi-edges."""
        (xa, ya), _ = self._proj(cooa)
        (xb, yb), _ = self._proj(coob)
        angle = get_angle((xa, ya), (xb, yb)) + math.pi / 2
        ox, oy = offset * math.cos(angle), offset * math.sin(angle)
        lo = (1 - midlength) / 2
        p1 = (
            xa + (xb - xa) * lo + ox,
            ya + (yb - ya) * lo + oy,
        )
        p2 = (
            xa + (xb - xa) * (1 - lo) + ox,
            ya + (yb - ya) * (1 - lo) + oy,
        )
        return self.curve(
            [(xa, ya), p1, p2, (xb, yb)], preset=preset, **kwargs
        )

    def arrowhead(self, cooa, coob, preset=None, **kwargs):
        """An arrowhead on the line from ``cooa`` to ``coob``, at
        fraction ``center`` (default 0.5) along it."""
        style, z = self._style(preset, kwargs, default=self.drawcolor)
        center = style.pop("center", 0.5)
        width = style.pop("width", 0.08)
        length = style.pop("length", 0.15)
        reverse = style.pop("reverse", False)
        (xa, ya), _ = self._proj(cooa)
        (xb, yb), _ = self._proj(coob)
        if reverse:
            (xa, ya), (xb, yb) = (xb, yb), (xa, ya)
            center = 1 - center
        lam = center
        tip = (xa + lam * (xb - xa), ya + lam * (yb - ya))
        ang = get_angle((xa, ya), (xb, yb))
        ca, sa = math.cos(ang), math.sin(ang)
        left = (
            tip[0] - length * ca - width * sa,
            tip[1] - length * sa + width * ca,
        )
        right = (
            tip[0] - length * ca + width * sa,
            tip[1] - length * sa - width * ca,
        )
        return self.shape(
            [left, tip, right],
            closed=True,
            facecolor=style.get("color"),
            edgecolor="none",
            zorder=z,
        )

    def curve(self, coos, preset=None, **kwargs):
        """A smooth open curve through the (projected) points."""
        from matplotlib.patches import PathPatch
        from matplotlib.path import Path

        style, z = self._style(preset, kwargs, default=self.drawcolor)
        smoothing = style.pop("smoothing", 0.5)
        style.setdefault("fill", False)
        style.setdefault("capstyle", "round")
        color = style.pop("color", None)
        if color is not None:
            style.setdefault("edgecolor", color)
        pts = []
        zs = []
        for coo in coos:
            (x, y), zp = self._proj(coo)
            pts.append((x, y))
            if zp is not None:
                zs.append(zp)
            self._see(x, y)
        n = len(pts)
        verts, codes = [pts[0]], [Path.MOVETO]
        for i in range(n - 1):
            p0 = pts[max(i - 1, 0)]
            p1, p2 = pts[i], pts[i + 1]
            p3 = pts[min(i + 2, n - 1)]
            t1 = (
                (p2[0] - p0[0]) * smoothing / 3,
                (p2[1] - p0[1]) * smoothing / 3,
            )
            t2 = (
                (p3[0] - p1[0]) * smoothing / 3,
                (p3[1] - p1[1]) * smoothing / 3,
            )
            verts += [
                (p1[0] + t1[0], p1[1] + t1[1]),
                (p2[0] - t2[0], p2[1] - t2[1]),
                p2,
            ]
            codes += [Path.CURVE4, Path.CURVE4, Path.CURVE4]
        patch = PathPatch(Path(verts, codes), **style)
        if z is None and zs:
            z = mean(zs)
        return self._add_patch(patch, z)

    # -- shapes and patches -----------------------------------------

    def shape(self, coos, preset=None, **kwargs):
        """A straight-edged polygon through the (projected) points."""
        import matplotlib.patches as mp

        style, z = self._style(preset, kwargs, default=self.shapecolor)
        closed = style.pop("closed", True)
        style.setdefault("linewidth", 1)
        color = style.pop("color", None)
        if color is not None:
            style.setdefault("facecolor", color)
            style.setdefault("edgecolor", darken_color(color))
        pts = []
        zs = []
        for coo in coos:
            (x, y), zp = self._proj(coo)
            pts.append((x, y))
            if zp is not None:
                zs.append(zp)
            self._see(x, y)
        p = mp.Polygon(pts, closed=closed, **style)
        if z is None and zs:
            z = mean(zs)
        return self._add_patch(p, z)

    def rectangle(self, cooa, coob, preset=None, **kwargs):
        """An axis-aligned rectangle with opposite corners ``cooa`` and
        ``coob`` (with optional ``radius`` rounding)."""
        import matplotlib.patches as mp

        style, z = self._style(preset, kwargs, default=self.shapecolor)
        radius = style.pop("radius", 0.0)
        style.setdefault("linewidth", 1)
        color = style.pop("color", None)
        if color is not None:
            style.setdefault("facecolor", color)
            style.setdefault("edgecolor", darken_color(color))
        (xa, ya), za = self._proj(cooa)
        (xb, yb), zb = self._proj(coob)
        x0, x1 = sorted((xa, xb))
        y0, y1 = sorted((ya, yb))
        if radius:
            p = mp.FancyBboxPatch(
                (x0, y0),
                x1 - x0,
                y1 - y0,
                boxstyle=f"round,pad=0,rounding_size={radius}",
                **style,
            )
        else:
            p = mp.Rectangle((x0, y0), x1 - x0, y1 - y0, **style)
        self._see(x0, y0)
        self._see(x1, y1)
        if z is None and za is not None and zb is not None:
            z = (za + zb) / 2
        return self._add_patch(p, z)

    def patch(self, coos, preset=None, **kwargs):
        """A closed smooth (bezier) patch through the points."""
        from matplotlib.patches import PathPatch

        style, z = self._style(preset, kwargs, default=self.shapecolor)
        smoothing = style.pop("smoothing", 0.5)
        style.setdefault("linewidth", 1)
        color = style.pop("color", None)
        if color is not None:
            style.setdefault("facecolor", color)
            style.setdefault("edgecolor", "none")
        pts = []
        for coo in coos:
            (x, y), _ = self._proj(coo)
            pts.append((x, y))
            self._see(x, y)
        return self._add_patch(
            PathPatch(_smooth_closed_path(pts, smoothing), **style), z
        )

    def patch_around(self, coos, radius=0.5, resolution=12,
                     preset=None, **kwargs):
        """A smooth blob around a set of (projected) points: the convex
        hull of circles of ``radius`` around each."""
        expanded = []
        for coo in coos:
            (x, y), _ = self._proj(coo)
            expanded.extend(
                gen_points_around((x, y), radius, resolution)
            )
        hull = _convex_hull(expanded)
        return self.patch(hull, preset=preset, **kwargs)

    def patch_around_circles(
        self, cooa, ra, coob, rb, padding=0.2, pinch=True,
        preset=None, **kwargs,
    ):
        """A smooth capsule enclosing two circles (as used to highlight
        pairwise contractions), optionally pinched at the waist."""
        (xa, ya), _ = self._proj(cooa)
        (xb, yb), _ = self._proj(coob)
        ang = get_angle((xa, ya), (xb, yb))
        pa = gen_points_around((xa, ya), ra + padding, 16)
        pb = gen_points_around((xb, yb), rb + padding, 16)
        pts = _convex_hull(pa + pb)
        if pinch:
            # pull the two waist points toward the midline
            mx, my = (xa + xb) / 2, (ya + yb) / 2
            perp = ang + math.pi / 2
            pinched = []
            for (x, y) in pts:
                d = abs(
                    (x - mx) * math.cos(ang)
                    + (y - my) * math.sin(ang)
                )
                seg = distance((xa, ya), (xb, yb)) / 2
                if d < 0.3 * seg:
                    w = (
                        (x - mx) * math.cos(perp)
                        + (y - my) * math.sin(perp)
                    )
                    x -= 0.3 * w * math.cos(perp)
                    y -= 0.3 * w * math.sin(perp)
                pinched.append((x, y))
            pts = pinched
        return self.patch(pts, preset=preset, **kwargs)

    def savefig(self, fname, dpi=300, bbox_inches="tight"):
        self.fig.savefig(
            fname, dpi=dpi, bbox_inches=bbox_inches,
            facecolor=self.fig.get_facecolor(),
        )
