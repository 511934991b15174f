"""Windowed-matmul gate execution (the counterpart of
``cotengra_tpu/ops/windowed.py``): a cluster of small-gate absorptions
into one large tensor runs as ONE plain 2-D matmul over a contiguous
window of its stored legs. No custom kernel: ``torch.matmul`` in true
fp32 (TF32 off), as the port's other GEMMs run.

- Every tensor is flat and plane-major ``(2, legs...)`` (split complex).
- A window is a contiguous span ``[i, j)`` of the stored leg order (or
  up to ``MAX_WINDOWS`` disjoint spans) covering a cluster of gate legs;
  its size ``S = prod(sizes[i:j])`` is capped. Untouched legs inside
  the span are carried by identity factors in the operator.
- The dense window operator ``W (S_in, S_out)`` is built from the gate
  tensors (``build_w4``: the gates composed with ``torch.einsum``, then
  expanded to the window by one-hot matmuls and a rest-digit mask) and
  embedded with the plane axis into the real block form ``W2 (2 S_out,
  2 S_in)``.
- ``exec_window`` applies it as ``W2 @ X (2 S_in, M)``. A prefix window
  (the span starts at leg 0) needs no data movement; the other forms
  first rotate the window legs forward with one permuted copy. The
  result stores the window's output legs first.

The planner (``plan_window_chain``, ``plan_rotation``) is the
reference's, decision for decision, so that both packages run the same
schedule. The reference chose this engine for the TPU's tile layout
(relayouts pad up to 64x there, matrix-unit flops are nearly free);
its identity-inflated operator does more flops than the gates it
replaces, so on the card it is an opt-in engine beside the in-place
chains (``gate_mode="window"``).
"""

import numpy as np
import torch

from ..utils.misc import prod

# The window caps are the reference's defaults (its CTG_WIN_* knobs
# unset): they keep the port's plans equal to the reference's, not a
# choice made for the card.
S_MAX = 1024
# absolute cap on the window product: the dense operator is
# 16 * S_in * S_out bytes in float32
S_HARD = 4096
# cap on the output window product (gates can grow the window)
S_OUT_MAX = 4096
# when splitting scattered gate legs into several windows: merge two
# neighbouring windows when the gap between them is at most this big
GAP_MERGE = 8
# merge neighbours unconditionally when the joined span stays this small
JOIN_SMALL = 256
# max disjoint windows in one operator
MAX_WINDOWS = 4
# gates this large go through the ordinary pair path
MAX_GATE_SIZE = 2048
# only large tensors take windows
MIN_TENSOR_SIZE = 2 ** 16
# max gates accumulated into one open chain before it closes
MAX_CHAIN_GATES = 16
# max gates composed into one cluster operator
MAX_CLUSTER_GATES = 8


class WindowRec:
    """One planned windowed-matmul step (a cluster of gates)."""

    __slots__ = (
        "x_id", "out_id",
        "gates",          # tuple of (y_id, y_plan, K, N)
        "recipe",         # static compose/expand program (_build_recipe)
        "form",           # "prefix" | "suffix" | "interior" | "multi"
        "A1", "S_in", "A2", "S_out",
        "xdims",          # non-prefix: full reshape dims (A0, S1, A1, ...)
        "sdims",          # non-prefix: window dim indices, in span order
        "rdims",          # non-prefix: rest dim indices in RESULT order
        "out_order",      # stored order of the result (no plane)
        "out_shape",      # logical shape of the result
        "w2_id",          # the reference's hoisted-operator id: always
                          # None here (the port's executor hoists)
    )


def _substitute(win_axes, win_dims, c_legs, ny_legs, sizes):
    """Replace ``c_legs`` in the window by ``ny_legs`` (all ny at the
    first contracted position). Returns new (axes, dims)."""
    cset = set(c_legs)
    first = min(i for i, a in enumerate(win_axes) if a in cset)
    axes, dims = [], []
    for i, (a, d) in enumerate(zip(win_axes, win_dims)):
        if i == first:
            axes.extend(ny_legs)
            dims.extend(sizes[n] for n in ny_legs)
        if a in cset:
            continue
        axes.append(a)
        dims.append(d)
    return axes, dims


# the subscripts torch.einsum takes; a cluster needing more letters is
# rejected at planning time (_LetterOverflow), as in the reference
_LETTERS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


class _LetterOverflow(Exception):
    pass


def _build_recipe(win_axes0, win_dims0, cluster, sizes):
    """Static program for composing the cluster's gates in their joint
    small space and expanding to the window.

    Returns ``(recipe, win_axes_out, win_dims_out)`` or ``(None, why,
    None)``. ``recipe`` is a dict consumed by :func:`build_w4`:

    - ``apply``: list of per-gate ``(j_sub, y_sub, out_sub, k_dims,
      n_dims)`` einsum fragments composing the joint operator ``J``
      (axes = original-in axes then current-out axes);
    - ``expand``: the index arrays of the expansion to the full window
      (``_index_arrays``) and the joint operator's in and out sizes;
    - ``S_in``, ``S_out``.
    """
    j_in = []      # axis names
    j_cur = []
    letter_of = {}
    counter = [0]

    def fresh():
        if counter[0] >= len(_LETTERS):
            raise _LetterOverflow()
        ch = _LETTERS[counter[0]]
        counter[0] += 1
        return ch

    apply_prog = []
    for (y_id, y_plan, c_legs, ny_legs, k_dims, n_dims) in cluster:
        j_sub = "".join(
            letter_of[a] for a in j_in
        ) + "".join(letter_of[a] for a in j_cur)
        y_letters = []
        new_in = []
        contracted = []
        for a in c_legs:
            if a in j_cur:
                y_letters.append(letter_of[a])
                contracted.append(a)
            else:
                # a brand-new original axis: its letter becomes a new J
                # input axis
                ch = fresh()
                letter_of[a] = ch
                y_letters.append(ch)
                new_in.append(a)
        n_letters = []
        for a in ny_legs:
            ch = fresh()
            letter_of[a] = ch
            n_letters.append(ch)
        y_sub = "".join(y_letters) + "".join(n_letters)
        j_in = j_in + new_in
        j_cur = [a for a in j_cur if a not in set(contracted)] + list(
            ny_legs
        )
        out_sub = "".join(letter_of[a] for a in j_in) + "".join(
            letter_of[a] for a in j_cur
        )
        if len(set(out_sub)) != len(out_sub):
            return None, "duplicate joint axis", None
        apply_prog.append((j_sub, y_sub, out_sub, k_dims, n_dims))

    # window substitution gives the output axis order
    win_axes, win_dims = list(win_axes0), list(win_dims0)
    for (y_id, y_plan, c_legs, ny_legs, k_dims, n_dims) in cluster:
        win_axes, win_dims = _substitute(
            win_axes, win_dims, c_legs, ny_legs, sizes
        )

    # the expansion to the full window runs as one-hot matmuls and a
    # rest-digit equality mask (build_w4); its index arrays are static
    rest_axes = [a for a in win_axes0 if a not in set(j_in)]
    if any(a not in win_axes for a in rest_axes):
        return None, "untouched axis vanished", None
    idx_in, rest_in = _index_arrays(
        list(win_axes0), list(win_dims0), j_in, rest_axes, sizes
    )
    idx_out, rest_out = _index_arrays(
        list(win_axes), list(win_dims), j_cur, rest_axes, sizes
    )
    kj = prod(sizes[a] for a in j_in) if j_in else 1
    nj = prod(sizes[a] for a in j_cur) if j_cur else 1
    recipe = {
        "apply": apply_prog,
        "expand": {
            "idx_in": idx_in,
            "rest_in": rest_in,
            "idx_out": idx_out,
            "rest_out": rest_out,
            "kj": kj,
            "nj": nj,
        },
        "S_in": prod(win_dims0) if win_dims0 else 1,
        "S_out": prod(win_dims) if win_dims else 1,
    }
    return recipe, win_axes, win_dims


def _index_arrays(axes, dims, j_axes, rest_axes, sizes):
    """For each flat index over ``(axes, dims)`` (row-major): the flat
    joint-operator index (mixed radix over ``j_axes`` in that order)
    and the flat rest key (mixed radix over ``rest_axes``)."""
    S = prod(dims) if dims else 1
    strides = {}
    s = 1
    for a, d in zip(reversed(axes), reversed(dims)):
        strides[a] = s
        s *= d
    i = np.arange(S, dtype=np.int64)
    jv = np.zeros(S, np.int64)
    for a in j_axes:
        d = sizes[a]
        jv = jv * d + (i // strides[a]) % d
    rv = np.zeros(S, np.int64)
    for a in rest_axes:
        d = sizes[a]
        rv = rv * d + (i // strides[a]) % d
    return jv.astype(np.int32), rv.astype(np.int32)


EXPAND_INDEX = ("rest_in", "rest_out", "idx_in", "idx_out")


def expand_index(recipe, device):
    """The index arrays of ``recipe["expand"]`` as tensors on
    ``device``, for ``build_w4(..., index=)``: copied there once, ahead
    of a CUDA graph capture, which refuses copies from pageable host
    memory."""
    ex = recipe["expand"]
    return {
        name: torch.as_tensor(ex[name], device=device)
        for name in EXPAND_INDEX if name in ex
    }


def build_w4(recipe, ys, dtype, device=None, index=None):
    """Build the block-embedded window operator.

    ``ys``: per-gate ``(2, K, N)`` plane tensors (K enumerates the
    gate's contracted legs, N its new legs), all on one device, or
    ``(S, 2, K, N)`` with a leading slice dim (one gate per slice of a
    batch). Returns ``W2 (2 * S_out, 2 * S_in)`` of ``dtype`` (``(S, 2 *
    S_out, 2 * S_in)`` where a gate has the slice dim): ``[[Wr^T,
    -Wi^T], [Wi^T, Wr^T]]``, the real form of the complex ``W (S_in,
    S_out)``. A rotation (no gates) builds on ``device``. ``index``
    (``expand_index``) holds the expansion's index arrays already on
    the device; without it they are copied there at each build.
    """
    # compose in float64 under float64 planes, else in float32: the
    # operator is small, so full precision here costs nothing
    cdt = torch.float64 if dtype == torch.float64 else torch.float32
    index_on_device = index
    jr = ji = None
    for (j_sub, y_sub, out_sub, k_dims, n_dims), y in zip(
        recipe["apply"], ys
    ):
        device = y.device
        shape = tuple(y.shape[:-3]) + tuple(k_dims) + tuple(n_dims)
        y4r = y.select(-3, 0).reshape(shape).to(cdt)
        y4i = y.select(-3, 1).reshape(shape).to(cdt)
        if jr is None:
            # the first gate: J = y (j_sub is empty)
            jr, ji = y4r, y4i
            continue
        # "..." carries a batch's slice dim, on either operand
        eq = f"...{j_sub},...{y_sub}->...{out_sub}"
        nr = torch.einsum(eq, jr, y4r) - torch.einsum(eq, ji, y4i)
        ni = torch.einsum(eq, jr, y4i) + torch.einsum(eq, ji, y4r)
        jr, ji = nr, ni
    ex = recipe["expand"]

    def index(name):
        if index_on_device is not None:
            return index_on_device[name]
        return torch.as_tensor(ex[name], device=device)

    rest_in, rest_out = index("rest_in"), index("rest_out")
    # rest-digit equality mask: W[i, o] is nonzero only where the
    # untouched window axes agree
    mask = (rest_in[:, None] == rest_out[None, :]).to(cdt)
    if jr is None:
        # a pure rotation (no gates): the mask IS the permuted identity
        wr, wi = mask, None
    else:
        kj, nj = ex["kj"], ex["nj"]
        lead = tuple(jr.shape[: jr.dim() - len(
            recipe["apply"][-1][2]
        )])
        jr2 = jr.reshape(lead + (kj, nj))
        ji2 = ji.reshape(lead + (kj, nj))
        # expand J to the window with one-hot matmuls (exact: one unit
        # term per sum)
        oh_in = (
            torch.arange(kj, dtype=torch.int32, device=device)[None, :]
            == index("idx_in")[:, None]
        ).to(cdt)  # (S_in, kj)
        oh_out = (
            torch.arange(nj, dtype=torch.int32, device=device)[None, :]
            == index("idx_out")[:, None]
        ).to(cdt)  # (S_out, nj)
        wr = (oh_in @ (jr2 @ oh_out.T)) * mask
        wi = (oh_in @ (ji2 @ oh_out.T)) * mask
    if wi is None:
        z = torch.zeros_like(wr)
        top = torch.cat([wr.mT, z], dim=-1)
        bot = torch.cat([z, wr.mT], dim=-1)
    else:
        top = torch.cat([wr.mT, -wi.mT], dim=-1)
        bot = torch.cat([wi.mT, wr.mT], dim=-1)
    return torch.cat([top, bot], dim=-2).to(dtype)


def exec_window(rec, xf, w2):
    """Run one window step: ``xf`` is the plane-major flat input
    (``(2 * numel,)``, or a batch's ``(S, 2 * numel)`` rows) and ``w2``
    its operator from :func:`build_w4` (``(2 * S_out, 2 * S_in)``, or
    ``(S, ...)`` for a batch). Returns the flat result in
    ``rec.out_order``, batched where either operand was.

    Every form is ONE matmul ``(2 S_out, 2 S_in) @ (2 S_in, M)`` (a
    batched or broadcast one over a batch's slices); a non-prefix form
    first rotates the window legs forward with one permuted copy
    (``grouped.permute_copy``, split beyond ``MAX_COPY_DIMS``).
    """
    # imported here: grouped.py imports this module
    from .grouped import permute_copy

    lead = tuple(xf.shape[:-1])
    S_in, S_out = rec.S_in, rec.S_out
    M = xf.shape[-1] // (2 * S_in)
    if rec.form == "prefix":
        x2 = xf.view(lead + (2 * S_in, M))
    else:
        # The reference 128-splits the copy's trailing dims here
        # (cotengra_tpu/ops/windowed.py:375-403), for the TPU's (8, 128)
        # tiles; a GPU copy needs no such split.
        nl = len(lead)
        perm = (
            tuple(range(nl + 1))
            + tuple(nl + 1 + i for i in rec.sdims)
            + tuple(nl + 1 + i for i in rec.rdims)
        )
        x2 = permute_copy(
            xf.view(lead + (2,) + tuple(rec.xdims)), perm
        ).view(lead + (2 * S_in, M))
    if w2.dim() == 2 and x2.dim() == 2:
        return (w2 @ x2).view(-1)
    # a batch: one batched GEMM, the unbatched operand broadcast by a
    # zero slice stride
    nb = max(w2.shape[0] if w2.dim() == 3 else 1, x2.shape[0]
             if x2.dim() == 3 else 1)
    if w2.dim() == 2:
        w2 = w2.expand(nb, -1, -1)
    if x2.dim() == 2:
        x2 = x2.expand(nb, -1, -1)
    return torch.bmm(w2, x2).view(nb, -1)


def _choose_windows(pos_set, cur_order, sizes):
    """Partition the gate-axis positions into <= MAX_WINDOWS disjoint
    contiguous spans, extended/merged under the size caps.

    Returns ``(spans, total_S)`` with ``spans`` a list of ``(lo, hi)``
    in ascending order, or ``(None, reason)``.
    """

    def span_prod(lo, hi):
        return prod(sizes[a] for a in cur_order[lo:hi])

    pos = sorted(pos_set)
    # initial spans: one per position, then merge near neighbours, only
    # while the TOTAL window product stays within the cap
    spans = [[p, p + 1] for p in pos]

    def total_of(sp):
        return prod(span_prod(lo, hi) for lo, hi in sp)

    total = total_of(spans)
    merged = True
    while merged:
        merged = False
        for i in range(len(spans) - 1):
            gap = span_prod(spans[i][1], spans[i + 1][0])
            joined = span_prod(spans[i][0], spans[i + 1][1])
            new_total = (
                total
                // span_prod(*spans[i])
                // span_prod(*spans[i + 1])
                * joined
            )
            if new_total <= S_HARD and (
                joined <= JOIN_SMALL
                or (gap <= GAP_MERGE and joined <= S_MAX)
            ):
                spans[i][1] = spans[i + 1][1]
                del spans[i + 1]
                total = new_total
                merged = True
                break
    # enforce the window-count cap by merging the smallest joins
    while len(spans) > MAX_WINDOWS:
        best, bi = None, None
        for i in range(len(spans) - 1):
            joined = span_prod(spans[i][0], spans[i + 1][1])
            if best is None or joined < best:
                best, bi = joined, i
        total = (
            total
            // span_prod(*spans[bi])
            // span_prod(*spans[bi + 1])
            * best
        )
        spans[bi][1] = spans[bi + 1][1]
        del spans[bi + 1]
    if total > S_HARD:
        return None, "window product too large"
    return [tuple(s) for s in spans], total


def _select_form(spans, cur_order, sizes):
    """Pick the cheapest feasible execution form for a window span set.

    Non-prefix forms add one permuted copy; the quadratic term charges
    for building and reading the dense operator. The weights are the
    reference's, measured on the TPU: kept so that the plans agree.

    Returns ``(form, spans_f, cost)`` or None.
    """
    n_ax = len(cur_order)

    def win_prod(lo, hi):
        return prod(sizes[a] for a in cur_order[lo:hi])

    def op_cost(s):
        return 0.5 * s / 1024 + 0.7 * (s / 1024) ** 2

    span_lo, span_hi = spans[0][0], spans[-1][1]
    candidates = []
    # prefix: [0, span_hi) - no copy
    s_pre = win_prod(0, span_hi)
    if s_pre <= S_HARD:
        candidates.append(
            ("prefix", [(0, span_hi)], 3.2 + op_cost(s_pre))
        )
    # windowed (copy + matmul): the chosen spans as they are
    s_tot = prod(win_prod(lo, hi) for lo, hi in spans)
    if s_tot <= S_HARD:
        if len(spans) > 1:
            form = "multi"
        elif span_hi == n_ax:
            form = "suffix"
        elif span_lo == 0:
            form = "prefix"
        else:
            form = "interior"
        if form != "prefix":
            candidates.append(
                (form, [tuple(s) for s in spans],
                 6.8 + op_cost(s_tot))
            )
    if not candidates:
        return None
    return min(candidates, key=lambda c: c[2])


def _fill_rec_dims(rec, form, spans_f, cur_order, sizes):
    """Fill the execution-shape fields of ``rec`` for its form.

    Returns the non-window ("rest") axes in the RESULT storage order:
    their current order for the prefix form, else the rest segments
    ascending by size (the reference's choice for the TPU's tiles, kept
    so that the stored orders agree).
    """
    n_ax = len(cur_order)

    def win_prod(lo, hi):
        return prod(sizes[a] for a in cur_order[lo:hi])

    rec.xdims = rec.sdims = rec.rdims = None
    rec.A1 = rec.A2 = None
    if form == "prefix":
        rec.A1 = 1
        rec.A2 = win_prod(spans_f[0][1], n_ax)
        return list(cur_order[spans_f[0][1]:])
    # alternating dims (A0, S1, A1, S2, ..., [Alast]) with size-1
    # A segments dropped; sdims = window dim indices
    xdims = []
    sidx = []
    segs = {}  # rest xdims index -> axes of that segment
    loose = []  # size-1 axes dropped from xdims (position-free)
    prev = 0
    for lo, hi in spans_f:
        a = win_prod(prev, lo)
        if a != 1 or not xdims:
            segs[len(xdims)] = cur_order[prev:lo]
            xdims.append(a)
        else:
            loose.extend(cur_order[prev:lo])
        sidx.append(len(xdims))
        xdims.append(win_prod(lo, hi))
        prev = hi
    a = win_prod(prev, n_ax)
    if a != 1:
        segs[len(xdims)] = cur_order[prev:n_ax]
        xdims.append(a)
    else:
        loose.extend(cur_order[prev:n_ax])
    rec.xdims = tuple(xdims)
    rec.sdims = tuple(sidx)
    sset = set(sidx)
    rdims = sorted(
        (i for i in range(len(xdims)) if i not in sset),
        key=lambda i: xdims[i],
    )
    rec.rdims = tuple(rdims)
    rest = [a for i in rdims for a in segs.get(i, ())]
    rest.extend(loose)
    return rest


def plan_rotation(order, sizes, axes, out_id):
    """Plan a pure-identity window step moving (the deepest subset of)
    ``axes`` to the front of the stored order, used when a gate's axes
    are too scattered to window directly. Returns ``(rec, None)`` or
    ``(None, why)``.
    """
    order = list(order)
    pos_all = sorted({order.index(a) for a in axes if a in order})
    if not pos_all:
        return None, "no axes to rotate"
    for k in range(len(pos_all)):
        subset = set(pos_all[k:])
        spans, _why = _choose_windows(subset, order, sizes)
        if spans is None:
            continue
        if spans[0][0] == 0 and len(spans) == 1:
            return None, "axes already front"
        sel = _select_form(spans, order, sizes)
        if sel is None:
            continue
        form, spans_f, _cost = sel
        win_axes0 = tuple(
            a for lo, hi in spans_f for a in order[lo:hi]
        )
        win_dims0 = tuple(sizes[a] for a in win_axes0)
        S = prod(win_dims0)
        # identity operator: _build_recipe with no gates gives a pure
        # rest-mask (permuted identity) in build_w4
        recipe, _wao, _wdo = _build_recipe(
            win_axes0, win_dims0, [], sizes
        )
        if recipe is None:
            continue
        rec = WindowRec()
        rec.x_id = None
        rec.out_id = out_id
        rec.w2_id = None
        rec.gates = ()
        rec.recipe = recipe
        rec.form = form
        rec.S_in = rec.S_out = S
        rest = _fill_rec_dims(rec, form, spans_f, order, sizes)
        out_order = list(win_axes0) + rest
        rec.out_order = tuple(out_order)
        rec.out_shape = tuple(sizes[a] for a in out_order)
        return rec, None
    return None, "no feasible rotation"


def plan_window_chain(order0, sizes, gates):
    """Plan a chain of gate absorptions as windowed-matmul clusters.

    Parameters
    ----------
    order0 : tuple
        Stored axis order of the big tensor at chain start (no plane).
    sizes : dict
    gates : list of (y_id, y_plan, c_legs, ny_legs, step_out)
        In application order; ``y_plan`` realigns the gate to
        ``(2, K, N)`` with K enumerating ``c_legs``, N ``ny_legs``.

    Returns
    -------
    (list[WindowRec], None) or (None, reason)
    """
    cur_order = list(order0)
    pending = list(gates)
    recs = []

    while pending:
        # grow a cluster from pending[0]
        cluster = []
        taken = 0
        involved = set()
        pos_set = set()
        spans = None
        span_total = 1
        # running output-window product: span_total grown by each
        # gate's ny/c dim ratio (exact: substitution is in-window)
        out_num, out_den = 1, 1
        for (y_id, y_plan, c_legs, ny_legs, step_out) in pending:
            if taken >= MAX_CLUSTER_GATES:
                break
            # axes created by earlier gates in THIS cluster substitute
            # in place; only real current axes contribute positions
            pos = [
                cur_order.index(a) for a in c_legs if a in cur_order
            ]
            missing = [
                a for a in c_legs
                if a not in cur_order and a not in involved
            ]
            if missing:
                return None, f"gate axis missing from order: {missing}"
            cand = pos_set | set(pos)
            if not cand:
                # the gate acts only on axes created inside the cluster
                new_spans, new_total = spans, span_total
            else:
                new_spans, new_total = _choose_windows(
                    cand, cur_order, sizes
                )
                if new_spans is None:
                    if taken:
                        break
                    return None, new_total
            k_dims = tuple(sizes[a] for a in c_legs)
            n_dims = tuple(sizes[a] for a in ny_legs)
            nn = out_num * (prod(n_dims) or 1)
            nd = out_den * (prod(k_dims) or 1)
            # prospective S_out = new_total * nn / nd (exact division)
            if new_total * nn > S_OUT_MAX * nd:
                if taken:
                    break
                return None, "gate expands window beyond S_OUT_MAX"
            spans, span_total = new_spans, new_total
            out_num, out_den = nn, nd
            pos_set = cand
            involved |= set(c_legs) | set(ny_legs)
            cluster.append(
                (y_id, y_plan, tuple(c_legs), tuple(ny_legs),
                 k_dims, n_dims)
            )
            taken += 1
        cluster_steps = pending[:taken]
        pending = pending[taken:]
        if spans is None:
            return None, "cluster without window positions"

        sel = _select_form(spans, cur_order, sizes)
        if sel is None:
            return None, "no feasible window form"
        form, spans_f, _cost = sel

        # the operator recipe over the concatenated spans
        win_axes0 = tuple(
            a for lo, hi in spans_f for a in cur_order[lo:hi]
        )
        win_dims0 = tuple(sizes[a] for a in win_axes0)
        try:
            recipe, win_axes_out, win_dims_out = _build_recipe(
                win_axes0, win_dims0, cluster, sizes
            )
        except _LetterOverflow:
            return None, "einsum letters exhausted"
        if recipe is None:
            return None, win_axes_out
        S_in = prod(win_dims0) if win_dims0 else 1
        S_out = recipe["S_out"]
        if S_out > S_OUT_MAX:
            # must match the growth-loop estimate; defensive only
            return None, "recipe output window exceeds S_OUT_MAX"

        rec = WindowRec()
        rec.w2_id = None
        # chain: cluster k consumes cluster k-1's output; the caller
        # fills in the first cluster's x (the chain's base tensor)
        rec.x_id = recs[-1].out_id if recs else None
        rec.gates = tuple(
            (y_id, y_plan, prod(k_dims) or 1, prod(n_dims) or 1)
            for (y_id, y_plan, c, nyl, k_dims, n_dims) in cluster
        )
        rec.recipe = recipe
        rec.form = form
        rec.S_in, rec.S_out = S_in, S_out
        rest = _fill_rec_dims(rec, form, spans_f, cur_order, sizes)

        # result order: window-out axes first, then the rest segments
        out_order = list(win_axes_out) + rest
        rec.out_id = cluster_steps[-1][4]
        rec.out_order = tuple(out_order)
        rec.out_shape = tuple(sizes[a] for a in out_order)
        recs.append(rec)
        cur_order = out_order

    return recs, None
