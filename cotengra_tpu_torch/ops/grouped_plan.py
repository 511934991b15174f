"""Host-side planning of the grouped split-complex executor.

``plan_grouped`` makes the same decisions as
``cotengra_tpu/ops/grouped.py::plan_grouped`` for every gate mode: the
same stored orders, step kinds, pair modes, scattered layouts, in-place
gate chains (``"inplace"``), window chains (``"window"``), fused kron
chains (``fuse_gates``) and, behind ``_LAYOUT_LOOKAHEAD``, the one-step
layout lookahead, so both packages run the same schedule. Where a
decision was made for the TPU (the caps, ``_plan_badness``, the 2^14 cut
of the all-small fallback), it is kept so that the plans agree.

Every intermediate is stored flat, with its logical leg order tracked
here; a change of order is a block transpose over maximal runs of legs
that stay together (``_block_plan``), so no step works at full rank.
"""

from ..utils.misc import prod
from .gate_chains import MAX_CHAIN_GATES, build_chain_spec
from .lowering import SingleStep
from .windowed import MAX_CHAIN_GATES as W_MAX_CHAIN
from .windowed import MAX_GATE_SIZE as W_MAX_GATE
from .windowed import MIN_TENSOR_SIZE as W_MIN_TENSOR
from .windowed import plan_rotation, plan_window_chain


def _block_plan(cur, tgt, sizes):
    """Plan a block transpose taking stored order ``cur`` to ``tgt``.

    Returns ``(block_dims, perm)``: reshape the flat tensor to
    ``block_dims`` (contiguous runs of ``cur``), apply ``perm``, and the
    result is contiguous in ``tgt`` order. Returns ``None`` if
    cur == tgt.
    """
    cur = tuple(cur)
    tgt = tuple(tgt)
    if cur == tgt:
        return None
    pos = {ix: i for i, ix in enumerate(cur)}
    # greedy maximal runs: walk tgt, extend while consecutive in cur
    blocks = []  # (cur_start, length)
    i = 0
    n = len(tgt)
    while i < n:
        start = pos[tgt[i]]
        length = 1
        while (
            i + length < n and pos[tgt[i + length]] == start + length
        ):
            length += 1
        blocks.append((start, length))
        i += length
    order = sorted(range(len(blocks)), key=lambda b: blocks[b][0])
    block_dims = tuple(
        prod(sizes[cur[blocks[b][0] + k]] for k in range(blocks[b][1]))
        for b in order
    )
    rank_of = {b: r for r, b in enumerate(order)}
    perm = tuple(rank_of[b] for b in range(len(blocks)))
    return block_dims, perm


class _GroupedPair:
    """Precomputed plan for one pairwise step.

    Modes (B = batch, K = contracted, N = gate-side free size):

    - "mac":    B==1, K<8  -> unrolled sum of plane MACs
    - "matvec": B==1, K>=8, N<8 -> per-column matvecs
    - "mm":     B==1, K>=8, N>=8 -> (N,K)@(K,M)
    - "bmm":    B>1 -> batched matmul
    """

    __slots__ = (
        "x_id", "y_id", "out_id",
        "x_plan", "y_plan",
        "mode",
        "x_layout",  # "cm" -> (K, M); "mc" -> (M, K); "scat" -> stored
        "B", "M", "K", "N",
        "out_order",
        # no-realign scattered dot: (view_dims, kpos) over the stored
        # x order (see _scatter_layout)
        "scatter",
        # recorded for gate-chain formation
        "c_legs", "ny_legs", "m_legs", "b_legs", "y_size",
    )


class _FusedChain:
    """A run of consecutive small-gate absorptions into one evolving
    tensor (``fuse_gates``), run as one step: the gates' kron product
    (small) applied with one small-y product, instead of one sweep of
    the large tensor per gate."""

    __slots__ = (
        "x_id", "x_src_order",
        "gates",      # list of (gate_id, gate_order, c_legs, n_legs)
        "m_rest",
        "out_id", "out_order",
        "x_plan", "x_layout",
        "M", "K", "N",
    )

    def refresh(self, sizes, plan_badness_fn):
        """Recompute layout and plan after the gates changed."""
        c_all = tuple(
            ix for (_, _, cl, _) in self.gates for ix in cl
        )
        n_all = tuple(
            ix for (_, _, _, nl) in self.gates for ix in nl
        )
        self.K = prod(sizes[ix] for ix in c_all)
        self.N = prod(sizes[ix] for ix in n_all)
        self.M = prod(sizes[ix] for ix in self.m_rest)
        self.out_order = n_all + tuple(self.m_rest)
        # the layout choice mirrors the pair's
        cand = []
        plan_cm = _block_plan(
            self.x_src_order, c_all + tuple(self.m_rest), sizes
        )
        cand.append(
            ("cm", plan_cm, plan_badness_fn(plan_cm, self.M * self.K))
        )
        if self.K % 128 == 0 or self.K < 8:
            plan_mc = _block_plan(
                self.x_src_order, tuple(self.m_rest) + c_all, sizes
            )
            cand.append(
                ("mc", plan_mc,
                 plan_badness_fn(plan_mc, self.M * self.K))
            )
        cand.sort(key=lambda t: t[2])
        self.x_layout, self.x_plan = cand[0][0], cand[0][1]


def _plan_badness(plan, total):
    """Padding proxy of a block plan for big buffers: how far the minor
    block of the source or the transposed copy falls short of 128."""
    if plan is None:
        return (1, 0)
    block_dims, perm = plan
    minor_in = block_dims[-1]
    minor_out = block_dims[perm[-1]]
    waste = max(1, 128 // max(min(minor_in, minor_out), 1))
    return (waste if total >= 2**16 else 1, len(perm))


class _InplaceRec:
    """A planned in-place gate chain (one ``run_chain`` call)."""

    __slots__ = ("x_id", "out_id", "spec", "ys", "out_order",
                 "out_shape")


# in-place chains take gates up to this many elements; the chain's own
# MAX_GATE_COMBOS bounds K*N per gate
INPLACE_MAX_GATE_SIZE = 2048

# per-chain cap on the summed K*N sweeps (effectively off, as in the
# reference default)
INPLACE_MAX_COMBO_SUM = 1000000

# fused kron chains: at most this many gates, a joint K of at most this,
# gates of at most this many elements (the reference's)
MAX_FUSED_GATES = 4
MAX_FUSED_K = 64
MAX_GATE_SIZE = 256

# the one-step layout lookahead of plan_grouped: off, as the reference's
# CTG_LAYOUT_LOOKAHEAD default (an opt-in research knob there: its
# badness proxy trades block-transpose granularity only)
_LAYOUT_LOOKAHEAD = False

# scattered pair dot (no x realign): engaged from this operand size, for
# stored views of at most this rank whose trailing dims are at least
# this wide - the reference's defaults, kept so the plans agree
_SCATTER_MIN = 2**20
_SCATTER_MAX_RANK = 11
_SCATTER_MIN_TRAIL = 16


def _chain_combo_sum(spec):
    """Summed K*N sweep count of a chain spec."""
    total = 0
    for g in spec.gates:
        _, _, kdims_dim, ny_dims_dim, _, roll_axes = g[:6]
        nroll = prod([kk for _, _, kk in roll_axes] or [1])
        total += (
            prod(kdims_dim or (1,))
            * prod(ny_dims_dim or (1,))
            * nroll
            * nroll
        )
    return total


def _scatter_layout(x_order, c_set, sizes):
    """Stored-view layout for a no-realign scattered pair dot.

    Merges adjacent same-class (contracted K vs free M) runs of the
    stored x order into view dims and returns ``(block_dims, kpos,
    m_stored, c_stored)``; the output carries the M legs in stored
    order. Returns None for views of too high rank or with a narrow
    trailing dim.
    """
    dims, isk, runs = [], [], []
    for ix in x_order:
        k = ix in c_set
        if isk and isk[-1] == k:
            dims[-1] *= sizes[ix]
            runs[-1].append(ix)
        else:
            dims.append(sizes[ix])
            isk.append(k)
            runs.append([ix])
    if len(dims) < 2 or len(dims) > _SCATTER_MAX_RANK:
        return None
    if not any(isk) or all(isk):
        return None
    mdims = [d for d, k in zip(dims, isk) if not k]
    if dims[-1] < _SCATTER_MIN_TRAIL or mdims[-1] < _SCATTER_MIN_TRAIL:
        return None
    kpos = tuple(i for i, k in enumerate(isk) if k)
    m_stored = tuple(
        ix for run, k in zip(runs, isk) if not k for ix in run
    )
    c_stored = tuple(
        ix for run, k in zip(runs, isk) if k for ix in run
    )
    return tuple(dims), kpos, m_stored, c_stored


def plan_grouped(ir, size_dict, input_orders, gate_mode=None,
                 fuse_gates=False):
    """Host-side symbolic pass: stored orders + per-step plans.

    ``gate_mode="inplace"`` lowers runs of small-gate absorptions into
    one evolving tensor to in-place gate chains (``gate_chains.py``);
    ``"window"`` to windowed-matmul clusters (``windowed.py``); ``None``
    (or any other value, as in the reference) plans pairs only.
    ``fuse_gates=True`` merges consecutive small-gate absorptions that
    neither engine took into fused kron-chain steps.

    Returns ``(plans, storage, out_plan, out_shape, plan_last_use)``.
    """
    # fresh ssa ids for planner-made intermediates (rotations)
    aux_ids = [ir.num_inputs + len(ir.steps) + 1]

    steps = ir.steps
    final_id = ir.final_id
    sizes = dict(size_dict)

    storage = {}
    for i, order in enumerate(input_orders):
        storage[i] = tuple(order)

    plans = []

    # open in-place chain state:
    # dict(x_id, order0, gates[(c, ny)], y_ids, y_orders, out_id, spec,
    #      out_order, c_orders)
    chain = None

    # open window-chain state (gate_mode == "window"):
    # dict(x_id, order0, gates[(y_id, y_plan, c, ny, step_out)], recs,
    #      out_id)
    wchain = None

    def close_window_chain():
        nonlocal wchain
        if wchain is None:
            return
        recs = wchain["recs"]
        recs[0].x_id = wchain["x_id"]
        for rec in recs:
            plans.append(("window", rec))
            storage[rec.out_id] = rec.out_order
        wchain = None

    def try_window(p, step, si):
        """Extend / start a window chain with pair ``p``. Returns True
        if the step was absorbed."""
        nonlocal wchain
        if (
            p.B != 1
            or p.b_legs
            or p.y_size > W_MAX_GATE
            or p.M * p.K < W_MIN_TENSOR
            or not p.c_legs
        ):
            return False
        y_order = storage[p.y_id]
        y_plan = _block_plan(
            y_order, tuple(p.c_legs) + tuple(p.ny_legs), sizes
        )
        g = (
            p.y_id, y_plan, tuple(p.c_legs), tuple(p.ny_legs), step.out
        )
        if (
            wchain is not None
            and wchain["out_id"] == p.x_id
            and ir.last_use.get(p.x_id) == si
            and len(wchain["gates"]) < W_MAX_CHAIN
        ):
            gates2 = wchain["gates"] + [g]
            recs, _why = plan_window_chain(
                wchain["order0"], sizes, gates2
            )
            if recs is not None:
                wchain["gates"] = gates2
                wchain["recs"] = recs
                wchain["out_id"] = step.out
                storage[step.out] = recs[-1].out_order
                return True
        close_window_chain()
        order0 = storage[p.x_id]
        recs, _why = plan_window_chain(order0, sizes, [g])
        base_id = p.x_id
        if recs is None and p.M * p.K >= 2 ** 16:
            # gate axes too scattered: pre-rotate the deep axes to the
            # front with a pure-identity window step, then retry
            rot, _rwhy = plan_rotation(
                order0, sizes, p.c_legs, aux_ids[0]
            )
            if rot is not None:
                recs2, _why2 = plan_window_chain(
                    rot.out_order, sizes, [g]
                )
                if recs2 is not None:
                    aux_ids[0] += 1
                    rot.x_id = p.x_id
                    plans.append(("window", rot))
                    storage[rot.out_id] = rot.out_order
                    base_id = rot.out_id
                    order0 = rot.out_order
                    recs = recs2
        if recs is None:
            return False
        wchain = {
            "x_id": base_id,
            "order0": order0,
            "gates": [g],
            "recs": recs,
            "out_id": step.out,
        }
        storage[step.out] = recs[-1].out_order
        return True

    def close_chain():
        nonlocal chain
        close_window_chain()
        if chain is None:
            return
        recs = []
        for y_id, y_order, (c_order, ny_order) in zip(
            chain["y_ids"], chain["y_orders"], chain["c_orders"]
        ):
            y_req = tuple(c_order) + tuple(ny_order)
            recs.append(
                (
                    y_id,
                    _block_plan(y_order, y_req, sizes),
                    max(1, prod(sizes[ix] for ix in c_order)),
                    max(1, prod(sizes[ix] for ix in ny_order)),
                )
            )
        rec = _InplaceRec()
        rec.x_id = chain["x_id"]
        rec.out_id = chain["out_id"]
        rec.spec = chain["spec"]
        rec.ys = tuple(recs)
        rec.out_order = chain["out_order"]
        rec.out_shape = tuple(sizes[ix] for ix in chain["out_order"])
        plans.append(("inplace", rec))
        storage[rec.out_id] = rec.out_order
        chain = None

    def try_inplace(p, step, si):
        """Extend / start an in-place chain with pair ``p``. Returns
        True if the step was absorbed."""
        nonlocal chain
        if (
            p.B != 1
            or p.b_legs
            or p.y_size > INPLACE_MAX_GATE_SIZE
            or p.M * p.K < 2**16
            or not p.c_legs
        ):
            return False
        g = (tuple(p.c_legs), tuple(p.ny_legs))
        y_order = storage[p.y_id]
        if (
            chain is not None
            and chain["out_id"] == p.x_id
            and ir.last_use.get(p.x_id) == si
            and len(chain["gates"]) < MAX_CHAIN_GATES
        ):
            gates2 = chain["gates"] + [g]
            spec, out_order, c_orders = build_chain_spec(
                chain["order0"], sizes, gates2
            )
            if spec is not None and _chain_combo_sum(spec) > (
                INPLACE_MAX_COMBO_SUM
            ):
                spec = None
            if spec is not None:
                chain["gates"] = gates2
                chain["y_ids"].append(p.y_id)
                chain["y_orders"].append(y_order)
                chain["out_id"] = step.out
                chain["spec"] = spec
                chain["out_order"] = out_order
                chain["c_orders"] = c_orders
                storage[step.out] = out_order
                return True
        close_chain()
        order0 = storage[p.x_id]
        spec, out_order, c_orders = build_chain_spec(
            order0, sizes, [g]
        )
        if spec is None:
            return False
        chain = {
            "x_id": p.x_id,
            "order0": order0,
            "gates": [g],
            "y_ids": [p.y_id],
            "y_orders": [y_order],
            "out_id": step.out,
            "spec": spec,
            "out_order": out_order,
            "c_orders": c_orders,
        }
        storage[step.out] = out_order
        return True

    # consumer lookup for the one-step layout lookahead: every
    # intermediate has exactly one consuming step in a tree
    consumer = {}
    for st in steps:
        if isinstance(st, SingleStep):
            consumer[st.inp] = None
        else:
            consumer[st.l] = st
            consumer[st.r] = st

    def _consumer_role_fn(out_id):
        """0/1/2 role of a leg at the consuming step (batch /
        contracted / free), or None when unknowable."""
        st = consumer.get(out_id)
        if st is None:
            return None
        other = set(st.r_legs if st.l == out_id else st.l_legs)
        cout = set(st.out_legs)

        def role(ix):
            if ix in other:
                return 0 if ix in cout else 1
            return 2

        return role

    for si, step in enumerate(steps):
        if isinstance(step, SingleStep):
            close_chain()
            plans.append(("single", step))
            storage[step.out] = tuple(step.out_legs)
            continue

        x_order = storage[step.l]
        y_order = storage[step.r]
        out_set = set(step.out_legs)
        x_set, y_set = set(x_order), set(y_order)
        shared = x_set & y_set

        b = [ix for ix in x_order if ix in shared and ix in out_set]
        c = [ix for ix in x_order if ix in shared and ix not in out_set]
        m = [ix for ix in x_order if ix not in shared]
        ny = [ix for ix in y_order if ix not in shared]

        # free axes not kept need pre-sums - rare; contract directly,
        # recording the stored orders (the flat tensors' actual legs)
        if any(ix not in out_set for ix in m + ny) or set(
            step.out_legs
        ) != set(b + m + ny):
            close_chain()
            x_dims = tuple(sizes[ix] for ix in x_order)
            y_dims = tuple(sizes[ix] for ix in y_order)
            plans.append(
                (
                    "fallback",
                    (step, step.l, step.r, x_order, y_order, x_dims,
                     y_dims),
                )
            )
            storage[step.out] = tuple(step.out_legs)
            continue

        # the tensor with the larger free group plays 'x'
        x_id, y_id = step.l, step.r
        msize = prod(sizes[ix] for ix in m)
        nsize = prod(sizes[ix] for ix in ny)
        if nsize > msize:
            x_id, y_id = y_id, x_id
            x_order, y_order = y_order, x_order
            m, ny = ny, m
            msize, nsize = nsize, msize

        # canonical shared-group orders follow the bigger input overall
        big_order = (
            x_order
            if prod(sizes[ix] for ix in x_order)
            >= prod(sizes[ix] for ix in y_order)
            else y_order
        )
        b = [ix for ix in big_order if ix in shared and ix in out_set]
        c = [
            ix
            for ix in big_order
            if ix in shared and ix not in out_set
        ]

        B = prod(sizes[ix] for ix in b)
        M = msize
        K = prod(sizes[ix] for ix in c)
        N = nsize

        p = _GroupedPair()
        p.x_id, p.y_id, p.out_id = x_id, y_id, step.out
        p.B, p.M, p.K, p.N = B, M, K, N

        if B * M * K < 2**14 and B * K * N < 2**14:
            # everything small: contract directly at full (small) rank
            close_chain()
            x_dims = tuple(sizes[ix] for ix in x_order)
            y_dims = tuple(sizes[ix] for ix in y_order)
            plans.append(
                (
                    "fallback",
                    (step, x_id, y_id, x_order, y_order, x_dims, y_dims),
                )
            )
            storage[step.out] = tuple(step.out_legs)
            continue

        # one-step layout lookahead: the internal order of the free
        # groups (m, ny) in the produced tensor is ours to choose;
        # clustering those legs by their role at the CONSUMING step
        # (batch / contracted / free there) turns the consumer's
        # realignment into fewer, larger blocks. Adopted only when the
        # summed producer + consumer badness drops.
        if B == 1 and _LAYOUT_LOOKAHEAD:
            crole = _consumer_role_fn(step.out)
            if crole is not None:
                m_cl = sorted(m, key=crole)
                ny_cl = sorted(ny, key=crole)
                if m_cl != m or ny_cl != ny:
                    osize = prod(
                        sizes[ix] for ix in b + ny + m
                    )

                    def tot_cost(mm, nn):
                        xp = _block_plan(
                            x_order, tuple(c) + tuple(mm), sizes
                        )
                        oo = tuple(b) + tuple(nn) + tuple(mm)
                        cp = _block_plan(
                            oo, tuple(sorted(oo, key=crole)), sizes
                        )
                        bx = _plan_badness(xp, M * K)
                        bc = _plan_badness(cp, osize)
                        return (bx[0] + bc[0], bx[1] + bc[1])

                    if tot_cost(m_cl, ny_cl) < tot_cost(m, ny):
                        m, ny = m_cl, ny_cl

        def choose_x_layout(allow_mc):
            """Pick (c+m) or (m+c) storage for x by the badness of the
            required block transpose."""
            cand = []
            plan_cm = _block_plan(x_order, tuple(c) + tuple(m), sizes)
            cand.append(("cm", plan_cm, _plan_badness(plan_cm, M * K)))
            if allow_mc:
                plan_mc = _block_plan(
                    x_order, tuple(m) + tuple(c), sizes
                )
                cand.append(
                    ("mc", plan_mc, _plan_badness(plan_mc, M * K))
                )
            cand.sort(key=lambda t: t[2])
            return cand[0][0], cand[0][1]

        p.scatter = None
        if B == 1:
            if K < 8:
                p.mode = "mac"
                p.x_layout, p.x_plan = choose_x_layout(allow_mc=True)
                y_req = tuple(c) + tuple(ny)      # (K, N)
            elif N < 8:
                p.mode = "matvec"
                p.x_layout, p.x_plan = choose_x_layout(
                    allow_mc=(K % 128 == 0)
                )
                y_req = tuple(c) + tuple(ny)      # (K, N)
            else:
                p.mode = "mm"
                p.x_layout, p.x_plan = choose_x_layout(
                    allow_mc=(K % 128 == 0)
                )
                y_req = tuple(ny) + tuple(c)      # (N, K)
            p.out_order = tuple(b) + tuple(ny) + tuple(m)
            # no-realign scattered dot: contract the stored view's K
            # positions directly instead of realigning the big x; the
            # output carries M in stored order
            if (
                p.mode in ("mm", "matvec")
                and p.x_plan is not None
                and 2 * K * M >= _SCATTER_MIN
            ):
                sc = _scatter_layout(x_order, set(c), sizes)
                if sc is not None:
                    dims, kpos, m_stored, c_stored = sc
                    p.scatter = (dims, kpos)
                    p.x_plan = None
                    p.x_layout = "scat"
                    m = list(m_stored)
                    c = list(c_stored)
                    if p.mode == "mm":
                        y_req = tuple(ny) + tuple(c)
                    else:
                        y_req = tuple(c) + tuple(ny)
                    p.out_order = tuple(b) + tuple(ny) + tuple(m)
        else:
            p.mode = "bmm"
            p.x_layout = "cm"
            x_req = tuple(b) + tuple(c) + tuple(m)   # (B, K, M)
            y_req = tuple(b) + tuple(ny) + tuple(c)  # (B, N, K)
            p.out_order = tuple(b) + tuple(ny) + tuple(m)
            p.x_plan = _block_plan(x_order, x_req, sizes)

        p.y_plan = _block_plan(y_order, y_req, sizes)
        p.c_legs = tuple(c)
        p.ny_legs = tuple(ny)
        p.m_legs = tuple(m)
        p.b_legs = tuple(b)
        p.y_size = prod(sizes[ix] for ix in y_order)

        if gate_mode == "window":
            if try_window(p, step, si):
                continue
            close_chain()
        elif gate_mode == "inplace":
            if try_inplace(p, step, si):
                continue
            close_chain()

        if fuse_gates and _try_extend_chain(
            plans, p, step, si, ir.last_use, storage, sizes
        ):
            continue

        plans.append(("pair", p))
        storage[step.out] = p.out_order

    close_chain()

    # final rearrangement to the true output order
    final_order = storage.get(final_id, ())
    out_plan = _block_plan(
        final_order,
        tuple(ir.output_legs),
        sizes,
    ) if tuple(final_order) != tuple(ir.output_legs) else None
    out_shape = tuple(sizes[ix] for ix in ir.output_legs)

    # plan-level liveness (chains change plan/step correspondence)
    plan_last_use = {}
    for pi, (kind, info) in enumerate(plans):
        if kind == "pair":
            ids = (info.x_id, info.y_id)
        elif kind == "single":
            ids = (info.inp,)
        elif kind == "fusedchain":
            ids = (info.x_id, *(g[0] for g in info.gates))
        elif kind == "inplace":
            ids = (info.x_id, *(y[0] for y in info.ys))
        elif kind == "window":
            ids = (info.x_id, *(g[0] for g in info.gates))
        else:  # fallback
            ids = (info[1], info[2])
        for vid in ids:
            plan_last_use[vid] = pi
    plan_last_use.pop(final_id, None)

    return plans, storage, out_plan, out_shape, plan_last_use


def _try_extend_chain(plans, p, step, si, step_last_use, storage, sizes):
    """Try merging the freshly planned pair ``p`` into a fused gate
    chain ending at ``plans[-1]``. Returns True if merged."""
    if p.B != 1 or p.b_legs or p.y_size > MAX_GATE_SIZE:
        return False
    if not plans:
        return False
    kind_prev, prev = plans[-1]

    if kind_prev == "pair":
        # the previous pair can seed a chain if it too absorbed a small
        # gate
        if (
            prev.B != 1
            or prev.b_legs
            or prev.y_size > MAX_GATE_SIZE
            or prev.out_id != p.x_id
            or step_last_use.get(prev.out_id) != si
            or prev.K * p.K > MAX_FUSED_K
        ):
            return False
        # the current gate must act on ORIGINAL axes of the chain base
        if any(ix in set(prev.ny_legs) for ix in p.c_legs):
            return False
        chain = _FusedChain()
        chain.x_id = prev.x_id
        chain.x_src_order = storage[prev.x_id]
        chain.gates = [
            (prev.y_id, storage[prev.y_id], prev.c_legs, prev.ny_legs),
            (p.y_id, storage[p.y_id], p.c_legs, p.ny_legs),
        ]
        chain.m_rest = [
            ix for ix in prev.m_legs if ix not in set(p.c_legs)
        ]
    elif kind_prev == "fusedchain":
        prev_n = {ix for (_, _, _, nl) in prev.gates for ix in nl}
        if (
            prev.out_id != p.x_id
            or step_last_use.get(prev.out_id) != si
            or len(prev.gates) >= MAX_FUSED_GATES
            or prev.K * p.K > MAX_FUSED_K
            or any(ix in prev_n for ix in p.c_legs)
        ):
            return False
        chain = prev
        chain.gates = chain.gates + [
            (p.y_id, storage[p.y_id], p.c_legs, p.ny_legs)
        ]
        chain.m_rest = [
            ix for ix in chain.m_rest if ix not in set(p.c_legs)
        ]
    else:
        return False

    chain.out_id = step.out
    chain.refresh(sizes, _plan_badness)
    plans[-1] = ("fusedchain", chain)
    storage[step.out] = chain.out_order
    return True
