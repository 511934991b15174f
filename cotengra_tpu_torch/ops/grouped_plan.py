"""Host-side planning of the grouped split-complex executor.

``plan_grouped`` makes the same decisions as
``cotengra_tpu/ops/grouped.py::plan_grouped`` for ``gate_mode`` None and
``"inplace"``: the same stored orders, step kinds, pair modes, scattered
layouts and gate chains, so both packages run the same schedule. The
reference's opt-in engines (``"window"`` chains, ``fuse_gates`` kron
chains and the layout lookahead) are not ported yet; asking for them
raises.

Every intermediate is stored flat, with its logical leg order tracked
here; a change of order is a block transpose over maximal runs of legs
that stay together (``_block_plan``), so no step works at full rank.
"""

from cotengra_tpu.utils.misc import prod

from .gate_chains import MAX_CHAIN_GATES, build_chain_spec
from .lowering import SingleStep


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


def plan_grouped(ir, size_dict, input_orders, gate_mode=None):
    """Host-side symbolic pass: stored orders + per-step plans.

    ``gate_mode="inplace"`` lowers runs of small-gate absorptions into
    one evolving tensor to in-place gate chains (``gate_chains.py``);
    ``None`` plans plain pairs only.

    Returns ``(plans, storage, out_plan, out_shape, plan_last_use)``.
    """
    if gate_mode not in (None, "inplace"):
        raise ValueError(
            f"gate_mode={gate_mode!r} is not ported; use None or "
            "'inplace'"
        )

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

    def close_chain():
        nonlocal chain
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

        if gate_mode == "inplace":
            if try_inplace(p, step, si):
                continue
            close_chain()

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
        elif kind == "inplace":
            ids = (info.x_id, *(y[0] for y in info.ys))
        else:  # fallback
            ids = (info[1], info[2])
        for vid in ids:
            plan_last_use[vid] = pi
    plan_last_use.pop(final_id, None)

    return plans, storage, out_plan, out_shape, plan_last_use
