"""In-place gate chains: planning, the plain PyTorch version, and the
CUDA kernel's wrapper.

A gate chain absorbs a run of small complex "gates" y (K x N, e.g. 4x4)
into one big evolving tensor x, one gate after another:
``out[..., n, ...] = sum_k y[k, n] * x[..., k, ...]`` over the gate's
contracted legs, with the new legs taking the old legs' place.

Planning (``build_chain_spec``) decides exactly as the reference
``cotengra_tpu/ops/pallas_gates.py::build_chain_spec`` does, limits
included, so the same chains form and every chain ends in the same
``out_order``. The TPU view it computes (R2/C carving, dim/roll gates,
mix/field modes) is kept only for those decisions. What the port runs
is recorded beside it: each gate's input and output leg order, turned
into one :class:`GateStrides` table per gate. The reference's
``_field_plan`` (coefficient fields of field-mode gates) has no
counterpart: indexing gate axes by stride needs no fields.

Execution (``run_chain``): CPU tensors go through ``run_chain_plain``,
one strided complex matmul per gate. CUDA tensors go through
``csrc/gate_chain.cu``, which applies a run of gates (a *pass*, the
whole chain where shared memory allows) to tiles of x held in shared
memory: one HBM read and one write per pass. ``chain_tile_plan`` cuts
the chain into passes, describes each pass's tile, and cuts each pass's
gates into groups that the kernel applies in registers between two
trips through shared memory (``ChainGroup``).
"""

import ctypes
import itertools
from collections import namedtuple

import numpy as np
import torch

from .. import tracing
from ..utils.misc import prod

# -- planning limits ----------------------------------------------------------
# The reference kernel's limits, kept verbatim so that chains form exactly
# as in the reference. They describe the TPU's (8, 128) tiles and VMEM;
# relaxing them for the GPU is later work.
C_MIN = 1024             # minimum minor dim (lanes)
R2_MIN, R2_MAX = 8, 128  # second-minor dim bounds (sublanes)
MAX_VIEW_RANK = 12       # view dims including plane, R2, C
MAX_CHAIN_GATES = 8
MAX_GATE_DIM_PROD = 64   # product of dim-gate axes live in the tile
MAX_GATE_COMBOS = 512    # K*N per gate
VMEM_TILE_BUDGET = 2048 * 1024
FIELD_GATE_BUDGET = 8192 * 1024
FIELD_CHAIN_BUDGET = 16384 * 1024


class ChainSpec:
    """Static description of one in-place gate chain.

    The fields up to ``grid`` are the reference's TPU view (compared by
    ``key()``); ``gate_strides`` is what the plain version executes,
    ``gate_orders`` and ``leg_sizes`` what :func:`chain_tile_plan` cuts
    into the kernel's passes.
    """

    __slots__ = (
        "in_view", "out_view", "in_block", "out_block",
        "seg_sizes", "in_seg_axes", "out_seg_axes",
        "r2", "c_dim", "c_blk",
        "gates",
        "grid",
        "gate_strides",  # tuple of GateStrides, one per gate
        # per gate (in_order, out_order, c_order, ny_order) of x's legs
        "gate_orders",
        "leg_sizes",     # {leg: size} of every leg the chain meets
        "_key",
        "_tiles",        # chain_tile_plan's cache, by budget (and device)
    )

    def key(self):
        if self._key is None:
            self._key = (
                self.in_view, self.out_view, self.in_block,
                self.out_block, self.seg_sizes, self.in_seg_axes,
                self.out_seg_axes, self.r2, self.c_dim, self.c_blk,
                self.gates, self.grid,
            )
        return self._key


# One gate as strided index maps over flat planes (strides in elements):
#   out[b, n] = sum_k y[k, n] * x[b, k]
# batch: ((size, in_stride, out_stride), ...) runs of untouched legs,
#        merged where contiguous in both x and out;
# kdims: ((size, in_stride), ...) contracted legs in y's K order;
# ndims: ((size, out_stride), ...) new legs in y's N order.
GateStrides = namedtuple(
    "GateStrides", ("numel_in", "numel_out", "batch", "kdims", "ndims")
)


def _strides(order, sizes):
    st = {}
    s = 1
    for ix in reversed(order):
        st[ix] = s
        s *= sizes[ix]
    return st, s


def gate_strides(in_order, out_order, c_order, ny_order, sizes,
                 out_strides=None):
    """:class:`GateStrides` of one gate taking a tensor stored in
    ``in_order`` to one stored in ``out_order``, contracting ``c_order``
    (y's K legs) and creating ``ny_order`` (y's N legs). ``out_strides``
    ({leg: stride}) places the output in a larger tensor instead."""
    sin, numel_in = _strides(in_order, sizes)
    sout, numel_out = _strides(out_order, sizes)
    if out_strides is not None:
        sout = out_strides
    cset, nset = set(c_order), set(ny_order)
    batch_legs = [ix for ix in in_order if ix not in cset]
    if batch_legs != [ix for ix in out_order if ix not in nset]:
        raise ValueError("gate reorders its untouched legs")
    batch = []
    for ix in batch_legs:
        sz = sizes[ix]
        if sz == 1:
            continue
        if (
            batch
            and batch[-1][1] == sin[ix] * sz
            and batch[-1][2] == sout[ix] * sz
        ):
            batch[-1] = (batch[-1][0] * sz, sin[ix], sout[ix])
        else:
            batch.append((sz, sin[ix], sout[ix]))
    return GateStrides(
        numel_in,
        numel_out,
        tuple(batch),
        tuple((sizes[ix], sin[ix]) for ix in c_order),
        tuple((sizes[ix], sout[ix]) for ix in ny_order),
    )


def build_chain_spec(order0, sizes, gates):
    """Try to build a :class:`ChainSpec` (the reference's decisions).

    Parameters
    ----------
    order0 : tuple[str]
        Stored axis order of the big tensor at chain start.
    sizes : dict
        Axis sizes.
    gates : list of (c_legs, ny_legs)
        Per gate: contracted legs and new legs, applied in sequence.

    Returns
    -------
    (spec, out_order, c_orders) or (None, reason, None)
        ``c_orders``: per gate ``(c_order, ny_order)`` - realign y to
        ``c_order + ny_order``; K/N enumerate in those orders.
    """
    if len(gates) > MAX_CHAIN_GATES:
        return None, "too many gates", None

    all_c = set()
    for c_legs, _ in gates:
        all_c |= set(c_legs)
    if not all_c:
        return None, "no gates", None

    def size_of(entry):
        # ("__part__", name, size) entries are split untouched axes
        if isinstance(entry, tuple):
            return entry[2]
        return sizes[entry]

    def name_of(entry):
        if isinstance(entry, tuple):
            return None
        return entry

    def gate_of(entry):
        nm = name_of(entry)
        return nm is not None and nm in all_c

    # ---- carve C then R2 off the tail ---------------------------------
    def carve(axes, lo, hi):
        region = []
        p = 1
        axes = list(axes)
        while p < lo and axes:
            e = axes[-1]
            sz = size_of(e)
            if gate_of(e):
                axes.pop()
                region.insert(0, (name_of(e), sz))
                p *= sz
            else:
                need = -(-lo // p)
                take = sz
                d = sz
                while d % 2 == 0 and d // 2 >= need:
                    d //= 2
                if d >= need and sz % d == 0:
                    take = d
                if take == sz:
                    axes.pop()
                    region.insert(0, (name_of(e), sz))
                else:
                    axes.pop()
                    axes.append(("__part__", name_of(e), sz // take))
                    region.insert(0, (None, take))
                p *= take
        if p < lo or p > hi:
            return None, None
        return region, axes

    cregion, rest = carve(list(order0), C_MIN, 2**18)
    if cregion is None:
        return None, "tensor too small for C", None
    c_dim = prod(s for _, s in cregion)
    if c_dim % 128:
        return None, "C not lane aligned", None
    r2region, rest = carve(rest, R2_MIN, R2_MAX * 16)
    if r2region is None:
        return None, "tensor too small for R2", None
    r2 = prod(s for _, s in r2region)
    if r2 % 8:
        return None, "R2 not sublane aligned", None

    # ---- above region: touched legs individual, runs fused ------------
    touched_above = set()
    above_names = []
    for e in rest:
        nm = name_of(e)
        above_names.append((nm, size_of(e)))
        if nm is not None and nm in all_c:
            touched_above.add(nm)

    dims = []  # ('seg', size) | ('leg', name, size)
    run = 1
    for nm, sz in above_names:
        if nm in touched_above:
            if run > 1:
                dims.append(("seg", run))
                run = 1
            dims.append(("leg", nm, sz))
        else:
            run *= sz
    if run > 1:
        dims.append(("seg", run))

    r2names = [nm for nm, _ in r2region]
    cnames = [nm for nm, _ in cregion]
    r2sizes = [s for _, s in r2region]
    csizes = [s for _, s in cregion]

    def roll_strides(names, szs):
        st = {}
        s = 1
        for nm, sz in zip(reversed(names), reversed(szs)):
            if nm is not None:
                st[nm] = s
            s *= sz
        return st

    in_dims = list(dims)
    gate_specs = []
    c_orders = []
    gate_orders = []  # per gate (in_order, out_order): what the port runs
    max_lane_period = 1
    field_bytes_total = 0
    order = list(order0)  # evolving output leg order

    for c_legs, ny_legs in gates:
        cset = set(c_legs)
        pos_above = sorted(
            i
            for i, d in enumerate(dims)
            if d[0] == "leg" and d[1] in cset
        )
        above_hit = {dims[i][1] for i in pos_above}
        r2_hit = [nm for nm in r2names if nm in cset]
        c_hit = [nm for nm in cnames if nm in cset]
        if len(above_hit) + len(r2_hit) + len(c_hit) != len(cset):
            return None, "gate axis not addressable", None

        # pair every roll-region axis with a same-size ny leg: the new
        # axis takes the old one's position; leftover ny legs become dim
        # axes at the first dim-c position
        roll_list = r2_hit + c_hit
        ny_pool = list(ny_legs)
        pair = {}
        for cx in roll_list:
            cand = next(
                (n for n in ny_pool if sizes[n] == sizes[cx]), None
            )
            if cand is None:
                return None, "roll axis unpairable", None
            pair[cx] = cand
            ny_pool.remove(cand)
        dim_ny = tuple(ny_pool)
        anchor_end = False
        if dim_ny and not pos_above:
            # anchor the new dims at the end of the above region, which
            # leg order expresses only on an axis boundary
            if r2region[0][0] is None:
                return None, "dim ny without dim anchor", None
            anchor_end = True

        str_r2 = roll_strides(r2names, r2sizes)
        str_c = roll_strides(cnames, csizes)
        roll_axes = tuple(
            [(0, str_r2[cx], sizes[cx]) for cx in r2_hit]
            + [(1, str_c[cx], sizes[cx]) for cx in c_hit]
        )
        for kind, st, kk in roll_axes:
            if kind == 1:
                max_lane_period = max(max_lane_period, st * kk)

        kdims_dim = tuple(dims[i][2] for i in pos_above)
        ny_dims_dim = tuple(sizes[ix] for ix in dim_ny)
        Kg = prod(kdims_dim) * prod(kk for _, _, kk in roll_axes)
        Ng = prod(ny_dims_dim) * prod(kk for _, _, kk in roll_axes)
        if Kg * Ng > MAX_GATE_COMBOS:
            return None, "too many gate combos", None
        first = pos_above[0] if pos_above else (
            len(dims) if anchor_end else 0
        )
        mode = "mix"
        if roll_axes:
            r2p = max(
                [st * kk for kind, st, kk in roll_axes if kind == 0]
                or [1]
            )
            pl = max(
                [st * kk for kind, st, kk in roll_axes if kind == 1]
                or [1]
            )
            shifts = tuple(
                itertools.product(
                    *[range(-(kk - 1), kk) for _, _, kk in roll_axes]
                )
            )
            nfields = (
                prod(kdims_dim or (1,))
                * prod(ny_dims_dim or (1,))
                * len(shifts)
            )
            fbytes = 2 * nfields * r2p * pl * 4
            if (
                fbytes <= FIELD_GATE_BUDGET
                and field_bytes_total + fbytes <= FIELD_CHAIN_BUDGET
            ):
                mode = "field"
                field_bytes_total += fbytes
        if mode == "field":
            gate_specs.append(
                ("field", tuple(pos_above), kdims_dim, ny_dims_dim,
                 first, roll_axes, shifts, r2p, pl)
            )
        else:
            gate_specs.append(
                ("mix", tuple(pos_above), kdims_dim, ny_dims_dim,
                 first, roll_axes)
            )
        c_orders.append(
            (
                tuple(dims[i][1] for i in pos_above)
                + tuple(roll_list),
                dim_ny + tuple(pair[cx] for cx in roll_list),
            )
        )

        # substitute dims (above region)
        if pos_above:
            new_dims = []
            for i, d in enumerate(dims):
                if i == first:
                    new_dims.extend(
                        ("leg", ix, sizes[ix]) for ix in dim_ny
                    )
                elif i in pos_above:
                    continue
                else:
                    new_dims.append(d)
            dims = new_dims
        elif anchor_end:
            dims = dims + [
                ("leg", ix, sizes[ix]) for ix in dim_ny
            ]
        if roll_list:
            r2names = [pair.get(nm, nm) for nm in r2names]
            cnames = [pair.get(nm, nm) for nm in cnames]

        # evolving output leg order: roll axes rename in place; dim-c
        # legs are removed with dim_ny inserted at the first's position
        order_in = tuple(order)
        order = [pair.get(ix, ix) for ix in order]
        if above_hit:
            fpos = min(order.index(ix) for ix in above_hit)
            order = (
                [ix for ix in order[:fpos] if ix not in above_hit]
                + list(dim_ny)
                + [ix for ix in order[fpos:] if ix not in above_hit]
            )
        elif anchor_end and dim_ny:
            fpos = order.index(r2names[0])
            order = order[:fpos] + list(dim_ny) + order[fpos:]
        gate_orders.append((order_in, tuple(order)))

    out_dims = dims

    if (
        len(in_dims) + 3 > MAX_VIEW_RANK
        or len(out_dims) + 3 > MAX_VIEW_RANK
    ):
        return None, "view rank too high", None

    def legs_prod(dd):
        return prod([d[2] for d in dd if d[0] == "leg"] or [1])

    gmax = max(legs_prod(in_dims), legs_prod(out_dims))
    if gmax > MAX_GATE_DIM_PROD:
        return None, "gate dim product too large", None

    # ---- tiling --------------------------------------------------------
    def blocks_bytes(cb):
        bi = 2 * prod(
            [1 if d[0] == "seg" else d[2] for d in in_dims] or [1]
        ) * r2 * cb * 4
        bo = 2 * prod(
            [1 if d[0] == "seg" else d[2] for d in out_dims] or [1]
        ) * r2 * cb * 4
        return bi + bo

    c_blk = min(c_dim, max(2048, max_lane_period))
    while (
        blocks_bytes(c_blk) > VMEM_TILE_BUDGET
        and c_blk // 2 >= max(128, max_lane_period)
        and c_dim % (c_blk // 2) == 0
    ):
        c_blk //= 2
    if blocks_bytes(c_blk) > VMEM_TILE_BUDGET:
        return None, "tile exceeds VMEM budget", None
    if c_blk % max_lane_period or c_dim % c_blk:
        return None, "C not tileable by lane period", None

    # demote field gates whose full-tile fields would exceed the budget
    fb_total = 0
    for i, g in enumerate(gate_specs):
        if g[0] != "field":
            continue
        nfields = (
            prod(g[2] or (1,)) * prod(g[3] or (1,)) * len(g[6])
        )
        fbytes = 2 * nfields * r2 * c_blk * 4
        if (
            fbytes > FIELD_GATE_BUDGET
            or fb_total + fbytes > FIELD_CHAIN_BUDGET
        ):
            gate_specs[i] = ("mix",) + g[1:6]
        else:
            fb_total += fbytes

    spec = ChainSpec()
    spec._key = None
    spec.in_view = (
        (2,)
        + tuple(d[1] if d[0] == "seg" else d[2] for d in in_dims)
        + (r2, c_dim)
    )
    spec.out_view = (
        (2,)
        + tuple(d[1] if d[0] == "seg" else d[2] for d in out_dims)
        + (r2, c_dim)
    )

    in_segs = [i for i, d in enumerate(in_dims) if d[0] == "seg"]
    out_segs = [i for i, d in enumerate(out_dims) if d[0] == "seg"]
    if [in_dims[i][1] for i in in_segs] != [
        out_dims[i][1] for i in out_segs
    ]:
        return None, "segment mismatch", None

    spec.seg_sizes = tuple(in_dims[i][1] for i in in_segs)
    spec.in_seg_axes = tuple(i + 1 for i in in_segs)
    spec.out_seg_axes = tuple(i + 1 for i in out_segs)
    spec.r2 = r2
    spec.c_dim = c_dim
    spec.c_blk = c_blk
    spec.gates = tuple(gate_specs)
    spec.grid = (max(1, prod(spec.seg_sizes)), c_dim // c_blk)

    def block_of(dd):
        blk = [2]
        for d in dd:
            blk.append(1 if d[0] == "seg" else d[2])
        blk.extend((r2, c_blk))
        return tuple(blk)

    spec.in_block = block_of(in_dims)
    spec.out_block = block_of(out_dims)
    spec.gate_orders = tuple(
        (o_in, o_out, c_order, ny_order)
        for (o_in, o_out), (c_order, ny_order) in zip(
            gate_orders, c_orders
        )
    )
    spec.gate_strides = tuple(
        gate_strides(*orders, sizes) for orders in spec.gate_orders
    )
    spec.leg_sizes = {
        ix: sizes[ix]
        for o_in, o_out, _, _ in spec.gate_orders
        for ix in o_in + o_out
    }
    spec._tiles = {}

    return spec, tuple(order), tuple(c_orders)


# -- execution ---------------------------------------------------------------


def _gate_plain(x, y, g):
    """One gate in plain PyTorch: a strided view of x as (2, B, K), a
    complex (B, K) @ (K, N) on the planes, and a strided write of the
    (2, B, N) result into the output's leg order. A leading slice dim of
    x (``(S, 2 * numel)``) or y (``(S, 2, K, N)``) broadcasts: the
    result has it where either has."""
    bsz = tuple(d[0] for d in g.batch)
    ksz = tuple(d[0] for d in g.kdims)
    nsz = tuple(d[0] for d in g.ndims)
    B, K, N = prod(bsz), prod(ksz), prod(nsz)
    x_lead = tuple(x.shape[:-1])
    xv = x.as_strided(
        x_lead + (2,) + bsz + ksz,
        tuple(x.stride()[:-1])
        + (g.numel_in,)
        + tuple(d[1] for d in g.batch)
        + tuple(d[1] for d in g.kdims),
        x.storage_offset(),
    ).reshape(x_lead + (2, B, K))
    lead = tuple(torch.broadcast_shapes(x_lead, tuple(y.shape[:-3])))
    xr, xi = xv.select(-3, 0), xv.select(-3, 1)
    yr, yi = y.select(-3, 0), y.select(-3, 1)
    res = torch.stack([xr @ yr - xi @ yi, xr @ yi + xi @ yr], dim=-3)
    out = x.new_empty(lead + (2 * g.numel_out,))
    out.as_strided(
        lead + (2,) + bsz + nsz,
        (2 * g.numel_out,) * len(lead)
        + (g.numel_out,)
        + tuple(d[2] for d in g.batch)
        + tuple(d[1] for d in g.ndims),
    ).copy_(res.reshape(lead + (2,) + bsz + nsz))
    return out


def run_chain_plain(spec, x_flat, ys):
    """Plain PyTorch version of the chain: one strided complex matmul
    per gate. Runs on any device; :func:`run_chain` uses it for CPU
    tensors only, and ``chip_smoke.py`` compares the kernel with it.
    Takes the batched forms of :func:`run_chain` too."""
    for g, y in zip(spec.gate_strides, ys, strict=True):
        x_flat = _gate_plain(x_flat, y, g)
    return x_flat


# -- the kernel's tile plan -------------------------------------------------
# Shared memory one block of csrc/gate_chain.cu may take on an H100
# (227 KB); the kernel's arrays are counted by ``_pass_smem_bytes``.
SMEM_BUDGET = 232448
# Loads and stores coalesce once the tile covers this many floats of
# x's (and out's) innermost legs: one 128-byte line per warp access.
# Where that leaves the tile small, it widens on to WIDE_FLOATS (longer
# runs of HBM a tile) as long as an SM still holds as many blocks.
COALESCE_FLOATS = 32
WIDE_FLOATS = 128
# A block's batch tile holds about this many complex elements of x (16 KB
# of both planes), and its load ring up to RING_STAGES batch tiles, so
# that each SM keeps enough bytes in flight to cover HBM latency.
TILE_ELEMS = 2048
RING_STAGES = 4
# limits of the kernel's argument block (csrc/gate_chain.cu)
MAX_PASS_GATES = MAX_CHAIN_GATES
MAX_BATCH_DIMS = 24
# A register group's state: at most 2**REG_BITS complex values a thread,
# one bit of the gates' legs a slot; the kernel holds up to
# MAX_REG_BITS slots (csrc/gate_chain.cu), and the argument block that
# many strides before and after each group
REG_BITS = 4
MAX_REG_BITS = 4

# One pass of a chain as the kernel runs it (strides in elements).
#   gates:      (first, stop) - the chain's gates ``first:stop``;
#   legs:       the tile's legs (sorted): every leg the pass's gates
#               contract or create, and the untouched legs that widen it;
#   io:         GateStrides of the whole pass over x and out: ``batch``
#               the untouched legs outside the tile (runs, as in
#               gate_strides), ``kdims`` the tile legs of x (in x's order,
#               x strides: the gather), ``ndims`` those of out (in out's
#               order, out strides);
#   tile:       GateStrides per gate: ``batch`` the tile's other legs,
#               ``kdims``/``ndims`` the gate's legs, strides inside the
#               tile buffers before and after the gate - after the last
#               gate, out's strides (it writes out); numel_in/numel_out
#               are the tile sizes before and after the gate;
#   groups:     the pass's gates cut into ChainGroups, in order;
#   batch_tile: batch elements a block holds at once;
#   stages:     batch tiles in the block's load ring;
#   smem_bytes: shared memory of one block.
ChainPass = namedtuple(
    "ChainPass",
    ("gates", "legs", "io", "tile", "groups", "batch_tile", "stages",
     "smem_bytes"),
)

# A run of a pass's gates that the kernel applies between two trips
# through shared memory.
#   gates:  (first, stop) - the chain's gates ``first:stop``;
#   slots:  a register group: each thread holds 2**slots complex values,
#           one bit of the group's legs a slot, and applies every gate of
#           the group to them; None: one gate on the per-item path;
#   io:     GateStrides over the tile buffers before and after the group
#           (after the pass's last group, out's strides): ``batch`` the
#           tile's legs that no gate of the group touches; for a register
#           group ``kdims`` / ``ndims`` one (2, stride) per slot before /
#           after the group, (1, 0) where the slot is empty; on the
#           per-item path the gate's own (its entry of ``tile``);
#   fields: per gate of a register group (kb, nb, p, perm_k, perm_n): the
#           gate contracts the bits in slots p:p+kb and writes its new
#           legs' bits to slots p:p+nb (the state index is the slots'
#           bits, slot 0 lowest); perm_k[k] (perm_n[n]) is y's row
#           (column) where the field's bits read k (n).
ChainGroup = namedtuple("ChainGroup", ("gates", "slots", "io", "fields"))


def _leg_bits(size):
    """log2(size) for a power of two, else None."""
    b = size.bit_length() - 1
    return b if size == 1 << b else None


def _field_perm(field, order, sizes):
    """y's index (row-major over the legs ``order``) of each value of the
    bits ``field`` ((leg, bit) a slot, lowest first)."""
    st = _strides(order, sizes)[0]
    w = [st[ix] << b for ix, b in field]
    return tuple(
        sum(wi for i, wi in enumerate(w) if v >> i & 1)
        for v in range(1 << len(w))
    )


def _slot_layout(gates, sizes, max_bits):
    """Registers for the consecutive gates ``(c_order, ny_order)``, or
    None where their legs take more than ``max_bits`` bits at once, a leg
    is not a power of two, a gate's contracted and created bits differ
    by more than one (the kernel compiles its register gates for those
    shapes only), or no layout exists.

    The state is indexed by slots, one bit each; each gate must find its
    contracted bits in consecutive slots p:p+kb (in any order: y's rows
    are permuted to match) with slots p+kb:p+nb empty where it creates
    more bits than it contracts, and leaves its new bits in p:p+nb. A
    breadth-first search over the slots' contents (at most 4! per bit
    count) finds a start layout and each gate's field. Returns (slots,
    contents before, contents after, fields) as in ChainGroup."""
    bits = {}
    for c, ny in gates:
        for ix in c + ny:
            bits[ix] = _leg_bits(sizes[ix])
            if bits[ix] is None:
                return None

    def atoms(legs):
        return [(ix, b) for ix in legs for b in range(bits[ix])]

    for c, ny in gates:
        if abs(len(atoms(c)) - len(atoms(ny))) > 1:
            return None
    made, inputs = set(), []
    for c, ny in gates:
        inputs += [ix for ix in c if ix not in made and ix not in inputs]
        made.update(ny)
    live = set(inputs)
    nslots = sum(bits[ix] for ix in live)
    for c, ny in gates:
        live = (live - set(c)) | set(ny)
        nslots = max(nslots, sum(bits[ix] for ix in live))
    if nslots > max_bits:
        return None
    start = atoms(inputs)
    layer = {}
    for pos in itertools.permutations(range(nslots), len(start)):
        st = [None] * nslots
        for a, p in zip(start, pos):
            st[p] = a
        layer[tuple(st)] = None
    history = []
    for c, ny in gates:
        catoms, natoms = set(atoms(c)), atoms(ny)
        kb, nb = len(catoms), len(natoms)
        mb = max(kb, nb)
        nxt = {}
        for st in layer:
            for p in range(nslots - mb + 1):
                if set(st[p:p + kb]) != catoms or any(
                    s is not None for s in st[p + kb:p + mb]
                ):
                    continue
                for perm in itertools.permutations(natoms):
                    new = st[:p] + perm + (None,) * (mb - nb) + st[p + mb:]
                    nxt.setdefault(new, (st, p))
        if not nxt:
            return None
        history.append(nxt)
        layer = nxt
    states = [next(iter(layer))]
    field_at = []
    for step in reversed(history):
        prev, p = step[states[0]]
        states.insert(0, prev)
        field_at.insert(0, p)
    fields = []
    for (c, ny), p, before, after in zip(gates, field_at, states,
                                         states[1:]):
        kb = sum(bits[ix] for ix in c)
        nb = sum(bits[ix] for ix in ny)
        fields.append((kb, nb, p, _field_perm(before[p:p + kb], c, sizes),
                       _field_perm(after[p:p + nb], ny, sizes)))
    return nslots, states[0], states[-1], tuple(fields)


def _cached_layout(spec, first, stop):
    """``_slot_layout`` of the chain's gates ``first:stop``, cached on the
    spec."""
    key = ("slots", first, stop, REG_BITS)
    if key not in spec._tiles:
        spec._tiles[key] = _slot_layout(
            [(c, ny) for _, _, c, ny in spec.gate_orders[first:stop]],
            spec.leg_sizes, REG_BITS,
        )
    return spec._tiles[key]


def _register_groups(spec, first, stop):
    """The gates ``first:stop`` of ``spec`` cut into groups, greedily:
    each group the longest run from its first gate that has a register
    layout (``_slot_layout``), a gate without one alone on the per-item
    path. A list of (first, stop, layout or None)."""
    groups = []
    a = first
    while a < stop:
        b, lay = a, None
        while b < stop:
            nxt = _cached_layout(spec, a, b + 1)
            if nxt is None:
                break
            b, lay = b + 1, nxt
        groups.append((a, max(b, a + 1), lay))
        a = max(b, a + 1)
    return groups


def _pass_smem_bytes(t_in, t_work, n_work, kn, table_ints, batch_tile,
                     stages):
    """Shared memory of one block (``csrc/gate_chain.cu`` lays it out
    the same way): every gate's y (complex, each from an even index);
    ``stages`` ring slots of the input tile and ``n_work`` work buffers
    of ``t_work`` (``_work_buffers``), complex, per batch element; the
    batch offsets (int64, x and out, ``stages + 2`` tiles); the index
    tables (int32)."""
    return (
        sum(8 * ((k * n + 1) // 2 * 2) for k, n in kn)
        + 8 * batch_tile * (stages * t_in + n_work * t_work)
        + 2 * 8 * batch_tile * (stages + 2)
        + 4 * table_ints
    )


def _innermost_extent(order, tile, sizes):
    """(elements, first leg outside ``tile``): how much of ``order``'s
    innermost end the tile covers contiguously."""
    ext = 1
    for ix in reversed(order):
        if ix not in tile and sizes[ix] != 1:
            return ext, ix
        ext *= sizes[ix]
    return ext, None


def _split_dims(dims):
    """Cut the row-major index space ``dims`` ((size, stride), ...) into
    outer and inner dims whose inner extent L is about its square root
    (splitting a dim where its size allows): offset(i) = hi[i // L] +
    lo[i % L], so two short tables replace one of prod(sizes)."""
    total = prod(d[0] for d in dims)
    target = max(1, int(round(total**0.5)))
    hi, lo, L = list(dims), [], 1
    while hi:
        size, stride = hi[-1]
        if L * size <= target:
            lo.insert(0, hi.pop())
            L *= size
            continue
        f = max(f for f in range(1, size + 1)
                if size % f == 0 and L * f <= target)
        if f > 1:
            hi[-1] = (size // f, stride * f)
            lo.insert(0, (f, stride))
        break
    return tuple(hi), tuple(lo)


def _group(orders, gates, first, a, b, lay, in_tile, out_strides, sizes):
    """The :class:`ChainGroup` of the pass's gates ``a:b`` (the pass
    starts at the chain's gate ``first``) with the register layout
    ``lay`` (None: the per-item path, one gate). The pass's last group
    writes out."""
    span = (first + a, first + b)
    if lay is None:
        return ChainGroup(span, None, gates[a], None)
    nslots, before, after, fields = lay
    o_in = in_tile(orders[a][0])
    o_out = in_tile(orders[b - 1][1])
    touched = {ix for _, _, c, ny in orders[a:b] for ix in c + ny}
    last = b == len(orders)
    io = gate_strides(
        o_in, o_out, [ix for ix in o_in if ix in touched],
        [ix for ix in o_out if ix in touched], sizes,
        out_strides if last else None,
    )
    sin = _strides(o_in, sizes)[0]
    sout = out_strides if last else _strides(o_out, sizes)[0]

    def slots(state, st):
        return tuple((1, 0) if s is None else (2, st[s[0]] << s[1])
                     for s in state)

    return ChainGroup(
        span, nslots,
        GateStrides(io.numel_in, io.numel_out, io.batch,
                    slots(before, sin), slots(after, sout)),
        fields,
    )


def _work_buffers(t_in, groups):
    """``t_work`` and ``n_work`` of a pass: the tiles between its groups
    go to a work buffer and the ring slot of the tile in turns (the slot
    is free once the first group has read it), so one work buffer does
    where the slot holds every other tile; else two, in turns."""
    tiles = [g.io.numel_out for g in groups[:-1]]
    if all(t <= t_in for t in tiles[1::2]):
        return dict(t_work=max(tiles[0::2] or [0]), n_work=min(1, len(tiles)))
    return dict(t_work=max(tiles), n_work=2)


def _make_pass(spec, first, stop, smem_bytes):
    """The :class:`ChainPass` of gates ``first:stop``, or None if its
    tile does not fit ``smem_bytes`` at one batch element."""
    sizes = spec.leg_sizes
    orders = spec.gate_orders[first:stop]
    order_in, order_out = orders[0][0], orders[-1][1]
    tile = set()
    for _, _, c_order, ny_order in orders:
        tile.update(c_order, ny_order)
    kn = [
        (prod(sizes[ix] for ix in c), prod(sizes[ix] for ix in ny))
        for _, _, c, ny in orders
    ]
    cuts = _register_groups(spec, first, stop)

    def layout():
        """(io, per-gate tile strides, groups, shared-memory sizes)."""
        def in_tile(order):
            return tuple(ix for ix in order if ix in tile)

        io = gate_strides(order_in, order_out, in_tile(order_in),
                          in_tile(order_out), sizes)
        # the last gate writes out itself: its output strides are out's
        out_strides = _strides(order_out, sizes)[0]
        gates = tuple(
            gate_strides(in_tile(o_in), in_tile(o_out), c, ny, sizes,
                         out_strides if j == len(orders) - 1 else None)
            for j, (o_in, o_out, c, ny) in enumerate(orders)
        )
        groups = tuple(
            _group(orders, gates, first, a - first, b - first, lay,
                   in_tile, out_strides, sizes)
            for a, b, lay in cuts
        )
        table = sum(k + n for k, n in kn)
        for dims in [io.kdims] + [g.io.batch for g in groups] * 2:
            hi, lo = _split_dims([d[:2] for d in dims])
            table += prod(d[0] for d in hi) + prod(d[0] for d in lo)
        smem = dict(
            t_in=gates[0].numel_in,
            **_work_buffers(gates[0].numel_in, groups),
            kn=kn,
            table_ints=table,
        )
        return io, gates, groups, smem

    def fits(batch_tile=1, stages=2, budget=smem_bytes):
        return _pass_smem_bytes(
            **layout()[3], batch_tile=batch_tile, stages=stages
        ) <= budget

    if not fits():
        return None

    def widen(floats, budget):
        """Widen the tile by x's and out's innermost untouched legs until
        both cover ``floats`` contiguous floats, as ``budget`` allows."""
        while True:
            ext_in, leg_in = _innermost_extent(order_in, tile, sizes)
            ext_out, leg_out = _innermost_extent(order_out, tile, sizes)
            if ext_in < floats and leg_in is not None:
                leg = leg_in
            elif ext_out < floats and leg_out is not None:
                leg = leg_out
            else:
                return
            tile.add(leg)
            if not fits(budget=budget):
                tile.discard(leg)
                return

    half = smem_bytes // 2
    widen(COALESCE_FLOATS, smem_bytes)
    # then on to WIDE_FLOATS, where the tile keeps the blocks an SM holds
    widen(WIDE_FLOATS, half if fits(1, 2, half) else smem_bytes)
    io, gates, groups, smem = layout()
    t_in = gates[0].numel_in
    n_batch = prod(d[0] for d in io.batch)
    # the batch tile (up to TILE_ELEMS elements of x) and ring depth that
    # keep the most of x in flight, within half the budget where the tile
    # allows (two blocks share an SM), else within all of it
    budget = half if fits(1, 2, half) else smem_bytes
    choices = [
        (1 << e, st)
        for e in range(31)
        if (1 << e) <= n_batch and (1 << e) * t_in <= max(TILE_ELEMS, t_in)
        for st in range(2, RING_STAGES + 1)
        if fits(1 << e, st, budget)
    ]
    batch_tile, stages = max(choices, key=lambda c: ((c[1] - 1) * c[0], c[1]))
    return ChainPass(
        (first, stop), tuple(sorted(tile, key=str)), io, gates, groups,
        batch_tile, stages,
        _pass_smem_bytes(**smem, batch_tile=batch_tile, stages=stages),
    )


def chain_tile_plan(spec, smem_bytes=SMEM_BUDGET):
    """The kernel's passes over ``spec``'s gates: a tuple of
    :class:`ChainPass`. A pass takes consecutive gates while its largest
    live tile (the legs its gates contract or create), at one batch
    element, fits ``smem_bytes``; so a chain is one pass unless its tile
    outgrows shared memory. Cached on the spec."""
    key = ("plan", smem_bytes)
    if key in spec._tiles:
        return spec._tiles[key]
    n = len(spec.gate_orders)
    passes = []
    first = 0
    while first < n:
        best = None
        for stop in range(first + 1, min(n, first + MAX_PASS_GATES) + 1):
            cand = _make_pass(spec, first, stop, smem_bytes)
            if cand is None:
                break
            best = cand
        if best is None:
            raise ValueError(
                f"gate {first} of the chain does not fit {smem_bytes} "
                "bytes of shared memory"
            )
        passes.append(best)
        first = best.gates[1]
    plan = tuple(passes)
    spec._tiles[key] = plan
    return plan


def _offsets(dims):
    """Row-major offsets of the index space ``dims`` ((size, stride),
    ...): an int64 array of prod(sizes) entries."""
    off = np.zeros(1, dtype=np.int64)
    for size, stride in dims:
        off = (off[:, None] + np.arange(size) * stride).reshape(-1)
    return off


def pass_tables(ps):
    """The index tables of one pass, as the kernel reads them. Each
    index space is a pair ``(hi, lo)`` of int64 arrays (``_split_dims``):
    offset(i) = hi[i // len(lo)] + lo[i % len(lo)]. ``gather`` (x
    offset of each input tile position); per group ``(oin, oout)``
    (pairs): the offsets of the tile's legs that the group leaves in the
    buffers before and after it - after the pass's last group, in out
    (the pass writes out from its last group); per gate ``(koff, noff)``
    (plain arrays): on the per-item path the offsets of y's K legs in
    the gate's input tile and of its N legs in its output, in a register
    group the field's ``perm_k`` and ``perm_n`` (``ChainGroup``)."""
    def pair(dims):
        hi, lo = _split_dims(dims)
        return _offsets(hi), _offsets(lo)

    gates = []
    for g in ps.groups:
        if g.slots is None:
            gates.append((_offsets(g.io.kdims), _offsets(g.io.ndims)))
        else:
            gates += [(np.asarray(pk, dtype=np.int64),
                       np.asarray(pn, dtype=np.int64))
                      for _, _, _, pk, pn in g.fields]
    return {
        "gather": pair(ps.io.kdims),
        "groups": [
            (pair([(s, i) for s, i, _ in g.io.batch]),
             pair([(s, o) for s, _, o in g.io.batch]))
            for g in ps.groups
        ],
        "gates": gates,
    }


def group_counts(ps):
    """(gates in register groups, gates on the per-item path, groups) of
    one pass."""
    reg = sum(g.gates[1] - g.gates[0] for g in ps.groups
              if g.slots is not None)
    return reg, ps.gates[1] - ps.gates[0] - reg, len(ps.groups)


def _pass_kernel_args(ps):
    """(meta, tables) of one pass: the int64 argument block read by
    ``ctg_gate_chain_f32`` in csrc/gate_chain.cu, with a 0 in each
    gate's y-pointer slot (``_META_Y + _META_GATE * g``), one slice
    (``_META_SLICES``) and slice strides of 0, and the int32 index
    tables it points into. Layout: a header (gates, batch tile, ring
    stages, batch runs, largest intermediate tile, batch count, x and
    out elements, table length, then position of hi, position of lo and
    len(lo) of the gather, then slices, x and out slice strides, then
    groups and work buffers); per gate (y, K, N, tile in, tile out,
    koff, noff, y slice stride, then kb, nb and p of its field in a
    register group, else 0); per group (slots or -1 on the per-item path,
    first and stop gate of the pass, tile in, tile out, oin hi, oin lo,
    oout hi, oout lo, len(lo) of oin and oout, the empty slots before and
    after it as bit masks, then ``MAX_REG_BITS`` slot strides before it
    and as many after it); per batch run (size, x stride, out stride).
    Strides and sizes are per slice: ``run_chain_cuda`` fills in the
    slice count and strides of a batch."""
    io = ps.io
    if len(io.batch) > MAX_BATCH_DIMS:
        raise ValueError(f"{len(io.batch)} batch runs > {MAX_BATCH_DIMS}")
    if len(ps.tile) > MAX_PASS_GATES:
        raise ValueError(f"{len(ps.tile)} gates > {MAX_PASS_GATES}")
    if max(io.numel_in, io.numel_out) >= 2**31:
        raise ValueError(
            "x and out must have fewer than 2**31 elements per slice"
        )
    tabs = pass_tables(ps)
    parts = []

    def put(arr):
        parts.append(arr)
        return sum(len(p) for p in parts) - len(arr)

    head = [put(tabs["gather"][0]), put(tabs["gather"][1]),
            len(tabs["gather"][1])]
    first = ps.gates[0]
    fields = [f for g in ps.groups for f in (g.fields or [None])]
    gate_meta = []
    for g, (koff, noff), f in zip(ps.tile, tabs["gates"], fields):
        K = prod(d[0] for d in g.kdims)
        N = prod(d[0] for d in g.ndims)
        if K * N > MAX_GATE_COMBOS:
            raise ValueError(f"gate K*N = {K * N} > {MAX_GATE_COMBOS}")
        gate_meta += [0, K, N, g.numel_in, g.numel_out, put(koff),
                      put(noff), 0, *(f[:3] if f else (0, 0, 0))]
    group_meta = []
    for g, (oin, oout) in zip(ps.groups, tabs["groups"]):
        if len(oin[1]) != len(oout[1]):
            raise ValueError("oin and oout must share their split")
        if g.slots is None:
            slots = [-1] + [0] * (2 + 2 * MAX_REG_BITS)
        else:
            pad = [0] * (MAX_REG_BITS - g.slots)
            slots = [
                g.slots,
                sum(1 << b for b, d in enumerate(g.io.kdims) if d[0] == 1),
                sum(1 << b for b, d in enumerate(g.io.ndims) if d[0] == 1),
                *(d[1] for d in g.io.kdims), *pad,
                *(d[1] for d in g.io.ndims), *pad,
            ]
        group_meta += [
            slots[0], g.gates[0] - first, g.gates[1] - first,
            g.io.numel_in, g.io.numel_out, put(oin[0]), put(oin[1]),
            put(oout[0]), put(oout[1]), len(oin[1]), *slots[1:],
        ]
    tables = np.concatenate(parts)
    if np.abs(tables).max() >= 2**31:
        raise ValueError("an index table exceeds int32")
    work = _work_buffers(ps.tile[0].numel_in, ps.groups)
    meta = [
        len(ps.tile), ps.batch_tile, ps.stages, len(io.batch),
        work["t_work"], prod(d[0] for d in io.batch), io.numel_in,
        io.numel_out, len(tables), *head, 1, 0, 0, len(ps.groups),
        work["n_work"], *gate_meta, *group_meta,
    ]
    for d in io.batch:
        meta.extend(d)
    return meta, tables.astype(np.int32)


_META_SLICES = 12  # slices, x and out slice strides in the argument block
_META_Y = 17       # index of the first gate's y pointer in the argument block
_META_GATE = 11    # int64s per gate in the argument block
_META_Y_SLICE = 7  # a gate's y slice stride, from its y pointer


def _kernel_args(spec, device):
    """Per pass (plan, meta list, device int32 tables, ``group_counts``),
    cached on the spec by device: built and copied to the card once."""
    key = ("args", device)
    if key not in spec._tiles:
        args = []
        for ps in chain_tile_plan(spec):
            meta, tables = _pass_kernel_args(ps)
            args.append((ps, meta, torch.from_numpy(tables).to(device),
                         group_counts(ps)))
        spec._tiles[key] = tuple(args)
    return spec._tiles[key]


def _slices_of(x_flat, ys):
    """The slice count of a batched call (None if nothing is batched):
    x ``(S, 2 * numel)``, a gate ``(S, 2, K, N)``."""
    counts = {x_flat.shape[0]} if x_flat.dim() == 2 else set()
    counts.update(y.shape[0] for y in ys if y.dim() == 4)
    if len(counts) > 1:
        raise ValueError(f"batched operands disagree on slices: {counts}")
    return counts.pop() if counts else None


def run_chain_cuda(spec, x_flat, ys):
    """Launch ``csrc/gate_chain.cu`` once per pass of
    ``chain_tile_plan(spec)`` on CUDA float32 planes, for one slice or
    for a whole batch (:func:`run_chain`'s batched forms: one launch per
    pass either way, a gate read by slice through its slice stride).
    ``run_chain_cuda.launches`` counts the launches, and
    ``GATE_COUNTS`` the gates they ran in register groups and on the
    per-item path. Each pass is a ``kernel.launch`` span (``tracing``)
    with those counts and its groups; the first takes in the checks
    before it."""
    from ._build import load_library

    if tracing.ON:
        tracing.begin()
    x_in = x_flat
    if x_flat.device.type != "cuda":
        raise ValueError("run_chain_cuda needs a CUDA tensor")
    if x_flat.dtype != torch.float32 or x_flat.dim() not in (1, 2):
        raise ValueError("gate-chain kernel takes flat float32 planes")
    if not x_flat.is_contiguous():
        raise ValueError("gate-chain kernel needs contiguous x")
    if x_flat.shape[-1] != 2 * spec.gate_strides[0].numel_in:
        raise ValueError("x does not match the chain's input size")
    ys = list(ys)
    if len(ys) != len(spec.gate_strides):
        raise ValueError(
            f"{len(ys)} gates given, the chain has {len(spec.gate_strides)}"
        )
    for g, y in zip(spec.gate_strides, ys):
        K = prod(d[0] for d in g.kdims)
        N = prod(d[0] for d in g.ndims)
        if (
            y.device != x_flat.device
            or y.dtype != torch.float32
            or tuple(y.shape[-3:]) != (2, K, N)
            or y.dim() not in (3, 4)
            or not y.is_contiguous()
        ):
            raise ValueError(
                f"gate must be contiguous float32 (2, {K}, {N}) or (S, 2, "
                f"{K}, {N}) on {x_flat.device}, got {y.dtype} "
                f"{tuple(y.shape)} on {y.device}"
            )
    nslice = _slices_of(x_flat, ys)
    lead = () if nslice is None else (nslice,)
    lib = load_library()
    stream = torch.cuda.current_stream(x_flat.device).cuda_stream
    for ps, meta, tables, (reg, item, groups) in _kernel_args(
        spec, x_flat.device
    ):
        if tracing.ON and x_flat is not x_in:
            tracing.begin()
        meta = list(meta)
        first, stop = ps.gates
        for j, y in enumerate(ys[first:stop]):
            at = _META_Y + _META_GATE * j
            meta[at] = y.data_ptr()
            if y.dim() == 4:
                meta[at + _META_Y_SLICE] = y.stride(0)
        out = torch.empty(
            lead + (2 * ps.io.numel_out,), dtype=torch.float32,
            device=x_flat.device,
        )
        if nslice is not None:
            meta[_META_SLICES:_META_SLICES + 3] = [
                nslice,
                x_flat.stride(0) if x_flat.dim() == 2 else 0,
                out.stride(0),
            ]
        meta = (ctypes.c_int64 * len(meta))(*meta)
        if tracing.ON:
            launched = tracing.now()
        rc = lib.ctg_gate_chain_f32(
            x_flat.data_ptr(), out.data_ptr(), tables.data_ptr(), meta,
            len(meta), stream,
        )
        if rc != 0:
            raise RuntimeError(
                f"gate-chain kernel launch failed: CUDA error {rc}"
            )
        run_chain_cuda.launches += 1
        GATE_COUNTS["reg_gates"] += reg
        GATE_COUNTS["item_gates"] += item
        if tracing.ON:
            tracing.end(
                "kernel.launch", "gate_chain", run_chain_cuda.launches - 1,
                (tuple(x_flat.shape), tuple(out.shape),
                 [tuple(y.shape) for y in ys[first:stop]]), launched,
                reg, item, groups,
            )
        x_flat = out
    return x_flat


run_chain_cuda.launches = 0
# gates that run_chain_cuda's launches ran in register groups and on the
# per-item path, cumulative
GATE_COUNTS = {"reg_gates": 0, "item_gates": 0}


def run_chain(spec, x_flat, ys):
    """Apply the chain to plane-major flat ``x_flat`` (real plane, then
    imaginary plane, in the chain's input leg order); ``ys`` are the
    realigned (2, K, N) gates. Returns the flat planes in the chain's
    ``out_order``.

    Batched: ``x_flat`` may be ``(S, 2 * numel)`` (S slices) and any
    gate ``(S, 2, K, N)`` (a gate that reads a sliced index); the result
    is then ``(S, 2 * numel_out)``, the unbatched operands shared by
    every slice.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes
    the plain version.
    """
    if x_flat.device.type == "cuda":
        return run_chain_cuda(spec, x_flat, ys)
    if x_flat.device.type == "cpu":
        return run_chain_plain(spec, x_flat, ys)
    raise ValueError(f"no gate-chain path for device {x_flat.device}")
