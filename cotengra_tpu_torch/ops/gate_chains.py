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

Execution (``run_chain``) applies the tables one gate at a time: CUDA
tensors go through ``csrc/gate_chain.cu`` (one launch per gate), CPU
tensors through ``run_chain_plain``.
"""

import ctypes
import itertools
from collections import namedtuple

import torch

from cotengra_tpu.utils.misc import prod

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
    ``key()``); ``gate_strides`` is what the port executes.
    """

    __slots__ = (
        "in_view", "out_view", "in_block", "out_block",
        "seg_sizes", "in_seg_axes", "out_seg_axes",
        "r2", "c_dim", "c_blk",
        "gates",
        "grid",
        "gate_strides",  # tuple of GateStrides, one per gate
        "_key",
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


def gate_strides(in_order, out_order, c_order, ny_order, sizes):
    """:class:`GateStrides` of one gate taking a tensor stored in
    ``in_order`` to one stored in ``out_order``, contracting ``c_order``
    (y's K legs) and creating ``ny_order`` (y's N legs)."""
    sin, numel_in = _strides(in_order, sizes)
    sout, numel_out = _strides(out_order, sizes)
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
    spec.gate_strides = tuple(
        gate_strides(o_in, o_out, c_order, ny_order, sizes)
        for (o_in, o_out), (c_order, ny_order) in zip(
            gate_orders, c_orders
        )
    )

    return spec, tuple(order), tuple(c_orders)


# -- execution ---------------------------------------------------------------


def _gate_plain(x, y, g):
    """One gate in plain PyTorch: a strided view of x as (2, B, K), a
    complex (B, K) @ (K, N) on the planes, and a strided write of the
    (2, B, N) result into the output's leg order."""
    bsz = tuple(d[0] for d in g.batch)
    ksz = tuple(d[0] for d in g.kdims)
    nsz = tuple(d[0] for d in g.ndims)
    B, K, N = prod(bsz), prod(ksz), prod(nsz)
    xv = x.as_strided(
        (2,) + bsz + ksz,
        (g.numel_in,)
        + tuple(d[1] for d in g.batch)
        + tuple(d[1] for d in g.kdims),
    ).reshape(2, B, K)
    yr, yi = y[0], y[1]
    res = torch.stack(
        [xv[0] @ yr - xv[1] @ yi, xv[0] @ yi + xv[1] @ yr]
    )
    out = x.new_empty(2 * g.numel_out)
    out.as_strided(
        (2,) + bsz + nsz,
        (g.numel_out,)
        + tuple(d[2] for d in g.batch)
        + tuple(d[1] for d in g.ndims),
    ).copy_(res.view((2,) + bsz + nsz))
    return out


def run_chain_plain(spec, x_flat, ys):
    """Plain PyTorch version of the chain: one strided complex matmul
    per gate. Runs on any device; :func:`run_chain` uses it for CPU
    tensors only, and ``chip_smoke.py`` compares the kernel with it."""
    for g, y in zip(spec.gate_strides, ys, strict=True):
        x_flat = _gate_plain(x_flat, y, g)
    return x_flat


# limits of the kernel's argument block (csrc/gate_chain.cu)
_MAX_BATCH_DIMS = 24
_MAX_GATE_AXES = 16


def _gate_meta(g):
    """The int64 argument block of one gate launch (layout read by
    ``ctg_gate_apply_f32`` in csrc/gate_chain.cu)."""
    n_batch = prod(d[0] for d in g.batch)
    if len(g.batch) > _MAX_BATCH_DIMS:
        raise ValueError(f"{len(g.batch)} batch runs > {_MAX_BATCH_DIMS}")
    if max(len(g.kdims), len(g.ndims)) > _MAX_GATE_AXES:
        raise ValueError(f"gate has more than {_MAX_GATE_AXES} axes")
    if n_batch >= 2**32:
        raise ValueError("gate batch count must be below 2**32")
    meta = [len(g.batch), len(g.kdims), len(g.ndims), n_batch,
            g.numel_in, g.numel_out]
    for d in g.batch:
        meta.extend(d)
    for d in g.kdims + g.ndims:
        meta.extend(d)
    return (ctypes.c_int64 * len(meta))(*meta)


def run_chain_cuda(spec, x_flat, ys):
    """Launch ``csrc/gate_chain.cu`` once per gate on CUDA float32
    planes. ``run_chain_cuda.launches`` counts the launches."""
    from ._build import load_library

    if x_flat.device.type != "cuda":
        raise ValueError("run_chain_cuda needs a CUDA tensor")
    if x_flat.dtype != torch.float32 or x_flat.dim() != 1:
        raise ValueError("gate-chain kernel takes flat float32 planes")
    if not x_flat.is_contiguous():
        raise ValueError("gate-chain kernel needs contiguous x")
    lib = load_library()
    stream = torch.cuda.current_stream(x_flat.device).cuda_stream
    for g, y in zip(spec.gate_strides, ys, strict=True):
        K = prod(d[0] for d in g.kdims)
        N = prod(d[0] for d in g.ndims)
        if K * N > MAX_GATE_COMBOS:
            raise ValueError(f"gate K*N = {K * N} > {MAX_GATE_COMBOS}")
        if (
            y.device != x_flat.device
            or y.dtype != torch.float32
            or tuple(y.shape) != (2, K, N)
            or not y.is_contiguous()
        ):
            raise ValueError(
                f"gate must be contiguous float32 (2, {K}, {N}) on "
                f"{x_flat.device}, got {y.dtype} {tuple(y.shape)} on "
                f"{y.device}"
            )
        if x_flat.numel() != 2 * g.numel_in:
            raise ValueError("x does not match the gate's input size")
        out = torch.empty(
            2 * g.numel_out, dtype=torch.float32, device=x_flat.device
        )
        meta = _gate_meta(g)
        rc = lib.ctg_gate_apply_f32(
            x_flat.data_ptr(), out.data_ptr(), y.data_ptr(), meta,
            len(meta), stream,
        )
        if rc != 0:
            raise RuntimeError(
                f"gate-chain kernel launch failed: CUDA error {rc}"
            )
        run_chain_cuda.launches += 1
        x_flat = out
    return x_flat


run_chain_cuda.launches = 0


def run_chain(spec, x_flat, ys):
    """Apply the chain to plane-major flat ``x_flat`` (real plane, then
    imaginary plane, in the chain's input leg order); ``ys`` are the
    realigned (2, K, N) gates. Returns the flat planes in the chain's
    ``out_order``.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes
    the plain version.
    """
    if x_flat.device.type == "cuda":
        return run_chain_cuda(spec, x_flat, ys)
    if x_flat.device.type == "cpu":
        return run_chain_plain(spec, x_flat, ys)
    raise ValueError(f"no gate-chain path for device {x_flat.device}")
