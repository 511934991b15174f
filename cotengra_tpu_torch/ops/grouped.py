"""The grouped split-complex executor on torch tensors.

Runs the plans of :func:`.grouped_plan.plan_grouped` as the reference
``cotengra_tpu/ops/grouped.py::_exec_steps_split`` does: every
intermediate is one flat real tensor of length ``2 * numel`` (real
plane, then imaginary plane), its leg order tracked by the plan, and
each step works on merged blocks of legs, never at full rank. The
intermediates of the Sycamore plans reach rank 27, beyond the 25 dims a
CUDA TensorIterator takes; a block transpose that still keeps more than
25 blocks apart is copied in parts (``permute_copy``).

What the reference carries only for the TPU and its compiler is gone:
the (8, 128) tile splitting of block transposes, the one-hot matmul
transposes, the multipass transposes, optimisation barriers and staged
jit. Each is named where its replacement stands.
"""

import torch

from .._device import resolve_device, resolve_plane_dtype
from .gate_chains import run_chain
from .grouped_plan import plan_grouped
from .lowering import extract_contractions, sliced_input_legs
from .pairwise import apply_pairwise, apply_single
from .slices import SliceBatch

# leg label reserved for the plane axis in single-term ops
_PLANE = "\x00plane"


def _to_planes(a, plane_dtype):
    """A tensor -> its ``(2, *shape)`` re/im planes of ``plane_dtype``,
    on its device; a real tensor gets a zero imaginary plane."""
    if a.is_complex():
        return torch.stack([a.real, a.imag]).to(plane_dtype)
    a = a.to(plane_dtype)
    return torch.stack([a, torch.zeros_like(a)])


def _planes_to_complex(flat, shape):
    """flat (2*numel,) planes -> complex tensor of ``shape``."""
    planes = flat.view((2,) + tuple(shape))
    return torch.complex(planes[0], planes[1])


# a CUDA TensorIterator copy takes at most this many dims
MAX_COPY_DIMS = 25


def _copy_permuted(out, src, max_dims):
    """``out.copy_(src)`` for a contiguous ``out`` and a strided ``src``
    of the same shape, in copies of at most ``max_dims`` dims: above it,
    one copy per index of the narrowest output axis but the last."""
    if src.dim() <= max_dims:
        out.copy_(src)
        return
    k = min(range(src.dim() - 1), key=lambda a: src.shape[a])
    for j in range(src.shape[k]):
        _copy_permuted(out.select(k, j), src.select(k, j), max_dims)


def permute_copy(x, perm, max_dims=None):
    """``x.permute(perm)`` as a new contiguous tensor.

    A block transpose of a rank-27 Sycamore intermediate can keep more
    blocks apart than a CUDA copy takes dims (``max_dims``, by default
    ``MAX_COPY_DIMS``); such a copy is split over the narrowest output
    axes (a rank-28 view of binary legs: 8 copies).
    """
    if max_dims is None:
        max_dims = MAX_COPY_DIMS
    src = x.permute(perm)
    if src.dim() <= max_dims:
        return src.contiguous()
    out = torch.empty(src.shape, dtype=x.dtype, device=x.device)
    _copy_permuted(out, src, max_dims)
    return out


# The reference's _apply_plan_matmul (one-hot matmul transposes),
# _multipass_plan / transpose_synth.py (multipass copies) and
# _split_block_factors (128-split tiles) worked around TPU tiling; a
# GPU copy needs none of them.
def _apply_block_plan_split(flat, plan):
    """Block transpose of plane-major flat storage: both planes move with
    the same plan, the plane dim stays leading. One permuted copy, split
    where it has more than ``MAX_COPY_DIMS`` dims."""
    if plan is None:
        return flat
    block_dims, perm = plan
    return permute_copy(
        flat.view((2,) + tuple(block_dims)),
        (0,) + tuple(p + 1 for p in perm),
    ).view(-1)


def _split_pair_scattered(x_flat, yf, p, block_dims, kpos):
    """One real contraction on the un-realigned x view.

    lhs (2N, 2, K) carries the complex combine over the plane axis: out
    rows [0:N] = yr.xr - yi.xi (real), rows [N:2N] = yi.xr + yr.xi
    (imag); contracting (plane, K-dims) of the stored view yields
    (2N, *m-dims), already plane-major (N, M).
    """
    N, K = p.N, p.K
    if p.mode == "mm":
        y2 = yf.view(2, N, K)
        yr, yi = y2[0], y2[1]
    else:  # y stored (K, N)
        y2 = yf.view(2, K, N)
        yr, yi = y2[0].T, y2[1].T
    lhs = torch.stack(
        [torch.cat([yr, yi]), torch.cat([-yi, yr])], dim=1
    )  # (2N, 2, K)
    kdims = tuple(block_dims[q] for q in kpos)
    lhs = lhs.reshape((2 * N, 2) + kdims)
    x2 = x_flat.view((2,) + tuple(block_dims))
    out = torch.tensordot(
        lhs,
        x2,
        dims=(
            list(range(1, 2 + len(kpos))),
            [0] + [q + 1 for q in kpos],
        ),
    )  # (2N, *mdims)
    return out.reshape(-1)


def _split_apply_small_y(xf, x_layout, M, K, N, ykn_r, ykn_i):
    """Apply a small (K, N) complex gate (planes ``ykn_r/ykn_i``) to the
    big plane-flat ``xf`` (logical (K, M) in ``x_layout``). Returns
    plane-flat (2*N*M,) in (N, M) order. B == 1 only."""
    if K < 8:
        # mac: unrolled plane MACs on (strided) 1-D slices
        if x_layout == "cm":
            xv = xf.view(2, K, M)
        else:
            xv = xf.view(2, M, K).transpose(1, 2)
        cols_r, cols_i = [], []
        for n in range(N):
            accr = acci = None
            for k in range(K):
                xr, xi = xv[0, k], xv[1, k]
                tr = xr * ykn_r[k, n] - xi * ykn_i[k, n]
                ti = xr * ykn_i[k, n] + xi * ykn_r[k, n]
                accr = tr if accr is None else accr + tr
                acci = ti if acci is None else acci + ti
            cols_r.append(accr)
            cols_i.append(acci)
        return torch.cat(cols_r + cols_i)

    if N < 8:
        # matvec: per-column matvecs
        cols_r, cols_i = [], []
        if x_layout == "cm":
            # stacked planes (2K, M); the complex combine is embedded in
            # the 2K-vector: zr = [yr; -yi] . X, zi = [yi; yr] . X
            x2 = xf.view(2 * K, M)
            for n in range(N):
                vr = torch.cat([ykn_r[:, n], -ykn_i[:, n]])
                vi = torch.cat([ykn_i[:, n], ykn_r[:, n]])
                cols_r.append(vr @ x2)
                cols_i.append(vi @ x2)
        else:
            # stacked planes (2M, K): a real y column hits both planes
            x2 = xf.view(2 * M, K)
            for n in range(N):
                a = x2 @ ykn_r[:, n]
                b = x2 @ ykn_i[:, n]
                cols_r.append(a[:M] - b[M:])
                cols_i.append(b[:M] + a[M:])
        return torch.cat(cols_r + cols_i)

    # mm: K >= 8, N >= 8
    yrT, yiT = ykn_r.T, ykn_i.T  # (N, K)
    if x_layout == "cm":
        yb = torch.cat(
            [torch.cat([yrT, -yiT], dim=1), torch.cat([yiT, yrT], dim=1)]
        )  # (2N, 2K): the real block embedding of the complex gate
        # (2N, M) = planes of (N, M), already plane-major
        return (yb @ xf.view(2 * K, M)).reshape(-1)
    x2 = xf.view(2 * M, K)
    a = yrT @ x2.T  # (N, 2M)
    b = yiT @ x2.T
    zr = a[:, :M] - b[:, M:]
    zi = b[:, :M] + a[:, M:]
    return torch.cat([zr.reshape(-1), zi.reshape(-1)])


# The reference's _maybe_barrier has no counterpart: eager torch ops do
# not fuse across steps.
def _exec_steps_split(plans, steps, temps, shapes, last_use,
                      strip_exponent=False):
    """Run the plan steps ``steps`` (indices into ``plans``, in order)
    over ``temps`` (id -> plane-major flat real tensor, freed after its
    last use); ``shapes`` maps id -> logical complex shape. Returns the
    summed log10 exponent of the stripped steps (None if nothing was
    stripped)."""
    exponent = None

    def store(out_id, flat, shape, si, srcs):
        temps[out_id] = flat
        shapes[out_id] = tuple(shape)
        for vid in srcs:
            if last_use.get(vid) == si:
                temps.pop(vid, None)

    def strip(flat):
        # max over both planes, as the reference: max(|re|, |im|), not
        # the modulus
        nonlocal exponent
        absmax = flat.abs().amax()
        scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
        e = torch.log10(scale)
        exponent = e if exponent is None else exponent + e
        return flat / scale

    for si in steps:
        kind, info = plans[si]
        if kind == "single":
            step = info
            x2 = temps[step.inp].view((2,) + tuple(shapes[step.inp]))
            out = apply_single(
                x2,
                (_PLANE,) + tuple(step.in_legs),
                (_PLANE,) + tuple(step.out_legs),
            )
            store(
                step.out, out.reshape(-1), out.shape[1:], si, (step.inp,)
            )
            continue

        if kind == "fallback":
            step, x_id, y_id, x_order, y_order, x_dims, y_dims = info
            xc = _planes_to_complex(temps[x_id], x_dims)
            yc = _planes_to_complex(temps[y_id], y_dims)
            out = apply_pairwise(xc, yc, x_order, y_order, step.out_legs)
            flat = torch.cat(
                [out.real.reshape(-1), out.imag.reshape(-1)]
            )
            if strip_exponent:
                flat = strip(flat)
            store(step.out, flat, out.shape, si, (x_id, y_id))
            continue

        if kind == "inplace":
            rec = info
            ys = [
                _apply_block_plan_split(temps[y_id], y_plan).view(2, K, N)
                for y_id, y_plan, K, N in rec.ys
            ]
            out = run_chain(rec.spec, temps[rec.x_id], ys)
            # no strip, as in the reference: chains are near-unitary and
            # the surrounding pair steps strip
            store(
                rec.out_id, out, rec.out_shape, si,
                (rec.x_id, *(y[0] for y in rec.ys)),
            )
            continue

        p = info
        B, M, K, N = p.B, p.M, p.K, p.N
        if p.scatter is not None:
            yf = _apply_block_plan_split(temps[p.y_id], p.y_plan)
            out = _split_pair_scattered(
                temps[p.x_id], yf, p, p.scatter[0], p.scatter[1]
            )
            if strip_exponent:
                out = strip(out)
            store(p.out_id, out, (B, N, M), si, (p.x_id, p.y_id))
            continue
        xf = _apply_block_plan_split(temps[p.x_id], p.x_plan)
        yf = _apply_block_plan_split(temps[p.y_id], p.y_plan)

        if p.mode == "bmm":
            x3 = xf.view(2, B, K, M)
            y3 = yf.view(2, B, N, K)
            rr = torch.bmm(y3[0], x3[0])
            ii = torch.bmm(y3[1], x3[1])
            ri = torch.bmm(y3[1], x3[0])
            ir = torch.bmm(y3[0], x3[1])
            out = torch.cat([(rr - ii).reshape(-1), (ri + ir).reshape(-1)])
        else:
            # y stored as (K, N) for mac/matvec, (N, K) for mm
            if p.mode == "mm":
                y2 = yf.view(2, N, K)
                ykn_r, ykn_i = y2[0].T, y2[1].T
            else:
                y2 = yf.view(2, K, N)
                ykn_r, ykn_i = y2[0], y2[1]
            out = _split_apply_small_y(
                xf, p.x_layout, M, K, N, ykn_r, ykn_i
            )
        if strip_exponent:
            out = strip(out)
        store(p.out_id, out, (B, N, M), si, (p.x_id, p.y_id))
    return exponent


def _step_io(plans):
    """(source ids, output id) of each plan step."""
    for kind, info in plans:
        if kind == "single":
            yield (info.inp,), info.out
        elif kind == "fallback":
            yield (info[1], info[2]), info[0].out
        elif kind == "inplace":
            yield (info.x_id, *(y[0] for y in info.ys)), info.out_id
        else:
            yield (info.x_id, info.y_id), info.out_id


SLICE_BATCH_MODES = ("auto", "scan", "vmap")


def make_grouped_contractor(
    tree, device="cuda", plane_dtype=torch.float32, gate_mode="auto",
    strip_exponent=False, slice_batch=None, slice_batch_mode="auto",
    constants=None,
):
    """Plan ``tree`` once and return ``fn(*planes) -> planes``.

    ``fn`` takes one ``(2, *shape)`` plane stack per (sliced) input, on
    ``device`` in ``plane_dtype`` (see :func:`..convert.to_plane_tensors`),
    and returns the ``(2, *out_shape)`` planes of the result; with
    ``strip_exponent``, ``(planes, log10 exponent)``, every pair step's
    result renormalised by the max over both its planes (not after
    single steps or in-place chains, as in the reference).

    ``slice_batch=B`` makes it ``fn(planes, slice_ids)``, as the
    reference's: ``planes`` are the RAW (unsliced) plane stacks and
    ``slice_ids`` the flat ids of the slices to contract (ints, a range,
    a numpy array or a CPU tensor; see ``slices._ids_to_digits``), B of
    them as a rule, though any number runs.
    It returns the ``(len(slice_ids), 2, *out_shape)`` per-slice planes,
    and a ``(len(slice_ids),)`` exponent vector under
    ``strip_exponent``; the caller sums them. The steps that no sliced
    index reaches run once per call, the others once per slice, on views
    selected from the raw planes (``slice_batch_mode="scan"``, which
    ``"auto"`` resolves to: one slice's memory at a time). ``"vmap"``,
    all slices of the batch at once, is not ported (ROADMAP A8).
    With ``constants`` (input positions whose planes never change),
    ``fn.fold(planes)`` runs the steps that only constants reach once,
    and ``fn(planes, slice_ids, folded)`` reuses its result
    (``slices.SliceBatch``).

    ``gate_mode="auto"`` resolves to ``"inplace"`` (gate chains), as the
    reference's split-complex default does; ``None`` plans pairs only.
    There is no staging: it worked around the TPU compiler.
    """
    dev = resolve_device(device)
    pdt = resolve_plane_dtype(plane_dtype)
    if gate_mode == "auto":
        gate_mode = "inplace"
    if slice_batch_mode not in SLICE_BATCH_MODES:
        raise ValueError(
            f"slice_batch_mode must be one of {SLICE_BATCH_MODES}, got "
            f"{slice_batch_mode!r}"
        )
    if slice_batch and slice_batch_mode == "vmap":
        raise NotImplementedError(
            "slice_batch_mode='vmap' (all slices of a batch at once) is "
            "not ported (ROADMAP A8: a batch leg through the chain "
            "kernel); use 'scan'"
        )
    ir = extract_contractions(tree)
    input_orders = [sliced_input_legs(tree, i) for i in range(tree.N)]
    plans, _, out_plan, out_shape, last_use = plan_grouped(
        ir, tree.size_dict, input_orders, gate_mode=gate_mode
    )
    sizes = tree.size_dict
    in_shapes = [tuple(sizes[ix] for ix in order) for order in input_orders]

    def check(planes, shapes):
        if len(planes) != len(shapes):
            raise ValueError(
                f"expected {len(shapes)} inputs, got {len(planes)}"
            )
        for i, (a, shape) in enumerate(zip(planes, shapes)):
            if a.device != dev or a.dtype != pdt:
                raise ValueError(
                    f"input {i} is {a.dtype} on {a.device}; the "
                    f"contractor runs {pdt} on {dev}"
                )
            if tuple(a.shape) != (2,) + tuple(shape):
                raise ValueError(
                    f"input {i} has shape {tuple(a.shape)}, expected "
                    f"{(2,) + tuple(shape)}"
                )

    def finish(temps):
        flat = _apply_block_plan_split(temps[ir.final_id], out_plan)
        return flat.view((2,) + tuple(out_shape))

    def zero():
        return torch.zeros((), dtype=pdt, device=dev)

    if slice_batch:
        batch = SliceBatch(tree, list(_step_io(plans)), last_use, constants)
        # every call stores the same shape under an id, so one map
        # serves them all, the folded steps' ids included
        shapes = dict(enumerate(in_shapes))

        def run_steps(steps, temps, lu):
            return _exec_steps_split(
                plans, steps, temps, shapes, lu, strip_exponent
            )

        def prepare(view):
            # a selected view is strided: one explicit copy makes it the
            # contiguous flat planes that the steps and the chain kernel
            # take
            return view.contiguous().view(-1)

        def fn(planes, slice_ids, folded=None):
            check(planes, tree.get_shapes())
            outs, exps = [], []
            for temps, e in batch.run(
                planes, slice_ids, run_steps, prepare, axis_offset=1,
                folded=folded,
            ):
                outs.append(finish(temps))
                exps.append(zero() if e is None else e)
            res = torch.stack(outs)
            return (res, torch.stack(exps)) if strip_exponent else res

        def fold(planes):
            check(planes, tree.get_shapes())
            return batch.fold(planes, run_steps, prepare, axis_offset=1)

        fn.plans = plans
        fn.batch = batch
        fn.fold = fold
        return fn

    def fn(*planes):
        check(planes, in_shapes)
        temps = {i: a.reshape(-1) for i, a in enumerate(planes)}
        shapes = dict(enumerate(in_shapes))
        exponent = _exec_steps_split(
            plans, range(len(plans)), temps, shapes, last_use,
            strip_exponent,
        )
        planes = finish(temps)
        if not strip_exponent:
            return planes
        return planes, zero() if exponent is None else exponent

    fn.plans = plans
    return fn
