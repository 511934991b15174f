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
transposes, the multipass transposes and optimisation barriers. Each is
named where its replacement stands. Its staged jit has a counterpart:
``make_grouped_staged_contractor`` captures the plan's stages as CUDA
graphs (``capture.py``).
"""

import torch

from .. import tracing
from .._device import resolve_device, resolve_plane_dtype
from ..tracing import STEP_CALLS
from ..utils.misc import prod
from .capture import (
    Graphs,
    clone_outputs,
    load,
    note_step,
    run_stages,
    stage_carries,
)
from .gate_chains import _kernel_args, run_chain
from .grouped_plan import plan_grouped
from .lowering import extract_contractions, sliced_input_legs
from .pairwise import apply_pairwise, apply_single
from .slices import (
    SliceBatch,
    _add_exponents,
    _flat_ids,
    _ids_to_digits,
    device_digits,
)
from .windowed import build_w4, exec_window, expand_index

# leg labels reserved for the plane axis and a batch's slice axis in
# the einsum steps
_PLANE = "\x00plane"
_SLICE = "\x00slice"


def _to_planes(a, plane_dtype):
    """A tensor -> its ``(2, *shape)`` re/im planes of ``plane_dtype``,
    on its device; a real tensor gets a zero imaginary plane."""
    if a.is_complex():
        return torch.stack([a.real, a.imag]).to(plane_dtype)
    a = a.to(plane_dtype)
    return torch.stack([a, torch.zeros_like(a)])


def _lead(flat):
    """``(S,)`` for a batch's rows, ``()`` for one slice's planes."""
    return tuple(flat.shape[:-1])


def _planes_to_complex(flat, shape):
    """flat (2*numel,) planes -> complex tensor of ``shape``; a batch's
    (S, 2*numel) rows -> (S, *shape)."""
    planes = flat.view(_lead(flat) + (2,) + tuple(shape))
    return torch.complex(*planes.unbind(-1 - len(shape)))


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
    the same plan, the plane dim (and a batch's slice dim before it)
    stays leading. One permuted copy, split where it has more than
    ``MAX_COPY_DIMS`` dims, the slice dim counted."""
    if plan is None:
        return flat
    block_dims, perm = plan
    lead = _lead(flat)
    nl = len(lead)
    return permute_copy(
        flat.view(lead + (2,) + tuple(block_dims)),
        tuple(range(nl + 1)) + tuple(p + nl + 1 for p in perm),
    ).view(lead + (-1,))


def _permuted_view(x, perm, shape):
    """``x.permute(perm)`` viewed as ``shape``, copied (``permute_copy``
    past ``MAX_COPY_DIMS``) only where no view exists."""
    src = x.permute(perm)
    if src.dim() <= MAX_COPY_DIMS:
        return src.reshape(shape)  # a view, else one contiguous copy
    try:
        return src.view(shape)
    except RuntimeError:
        return permute_copy(x, perm).view(shape)


# Every step below takes a leading slice dim on x, y, both or neither:
# a stored id holds a batch's (S, 2 * numel) rows ("vmap") or one
# slice's (2 * numel,) planes, and an operand without the slice dim
# broadcasts.


def _split_pair_scattered(x_flat, yf, p, block_dims, kpos):
    """One real contraction on the un-realigned x view, a leading slice
    dim on x, y, both or neither.

    lhs (2N, 2, K) carries the complex combine over the plane axis: out
    rows [0:N] = yr.xr - yi.xi (real), rows [N:2N] = yi.xr + yr.xi
    (imag). The stored view's plane and K blocks are gathered in front,
    (2K, M), and one GEMM with the lhs (2N, 2K), batched where a slice
    dim is, yields (2N, M), already plane-major.
    """
    N, K = p.N, p.K
    lead_x, lead_y = _lead(x_flat), _lead(yf)
    if p.mode == "mm":
        y2 = yf.view(lead_y + (2, N, K))
        yr, yi = y2.select(-3, 0), y2.select(-3, 1)
    else:  # y stored (K, N)
        y2 = yf.view(lead_y + (2, K, N))
        yr, yi = y2.select(-3, 0).mT, y2.select(-3, 1).mT
    lhs = torch.stack(
        [torch.cat([yr, yi], -2), torch.cat([-yi, yr], -2)], dim=-2
    )  # (2N, 2, K)
    nl = len(lead_x)
    mpos = [q for q in range(len(block_dims)) if q not in kpos]
    perm = (
        tuple(range(nl + 1))
        + tuple(q + nl + 1 for q in kpos)
        + tuple(q + nl + 1 for q in mpos)
    )
    M = prod(block_dims[q] for q in mpos)
    xk = _permuted_view(
        x_flat.view(lead_x + (2,) + tuple(block_dims)), perm,
        lead_x + (2 * K, M),
    )
    out = torch.matmul(lhs.reshape(lead_y + (2 * N, 2 * K)), xk)
    return out.flatten(-2)


def _mv(v, m):
    """``v @ m`` for a vector ``v`` and a matrix ``m``, either with a
    leading slice dim."""
    if v.dim() == 1:
        return v @ m
    return (v.unsqueeze(-2) @ m).squeeze(-2)


def _mv_right(m, v):
    """``m @ v`` for a matrix ``m`` and a vector ``v``, either with a
    leading slice dim."""
    if v.dim() == 1:
        return m @ v
    return (m @ v.unsqueeze(-1)).squeeze(-1)


def _split_apply_small_y(xf, x_layout, M, K, N, ykn_r, ykn_i):
    """Apply a small (K, N) complex gate (planes ``ykn_r/ykn_i``) to the
    big plane-flat ``xf`` (logical (K, M) in ``x_layout``), a leading
    slice dim on ``xf`` (S, 2*K*M), on the gate (S, K, N), both or
    neither. Returns plane-flat (2*N*M,) in (N, M) order per slice.
    Where x alone has the slice dim, the slices fold into x's free legs
    of the same GEMM."""
    lead = _lead(xf)
    if K < 8:
        # mac: unrolled plane MACs on (strided) 1-D slices
        if x_layout == "cm":
            xv = xf.view(lead + (2, K, M))
        else:
            xv = xf.view(lead + (2, M, K)).transpose(-1, -2)
        batched_y = ykn_r.dim() > 2
        xs = xv.unbind(-3)
        xr_k, xi_k = xs[0].unbind(-2), xs[1].unbind(-2)
        cols_r, cols_i = [], []
        for n in range(N):
            accr = acci = None
            for k in range(K):
                xr, xi = xr_k[k], xi_k[k]
                if batched_y:  # a gate per slice: (S, 1) against (M,)
                    yr, yi = ykn_r[:, k, n, None], ykn_i[:, k, n, None]
                else:
                    yr, yi = ykn_r[k, n], ykn_i[k, n]
                tr = xr * yr - xi * yi
                ti = xr * yi + xi * yr
                accr = tr if accr is None else accr + tr
                acci = ti if acci is None else acci + ti
            cols_r.append(accr)
            cols_i.append(acci)
        return torch.cat(cols_r + cols_i, dim=-1)

    if N < 8:
        # matvec: per-column matvecs
        cols_r, cols_i = [], []
        if x_layout == "cm":
            # stacked planes (2K, M); the complex combine is embedded in
            # the 2K-vector: zr = [yr; -yi] . X, zi = [yi; yr] . X
            x2 = xf.view(lead + (2 * K, M))
            for n in range(N):
                vr = torch.cat([ykn_r[..., n], -ykn_i[..., n]], -1)
                vi = torch.cat([ykn_i[..., n], ykn_r[..., n]], -1)
                cols_r.append(_mv(vr, x2))
                cols_i.append(_mv(vi, x2))
        else:
            # stacked planes (2M, K): a real y column hits both planes
            x2 = xf.view(lead + (2 * M, K))
            for n in range(N):
                a = _mv_right(x2, ykn_r[..., n])
                b = _mv_right(x2, ykn_i[..., n])
                cols_r.append(a[..., :M] - b[..., M:])
                cols_i.append(b[..., :M] + a[..., M:])
        return torch.cat(cols_r + cols_i, dim=-1)

    # mm: K >= 8, N >= 8
    yrT, yiT = ykn_r.mT, ykn_i.mT  # (N, K)
    if x_layout == "cm":
        yb = torch.cat(
            [torch.cat([yrT, -yiT], dim=-1), torch.cat([yiT, yrT], dim=-1)],
            dim=-2,
        )  # (2N, 2K): the real block embedding of the complex gate
        # (2N, M) = planes of (N, M), already plane-major
        return (yb @ xf.view(lead + (2 * K, M))).flatten(-2)
    x2 = xf.view(lead + (2 * M, K))
    a = yrT @ x2.mT  # (N, 2M)
    b = yiT @ x2.mT
    zr = a[..., :M] - b[..., M:]
    zi = b[..., :M] + a[..., M:]
    return torch.cat([zr.flatten(-2), zi.flatten(-2)], dim=-1)


def _pair(p, xf, yf):
    """A bmm / mac / matvec / mm pair step on realigned operands, a
    leading slice dim on x, y, both or neither."""
    B, M, K, N = p.B, p.M, p.K, p.N
    lead_x, lead_y = _lead(xf), _lead(yf)
    if p.mode == "bmm":
        x3 = xf.view(lead_x + (2, B, K, M))
        y3 = yf.view(lead_y + (2, B, N, K))
        xr, xi = x3.select(-4, 0), x3.select(-4, 1)
        yr, yi = y3.select(-4, 0), y3.select(-4, 1)
        rr, ii = torch.matmul(yr, xr), torch.matmul(yi, xi)
        ri, ir = torch.matmul(yi, xr), torch.matmul(yr, xi)
        return torch.cat([(rr - ii).flatten(-3), (ri + ir).flatten(-3)],
                         dim=-1)
    # y stored as (K, N) for mac/matvec, (N, K) for mm
    if p.mode == "mm":
        y2 = yf.view(lead_y + (2, N, K))
        ykn_r, ykn_i = y2.select(-3, 0).mT, y2.select(-3, 1).mT
    else:
        y2 = yf.view(lead_y + (2, K, N))
        ykn_r, ykn_i = y2.select(-3, 0), y2.select(-3, 1)
    return _split_apply_small_y(xf, p.x_layout, M, K, N, ykn_r, ykn_i)


def _kron(a, b):
    """``torch.kron`` of the last two dims of ``a`` and ``b``, a leading
    slice dim on either broadcast."""
    out = torch.einsum("...ij,...kl->...ikjl", a, b)
    return out.reshape(out.shape[:-4] + (
        a.shape[-2] * b.shape[-2], a.shape[-1] * b.shape[-1]
    ))


# The reference's _maybe_barrier has no counterpart: eager torch ops do
# not fuse across steps.
def _exec_steps_split(plans, steps, temps, shapes, last_use,
                      strip_exponent=False):
    """Run the plan steps ``steps`` (indices into ``plans``, in order)
    over ``temps`` (id -> plane-major flat real tensor, freed after its
    last use); ``shapes`` maps id -> logical complex shape. Returns the
    summed log10 exponent of the stripped steps (None if nothing was
    stripped).

    A stored id of a batch of slices (``"vmap"``) holds ``(S, 2 *
    numel)``, one row per slice; the others hold ``(2 * numel,)`` and
    are shared by every slice. A step with a batched operand gives a
    batched result, and its strip is per slice: the exponent is then a
    ``(S,)`` vector. ``tracing.STEP_CALLS`` counts the calls: a replay
    of captured graphs makes none."""
    STEP_CALLS["_exec_steps_split"] += 1
    if tracing.ON:
        tracing.begin()
    exponent = None

    def store(out_id, flat, shape, si, srcs):
        temps[out_id] = flat
        shapes[out_id] = tuple(shape)
        for vid in srcs:
            if last_use.get(vid) == si:
                temps.pop(vid, None)
        if tracing.ON:  # every step ends here
            tracing.end("executor.step", si, plans[si][0])

    def strip(flat):
        # max over both planes, as the reference: max(|re|, |im|), not
        # the modulus; a batch's slices each by their own
        nonlocal exponent
        absmax = flat.abs().amax(dim=-1, keepdim=True)
        scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
        e = torch.log10(scale).squeeze(-1)
        exponent = e if exponent is None else exponent + e
        return flat / scale

    si = None
    try:
        for si in steps:
            if tracing.ON:
                tracing.begin()
            kind, info = plans[si]
            if kind == "single":
                step = info
                flat = temps[step.inp]
                lead = (_SLICE,) * (flat.dim() - 1)
                x2 = flat.view(
                    flat.shape[:-1] + (2,) + tuple(shapes[step.inp])
                )
                out = apply_single(
                    x2,
                    lead + (_PLANE,) + tuple(step.in_legs),
                    lead + (_PLANE,) + tuple(step.out_legs),
                )
                store(
                    step.out, out.reshape(flat.shape[:-1] + (-1,)),
                    out.shape[len(lead) + 1:], si, (step.inp,),
                )
                continue

            if kind == "fallback":
                step, x_id, y_id, x_order, y_order, x_dims, y_dims = info
                xf, yf = temps[x_id], temps[y_id]
                # the slice leg: kept on the batched operands, a batch
                # leg where both have it
                lx = (_SLICE,) * (xf.dim() - 1)
                ly = (_SLICE,) * (yf.dim() - 1)
                rows = _lead(xf) or _lead(yf)  # (S,) where either has it
                out = apply_pairwise(
                    _planes_to_complex(xf, x_dims),
                    _planes_to_complex(yf, y_dims),
                    lx + tuple(x_order), ly + tuple(y_order),
                    (_SLICE,) * len(rows) + tuple(step.out_legs),
                )
                flat = torch.cat([out.real.reshape(rows + (-1,)),
                                  out.imag.reshape(rows + (-1,))], dim=-1)
                if strip_exponent:
                    flat = strip(flat)
                store(step.out, flat, out.shape[len(rows):], si,
                      (x_id, y_id))
                continue

            if kind == "w2build":
                # a window step's operator, from its gates alone (see
                # hoist_window_operators)
                rec = info.rec
                ys = []
                for y_id, y_plan, K, N in rec.gates:
                    yf = _apply_block_plan_split(temps[y_id], y_plan)
                    ys.append(yf.view(yf.shape[:-1] + (2, K, N)))
                # the index arrays already on the device, where
                # prepare_device put them (CUDA and meta tensors)
                on_device = {} if info.index is None else {"index": info.index}
                w2 = build_w4(rec.recipe, ys, info.dtype, info.device,
                              **on_device)
                store(info.w2_id, w2, (2 * rec.S_in * rec.S_out,), si,
                      tuple(g[0] for g in rec.gates))
                continue

            if kind == "window":
                rec = info.rec
                out = exec_window(rec, temps[rec.x_id], temps[info.w2_id])
                # no strip, as in the reference: window chains are
                # near-unitary and the surrounding pair steps strip
                store(rec.out_id, out, rec.out_shape, si,
                      (rec.x_id, info.w2_id))
                continue

            if kind == "fusedchain":
                ch = info
                xf = _apply_block_plan_split(temps[ch.x_id], ch.x_plan)
                gk = None
                for gid, gorder, c_legs, n_legs in ch.gates:
                    gf = temps[gid]
                    lead = (_SLICE,) * (gf.dim() - 1)
                    g2 = apply_single(
                        _planes_to_complex(gf, shapes[gid]),
                        lead + tuple(gorder),
                        lead + tuple(c_legs) + tuple(n_legs),
                    )
                    dims = g2.shape[len(lead):]
                    g2 = g2.reshape(g2.shape[:len(lead)] + (
                        prod(dims[:len(c_legs)]), prod(dims[len(c_legs):])
                    ))
                    gk = g2 if gk is None else _kron(gk, g2)
                # The reference rounds the kron product to float32 even
                # under float64 planes (cotengra_tpu/ops/grouped.py:
                # 1649-1650); here it keeps the planes' precision.
                out = _split_apply_small_y(xf, ch.x_layout, ch.M, ch.K,
                                           ch.N, gk.real, gk.imag)
                if strip_exponent:
                    out = strip(out)
                store(ch.out_id, out, (1, ch.N, ch.M), si,
                      (ch.x_id, *(g[0] for g in ch.gates)))
                continue

            if kind == "inplace":
                rec = info
                ys = []
                for y_id, y_plan, K, N in rec.ys:
                    yf = _apply_block_plan_split(temps[y_id], y_plan)
                    ys.append(yf.view(yf.shape[:-1] + (2, K, N)))
                out = run_chain(rec.spec, temps[rec.x_id], ys)
                # no strip, as in the reference: chains are near-unitary and
                # the surrounding pair steps strip
                store(
                    rec.out_id, out, rec.out_shape, si,
                    (rec.x_id, *(y[0] for y in rec.ys)),
                )
                continue

            p = info
            if p.scatter is not None:
                yf = _apply_block_plan_split(temps[p.y_id], p.y_plan)
                out = _split_pair_scattered(temps[p.x_id], yf, p,
                                            *p.scatter)
            else:
                xf = _apply_block_plan_split(temps[p.x_id], p.x_plan)
                yf = _apply_block_plan_split(temps[p.y_id], p.y_plan)
                out = _pair(p, xf, yf)
            if strip_exponent:
                out = strip(out)
            store(p.out_id, out, (p.B, p.N, p.M), si, (p.x_id, p.y_id))
    except Exception as err:
        # the plan step that raised: a refused capture names it
        note_step(err, f"plan step {si} ({plans[si][0]})")
        raise
    if tracing.ON:
        tracing.end("executor.steps", len(steps))
    return exponent


def _step_io(plans):
    """(source ids, output id) of each step of an executor plan (see
    ``hoist_window_operators``)."""
    for kind, info in plans:
        if kind == "single":
            yield (info.inp,), info.out
        elif kind == "fallback":
            yield (info[1], info[2]), info[0].out
        elif kind == "inplace":
            yield (info.x_id, *(y[0] for y in info.ys)), info.out_id
        elif kind == "fusedchain":
            yield (info.x_id, *(g[0] for g in info.gates)), info.out_id
        elif kind == "w2build":
            yield tuple(g[0] for g in info.rec.gates), info.w2_id
        elif kind == "window":
            yield (info.rec.x_id, info.w2_id), info.rec.out_id
        else:
            yield (info.x_id, info.y_id), info.out_id


class _WindowOp:
    """A window step of an executor plan and the id of its operator,
    built by a ``"w2build"`` step of its own (``device`` and ``dtype``
    place a rotation's operator, which reads no gate; ``index`` holds
    the build's index arrays on the device, once ``prepare_device``
    has copied them there)."""

    __slots__ = ("rec", "w2_id", "device", "dtype", "index")


def hoist_window_operators(plans, final_id, num_inputs, device=None,
                           dtype=torch.float32):
    """The executor plan of ``plan_grouped``'s ``plans``: each window
    step preceded by the build of its operator ``W2`` as a step of its
    own (``"w2build"``), which reads only the gates and writes a fresh
    id that the window step reads. Returns ``(plans, last_use)``.

    This is the counterpart of the reference's operator hoist
    (``_plan_operator_hoist``, ``cotengra_tpu/ops/grouped.py:1891``),
    through the machinery that runs every step: ``SliceBatch`` runs a
    build once per call where no sliced index reaches its gates (and
    ``fold`` keeps it where only constants do), else once per slice
    under ``"scan"`` and once, stacked over the slices, under
    ``"vmap"``. The reference's cross-call cache of operators, keyed on
    the identity of the leaf arrays, is not copied: a tensor can change
    in place under the same identity. Nor is its option to build on
    the host CPU (``CTG_HOIST_BACKEND``), a workaround for the TPU's
    remote compiler.
    """
    next_id = 1 + max([num_inputs - 1] + [
        info.out if kind == "single"
        else info[0].out if kind == "fallback"
        else info.out_id
        for kind, info in plans
    ])
    out = []
    for kind, info in plans:
        if kind == "window":
            op = _WindowOp()
            op.rec, op.w2_id = info, next_id
            op.device, op.dtype, op.index = device, dtype, None
            next_id += 1
            out.append(("w2build", op))
            out.append(("window", op))
        else:
            out.append((kind, info))
    last_use = {}
    for si, (srcs, _) in enumerate(_step_io(out)):
        for vid in srcs:
            last_use[vid] = si
    last_use.pop(final_id, None)
    return out, last_use


SLICE_BATCH_MODES = ("auto", "scan", "vmap")

# "auto" on the card takes "vmap" only where the batch's live peak, the
# per-slice peak (``slice_peak_bytes``) times the slices, and the raw
# inputs fit this share of the card's memory (the rest: the caching
# allocator's slack and the GEMMs' workspaces) ...
VMAP_MEMORY_SHARE = 0.9
# ... and where one slice's live peak is at most this many bytes: the
# largest per-slice peak at which "vmap" was measured no slower than
# "scan" is m20-t28's 6.00 GiB (``auto_slice_batch_mode``).
VMAP_AUTO_MAX_SLICE_BYTES = 7 * 2**30


def _numel_out(kind, info, sizes):
    if kind == "single":
        return prod(sizes[ix] for ix in info.out_legs)
    if kind == "fallback":
        return prod(sizes[ix] for ix in info[0].out_legs)
    if kind == "inplace":
        return prod(info.out_shape)
    if kind == "window":
        return prod(info.rec.out_shape)
    if kind == "w2build":
        # W2 holds 4 S_in S_out floats: twice the planes of S_in S_out
        return 2 * info.rec.S_in * info.rec.S_out
    if kind == "fusedchain":
        return info.M * info.N
    return info.B * info.M * info.N


def slice_peak_bytes(plans, in_shapes, last_use, sizes, itemsize=4):
    """The live peak of one slice's steps, reckoned from the plan, in
    bytes of split-complex planes of ``itemsize``-byte floats: before
    each step the ids still live, plus the step's copies (realigned
    operands, the complex operands of a fallback einsum) and twice its
    output (the result and its stripped or flattened copy)."""
    numel = {i: prod(shape) for i, shape in enumerate(in_shapes)}
    live = sum(numel.values())
    peak = live
    for si, ((kind, info), (srcs, out)) in enumerate(
        zip(plans, _step_io(plans))
    ):
        n_out = _numel_out(kind, info, sizes)
        if kind == "fallback":
            copies = numel[srcs[0]] + numel[srcs[1]]
        elif kind == "pair":
            copies = (
                numel[info.x_id] * (info.x_plan is not None)
                + numel[info.y_id] * (info.y_plan is not None)
            )
        elif kind == "fusedchain":
            copies = numel[info.x_id] * (info.x_plan is not None)
        elif kind == "window":
            # the rotation copy of a non-prefix form
            copies = numel[info.rec.x_id] * (info.rec.form != "prefix")
        else:
            copies = 0
        peak = max(peak, live + copies + 2 * n_out)
        numel[out] = n_out
        live += n_out
        for vid in set(srcs):
            if last_use.get(vid) == si:
                live -= numel[vid]
    return 2 * itemsize * peak


def vmap_max_batch(slice_bytes, raw_bytes, device_bytes):
    """The most slices whose ``"vmap"`` batch fits: ``slices x
    slice_bytes + raw_bytes`` within ``VMAP_MEMORY_SHARE`` of
    ``device_bytes`` (0 if not even one does)."""
    room = VMAP_MEMORY_SHARE * device_bytes - raw_bytes
    return max(0, int(room // slice_bytes))


def auto_slice_batch_mode(device, slice_batch, slice_bytes, raw_bytes,
                          device_bytes):
    """What ``slice_batch_mode="auto"`` takes for a batch of
    ``slice_batch`` slices.

    CPU tensors take ``"scan"``. On the card, ``"vmap"`` where the batch
    fits (``vmap_max_batch``) and one slice's live peak is at most
    ``VMAP_AUTO_MAX_SLICE_BYTES``, else ``"scan"``. Warm seconds on an
    NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py`` phases 32-34,
    PERF.md), "vmap" against "scan":

    - m10-t27, 4 slices a call (3.0 GiB a slice): 0.1168 against 0.1241;
    - m20-t28, 16 slices in calls of 11 against one call of 16 (6.0 GiB
      a slice; 16 do not fit): 0.8030 against 0.9132;
    - the example's m10 tree sliced to 2^22, 512 slices in calls of 16
      (0.09 GiB a slice): 1.1028 against 9.2964.

    "vmap" was never slower; it saves host time (B times fewer step
    calls), so its gain grows as slices shrink, at B times the memory.
    The reference took scan once ``max_size * B > 2**24`` elements, a
    TPU's HBM budget.
    """
    if torch.device(device).type != "cuda":
        return "scan"
    if slice_batch > vmap_max_batch(slice_bytes, raw_bytes, device_bytes):
        return "scan"
    if slice_bytes > VMAP_AUTO_MAX_SLICE_BYTES:
        return "scan"
    return "vmap"


def prepare_device(plans, device):
    """Copy what the plan's steps read from host tables to ``device``,
    once, at plan time: the gate-chain kernel's index tables
    (``gate_chains._kernel_args``, cached on each chain) and the window
    builds' index arrays (``windowed.expand_index``). A CUDA graph
    capture refuses copies from pageable host memory, so none may be
    left for the first call. CPU steps read neither."""
    if device.type == "cpu":
        return
    for kind, info in plans:
        if kind == "inplace":
            _kernel_args(info.spec, device)
        elif kind == "w2build":
            info.index = expand_index(info.rec.recipe, device)


def stage_bounds(n_steps, stage_size):
    """Stage bounds over ``n_steps`` plan steps: ``range(0, n,
    stage_size)`` and ``n``, as the reference's (one stage for a plan
    without steps)."""
    if n_steps == 0:
        return [0, 0]
    return list(range(0, n_steps, max(1, stage_size))) + [n_steps]


def _flat_copy(view):
    # a selected view is strided: one explicit copy makes it the
    # contiguous flat planes that the steps and the chain kernel take
    return view.contiguous().view(-1)


class _StagedProgram:
    """A grouped contraction of ``tree``, planned once, as stages of plan
    steps: functions from a state to the next, which ``capture.Graphs``
    captures as one CUDA graph each and ``capture.run_stages`` runs
    eagerly. ``make_grouped_contractor`` runs its plan as one stage,
    ``make_grouped_staged_contractor`` as stages of ``stage_size`` steps.

    The plan is ``plan_grouped``'s, window operators hoisted
    (``hoist_window_operators``), with its tables on the device
    (``prepare_device``). ``bounds`` and ``carries`` are the reference's
    stage bounds and the ids each stage hands on (``stage_bounds``,
    ``capture.stage_carries``).

    The first stage takes ``(planes, digits, folded)``: the plane stacks
    (raw under a batch), the ``(S, ncols)`` int64 slice digits on the
    device (None without a batch) and the folded constants
    (``SliceBatch.fold``'s ``(temps, exponent)``, or None). It selects
    the slice-invariant inputs by their projected indices and gathers
    each varying input for every slice by the device digits
    (``SliceBatch.gather_each``: never a host int, so that a graph
    replays whatever digits its buffer holds), and writes to none of
    its arguments. Each stage runs the plan steps in its bounds and
    keeps only the ids carried across its end; the folded ids stay
    outside, read by every stage. Under ``"vmap"`` one dict holds every
    id, a batch's rows where a sliced index reaches it; under ``"scan"``
    the invariant ids live in one dict, run once, and each slice's in
    its own, run slice after slice inside the stage (every slice's
    varying inputs are gathered at the start). The last stage returns
    the output planes, and the exponent under ``strip_exponent``."""

    def __init__(self, tree, device, plane_dtype, gate_mode, fuse_gates,
                 strip_exponent, slice_batch, slice_batch_mode, constants,
                 stage_size=None):
        if slice_batch_mode not in SLICE_BATCH_MODES:
            raise ValueError(
                f"slice_batch_mode must be one of {SLICE_BATCH_MODES}, got "
                f"{slice_batch_mode!r}"
            )
        if gate_mode == "auto":
            gate_mode = "inplace"
        self.dev, self.pdt, self.gate_mode = device, plane_dtype, gate_mode
        self.strip = strip_exponent
        ir = extract_contractions(tree)
        input_orders = [sliced_input_legs(tree, i) for i in range(tree.N)]
        plans, _, self.out_plan, self.out_shape, _ = plan_grouped(
            ir, tree.size_dict, input_orders, gate_mode=gate_mode,
            fuse_gates=fuse_gates,
        )
        self.plans, self.last_use = hoist_window_operators(
            plans, ir.final_id, ir.num_inputs, device, plane_dtype
        )
        prepare_device(self.plans, device)
        self.final_id = ir.final_id
        step_io = list(_step_io(self.plans))
        in_shapes = [
            tuple(tree.size_dict[ix] for ix in order) for order in input_orders
        ]
        # every call stores the same shape under an id, so one map
        # serves them all, the folded steps' ids included
        self.shapes = dict(enumerate(in_shapes))
        n = len(self.plans)
        self.bounds = stage_bounds(n, n if stage_size is None else stage_size)
        self.carries = stage_carries(step_io, self.last_use, ir.final_id,
                                     ir.num_inputs, self.bounds)
        self.batch = self.mode = None
        self.raw_shapes = in_shapes
        if slice_batch:
            self.batch = SliceBatch(tree, step_io, self.last_use, constants)
            self.raw_shapes = tree.get_shapes()
            self.mode = slice_batch_mode
            if self.mode == "auto":
                itemsize = torch.empty((), dtype=plane_dtype).element_size()
                self.mode = auto_slice_batch_mode(
                    device, slice_batch,
                    slice_peak_bytes(self.plans, in_shapes, self.last_use,
                                     tree.size_dict, itemsize),
                    2 * itemsize * sum(prod(s) for s in self.raw_shapes),
                    torch.cuda.get_device_properties(device).total_memory
                    if device.type == "cuda" else 0,
                )
        last = len(self.bounds) - 2
        self.stages = [
            self._stage(k, self.bounds[k], self.bounds[k + 1],
                        set(self.carries[k + 1]), k == last)
            for k in range(last + 1)
        ]

    def check(self, planes):
        """Raise unless ``planes`` are the plane stacks the program
        takes: one per input, ``(2, *shape)``, of its dtype and
        device."""
        shapes = self.raw_shapes
        if len(planes) != len(shapes):
            raise ValueError(
                f"expected {len(shapes)} inputs, got {len(planes)}"
            )
        for i, (a, shape) in enumerate(zip(planes, shapes)):
            if a.device != self.dev or a.dtype != self.pdt:
                raise ValueError(
                    f"input {i} is {a.dtype} on {a.device}; the "
                    f"contractor runs {self.pdt} on {self.dev}"
                )
            if tuple(a.shape) != (2,) + tuple(shape):
                raise ValueError(
                    f"input {i} has shape {tuple(a.shape)}, expected "
                    f"{(2,) + tuple(shape)}"
                )

    def digits(self, slice_ids):
        """The host digit matrix of ``slice_ids``, decoded exactly
        (``slices._ids_to_digits``) after the batch's checks."""
        if tracing.ON:
            tracing.begin()
        digits = _ids_to_digits(self.batch._ids(slice_ids), self.batch.meta)
        if tracing.ON:
            tracing.end("slices.select", 0)
        return digits

    def fold(self, planes):
        """``SliceBatch.fold`` over the raw ``planes``."""
        return self.batch.fold(planes, self._run, _flat_copy, axis_offset=1)

    def _run(self, steps, temps, last_use):
        if not steps:
            return None
        return _exec_steps_split(self.plans, steps, temps, self.shapes,
                                 last_use, self.strip)

    def _start(self, planes, digits, folded):
        state = {"folded": {} if folded is None else folded[0],
                 "shared": {}, "e": None if folded is None else folded[1]}
        batch = self.batch
        if batch is None:
            state["shared"] = {i: a.reshape(-1) for i, a in enumerate(planes)}
            return state
        S = state["S"] = digits.shape[0]
        state["shared"] = batch.select_once(planes, _flat_copy, 1)
        if self.mode == "vmap":
            state["shared"].update(batch.gather_each(planes, digits, 1))
            return state
        state["each"] = [
            {i: t.view(-1) for i, t in
             batch.gather_each(planes, digits[b:b + 1], 1).items()}
            for b in range(S)
        ]
        state["e_each"] = [None] * S
        return state

    def _stage(self, k, lo, hi, keep, last):
        batch = self.batch
        if batch is None:
            steps, once, each = range(lo, hi), (), ()
        else:
            fold = set(batch.steps_fold)
            steps = [si for si in range(lo, hi) if si not in fold]
            once = [si for si in batch.steps_once if lo <= si < hi]
            each = [si for si in batch.steps_each if lo <= si < hi]

        def stage(state):
            if k == 0:
                state = self._start(*state)
            folded = state["folded"]
            temps = {**folded, **state["shared"]}
            if "each" not in state:
                e = self._run(steps, temps, self.last_use)
            else:
                e = self._run(once, temps, batch.last_use_once)
                for b, own in enumerate(state["each"]):
                    mine = {**temps, **own}
                    state["e_each"][b] = _add_exponents(
                        state["e_each"][b],
                        self._run(each, mine, self.last_use),
                    )
                    state["each"][b] = {
                        vid: t for vid, t in mine.items()
                        if vid in keep and vid not in temps
                    }
            state["e"] = _add_exponents(state["e"], e)
            state["shared"] = {
                vid: t for vid, t in temps.items()
                if vid in keep and vid not in folded
            }
            return self._finish(state) if last else state

        return stage

    def _output(self, temps):
        flat = _apply_block_plan_split(temps[self.final_id], self.out_plan)
        return flat.view(_lead(flat) + (2,) + tuple(self.out_shape))

    def _zero(self):
        return torch.zeros((), dtype=self.pdt, device=self.dev)

    def _finish(self, state):
        temps = {**state["folded"], **state["shared"]}
        if "each" in state:
            outs, exps = [], []
            for own, e in zip(state["each"], state["e_each"]):
                outs.append(self._output({**temps, **own}))
                e = _add_exponents(state["e"], e)
                exps.append(self._zero() if e is None else e)
            res, e = torch.stack(outs), torch.stack(exps)
        else:
            res, e = self._output(temps), state["e"]
            e = self._zero() if e is None else e
            if self.batch is not None:
                # an output that no sliced index reaches is every slice's
                S = state["S"]
                res = res.expand((S,) + tuple(
                    res.shape[-1 - len(self.out_shape):]))
                e = e.expand(S)
        return (res, e) if self.strip else res


def _count_ids(planes, slice_ids, *args, **kwargs):
    return len(_flat_ids(slice_ids))


def make_grouped_contractor(
    tree, device="cuda", plane_dtype=torch.float32, gate_mode="auto",
    strip_exponent=False, slice_batch=None, slice_batch_mode="auto",
    constants=None, fuse_gates=False,
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
    ``strip_exponent``; the caller sums them. The ids are decoded on the
    host and their digits copied to the device once a call
    (``slices.device_digits``), or not at all where the caller passes
    ``digits=fn.digits(slice_ids)``, made once for ids that come again.
    The steps that no sliced index reaches run once per call.
    ``slice_batch_mode`` says how the others run:

    - ``"scan"``: once per slice, on each slice's inputs gathered from
      the raw planes (one slice's intermediates at a time);
    - ``"vmap"``: once per call for all the slices together, each
      varying input gathered for the batch (``slices.gather_input``):
      B times one slice's memory, and B times fewer step calls and
      kernel launches (a chain pass is one launch for the batch). A
      batch that does not fit raises the allocator's out-of-memory
      error; it never turns into ``"scan"``;
    - ``"auto"``: ``auto_slice_batch_mode`` (``"scan"`` on the CPU).

    With ``constants`` (input positions whose planes never change),
    ``fn.fold(planes)`` runs the steps that only constants reach once,
    and ``fn(planes, slice_ids, folded)`` reuses its result
    (``slices.SliceBatch``). ``fn.mode`` is the mode taken.

    ``gate_mode`` picks the engine of the small-gate absorptions:

    - ``"inplace"``: in-place gate chains through the gate-chain kernel
      (``gate_chains.py``), one launch a pass;
    - ``"window"``: windowed-matmul clusters (``windowed.py``): each
      cluster one ``torch.matmul`` of its dense operator ``W2`` with the
      large tensor, after one rotation copy unless the window is a
      prefix; each ``W2`` is built by a step of its own that reads only
      the gates (``hoist_window_operators``), so a batch builds it once
      where no sliced index reaches the gates;
    - ``None``: pair steps only;
    - ``"auto"``: ``"inplace"``, as the reference's split-complex
      default.

    ``fuse_gates=True`` merges consecutive small-gate absorptions that
    the engine did not take into fused kron chains (one small-y product
    of the gates' kron product). ``"window"`` and ``fuse_gates`` are
    opt-in, as in the reference; ``PERF.md`` section 6 has their times
    on the card. ``fn.plans`` is the executor's plan.

    The call runs the plan as the one stage of a ``_StagedProgram``;
    ``make_grouped_staged_contractor`` runs the same program in stages,
    as captured CUDA graphs.
    """
    dev = resolve_device(device)
    prog = _StagedProgram(
        tree, dev, resolve_plane_dtype(plane_dtype), gate_mode, fuse_gates,
        strip_exponent, slice_batch, slice_batch_mode, constants,
    )
    if slice_batch:
        @tracing.entry("grouped", _count_ids)
        def fn(planes, slice_ids, folded=None, digits=None):
            prog.check(planes)
            if digits is None:
                digits = device_digits(prog.digits(slice_ids), dev)
            if folded is None:
                folded = prog.fold(planes)
            return run_stages(prog.stages, (planes, digits, folded))

        def fold(planes):
            prog.check(planes)
            return prog.fold(planes)

        fn.fold = fold
        fn.digits = lambda slice_ids: device_digits(
            prog.digits(slice_ids), dev
        )
        fn.mode = prog.mode
        fn.batch = prog.batch
    else:
        @tracing.entry("grouped", 1)
        def fn(*planes):
            prog.check(planes)
            return run_stages(prog.stages, (planes, None, None))

    fn.plans = prog.plans
    return fn


# -- the staged contractor: the plan as CUDA graphs ---------------------------


def make_grouped_staged_contractor(
    tree, stage_size=12, strip_exponent=False, autojit=True,
    fuse_gates=False, plane_dtype=torch.float32, slice_batch=None,
    slice_batch_mode="auto", gate_mode="auto", device="cuda",
    constants=None,
):
    """``make_grouped_contractor``'s plan run as stages of about
    ``stage_size`` steps (the reference's ``make_grouped_staged_contractor``,
    ``cotengra_tpu/ops/grouped.py:2072``, split-complex with plane I/O).

    ``autojit=True`` on a CUDA device captures each stage as a CUDA
    graph (``capture.Graphs``), all in one memory pool, the ids that
    cross a stage boundary at fixed addresses: at the first call with a
    new number of slice ids (or at ``fn.precompile``), after one eager
    warm-up; every call then copies its planes into the static input
    buffers (one ``torch._foreach_copy_``; none for the buffers
    ``fn.inputs`` themselves), its slice digits into a static device
    buffer (decoded on the host, exactly, ``slices._ids_to_digits``;
    one pinned, non-blocking copy) and replays one graph per stage: one
    dispatch a stage, as the reference's jitted stages, and no Python
    step (``tracing.STEP_CALLS`` stays put). The result is a copy
    of the graphs' outputs. A stage that cannot be captured raises
    ``capture.CaptureError`` naming the plan step; nothing reruns
    eagerly. On the CPU, or with ``autojit=False``, the same stages run
    eagerly.

    Arguments and results are ``make_grouped_contractor``'s:
    ``fn(*planes)``, or ``fn(planes, slice_ids)`` under ``slice_batch``,
    whose ``"scan"`` runs each slice's steps one slice after another
    inside each stage and ``"vmap"`` all of them at once. The steps no
    sliced index reaches run once a call in both. With ``constants``
    (input positions, under ``slice_batch``), the steps only they reach
    are folded once, eagerly, at the first call, and the graphs read
    the folded tensors.

    ``fn.precompile(planes, slice_ids)`` (``fn.precompile(*planes)``)
    captures every stage without a real call and returns the number of
    graphs (of stages on the CPU); like the reference's, it returns
    None under ``gate_mode="window"`` (captured at the first call) or
    without ``autojit``. ``fn.bounds`` and ``fn.carries`` are the
    stages' bounds and carried ids, ``fn.stages`` the stage functions,
    ``fn.graphs`` the captured ``Graphs`` by slice count.
    """
    dev = resolve_device(device)
    pdt = resolve_plane_dtype(plane_dtype)
    prog = _StagedProgram(tree, dev, pdt, gate_mode, fuse_gates,
                          strip_exponent, slice_batch, slice_batch_mode,
                          constants, stage_size)
    batch = prog.batch
    read = list(range(tree.N)) if batch is None else sorted(
        batch.inputs_once + batch.inputs_each
    )
    captured = autojit and dev.type == "cuda"
    inputs = [
        torch.zeros((2,) + tuple(s), dtype=pdt, device=dev)
        for s in prog.raw_shapes
    ] if captured else None
    graphs, digit_bufs = {}, {}
    folded = []  # the folded constants, made at the first call

    def fold(planes):
        if batch is None:
            return None
        if not folded:
            folded.append(prog.fold(planes))
        return folded[0]

    def arguments(planes, slice_ids):
        prog.check(planes)
        return None if batch is None else prog.digits(slice_ids)

    def graphs_for(planes, digits):
        """The graphs for calls of this many slices, with this call's
        planes and digits loaded into their buffers."""
        load([inputs[i] for i in read], [planes[i] for i in read])
        S = None if digits is None else len(digits)
        if S is not None:
            if S not in digit_bufs:
                digit_bufs[S] = torch.zeros(digits.shape, dtype=torch.int64,
                                            device=dev)
            if digits.size:
                digit_bufs[S].copy_(torch.from_numpy(digits).pin_memory(),
                                    non_blocking=True)
        g = graphs.get(S)
        if g is None:
            g = graphs[S] = Graphs(
                prog.stages, (inputs, digit_bufs.get(S), fold(planes)), dev,
            )
        return g

    def call(planes, slice_ids=None):
        digits = arguments(planes, slice_ids)
        if not captured:
            if digits is not None:
                digits = device_digits(digits, dev)
            return run_stages(prog.stages, (planes, digits, fold(planes)))
        return clone_outputs(graphs_for(planes, digits).replay())

    def precompile(planes, slice_ids=None):
        if not autojit or prog.gate_mode == "window":
            return None
        digits = arguments(planes, slice_ids)
        if not captured:
            return len(prog.stages)
        return len(graphs_for(planes, digits).graphs)

    if slice_batch:
        fn = call
        fn.precompile = precompile
    else:
        def fn(*planes):
            return call(planes)

        fn.precompile = lambda *planes: precompile(planes)
    fn.mode = prog.mode
    fn.plans = prog.plans
    fn.batch = batch
    fn.bounds = prog.bounds
    fn.carries = prog.carries
    fn.stages = prog.stages
    fn.graphs = graphs
    fn.inputs = inputs
    return fn
