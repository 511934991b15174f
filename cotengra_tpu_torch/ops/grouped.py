"""The grouped split-complex executor on torch tensors.

Runs the plans of :func:`.grouped_plan.plan_grouped` as the reference
``cotengra_tpu/ops/grouped.py::_exec_steps_split`` does: every
intermediate is one flat real tensor of length ``2 * numel`` (real
plane, then imaginary plane), its leg order tracked by the plan, and
each step works on merged blocks of legs, never at full rank. The
intermediates of the Sycamore plans reach rank 27, beyond the 25 dims a
CUDA TensorIterator takes.

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

# leg label reserved for the plane axis in single-term ops
_PLANE = "\x00plane"


# The reference's _to_planes (complex inputs split on device) has no
# counterpart: inputs arrive as plane stacks (convert.to_plane_tensors).
def _planes_to_complex(flat, shape):
    """flat (2*numel,) planes -> complex tensor of ``shape``."""
    planes = flat.view((2,) + tuple(shape))
    return torch.complex(planes[0], planes[1])


# The reference's _apply_plan_matmul (one-hot matmul transposes),
# _multipass_plan / transpose_synth.py (multipass copies) and
# _split_block_factors (128-split tiles) worked around TPU tiling; a
# GPU copy needs none of them.
def _apply_block_plan_split(flat, plan):
    """Block transpose of plane-major flat storage: both planes move with
    the same plan, the plane dim stays leading. One permuted copy."""
    if plan is None:
        return flat
    block_dims, perm = plan
    return (
        flat.view((2,) + tuple(block_dims))
        .permute((0,) + tuple(p + 1 for p in perm))
        .reshape(-1)
    )


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
def _exec_steps_split(plans, temps, shapes, last_use):
    """Run every plan step over ``temps`` (id -> plane-major flat real
    tensor, freed after its last use); ``shapes`` maps id -> logical
    complex shape."""

    def store(out_id, flat, shape, si, srcs):
        temps[out_id] = flat
        shapes[out_id] = tuple(shape)
        for vid in srcs:
            if last_use.get(vid) == si:
                temps.pop(vid, None)

    for si, (kind, info) in enumerate(plans):
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
            store(step.out, flat, out.shape, si, (x_id, y_id))
            continue

        if kind == "inplace":
            rec = info
            ys = [
                _apply_block_plan_split(temps[y_id], y_plan).view(2, K, N)
                for y_id, y_plan, K, N in rec.ys
            ]
            out = run_chain(rec.spec, temps[rec.x_id], ys)
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
        store(p.out_id, out, (B, N, M), si, (p.x_id, p.y_id))


def make_grouped_contractor(tree, device, plane_dtype, gate_mode="auto"):
    """Plan ``tree`` once and return ``fn(*planes) -> planes``.

    ``fn`` takes one ``(2, *shape)`` plane stack per (sliced) input, on
    ``device`` in ``plane_dtype`` (see :func:`..convert.to_plane_tensors`),
    and returns the ``(2, *out_shape)`` planes of the result.

    ``gate_mode="auto"`` resolves to ``"inplace"`` (gate chains), as the
    reference's split-complex default does; ``None`` plans pairs only.
    There is no staging: it worked around the TPU compiler.
    """
    dev = resolve_device(device)
    pdt = resolve_plane_dtype(plane_dtype)
    if gate_mode == "auto":
        gate_mode = "inplace"
    ir = extract_contractions(tree)
    input_orders = [sliced_input_legs(tree, i) for i in range(tree.N)]
    plans, _, out_plan, out_shape, last_use = plan_grouped(
        ir, tree.size_dict, input_orders, gate_mode=gate_mode
    )
    sizes = tree.size_dict
    in_shapes = [tuple(sizes[ix] for ix in order) for order in input_orders]

    def fn(*planes):
        if len(planes) != len(in_shapes):
            raise ValueError(
                f"expected {len(in_shapes)} inputs, got {len(planes)}"
            )
        temps = {}
        for i, (a, shape) in enumerate(zip(planes, in_shapes)):
            if a.device != dev or a.dtype != pdt:
                raise ValueError(
                    f"input {i} is {a.dtype} on {a.device}; the "
                    f"contractor runs {pdt} on {dev}"
                )
            if tuple(a.shape) != (2,) + shape:
                raise ValueError(
                    f"input {i} has shape {tuple(a.shape)}, expected "
                    f"{(2,) + shape}"
                )
            temps[i] = a.reshape(-1)
        shapes = dict(enumerate(in_shapes))
        _exec_steps_split(plans, temps, shapes, last_use)
        flat = _apply_block_plan_split(temps[ir.final_id], out_plan)
        return flat.view((2,) + tuple(out_shape))

    fn.plans = plans
    return fn

