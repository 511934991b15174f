"""Compressed (approximate, chi-capped) contraction on torch tensors
(counterpart of ``cotengra_tpu/ops/compressed.py``).

Follow the tree in surface order; after each pairwise contraction, any
multibond to a neighbouring tensor whose combined dimension exceeds
``chi`` is truncated with a QR+SVD compression:

    T_a --(D>chi)-- T_b
    T_a = Q_a R_a ;  T_b = Q_b R_b          (QR onto the bond)
    U s V = SVD(R_a @ R_b^T), keep chi      (truncate the core)
    T_a <- Q_a U sqrt(s) ; T_b <- Q_b V sqrt(s)

The transposes are bilinear (``R_b.T``, ``Vh.T``), not adjoints, as in
the reference, so complex inputs give its result. On the card, for real
operands, the two QRs and the products with their Q are two launches of
a hand-written kernel (``qr_core``: both sides factored by Householder
reflections in one, each Q applied to ``U sqrt(s)`` or ``V sqrt(s)``
without being formed in the other), and the core's SVD is
``svd_core.svd_topk``'s kernel; both decide everything on the card, so a
truncation never makes the host wait. On the CPU and for complex
operands the QRs are ``torch.linalg.qr`` and the products ``@``, and the
SVD ``torch.linalg.svd`` (``svd_topk``'s plain version). The
pairwise contractions are ``ops/pairwise.py``. Shapes change with every
truncation, so the loop runs eagerly on the host, one device call after
another (the reference jits one program per shape). The stripped
exponent is summed in float64 whatever the inputs' dtype (the reference
sums it in float32, whose ulp at a value of 10^289 is 3e-5 in log10).

Spans (``tracing``): the call is an ``entry`` of kind ``compressed``;
each step of the loop a ``compressed.step`` (its leg bookkeeping, the
pairwise contraction, the stripping), each ``compress_with_neighbors``
inside it a ``compressed.neighbours`` (the neighbour and index-holder
bookkeeping), and each truncated bond inside that a
``compressed.truncate`` (its QR, SVD and products; the kernels'
``kernel.launch`` spans inside it). ``COUNTS`` counts, traced or not, the
truncations (each one SVD) and the operands they factor, two a
truncation: by the kernel (``qr_kernel``) or by ``torch.linalg.qr``
(``qr_library``); a call makes ``tree.N - 1`` steps.
"""

import torch

from .. import tracing
from .._device import resolve_device
from .pairwise import apply_pairwise, apply_single, promote_pair
from .qr_core import qr_apply_cuda, qr_factor_cuda
from .svd_core import svd_topk

# bonds truncated and the operands factored, by route; cumulative over
# every call of the process
COUNTS = {"truncations": 0, "qr_kernel": 0, "qr_library": 0}


def _mm(a, b):
    """``a @ b`` in the promoted dtype (a real factor meets a complex
    one), as ``jnp.matmul`` promotes."""
    return torch.matmul(*promote_pair(a, b))


def _compress_pair_core(A, B, chi):
    """A: (la, D), B: (lb, D) sharing bond D>chi -> (la, chi), (lb, chi).
    Real operands on the card take the QR kernel, the others the library.
    The choice is made here, not in ``qr_core`` as ``svd_topk`` makes its
    own: the kernel's two launches stand on either side of the SVD, so it
    picks the route of the whole truncation, and the library's route is
    the truncation's plain version, written out below (the benchmark's
    fault tests rebuild this function from its source)."""
    if A.device.type == "cuda" and not (A.is_complex() or B.is_complex()):
        dtype = torch.promote_types(A.dtype, B.dtype)
        Ra, Rb, factors = qr_factor_cuda(
            A.to(dtype).contiguous(), B.to(dtype).contiguous())
        COUNTS["qr_kernel"] += 2
        U, s, V = svd_topk(_mm(Ra, Rb.T), chi)
        return qr_apply_cuda(factors, U, V, s)
    COUNTS["qr_library"] += 2
    Qa, Ra = torch.linalg.qr(A)        # (la, k) (k, D)
    Qb, Rb = torch.linalg.qr(B)        # (lb, k') (k', D)
    M = _mm(Ra, Rb.T)                  # (k, k')
    U, s, V = svd_topk(M, chi)         # (k, chi) (chi) (k', chi)
    sq = torch.sqrt(s)
    newA = _mm(Qa, U * sq[None, :])    # (la, chi)
    newB = _mm(Qb, V * sq[None, :])    # (lb, chi)
    return newA, newB


def _move_bond_last(x, legs, bond_group):
    """Transpose/reshape so the bond-group axes are fused last.

    Returns (matrix, other_legs, other_shape)."""
    other = [ix for ix in legs if ix not in bond_group]
    perm = [legs.index(ix) for ix in other] + [
        legs.index(ix) for ix in bond_group
    ]
    xt = x.permute(perm)
    other_shape = tuple(xt.shape[: len(other)])
    d_other = 1
    for d in other_shape:
        d_other *= d
    d_bond = 1
    for d in xt.shape[len(other):]:
        d_bond *= d
    return xt.reshape(d_other, d_bond), tuple(other), other_shape


def compress_bond(Ta, legs_a, Tb, legs_b, bond_group, chi, new_ix):
    """Compress the shared ``bond_group`` indices between two tensors to a
    single new index of size <= chi. Returns updated
    (Ta, legs_a, Tb, legs_b). A ``compressed.truncate`` span with the
    rows of each side's matrix, the fused bond and the kept k."""
    if tracing.ON:
        tracing.begin()
    Am, other_a, shape_a = _move_bond_last(Ta, list(legs_a), bond_group)
    Bm, other_b, shape_b = _move_bond_last(Tb, list(legs_b), bond_group)
    k = min(Am.shape[0], Bm.shape[0], Am.shape[1], chi)
    newA, newB = _compress_pair_core(Am, Bm, int(k))
    Ta2 = newA.reshape(*shape_a, newA.shape[-1])
    Tb2 = newB.reshape(*shape_b, newB.shape[-1])
    COUNTS["truncations"] += 1
    if tracing.ON:
        tracing.end("compressed.truncate", Am.shape[0], Bm.shape[0],
                    Am.shape[1], int(k))
    return Ta2, (*other_a, new_ix), Tb2, (*other_b, new_ix)


@tracing.entry("compressed", 1)
def contract_compressed(
    tree,
    arrays,
    chi=None,
    order="surface_order",
    compress_late=None,
    strip_exponent=False,
    device="cuda",
):
    """Execute ``tree`` approximately with maximum bond dimension ``chi``.

    Parameters
    ----------
    tree : ContractionTree or ContractionTreeCompressed
    arrays : sequence of numpy arrays or torch tensors
        Moved to ``device`` in their own dtype (float64 stays float64);
        real and complex inputs mix, each step promoting its operands.
    chi : int, optional
        Maximum bond dimension (default: the tree's default chi).
    order : "surface_order" or callable
    compress_late : bool, optional
        Compress the inputs of each contraction just before contracting
        (True) or the new tensor just after (False, default).
    strip_exponent : bool, optional
        Divide every intermediate by its max|.| and return
        ``(mantissa, exponent)``, the value being mantissa *
        10**exponent; the mantissa keeps the result's dtype, the
        exponent is a float64 tensor (the sum of each step's log10
        scale, taken in float64), for float32 inputs too.
    device : str or torch.device, optional
        ``"cuda"`` (the default; raises without a card) or ``"cpu"``.

    Returns
    -------
    torch.Tensor or (torch.Tensor, torch.Tensor)
        The (approximate) contraction result, transposed to the tree's
        output index order, on ``device``.
    """
    dev = resolve_device(device)
    if chi is None or chi == "auto":
        chi = tree.get_default_chi()
    if compress_late is None:
        compress_late = getattr(
            tree, "get_default_compress_late", lambda: False
        )()

    # live tensors: node -> (array, legs tuple)
    live = {}
    for i, leaf in enumerate(tree.gen_leaves()):
        x = torch.as_tensor(arrays[i], device=dev)
        raw = tuple(tree.inputs[i])
        eff = tuple(dict.fromkeys(raw))
        if raw != eff:
            x = apply_single(x, raw, eff)
        live[leaf] = (x, eff)

    fresh = map("__chi{}".format, range(10**6)).__next__

    def neighbors_of(node):
        """Other live nodes sharing at least one index with ``node``."""
        _, legs = live[node]
        legset = set(legs)
        for other, (_, olegs) in live.items():
            if other != node and legset.intersection(olegs):
                yield other

    def compress_with_neighbors(node):
        if tracing.ON:
            tracing.begin()
            scanned = len(live)
        for other in list(neighbors_of(node)):
            x, legs = live[node]
            y, olegs = live[other]
            # never compress output indices, and only bonds exclusively
            # between these two tensors (not hyperedges on 3+ tensors)
            holders = {}
            for nd, (_, lg) in live.items():
                for ix in lg:
                    holders[ix] = holders.get(ix, 0) + 1
            shared = tuple(
                ix
                for ix in legs
                if ix in set(olegs)
                and ix not in out_set
                and holders.get(ix, 0) == 2
            )
            d = 1
            for ix in shared:
                ax = legs.index(ix)
                d *= x.shape[ax]
            if d > chi and shared:
                new_ix = fresh()
                x2, l2, y2, o2 = compress_bond(
                    x, legs, y, olegs, shared, chi, new_ix
                )
                live[node] = (x2, l2)
                live[other] = (y2, o2)
        if tracing.ON:
            tracing.end("compressed.neighbours", scanned)

    out_set = set(tree.output)
    exponent = torch.zeros((), dtype=torch.float64, device=dev)

    for si, (p, l, r) in enumerate(tree.traverse(order)):
        if tracing.ON:
            tracing.begin()
        if compress_late:
            compress_with_neighbors(l)
            compress_with_neighbors(r)
        (x, l_legs) = live.pop(l)
        (y, r_legs) = live.pop(r)
        # kept legs = indices that still appear on other live tensors or
        # in the output; everything else is contracted/summed here
        other_inds = set(out_set)
        for _, (_, olegs) in live.items():
            other_inds.update(olegs)
        p_legs = tuple(
            ix
            for ix in dict.fromkeys(l_legs + r_legs)
            if ix in other_inds
        )
        z = apply_pairwise(x, y, l_legs, r_legs, p_legs)
        if strip_exponent:
            absmax = z.abs().max()
            scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
            z = z / scale
            exponent = exponent + torch.log10(scale.to(torch.float64))
        live[p] = (z, p_legs)
        if not compress_late:
            compress_with_neighbors(p)
        if tracing.ON:
            tracing.end("compressed.step", si, z.numel())

    (result, legs) = live.popitem()[1]
    # transpose to output order (output indices always survive)
    target = tuple(ix for ix in tree.output if ix in legs)
    if legs != target and target:
        perm = tuple(legs.index(ix) for ix in target)
        result = result.permute(perm)
    if strip_exponent:
        return result, exponent
    return result
