"""The two primitive tensor operations of the executor, on torch tensors
(complex included).

- ``apply_single``: single-term einsum (diag / trace / sum / transpose);
- ``apply_pairwise``: pairwise contraction; ``out_legs`` decides which
  shared legs are batch (kept) and which are contracted (summed).

Both map the step's legs to local einsum letters and call
``torch.einsum``. They serve the executor's ``single`` and ``fallback``
steps, whose ranks stay far below PyTorch's 25-dim limit.
``torch.einsum`` does not promote, so a pair step first brings both
operands to ``torch.promote_types`` of the two (``promote_pair``), as
JAX's ``dot_general`` does: a real operand meets a complex one as
complex.

``einsum`` and ``tensordot`` are the public one- and two-operand entry
points over the same steps (the reference's array functions).
"""

import functools
import string

import torch

from ..utils.eqs import find_output_from_inputs

# torch.einsum accepts only these subscripts
_LETTERS = string.ascii_letters


def _letters(legs_seq):
    symmap = {}
    for legs in legs_seq:
        for ix in legs:
            if ix not in symmap:
                if len(symmap) == len(_LETTERS):
                    raise ValueError(
                        "einsum step has more than 52 distinct legs"
                    )
                symmap[ix] = _LETTERS[len(symmap)]
    return symmap


@functools.lru_cache(maxsize=2**14)
def _single_eq(in_legs, out_legs):
    s = _letters((in_legs,))
    lhs = "".join(s[ix] for ix in in_legs)
    rhs = "".join(s[ix] for ix in out_legs)
    return f"{lhs}->{rhs}"


@functools.lru_cache(maxsize=2**14)
def _pair_eq(l_legs, r_legs, out_legs):
    s = _letters((l_legs, r_legs))
    lhs = "".join(s[ix] for ix in l_legs)
    rhs = "".join(s[ix] for ix in r_legs)
    out = "".join(s[ix] for ix in out_legs)
    return f"{lhs},{rhs}->{out}"


def promote_pair(x, y):
    """``x`` and ``y`` in ``torch.promote_types`` of their dtypes."""
    dt = torch.promote_types(x.dtype, y.dtype)
    return x.to(dt), y.to(dt)


def apply_single(x, in_legs, out_legs):
    """Diagonals for repeated legs, sums over removed legs, and a
    transposition into ``out_legs`` order."""
    return torch.einsum(_single_eq(tuple(in_legs), tuple(out_legs)), x)


def apply_pairwise(x, y, l_legs, r_legs, out_legs):
    """Contract ``x`` (legs ``l_legs``) with ``y`` (legs ``r_legs``) into
    ``out_legs``. Legs on one side only and absent from ``out_legs`` are
    summed."""
    eq = _pair_eq(tuple(l_legs), tuple(r_legs), tuple(out_legs))
    return torch.einsum(eq, *promote_pair(x, y))


# -- standalone tensor utilities ----------------------------------------------


def einsum(eq, *arrays):
    """Contract one or two tensors with an einsum equation, through
    ``apply_single`` / ``apply_pairwise``. For more than two operands
    use :func:`cotengra_tpu_torch.einsum`, which plans a full
    contraction tree."""
    lhs, rhs = eq.split("->") if "->" in eq else (eq, None)
    terms = lhs.split(",")
    if rhs is None:
        rhs = find_output_from_inputs(terms)
    arrays = [torch.as_tensor(a) for a in arrays]
    if len(terms) == 1:
        return apply_single(arrays[0], tuple(terms[0]), tuple(rhs))
    if len(terms) == 2:
        return apply_pairwise(
            arrays[0], arrays[1], tuple(terms[0]), tuple(terms[1]),
            tuple(rhs),
        )
    raise ValueError(
        "pairwise einsum handles 1 or 2 operands; use "
        "cotengra_tpu_torch.einsum for full contractions"
    )


def tensordot(a, b, axes=2):
    """``np.tensordot``: ``axes`` is an int (contract the last / first
    ``axes`` dims) or a pair of dim lists. The operands are promoted as
    in a pair step."""
    a, b = promote_pair(torch.as_tensor(a), torch.as_tensor(b))
    if isinstance(axes, int):
        ax_a = tuple(range(a.dim() - axes, a.dim()))
        ax_b = tuple(range(axes))
    else:
        ax_a, ax_b = axes
        if isinstance(ax_a, int):
            ax_a = (ax_a,)
        if isinstance(ax_b, int):
            ax_b = (ax_b,)
        ax_a = tuple(d % a.dim() for d in ax_a)
        ax_b = tuple(d % b.dim() for d in ax_b)
    return torch.tensordot(a, b, dims=(list(ax_a), list(ax_b)))
