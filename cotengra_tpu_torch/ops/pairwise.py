"""The two primitive tensor operations of the executor, on torch tensors
(complex included).

- ``apply_single``: single-term einsum (diag / trace / sum / transpose);
- ``apply_pairwise``: pairwise contraction; ``out_legs`` decides which
  shared legs are batch (kept) and which are contracted (summed).

Both map the step's legs to local einsum letters and call
``torch.einsum``. They serve the executor's ``single`` and ``fallback``
steps, whose ranks stay far below PyTorch's 25-dim limit.
"""

import functools
import string

import torch

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


def apply_single(x, in_legs, out_legs):
    """Diagonals for repeated legs, sums over removed legs, and a
    transposition into ``out_legs`` order."""
    return torch.einsum(_single_eq(tuple(in_legs), tuple(out_legs)), x)


def apply_pairwise(x, y, l_legs, r_legs, out_legs):
    """Contract ``x`` (legs ``l_legs``) with ``y`` (legs ``r_legs``) into
    ``out_legs``. Legs on one side only and absent from ``out_legs`` are
    summed."""
    eq = _pair_eq(tuple(l_legs), tuple(r_legs), tuple(out_legs))
    return torch.einsum(eq, x, y)
