"""Compressed (chi-truncated) contraction of a saved plan in plain
PyTorch: the reference of a configuration whose ``"reference"`` names
``"kind": "compressed"``.

A compressed contraction is approximate by definition: its answer is
the value that truncating bonds to ``chi`` along the plan's order
gives, not the exact value. So it is judged against this walk, which
follows the semantics that cotengra's compressed contraction documents
(Gray & Chan, "Hyper-optimized compressed contraction of tensor
networks with arbitrary geometry", PRX 14, 011009, 2024):

- the plan's contractions run in its surface order, the order of
  ``children`` in the plan file (the order in which the planner added
  them), each as one ``torch.bmm``;
- after each contraction (before it, for both operands, with
  ``compress_late``), the new tensor's live neighbours are visited in
  the order they became live: the inputs first, in input order, then
  each contraction's result in its turn;
- with each neighbour, the bonds that the two share and that no third
  live tensor or the output holds are fused; where the fused size
  exceeds ``chi`` it is truncated: the QR of each side's matrix (the
  other legs by the fused bond), the SVD of ``R_a R_b^T``,
  ``k = min(rows_a, rows_b, bond, chi)`` singular values kept, and
  ``sqrt(s)`` given to each side. The transposes are bilinear, with no
  conjugation, so that ``T_a T_b`` over the new bond approximates the
  fused bond's product for complex entries too.

It departs from the paper where the paper leaves a choice: the
neighbours are taken in the fixed order above, not by size or
distance, and a bond is truncated from its two tensors alone, with no
gauging of their surroundings first.

``strip=True`` scales each contraction's result by a power of two that
brings its largest magnitude into [0.5, 1), exactly, and carries the
exponent as an integer (``reference.contract``). A chi or
``compress_late`` that differs from the options the program is run
with is refused: the two would compute different things.
"""

import itertools
import math
from collections import Counter

import torch

from .contract import _pair, permute, tf32_round

_COMPLEX = {torch.float64: torch.complex128, torch.float32: torch.complex64}
_REAL = {c: r for r, c in _COMPLEX.items()}


def prepare(config, inputs, output, size_dict):
    """The reference of ``config``: chi and ``compress_late`` from its
    ``"reference"``, held equal to its ``"options"`` (the program's)."""
    ref, opts = config["reference"], config.get("options", {})
    chi = int(ref["chi"])
    late = bool(ref.get("compress_late", False))
    program = (opts.get("chi"), bool(opts.get("compress_late", False)),
               opts.get("order", "surface_order"))
    if program != (chi, late, "surface_order"):
        raise ValueError(
            f"the program runs chi, compress_late, order = {program}; "
            f"the reference computes {(chi, late, 'surface_order')}"
        )
    return CompressedPlan(config["plan"], inputs, output, size_dict, chi, late)


def _mm(a, b, tf32):
    if tf32:
        a, b = tf32_round(a), tf32_round(b)
    return a @ b


def _as_matrix(t, legs, bond):
    """``t`` as (the other legs fused, ``bond`` fused): the matrix, the
    other legs and their sizes."""
    rest = [ix for ix in legs if ix not in bond]
    m = permute(t, [legs.index(ix) for ix in rest + bond])
    shape = list(m.shape[: len(rest)])
    return m.reshape(math.prod(shape), -1), rest, shape


def truncate(x, lx, y, ly, bond, chi, name, tf32=False):
    """Truncate the bond ``bond`` (legs that ``x`` and ``y`` share) to
    one leg ``name`` of at most ``chi``: ``((x', legs), (y', legs))``
    with the new leg last on both."""
    a, ra, sa = _as_matrix(x, lx, bond)
    b, rb, sb = _as_matrix(y, ly, bond)
    k = min(a.shape[0], b.shape[0], a.shape[1], chi)
    qa, r_a = torch.linalg.qr(a)
    qb, r_b = torch.linalg.qr(b)
    u, s, vh = torch.linalg.svd(_mm(r_a, r_b.T, tf32), full_matrices=False)
    root = s[:k].sqrt()
    a2 = _mm(qa, u[:, :k] * root, tf32)
    b2 = _mm(qb, vh[:k].T * root, tf32)
    return (a2.reshape(sa + [k]), ra + [name]), (b2.reshape(sb + [k]), rb + [name])


class CompressedPlan:
    """A saved plan bound to its network, walked with truncation."""

    def __init__(self, plan, inputs, output, size_dict, chi, compress_late=False):
        if plan.get("sliced_inds"):
            raise ValueError("a compressed contraction takes an unsliced plan")
        self.inputs = [list(t) for t in inputs]
        if any(len(set(t)) != len(t) for t in self.inputs):
            raise ValueError("an input repeats an index")
        self.output = list(output)
        self.size_dict = dict(size_dict)
        self.chi = chi
        self.compress_late = compress_late
        self.steps = [(int(p), int(lr[0]), int(lr[1])) for p, lr in plan["children"].items()]
        done = {1 << i for i in range(len(self.inputs))}
        for p, left, right in self.steps:
            if left not in done or right not in done or left | right != p:
                raise ValueError(f"plan step {p} does not follow its children")
            done -= {left, right}
            done.add(p)
        if done != {(1 << len(self.inputs)) - 1}:
            raise ValueError("the plan does not end in one tensor")

    def contract(self, arrays, slice_ids, dtype, device, strip=False, tf32=False):
        """The value over the raw inputs ``arrays`` (numpy) in ``dtype``:
        ``(value, |value|, log2 exponent)``, the reference's interface
        (``reference.contract.contract_slices``) for the plan's one
        slice."""
        if list(slice_ids) != [0]:
            raise ValueError(f"a compressed plan has one slice, not {list(slice_ids)}")
        m, e = self.value(arrays, dtype, device, strip=strip, tf32=tf32)
        v = complex(m.to(torch.complex128).item())
        return v, abs(v), int(e.item())

    def value(self, arrays, dtype, device, strip=False, tf32=False):
        """``(mantissa, log2 exponent)``: the mantissa a tensor in the
        output's legs, the exponent an int tensor."""
        if any(a.dtype.kind == "c" for a in arrays):
            dtype = _COMPLEX.get(dtype, dtype)
        else:
            dtype = _REAL.get(dtype, dtype)
        live = {
            1 << i: (torch.from_numpy(a).to(device=device, dtype=dtype), list(term))
            for i, (a, term) in enumerate(zip(arrays, self.inputs))
        }
        names = (("chi", n) for n in itertools.count())
        exponent = torch.zeros((), dtype=torch.int64, device=device)
        for p, left, right in self.steps:
            if self.compress_late:
                self._compress_around(live, left, names, tf32)
                self._compress_around(live, right, names, tf32)
            (x, lx), (y, ly) = live.pop(left), live.pop(right)
            keep = set(self.output).union(*(legs for _, legs in live.values()))
            z, legs = _pair(x, lx, y, ly, keep, tf32)
            if strip:
                e = torch.frexp(z.abs().amax()).exponent.to(torch.int64)
                z = z * torch.pow(2.0, (-e).to(torch.float64)).to(z.real.dtype)
                exponent = exponent + e
            live[p] = (z, legs)
            if not self.compress_late:
                self._compress_around(live, p, names, tf32)
        ((z, legs),) = live.values()
        if legs != self.output:
            z = permute(z, [legs.index(ix) for ix in self.output])
        return z, exponent

    def _compress_around(self, live, node, names, tf32):
        """Truncate each bond of ``node`` to its live neighbours, in the
        order they became live, where the bond exceeds chi."""
        legs = set(live[node][1])
        neighbours = [o for o, (_, ol) in live.items() if o != node and legs.intersection(ol)]
        out = set(self.output)
        for other in neighbours:
            (x, lx), (y, ly) = live[node], live[other]
            holders = Counter(ix for _, lg in live.values() for ix in lg)
            bond = [ix for ix in lx if ix in ly and ix not in out and holders[ix] == 2]
            size = math.prod(x.shape[lx.index(ix)] for ix in bond)
            if bond and size > self.chi:
                live[node], live[other] = truncate(x, lx, y, ly, bond, self.chi, next(names), tf32)
