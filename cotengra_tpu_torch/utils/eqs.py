"""Einsum equation parsing and canonicalization (counterpart of
``cotengra_tpu/utils/eqs.py``): string equation <-> (inputs, output),
implicit outputs, ellipsis expansion, interleaved-argument einsum parsing,
and canonical relabelling of arbitrary hashable index labels for cache
keys.

Terms are tuples of hashable index labels; the string-equation forms are
a thin layer on top. Operands may be numpy arrays or torch tensors: only
their ``shape`` is read.
"""

import hashlib
import itertools
import pickle

from .symbols import get_symbol


def find_output_from_inputs(inputs):
    """The implicit output: indices appearing exactly once across all
    inputs, sorted (einsum convention)."""
    counts = {}
    for term in inputs:
        for ix in term:
            counts[ix] = counts.get(ix, 0) + 1
    return tuple(sorted((ix for ix, c in counts.items() if c == 1), key=str))


def eq_to_inputs_output(eq):
    """A string equation -> ``(inputs, output)`` tuples of tuples.

    Handles an implicit output (``'ab,bc'``) but not ellipses (expand
    them first with :func:`parse_eq_ellipses`).
    """
    if "->" in eq:
        lhs, rhs = eq.split("->")
        output = tuple(rhs)
    else:
        lhs = eq
        output = None
    inputs = tuple(tuple(term) for term in lhs.split(","))
    if output is None:
        output = find_output_from_inputs(inputs)
    return inputs, output


def inputs_output_to_eq(inputs, output):
    """``(inputs, output)`` of single-character labels -> a string
    equation."""
    lhs = ",".join("".join(term) for term in inputs)
    rhs = "".join(output)
    return f"{lhs}->{rhs}"


def parse_eq_ellipses(eq, shapes):
    """Expand the ellipses (``'...'``) of ``eq`` given the operands'
    ``shapes``, returning the full equation.

    numpy semantics: the ellipsis dimensions of all operands broadcast
    together, and an implicit output (or one containing ``'...'``) gets
    the broadcast dimensions first.
    """
    if "..." not in eq:
        return eq

    if "->" in eq:
        lhs, rhs = eq.split("->")
    else:
        lhs, rhs = eq, None

    terms = lhs.split(",")
    if len(terms) != len(shapes):
        raise ValueError(
            f"Equation has {len(terms)} terms but {len(shapes)} "
            "operands were supplied."
        )

    used = set(eq) - {".", ",", "-", ">"}
    # fresh symbols for the broadcast dimensions
    fresh = (s for s in map(get_symbol, itertools.count()) if s not in used)

    num_broadcast = 0
    ell_ndims = []
    for term, shape in zip(terms, shapes):
        if "..." in term:
            n = len(shape) - (len(term) - 3)
            if n < 0:
                raise ValueError(
                    f"Term '{term}' has more explicit indices than operand "
                    f"dims {tuple(shape)}."
                )
            ell_ndims.append(n)
            num_broadcast = max(num_broadcast, n)
        else:
            if len(term) != len(shape):
                raise ValueError(
                    f"Term '{term}' doesn't match operand shape "
                    f"{tuple(shape)}."
                )
            ell_ndims.append(None)

    bsyms = list(itertools.islice(fresh, num_broadcast))

    new_terms = []
    for term, n in zip(terms, ell_ndims):
        if n is None:
            new_terms.append(term)
        else:
            # the rightmost ellipsis dimensions align (broadcasting)
            sub = "".join(bsyms[num_broadcast - n:])
            new_terms.append(term.replace("...", sub))

    new_lhs = ",".join(new_terms)

    if rhs is None:
        # implicit: broadcast dimensions first, then once-appearing sorted
        counts = {}
        for term in new_terms:
            for ix in term:
                counts[ix] = counts.get(ix, 0) + 1
        explicit = "".join(
            sorted(
                ix
                for ix, c in counts.items()
                if c == 1 and ix not in bsyms
            )
        )
        new_rhs = "".join(bsyms) + explicit
    else:
        new_rhs = rhs.replace("...", "".join(bsyms))

    return f"{new_lhs}->{new_rhs}"


def parse_einsum_input(args, shapes=False):
    """Parse einsum arguments, ``(eq, *arrays)`` or interleaved
    ``(array0, inds0, array1, inds1, ..., [out_inds])``, into ``(eq,
    arrays)`` with ellipses expanded. With ``shapes=True`` the operands
    are shapes."""
    if isinstance(args[0], str):
        eq, arrays = args[0], tuple(args[1:])
    else:
        if len(args) % 2 == 0:
            arrays = args[::2]
            inds_seq = args[1::2]
            output = None
        else:
            arrays = args[:-1:2]
            inds_seq = args[1:-1:2]
            output = args[-1]

        symmap = {}

        def tosym(ix):
            if ix is Ellipsis:
                return "..."
            if ix not in symmap:
                symmap[ix] = get_symbol(len(symmap))
            return symmap[ix]

        terms = ["".join(map(tosym, term)) for term in inds_seq]
        eq = ",".join(terms)
        if output is not None:
            eq += "->" + "".join(map(tosym, output))

    if shapes:
        shps = arrays
    else:
        shps = tuple(getattr(a, "shape", ()) for a in arrays)

    eq = eq.replace(" ", "")
    eq = parse_eq_ellipses(eq, shps)
    return eq, arrays


def canonicalize_inputs(inputs, output=None, shapes=None, size_dict=None):
    """Relabel arbitrary hashable index labels into canonical symbols (in
    order of first appearance).

    ``output`` None means the implicit output (indices appearing once,
    sorted by ``str``). Sizes come from ``shapes`` (broadcasting size-1
    dimensions) or from ``size_dict``. Returns ``(canon_inputs,
    canon_output, canon_size_dict or None, symmap)``, ``symmap`` mapping
    each original label to its symbol.
    """
    symmap = {}
    canon_inputs = []
    canon_size_dict = (
        {} if (shapes is not None or size_dict is not None) else None
    )

    for t, term in enumerate(inputs):
        for ax, ix in enumerate(term):
            try:
                sym = symmap[ix]
            except KeyError:
                sym = symmap[ix] = get_symbol(len(symmap))
            if canon_size_dict is not None:
                if shapes is not None:
                    d = int(shapes[t][ax])
                    prev = canon_size_dict.setdefault(sym, d)
                    if prev != d and not (prev == 1 or d == 1):
                        raise ValueError(
                            f"Index {ix} has inconsistent sizes {prev}, {d}."
                        )
                    # broadcasting: keep the larger
                    canon_size_dict[sym] = max(prev, d)
                else:
                    canon_size_dict[sym] = size_dict[ix]

    for term in inputs:
        canon_inputs.append(tuple(symmap[ix] for ix in term))

    if output is None:
        canon_output = find_output_from_inputs(canon_inputs)
    else:
        try:
            canon_output = tuple(symmap[ix] for ix in output)
        except KeyError as e:
            raise ValueError(
                f"Output index {e} does not appear in any input."
            ) from None

    return tuple(canon_inputs), canon_output, canon_size_dict, symmap


def hash_contraction(inputs, output, size_dict, **kwargs):
    """A stable content hash of a contraction (and ``kwargs``), for
    caching. Labels are canonicalized first, so relabelled but identical
    contractions share a key."""
    canon_inputs, canon_output, canon_size_dict, _ = canonicalize_inputs(
        inputs, output, size_dict=size_dict
    )
    payload = pickle.dumps(
        (
            canon_inputs,
            canon_output,
            tuple(sorted(canon_size_dict.items())),
            tuple(sorted(kwargs.items())),
        ),
        protocol=4,
    )
    return hashlib.sha1(payload).hexdigest()
