"""Index symbols (counterpart of ``cotengra_tpu/utils/symbols.py``): a
stable mapping from integers to unicode index symbols, skipping
surrogates, matching ``opt_einsum``'s convention for the first 52 (a-z,
A-Z).
"""

import functools
import string

# the 52 ascii letters, matching opt_einsum / numpy interleaved convention
_BASE_SYMBOLS = string.ascii_lowercase + string.ascii_uppercase


@functools.lru_cache(2**14)
def get_symbol(i):
    """Get the symbol corresponding to int ``i``, matching ``opt_einsum``.

    The first 52 are the ascii letters, then unicode characters starting
    from ``chr(192)``, skipping the surrogate block.
    """
    if i < 52:
        return _BASE_SYMBOLS[i]
    i += 140
    if i >= 55296:
        # skip surrogates
        i += 2048
    return chr(i)


def get_symbol_map(inputs):
    """Map the unique (hashable) indices appearing in ``inputs`` to
    single-character symbols, in order of first appearance.

    Parameters
    ----------
    inputs : sequence[sequence[hashable]]
        The index labels of each tensor.

    Returns
    -------
    dict[hashable, str]
    """
    symmap = {}
    c = 0
    for term in inputs:
        for ix in term:
            if ix not in symmap:
                symmap[ix] = get_symbol(c)
                c += 1
    return symmap


def inds_to_eq(inputs, output=None):
    """Lists of hashable index labels -> an einsum equation of
    single-character symbols (``get_symbol_map``'s). Without ``output``,
    the indices appearing exactly once, sorted."""
    symmap = get_symbol_map(inputs)
    if output is None:
        from .eqs import find_output_from_inputs

        output = find_output_from_inputs(inputs)
    lhs = ",".join("".join(symmap[ix] for ix in term) for term in inputs)
    rhs = "".join(symmap[ix] for ix in output)
    return f"{lhs}->{rhs}"
