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
