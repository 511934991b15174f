"""Network generators, one module per ``"generator"`` named in a
configuration's ``"network"`` recipe.

Each module has ``build(recipe) -> (inputs, output, size_dict)``, the
network's structure, and ``make_arrays(recipe, inputs, rng) -> list of
numpy arrays``, its values drawn from a ``numpy.random.Generator`` or a
``random.Random`` seeded by the run. They are frozen copies of the
port's instance builders: the harness and the reference build the same
network without importing the program.
"""

import string

_BASE_SYMBOLS = string.ascii_lowercase + string.ascii_uppercase


def get_symbol(i):
    """The ``i``-th index symbol: the 52 ascii letters, then unicode
    from ``chr(192)``, skipping the surrogate block (opt_einsum's
    convention, which the committed plans' index names follow)."""
    if i < 52:
        return _BASE_SYMBOLS[i]
    i += 140
    if i >= 55296:
        i += 2048
    return chr(i)
