"""Small shared primitives (counterpart of ``cotengra_tpu/utils/misc.py``:
``prod`` and ``get_rng``)."""

import random


def prod(it):
    p = 1
    for x in it:
        p *= x
    return p


def get_rng(seed=None):
    """Get a ``random.Random`` instance: pass through if already one, seed a
    new one with an int or None.
    """
    if isinstance(seed, random.Random):
        return seed
    return random.Random(seed)
