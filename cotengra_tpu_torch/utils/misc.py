"""Small shared primitives (counterpart of ``cotengra_tpu/utils/misc.py``:
``prod``, ``get_rng`` and ``GumbelBatchedGenerator``)."""

import math
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


class GumbelBatchedGenerator:
    """Cheap Gumbel noise for the greedy search's hot loop: exponential
    variates drawn 512 at a time and transformed, then handed out from
    the end of the batch. The same seed draws the same numbers as the
    reference's generator."""

    def __init__(self, rng=None):
        self.rng = get_rng(rng)
        self._buf = []

    def __call__(self):
        if not self._buf:
            expo = self.rng.expovariate
            self._buf = [-math.log(expo(1.0)) for _ in range(512)]
        return self._buf.pop()
