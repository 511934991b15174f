"""Square-lattice networks with entries near 1: the structure of
``lattice.py`` (cotengra's ``lattice_equation``: one tensor per site, one
index per bond of size ``d_min``, open boundaries, no output), each
entry ``mean + std * normal`` of the recipe. Near-uniform positive
entries, as in a high-temperature partition function or a PEPS norm,
give a value that grows with the lattice's size, about 10^289 on a 16x16
lattice of bond 4 at ``mean`` 1 and ``std`` 0.05.
"""

import numpy as np

from .lattice import _structure


def make_sets(recipe, seed, n_sets):
    """``(inputs, output, size_dict, [arrays of each set])``: ``n_sets``
    draws from one ``numpy.random.default_rng(seed)``, each input in
    order, as ``mean + std * rng.normal(size=shape)`` cast to
    ``recipe["dtype"]`` (at ``mean`` 1 the arrays of
    ``np.ones(shape) + std * rng.normal(size=shape)``)."""
    inputs, size_dict = _structure(recipe["dims"], recipe["d_min"])
    rng = np.random.default_rng(seed)
    shapes = [tuple(size_dict[ix] for ix in term) for term in inputs]
    sets = [
        [(recipe["mean"] + recipe["std"] * rng.normal(size=s)).astype(recipe["dtype"])
         for s in shapes]
        for _ in range(n_sets)
    ]
    return inputs, [], size_dict, sets
