"""Square-lattice networks (cotengra's ``lattice_equation``): one tensor
per site, one index per bond of size ``d_min``, open boundaries, no
output. Values are uniform on [``low``, ``high``) of the recipe. A
frozen copy of the port's
``models.instances.lattice_equation`` (fixed bond size, no periodic
boundary): the same indices in the same order, so the committed plans
load on it by their ``hash_b``.
"""

import itertools

import numpy as np

from . import get_symbol


def _structure(dims, d):
    sites = list(itertools.product(*(range(n) for n in dims)))
    site_id = {s: i for i, s in enumerate(sites)}
    inputs = [[] for _ in sites]
    size_dict = {}
    c = 0
    for s in sites:
        for ax in range(len(dims)):
            nxt = list(s)
            nxt[ax] += 1
            if nxt[ax] == dims[ax]:
                continue
            ix = get_symbol(c)
            c += 1
            size_dict[ix] = d
            inputs[site_id[s]].append(ix)
            inputs[site_id[tuple(nxt)]].append(ix)
    return inputs, size_dict


def make_sets(recipe, seed, n_sets):
    """``(inputs, output, size_dict, [arrays of each set])``: ``n_sets``
    draws from one ``numpy.random.default_rng(seed)``, each input in
    order, as ``uniform(low, high, size=shape)`` cast to
    ``recipe["dtype"]`` (``low=0, high=1`` draws what
    ``uniform(size=shape)`` does)."""
    inputs, size_dict = _structure(recipe["dims"], recipe["d_min"])
    rng = np.random.default_rng(seed)
    shapes = [tuple(size_dict[ix] for ix in term) for term in inputs]
    sets = [
        [rng.uniform(recipe["low"], recipe["high"], size=s).astype(recipe["dtype"])
         for s in shapes]
        for _ in range(n_sets)
    ]
    return inputs, [], size_dict, sets
