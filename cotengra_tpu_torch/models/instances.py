"""Contraction instances (counterpart of
``cotengra_tpu/models/instances.py``): ``rand_equation`` and
``lattice_equation``, with the same return contract ``(inputs, output,
shapes, size_dict)`` and the same indices as the JAX package's.
"""

import collections
import itertools

from ..utils.misc import get_rng
from ..utils.symbols import get_symbol

Contraction = collections.namedtuple(
    "Contraction", ("inputs", "output", "shapes", "size_dict")
)


def _finalize(inputs, output, size_dict):
    inputs = [list(term) for term in inputs]
    output = list(output)
    shapes = [tuple(size_dict[ix] for ix in term) for term in inputs]
    return Contraction(inputs, output, shapes, size_dict)


def rand_equation(
    n, reg, n_out=0, n_hyper_in=0, n_hyper_out=0, d_min=2, d_max=3, seed=None
):
    """Random einsum instance with optional inner/outer hyper edges.

    Parameters
    ----------
    n : int
        Number of tensors.
    reg : int
        Average number of (plain) indices per tensor: ``n * reg // 2`` total.
    n_out : int
        Number of plain output (once-appearing) indices.
    n_hyper_in, n_hyper_out : int
        Number of inner / outer hyper indices (appearing on >=3 tensors).
    d_min, d_max : int
        Index dimension range (inclusive).
    seed : int or random.Random, optional

    Returns
    -------
    (inputs, output, shapes, size_dict)
    """
    rng = get_rng(seed)

    num_inds = max((n * reg) // 2, n_hyper_in + n_hyper_out + n_out)
    size_dict = {
        get_symbol(i): rng.randint(d_min, d_max) for i in range(num_inds)
    }

    ind_it = iter(size_dict)
    inputs = [[] for _ in range(n)]
    output = []
    all_pos = list(range(n))

    for _ in range(n_hyper_out):
        ix = next(ind_it)
        output.append(ix)
        for i in rng.sample(all_pos, rng.randint(3, n)):
            inputs[i].append(ix)

    for _ in range(n_hyper_in):
        ix = next(ind_it)
        for i in rng.sample(all_pos, rng.randint(3, n)):
            inputs[i].append(ix)

    for _ in range(n_out):
        ix = next(ind_it)
        output.append(ix)
        inputs[rng.randrange(n)].append(ix)

    for ix in ind_it:
        i, j = rng.sample(all_pos, 2)
        inputs[i].append(ix)
        inputs[j].append(ix)

    rng.shuffle(output)
    return _finalize(inputs, output, size_dict)


def lattice_equation(dims, cyclic=False, d_min=2, d_max=None, seed=None):
    """Hypercubic-lattice contraction: one tensor per site, one index per
    lattice bond, optional periodic boundaries, no output.

    Parameters
    ----------
    dims : sequence[int]
        Lattice extents, e.g. ``(8, 8)``.
    cyclic : bool or sequence[bool]
        Periodic boundary per dimension.
    d_min, d_max : int
        Bond dimension range; if ``d_max`` is None all bonds have ``d_min``.
    """
    rng = get_rng(seed)
    dims = tuple(dims)
    ndim = len(dims)
    if isinstance(cyclic, bool):
        cyclic = (cyclic,) * ndim

    sites = list(itertools.product(*(range(d) for d in dims)))
    site_id = {s: i for i, s in enumerate(sites)}
    inputs = [[] for _ in sites]
    size_dict = {}

    c = 0
    for s in sites:
        for ax in range(ndim):
            nxt = list(s)
            nxt[ax] += 1
            if nxt[ax] == dims[ax]:
                if not cyclic[ax] or dims[ax] <= 2:
                    continue
                nxt[ax] = 0
            nxt = tuple(nxt)
            ix = get_symbol(c)
            c += 1
            if d_max is None:
                size_dict[ix] = d_min
            else:
                size_dict[ix] = rng.randint(d_min, d_max)
            inputs[site_id[s]].append(ix)
            inputs[site_id[nxt]].append(ix)

    return _finalize(inputs, [], size_dict)
