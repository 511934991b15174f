"""Contraction instances (counterpart of
``cotengra_tpu/models/instances.py``): the random and structured
equation builders with the same return contract ``(inputs, output,
shapes, size_dict)``, and the same indices, sizes and arrays for the same
seed as the JAX package's; example arrays and a random tree.
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


def tree_equation(n, d_min=2, d_max=3, n_outer=0, seed=None):
    """Random contraction whose interaction graph is a tree of ``n``
    tensors (so optimal contraction is cheap and unique-ish).
    """
    rng = get_rng(seed)
    size_dict = {}

    def new_ind():
        ix = get_symbol(len(size_dict))
        size_dict[ix] = rng.randint(d_min, d_max)
        return ix

    inputs = [[]]
    for _ in range(1, n):
        ix = new_ind()
        # attach new leaf tensor to a random existing tensor
        other = rng.randrange(len(inputs))
        inputs[other].append(ix)
        inputs.append([ix])

    output = []
    for _ in range(n_outer):
        ix = new_ind()
        inputs[rng.randrange(len(inputs))].append(ix)
        output.append(ix)

    rng.shuffle(output)
    return _finalize(inputs, output, size_dict)


def randreg_equation(n, reg, d_min=2, d_max=3, seed=None):
    """Contraction of a random ``reg``-regular graph of ``n`` tensors (one
    index per edge, no output). ``n * reg`` must be even.
    """
    rng = get_rng(seed)
    if (n * reg) % 2 != 0:
        raise ValueError("n * reg must be even.")

    # configuration model with retry until simple
    for _attempt in range(1000):
        stubs = [i for i in range(n) for _ in range(reg)]
        rng.shuffle(stubs)
        edges = set()
        ok = True
        for i, j in zip(stubs[::2], stubs[1::2]):
            if i == j or (min(i, j), max(i, j)) in edges:
                ok = False
                break
            edges.add((min(i, j), max(i, j)))
        if ok:
            break
    else:
        raise RuntimeError("Failed to generate a simple regular graph.")

    inputs = [[] for _ in range(n)]
    size_dict = {}
    for c, (i, j) in enumerate(sorted(edges)):
        ix = get_symbol(c)
        size_dict[ix] = rng.randint(d_min, d_max)
        inputs[i].append(ix)
        inputs[j].append(ix)

    return _finalize(inputs, [], size_dict)


def perverse_equation(
    n, n_inputs=5, d_min=2, d_max=3, seed=None
):
    """Adversarial generator covering einsum edge cases: repeated indices
    within a term, scalars, size-1 dims, hyper in/out edges, indices
    appearing many times.
    """
    rng = get_rng(seed)
    size_dict = {
        get_symbol(i): rng.choice([1, *range(d_min, d_max + 1)])
        for i in range(n)
    }
    all_inds = list(size_dict)

    inputs = []
    for _ in range(n_inputs):
        ndim = rng.randint(0, 4)
        # sample with replacement -> repeats possible
        term = [rng.choice(all_inds) for _ in range(ndim)]
        inputs.append(term)

    appearing = sorted({ix for term in inputs for ix in term})
    n_out = rng.randint(0, min(3, len(appearing))) if appearing else 0
    output = rng.sample(appearing, n_out)
    size_dict = {ix: size_dict[ix] for ix in appearing}
    return _finalize(inputs, output, size_dict)


def networkx_graph_to_equation(G, d_min=2, d_max=3, seed=None):
    """Turn any networkx graph into a contraction: one tensor per node,
    one index per edge. ``networkx`` itself is not needed: any object
    with ``nodes()`` and ``edges()`` serves.
    """
    rng = get_rng(seed)
    nodes = list(G.nodes())
    pos = {n: i for i, n in enumerate(nodes)}
    inputs = [[] for _ in nodes]
    size_dict = {}
    for c, (u, v) in enumerate(G.edges()):
        ix = get_symbol(c)
        size_dict[ix] = rng.randint(d_min, d_max)
        inputs[pos[u]].append(ix)
        inputs[pos[v]].append(ix)
    return _finalize(inputs, [], size_dict)


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


def make_rand_size_dict_from_inputs(inputs, d_min=2, d_max=3, seed=None):
    """Random index-size dictionary for given input terms."""
    rng = get_rng(seed)
    size_dict = {}
    for term in inputs:
        for ix in term:
            if ix not in size_dict:
                size_dict[ix] = rng.randint(d_min, d_max)
    return size_dict


def make_shapes_from_inputs(inputs, size_dict):
    """Shapes matching ``inputs`` under ``size_dict``."""
    return [tuple(size_dict[ix] for ix in term) for term in inputs]


def make_arrays_from_inputs(
    inputs, size_dict, seed=None, dtype="float64"
):
    """Example numpy arrays matching ``inputs`` under ``size_dict``."""
    import numpy as np

    rng = np.random.default_rng(
        seed if isinstance(seed, int) or seed is None else None
    )
    arrays = []
    for shape in make_shapes_from_inputs(inputs, size_dict):
        x = rng.normal(size=shape)
        if "complex" in dtype:
            x = x + 1j * rng.normal(size=shape)
        arrays.append(x.astype(dtype))
    return arrays


def make_arrays_from_eq(
    eq, d_min=2, d_max=3, seed=None, size_dict=None, dtype="float64"
):
    """Example arrays directly from an einsum equation."""
    from ..utils.eqs import eq_to_inputs_output

    inputs, _ = eq_to_inputs_output(eq)
    if size_dict is None:
        size_dict = make_rand_size_dict_from_inputs(
            inputs, d_min=d_min, d_max=d_max, seed=seed
        )
    return make_arrays_from_inputs(
        inputs, size_dict, seed=seed, dtype=dtype
    )


def rand_tree(
    n,
    reg,
    n_out=0,
    n_hyper_in=0,
    n_hyper_out=0,
    d_min=2,
    d_max=3,
    seed=None,
    optimize="greedy",
):
    """A random :class:`ContractionTree` over a random equation."""
    from ..interface import array_contract_tree

    inputs, output, shapes, size_dict = rand_equation(
        n,
        reg,
        n_out=n_out,
        n_hyper_in=n_hyper_in,
        n_hyper_out=n_hyper_out,
        d_min=d_min,
        d_max=d_max,
        seed=seed,
    )
    return array_contract_tree(
        inputs, output, size_dict=size_dict, optimize=optimize
    )
