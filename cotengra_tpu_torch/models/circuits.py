"""Random-quantum-circuit tensor networks (counterpart of
``cotengra_tpu/models/circuits.py``): amplitude networks shaped like the
Sycamore random-circuit sampling benchmark - a 2D grid of qubits,
alternating two-qubit-gate patterns (ABCD), single-qubit layers, closed
with an initial product state and a final bitstring. For the same seed
they are identical to the JAX package's: the same indices and the same
arrays, bit for bit.
"""

import itertools

import numpy as np

from ..utils.misc import get_rng
from ..utils.symbols import get_symbol


def _rand_unitary(n, rng):
    """Haar-ish random unitary via QR of a complex gaussian."""
    z = np.array(
        [
            [complex(rng.gauss(0, 1), rng.gauss(0, 1)) for _ in range(n)]
            for _ in range(n)
        ]
    )
    q, r = np.linalg.qr(z)
    d = np.diagonal(r)
    return q * (d / abs(d))


def sycamore_like_qubits(n_qubits=53):
    """Positions of a Sycamore-like device: a 6x9 grid (54 sites) with one
    corner removed to give 53 qubits (or truncated further for smaller n).
    """
    sites = [(r, c) for r in range(6) for c in range(9)]
    sites.remove((5, 8))
    return sites[:n_qubits]


def grid_couplers(qubits):
    """Nearest-neighbour couplers on a set of grid positions, grouped into
    the 4 alternating activation patterns (A, B, C, D) of the Sycamore
    supremacy circuits: alternate row/column parities.
    """
    qset = set(qubits)
    patterns = {k: [] for k in "ABCD"}
    for (r, c) in qubits:
        # horizontal couplers: A (even col), B (odd col)
        if (r, c + 1) in qset:
            patterns["A" if c % 2 == 0 else "B"].append(((r, c), (r, c + 1)))
        # vertical couplers: C (even row), D (odd row)
        if (r + 1, c) in qset:
            patterns["C" if r % 2 == 0 else "D"].append(((r, c), (r + 1, c)))
    return patterns


def rand_circuit_tn(
    n_qubits=53,
    depth=10,
    seed=None,
    pattern_sequence="ABCDCDAB",
    fuse_singles=True,
    dtype="complex64",
):
    """Build an amplitude tensor network for a random circuit.

    Parameters
    ----------
    n_qubits : int
        Number of qubits (53 = Sycamore-like).
    depth : int
        Number of two-qubit-gate cycles (``m`` in the supremacy papers).
    seed : int, optional
    pattern_sequence : str
        Order in which the coupler patterns activate, cycled over ``depth``.
    fuse_singles : bool
        Fuse single-qubit gates into neighbouring two-qubit gates (standard
        preprocessing - dramatically reduces tensor count without changing
        the contraction's difficulty class).
    dtype : str

    Returns
    -------
    inputs : list[list[str]]
    output : list[str]
    shapes : list[tuple[int]]
    size_dict : dict[str, int]
    arrays : list[np.ndarray]
    """
    rng = get_rng(seed)
    np_rng = np.random.default_rng(
        rng.randrange(2**63)
    )
    qubits = sycamore_like_qubits(n_qubits)
    patterns = grid_couplers(qubits)

    counter = itertools.count()

    def new_ind():
        return get_symbol(next(counter))

    # current open index on each qubit wire
    wire = {}
    inputs = []
    arrays = []

    # initial |0> states
    for q in qubits:
        ix = new_ind()
        wire[q] = ix
        inputs.append([ix])
        arrays.append(np.array([1.0, 0.0], dtype=dtype))

    pending_single = {q: None for q in qubits}

    def apply_single(q):
        u = _rand_unitary(2, rng).astype(dtype)
        if fuse_singles:
            if pending_single[q] is None:
                pending_single[q] = u
            else:
                pending_single[q] = u @ pending_single[q]
        else:
            old, new = wire[q], new_ind()
            inputs.append([new, old])
            arrays.append(u)
            wire[q] = new

    def flush_single(q):
        # absorb any pending single-qubit unitary by inserting it now
        u = pending_single[q]
        if u is not None:
            old, new = wire[q], new_ind()
            inputs.append([new, old])
            arrays.append(u)
            wire[q] = new
            pending_single[q] = None

    def apply_two(qa, qb):
        u4 = _rand_unitary(4, rng).astype(dtype).reshape(2, 2, 2, 2)
        if fuse_singles:
            # contract pending singles into the 4x4 gate
            ua = pending_single.pop(qa, None)
            ub = pending_single.pop(qb, None)
            m = u4.reshape(4, 4)
            pre = np.kron(
                ua if ua is not None else np.eye(2, dtype=dtype),
                ub if ub is not None else np.eye(2, dtype=dtype),
            )
            u4 = (m @ pre).reshape(2, 2, 2, 2)
            pending_single[qa] = None
            pending_single[qb] = None
        oa, ob = wire[qa], wire[qb]
        na, nb = new_ind(), new_ind()
        inputs.append([na, nb, oa, ob])
        arrays.append(u4)
        wire[qa], wire[qb] = na, nb

    for cycle in range(depth):
        for q in qubits:
            apply_single(q)
        pat = pattern_sequence[cycle % len(pattern_sequence)]
        for qa, qb in patterns[pat]:
            apply_two(qa, qb)

    # final single-qubit layer + projection onto a random bitstring
    for q in qubits:
        apply_single(q)
        flush_single(q)
        bit = np_rng.integers(0, 2)
        vec = np.zeros(2, dtype=dtype)
        vec[bit] = 1.0
        inputs.append([wire[q]])
        arrays.append(vec)

    size_dict = {ix: 2 for term in inputs for ix in term}
    shapes = [tuple(size_dict[ix] for ix in term) for term in inputs]
    return inputs, [], shapes, size_dict, arrays
