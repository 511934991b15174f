"""The program's Sycamore-like random-circuit amplitude networks: 53
qubits on a 6x9 grid less one corner, two-qubit gates on the couplers
of patterns A, B, C, D in the order of ``"pattern"`` (the cycle order
of Arute et al., Nature 574:505, 2019), a random single-qubit unitary
on every qubit before each cycle and before the final projection,
single-qubit gates fused into the next two-qubit gate, |0> inputs and a
bitstring output; then every tensor of rank <= 2 absorbed into a
neighbour, as cotengra's examples do before planning.

This is not the Sycamore device's circuit. The grid has 91 couplers (47
horizontal, in A on even and B on odd columns; 44 vertical, in C on
even and D on odd rows), so m=20 cycles hold 455 two-qubit gates;
Sycamore has 86 couplers on a rotated lattice and 430 two-qubit gates
at m=20. Gates are Haar-random unitaries (QR of a complex Gaussian),
not fSim gates. This is a frozen copy of the port's
``models.circuits.rand_circuit_tn`` and ``ops.preprocess
.absorb_simple_tensors``: for the same seed it gives the same indices
and arrays, so the committed plans load on it by their ``hash_b``.
"""

import itertools
import random

import numpy as np

from . import get_symbol


def _rand_unitary(n, rng):
    z = np.array(
        [
            [complex(rng.gauss(0, 1), rng.gauss(0, 1)) for _ in range(n)]
            for _ in range(n)
        ]
    )
    q, r = np.linalg.qr(z)
    d = np.diagonal(r)
    return q * (d / abs(d))


def _qubits(n_qubits):
    sites = [(r, c) for r in range(6) for c in range(9)]
    sites.remove((5, 8))
    return sites[:n_qubits]


def _couplers(qubits):
    qset = set(qubits)
    patterns = {k: [] for k in "ABCD"}
    for (r, c) in qubits:
        if (r, c + 1) in qset:
            patterns["A" if c % 2 == 0 else "B"].append(((r, c), (r, c + 1)))
        if (r + 1, c) in qset:
            patterns["C" if r % 2 == 0 else "D"].append(((r, c), (r + 1, c)))
    return patterns


def _circuit(n_qubits, depth, pattern, rng, dtype):
    """The unabsorbed network: (inputs, arrays), single-qubit gates
    fused into the next two-qubit gate on their wire."""
    np_rng = np.random.default_rng(rng.randrange(2**63))
    qubits = _qubits(n_qubits)
    patterns = _couplers(qubits)
    counter = itertools.count()
    wire, inputs, arrays = {}, [], []
    for q in qubits:
        wire[q] = get_symbol(next(counter))
        inputs.append([wire[q]])
        arrays.append(np.array([1.0, 0.0], dtype=dtype))
    pending = {q: None for q in qubits}

    def single(q):
        u = _rand_unitary(2, rng).astype(dtype)
        pending[q] = u if pending[q] is None else u @ pending[q]

    def two(qa, qb):
        u4 = _rand_unitary(4, rng).astype(dtype)
        ua, ub = pending[qa], pending[qb]
        pre = np.kron(
            ua if ua is not None else np.eye(2, dtype=dtype),
            ub if ub is not None else np.eye(2, dtype=dtype),
        )
        u4 = (u4 @ pre).reshape(2, 2, 2, 2)
        pending[qa] = pending[qb] = None
        oa, ob = wire[qa], wire[qb]
        na, nb = get_symbol(next(counter)), get_symbol(next(counter))
        inputs.append([na, nb, oa, ob])
        arrays.append(u4)
        wire[qa], wire[qb] = na, nb

    for cycle in range(depth):
        for q in qubits:
            single(q)
        for qa, qb in patterns[pattern[cycle % len(pattern)]]:
            two(qa, qb)
    for q in qubits:
        single(q)
        old, new = wire[q], get_symbol(next(counter))
        inputs.append([new, old])
        arrays.append(pending[q])
        wire[q] = new
        vec = np.zeros(2, dtype=dtype)
        vec[np_rng.integers(0, 2)] = 1.0
        inputs.append([wire[q]])
        arrays.append(vec)
    return inputs, arrays


def _absorb(inputs, arrays, max_rank, max_absorb_size):
    """Contract every tensor of rank <= ``max_rank`` into its smallest
    neighbour, repeatedly, unless the neighbour would grow beyond
    ``max_absorb_size`` elements (no output indices here)."""
    inputs = [tuple(t) for t in inputs]
    arrays = [np.asarray(a) for a in arrays]

    def holders_of():
        holders = {}
        for p, term in enumerate(inputs):
            if term is not None:
                for ix in term:
                    holders.setdefault(ix, []).append(p)
        return holders

    changed = True
    while changed:
        changed = False
        holders = holders_of()
        for p, term in enumerate(inputs):
            if term is None or len(term) > max_rank:
                continue
            cands = [
                q for ix in term for q in holders.get(ix, ())
                if q != p and inputs[q] is not None
            ]
            if not cands:
                continue
            q = min(cands, key=lambda q: arrays[q].size)
            ta, tb = term, inputs[q]
            shared = set(ta) & set(tb)
            keep = [
                ix for ix in dict.fromkeys(ta + tb)
                if ix not in shared or len(holders.get(ix, ())) > 2
            ]
            sizes = dict(zip(ta, arrays[p].shape))
            sizes.update(zip(tb, arrays[q].shape))
            if int(np.prod([sizes[ix] for ix in keep])) > max_absorb_size:
                continue
            sym = {ix: get_symbol(k) for k, ix in enumerate(dict.fromkeys(ta + tb))}
            eq = (
                "".join(sym[ix] for ix in ta) + ","
                + "".join(sym[ix] for ix in tb) + "->"
                + "".join(sym[ix] for ix in keep)
            )
            arrays[q] = np.einsum(eq, arrays[p], arrays[q])
            inputs[q] = tuple(keep)
            inputs[p] = arrays[p] = None
            changed = True
            holders = holders_of()
    return (
        [t for t in inputs if t is not None],
        [a for a in arrays if a is not None],
    )


def make_sets(recipe, seed, n_sets):
    """``(inputs, output, size_dict, [arrays of each set])``: ``n_sets``
    draws of the circuit's gates and bitstring from one
    ``random.Random(seed)``; the structure is the same for every
    seed."""
    rng = random.Random(seed)
    sets = []
    for _ in range(n_sets):
        raw_inputs, raw = _circuit(
            recipe["n_qubits"], recipe["depth"], recipe["pattern"], rng,
            recipe["dtype"],
        )
        inputs, arrays = _absorb(
            raw_inputs, raw, recipe["absorb_max_rank"],
            recipe["absorb_max_size"],
        )
        sets.append(arrays)
    size_dict = {
        ix: int(d) for term, a in zip(inputs, sets[0])
        for ix, d in zip(term, a.shape)
    }
    return inputs, [], size_dict, sets
