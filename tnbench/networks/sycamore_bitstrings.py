"""Amplitudes of one fixed Sycamore-like circuit, one bitstring a set.

Cross-entropy benchmarking of a random-circuit sampling run (Arute et
al., Nature 574:505, 2019) takes the ideal amplitude of each sampled
bitstring of one circuit: the gates stay, the bitstring changes. Here
the circuit's gates are drawn once from the seed, exactly as the frozen
``sycamore_circuit`` generator draws its first set, and each input set
projects them onto a bitstring of its own, drawn from the seed too. The
network's indices and shapes are ``sycamore_circuit``'s (rank <= 2
tensors absorbed the same way), so the committed plans load on it by
their ``hash_b``; only the values of the tensors that absorbed a
projection change from set to set.
"""

import random

import numpy as np

from .sycamore_circuit import _absorb, _circuit


def _projections(raw_inputs, n_qubits):
    """Positions of the bitstring's projection vectors in the unabsorbed
    network: the last tensor on each qubit's wire, after its final
    single-qubit gate (``_circuit`` ends with a (gate, vector) pair a
    qubit)."""
    n = len(raw_inputs)
    return [n - 2 * n_qubits + 2 * q + 1 for q in range(n_qubits)]


def raw_circuit(recipe, seed, n_sets):
    """``(inputs, [arrays of each set], [bits of each set])`` of the
    unabsorbed network: the gates of ``random.Random(seed)``, then a
    bitstring a set (0 or 1 for each qubit, in ``_circuit``'s qubit
    order)."""
    rng = random.Random(seed)
    inputs, arrays = _circuit(
        recipe["n_qubits"], recipe["depth"], recipe["pattern"], rng,
        recipe["dtype"],
    )
    bits_rng = np.random.default_rng(rng.randrange(2**63))
    at = _projections(inputs, recipe["n_qubits"])
    sets, bits = [], []
    for _ in range(n_sets):
        b = bits_rng.integers(0, 2, recipe["n_qubits"])
        arrs = list(arrays)
        for pos, v in zip(at, b):
            vec = np.zeros(2, dtype=recipe["dtype"])
            vec[v] = 1.0
            arrs[pos] = vec
        sets.append(arrs)
        bits.append([int(v) for v in b])
    return inputs, sets, bits


def make_sets(recipe, seed, n_sets):
    """``(inputs, output, size_dict, [arrays of each set])``: the absorbed
    network of ``raw_circuit``'s sets, one bitstring a set."""
    raw_inputs, raw_sets, _ = raw_circuit(recipe, seed, n_sets)
    sets = []
    for raw in raw_sets:
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
