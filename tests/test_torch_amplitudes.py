"""Single amplitudes of one Sycamore-like circuit, one bitstring a call
(the benchmark's ``sycamore_bitstrings`` generator), through the port's
normal entry ``contract_tree(..., autojit=True)``, which runs eagerly on
the CPU (the card tests replay it as a CUDA graph).

The generator keeps the frozen ``sycamore_circuit`` generator's indices
and shapes for every bitstring, so the committed m=10 plan loads by its
hash on each; at a small size the port's amplitudes equal the plain
complex128 walk of the plan (``tnbench/reference/contract.py``) and a
dense statevector simulation of the unabsorbed circuit written here with
numpy, which shares nothing with the plan.
"""

import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import cotengra_tpu_torch as ctt
from cotengra_tpu_torch.utils.io import save_tree
from tnbench.networks import sycamore_bitstrings, sycamore_circuit
from tnbench.reference import contract as reference

ROOT = Path(__file__).resolve().parent.parent
M10 = {"n_qubits": 53, "depth": 10, "pattern": "ABCDCDAB", "dtype": "complex64",
       "absorb_max_rank": 2, "absorb_max_size": 4096}
# complex128 entries, so that absorbing the small circuit's tensors
# rounds in float64 as the statevector does
SMALL = dict(M10, n_qubits=14, depth=4, dtype="complex128")


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**62 + 3])
def test_bitstrings_keep_the_frozen_structure_and_load_the_m10_plan(seed):
    """Every set has the frozen generator's indices and shapes, its gates
    are the frozen generator's first set's, only the tensors that
    absorbed a projection change between sets, and the m=10 plan loads
    on it by its ``hash_b`` (``load_tree`` checks the hash)."""
    inputs, output, size_dict, sets = sycamore_bitstrings.make_sets(M10, seed, 3)
    f_inputs, f_output, f_size_dict, (frozen,) = sycamore_circuit.make_sets(M10, seed, 1)
    assert inputs == f_inputs and output == f_output and size_dict == f_size_dict
    _, _, bits = sycamore_bitstrings.raw_circuit(M10, seed, 3)
    assert len({tuple(b) for b in bits}) == 3
    for arrays in sets:
        assert [a.shape for a in arrays] == [a.shape for a in frozen]
        assert all(a.dtype == np.complex64 for a in arrays)
    # 53 projections, each absorbed into a neighbour: the rest is the
    # frozen set's gates, equal in every set
    moved = [i for i, (a, b) in enumerate(zip(sets[0], sets[1])) if not np.array_equal(a, b)]
    assert 0 < len(moved) <= 53
    for arrays in sets:
        same = [i for i, (a, b) in enumerate(zip(arrays, frozen)) if np.array_equal(a, b)]
        assert len(same) >= len(inputs) - 53
    plan = json.loads((ROOT / "tnbench" / "configs" / "sycamore-like-6x9-m10.json").read_text())
    tree = ctt.load_tree(io.StringIO(json.dumps(plan["plan"])), inputs, output, size_dict)
    assert tree.multiplicity == 4 and tree.max_size() == 2**27


def _statevector_amplitude(inputs, arrays, n_qubits):
    """The circuit's amplitude by a dense statevector simulation of the
    unabsorbed network, gate by gate in circuit order: the |0> inputs'
    product state, each two-qubit gate ``(new a, new b, old a, old b)``
    and final single-qubit gate ``(new, old)`` applied to the wires it
    names, then each projection vector contracted away."""
    legs = [inputs[q][0] for q in range(n_qubits)]
    state = np.asarray(arrays[0], dtype=np.complex128)
    for q in range(1, n_qubits):
        state = np.multiply.outer(state, np.asarray(arrays[q], dtype=np.complex128))
    for term, a in zip(inputs[n_qubits:], arrays[n_qubits:]):
        a = np.asarray(a, dtype=np.complex128)
        if len(term) == 4:
            new, old = list(term[:2]), list(term[2:])
        elif len(term) == 2:
            new, old = [term[0]], [term[1]]
        else:
            new, old = [], [term[0]]
        at = [legs.index(ix) for ix in old]
        state = np.tensordot(a, state, axes=(list(range(len(new), a.ndim)), at))
        legs = new + [ix for ix in legs if ix not in old]
    assert legs == [] and state.shape == ()
    return complex(state)


def _small_case(seed, n_sets):
    """The small circuit's absorbed sets, its unabsorbed sets and a plan
    of the port's own (greedy, sliced 4 ways) as the JSON ``save_tree``
    writes."""
    inputs, output, size_dict, sets = sycamore_bitstrings.make_sets(SMALL, seed, n_sets)
    raw_inputs, raw_sets, _ = sycamore_bitstrings.raw_circuit(SMALL, seed, n_sets)
    path = ctt.array_contract_path(inputs, output, size_dict=size_dict, optimize="greedy")
    tree = ctt.ContractionTree.from_path(inputs, output, size_dict, path=path)
    tree.slice_(target_slices=4)
    f = io.StringIO()
    save_tree(f, tree)
    plan = json.loads(f.getvalue())
    return inputs, output, size_dict, sets, raw_inputs, raw_sets, plan


@pytest.mark.parametrize("implementation", [None, "grouped"])
def test_small_amplitudes_match_the_reference_and_a_statevector(implementation):
    """Four bitstrings of one seeded 14-qubit m=4 circuit, its port plan
    sliced 4 ways, through ``contract_tree(..., autojit=True)`` on the
    CPU (float64 planes): equal to the complex128 walk of the plan and to
    the statevector's amplitude within 1e-10 of the slices' norm (every
    side in float64 arithmetic, the absorbed tensors too; only the order
    of the sums differs, ~1e-15 a step over ~100 steps); the same
    entries rounded to complex64 in float32 planes, the configuration's
    precision, within 1e-5 (float32's 6e-8 a rounding over ~100 steps
    and 4 slices, with room). The four amplitudes differ from each other
    by far more than either tolerance."""
    inputs, output, size_dict, sets, raw_inputs, raw_sets, plan = _small_case(2**31 + 5, 4)
    tree = ctt.load_tree(io.StringIO(json.dumps(plan)), inputs, output, size_dict)
    assert tree.multiplicity == 4
    ref = reference.Plan(plan, inputs, output, size_dict)
    amps = []
    for arrays, raw in zip(sets, raw_sets):
        want, norm, e = ref.contract(arrays, range(4), torch.complex128, "cpu")
        want, norm = want * 2.0**e, norm * 2.0**e
        sv = _statevector_amplitude(raw_inputs, raw, SMALL["n_qubits"])
        assert abs(sv - want) <= 1e-10 * norm
        got64 = ctt.contract_tree(tree, arrays, device="cpu", plane_dtype=torch.float64,
                                  implementation=implementation, autojit=True)
        got32 = ctt.contract_tree(tree, [a.astype(np.complex64) for a in arrays], device="cpu",
                                  implementation=implementation, autojit=True)
        assert got64.dtype == torch.complex128 and got32.dtype == torch.complex64
        assert abs(complex(got64) - want) <= 1e-10 * norm
        assert abs(complex(got64) - sv) <= 1e-10 * norm
        assert abs(complex(got32) - want) <= 1e-5 * norm
        amps.append((want, norm))
    for i, (a, na) in enumerate(amps):
        for b, nb in amps[i + 1:]:
            assert abs(a - b) > 1e-3 * max(na, nb)


def test_statevector_matches_the_absorbed_network():
    """The test's statevector agrees with the frozen generator's network
    contracted whole (``numpy.einsum``) at 10 qubits: the simulation
    reads the unabsorbed circuit as the generators write it."""
    recipe = dict(SMALL, n_qubits=10, depth=3)
    raw_inputs, (raw,), _ = sycamore_bitstrings.raw_circuit(recipe, 3, 1)
    inputs, output, _, (arrays,) = sycamore_bitstrings.make_sets(recipe, 3, 1)
    eq = ctt.utils.eqs.inputs_output_to_eq(inputs, output)
    whole = complex(np.einsum(eq, *arrays, optimize=True))
    sv = _statevector_amplitude(raw_inputs, raw, recipe["n_qubits"])
    assert abs(sv - whole) <= 1e-12 * max(1.0, abs(whole)) + 1e-15
