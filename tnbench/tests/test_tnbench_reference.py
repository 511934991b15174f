"""The plain reference against the program on the CPU (float64, tiny
sliced networks), its slice-id order, its wide permutes and its TF32
rounding."""

import json
import math

import numpy as np
import pytest
import torch

from conftest import TINY_CIRCUIT, TINY_LATTICE, _plan


def _circuit(seed):
    from tnbench.networks import sycamore_circuit

    rec = {"pattern": "ABCDCDAB", "dtype": "complex64", "absorb_max_rank": 2,
           "absorb_max_size": 4096, **TINY_CIRCUIT}
    return sycamore_circuit.make_sets(rec, seed, 1)


def _tree(plan, inputs, output, size_dict):
    import io

    import cotengra_tpu_torch as ctt

    return ctt.load_tree(io.StringIO(json.dumps(plan)), inputs, output, size_dict)


@pytest.mark.parametrize("seed", [3, 4])
def test_circuit_slices_equal_the_program(seed):
    from tnbench.reference.contract import Plan, contract_slices

    inputs, output, size_dict, sets = _circuit(seed)
    plan = _plan(inputs, output, size_dict, 16)
    tree = _tree(plan, inputs, output, size_dict)
    ref = Plan(plan, inputs, output, size_dict)
    for ids in ([0], [5, 6, 7], range(tree.multiplicity)):
        m, n, e = contract_slices(ref, sets[0], ids, torch.complex128, "cpu")
        parts = [
            complex(tree.contract_slice(sets[0], i, device="cpu", plane_dtype=torch.float64))
            for i in ids
        ]
        assert abs(m * 2.0**e - sum(parts)) <= 1e-12 * abs(sum(parts))
        assert n * 2.0**e == pytest.approx(math.sqrt(sum(abs(p) ** 2 for p in parts)), rel=1e-12)


def test_lattice_value_equals_the_program_stripped():
    import cotengra_tpu_torch as ctt
    from tnbench.networks import lattice
    from tnbench.reference.contract import Plan, contract_slices

    rec = {"dtype": "float32", "low": -1.0, "high": 1.0, **TINY_LATTICE}
    inputs, output, size_dict, sets = lattice.make_sets(rec, 11, 1)
    plan = _plan(inputs, output, size_dict, 4)
    tree = _tree(plan, inputs, output, size_dict)
    m, _, e = contract_slices(Plan(plan, inputs, output, size_dict), sets[0],
                              range(tree.multiplicity), torch.float64, "cpu", strip=True)
    pm, pe = ctt.contract_tree(tree, sets[0], device="cpu", strip_exponent=True,
                               plane_dtype=torch.float64)
    got = math.log10(abs(m.real)) + e * math.log10(2)
    assert abs(got - (math.log10(abs(float(pm))) + float(pe))) < 1e-12
    assert (m.real > 0) == (float(pm) > 0)
    # unstripped float64 agrees
    m2, _, e2 = contract_slices(Plan(plan, inputs, output, size_dict), sets[0],
                                range(tree.multiplicity), torch.float64, "cpu")
    assert e2 == 0 and abs(math.log10(abs(m2.real)) - got) < 1e-12


def test_slice_order_is_the_programs():
    from tnbench.reference.contract import slice_values

    inputs, output, size_dict, _ = _circuit(0)
    plan = _plan(inputs, output, size_dict, 64)
    tree = _tree(plan, inputs, output, size_dict)
    for i in (0, 1, 7, 33, tree.multiplicity - 1):
        assert slice_values(plan["sliced_inds"], output, size_dict, i) == tree.slice_key(i)


@pytest.mark.parametrize("perm_seed", range(3))
def test_wide_permute_equals_torch(perm_seed, monkeypatch):
    from tnbench.reference import contract

    monkeypatch.setattr(contract, "_MAX_COPY_DIMS", 5)
    rng = np.random.default_rng(perm_seed)
    t = torch.randn((2,) * 12, dtype=torch.float64)
    perm = list(rng.permutation(12))
    assert torch.equal(contract.permute(t, perm), t.permute(perm).contiguous())


def test_tf32_round():
    from tnbench.reference.contract import tf32_round

    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-10, -(1.0 + 3 * 2.0**-12), 3.0e38])
    y = tf32_round(x)
    assert y.tolist() == [1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-10, -(1.0 + 2.0**-10),
                          tf32_round(torch.tensor([3.0e38])).item()]
    r = torch.randn(1000)
    rel = ((tf32_round(r) - r).abs() / r.abs()).max().item()
    assert 2.0**-12 < rel <= 2.0**-11
    z = torch.randn(8, dtype=torch.complex64)
    assert torch.equal(torch.view_as_real(tf32_round(z)), tf32_round(torch.view_as_real(z)))
