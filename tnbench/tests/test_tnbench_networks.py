"""The benchmark's frozen generators against the program's instance
builders: the same structure, the committed plans' ``hash_b``, and for
the circuit the same arrays for the same seed."""

import json

import numpy as np
import pytest

from conftest import ROOT


def _config(name):
    return json.loads((ROOT / "tnbench" / "configs" / f"{name}.json").read_text())


def test_sycamore_m20_matches_the_program_and_the_plan():
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.utils.io import hash_contraction_b
    from tnbench.networks import sycamore_circuit

    conf = _config("sycamore-like-6x9-m20")
    inputs, output, size_dict, sets = sycamore_circuit.make_sets(conf["network"], 42, 2)
    pi, po, _, _, pa = ctt.rand_circuit_tn(53, 20, seed=42)
    pi, pa = ctt.absorb_simple_tensors(pi, pa, po, max_rank=2, max_absorb_size=2**12)
    assert [list(t) for t in pi] == [list(t) for t in inputs] and list(po) == output
    assert len(inputs) == 413
    assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(pa, sets[0]))
    assert hash_contraction_b(inputs, output, size_dict) == conf["plan"]["hash_b"]
    # a second draw: the same structure, other values
    assert not all(np.array_equal(a, b) for a, b in zip(sets[0], sets[1]))
    tree = ctt.load_tree(str(ROOT / "plans" / "sycamore53_m20_t28.json"), inputs, output, size_dict)
    assert tree.multiplicity == 2**29


@pytest.mark.parametrize("seed", [0, 2**31 + 12345, 10**12])
def test_sycamore_structure_is_the_same_for_every_seed(seed):
    from cotengra_tpu_torch.utils.io import hash_contraction_b
    from tnbench.networks import sycamore_circuit

    conf = _config("sycamore-like-6x9-m20")
    inputs, output, size_dict, sets = sycamore_circuit.make_sets(conf["network"], seed, 1)
    assert hash_contraction_b(inputs, output, size_dict) == conf["plan"]["hash_b"]
    for a in sets[0]:
        assert a.dtype == np.complex64 and np.isfinite(a).all()


def test_lattice_matches_the_program_and_the_plan():
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.utils.io import hash_contraction_b
    from tnbench.networks import lattice

    conf = _config("lattice7x7-d16")
    recipe = dict(conf["network"], low=0.0, high=1.0)
    inputs, output, size_dict, sets = lattice.make_sets(recipe, 7, 4)
    pi, po, shapes, ps = ctt.lattice_equation([7, 7], d_min=16)
    assert [list(t) for t in pi] == inputs and ps == size_dict and list(po) == output
    assert hash_contraction_b(inputs, output, size_dict) == conf["plan"]["hash_b"]
    # set 0 of seed 7 is the recipe of the plan's float64 reference
    rng = np.random.default_rng(7)
    assert all(np.array_equal(rng.uniform(size=s).astype(np.float32), a)
               for s, a in zip(shapes, sets[0]))
    assert len(sets) == 4 and not np.array_equal(sets[0][0], sets[1][0])
    signed = lattice.make_sets(conf["network"], 7, 1)[3][0]
    assert all(a.dtype == np.float32 and a.min() >= -1 and a.max() < 1 for a in signed)
    assert min(a.min() for a in signed) < 0


def test_sycamore_like_grid_counts():
    """The grid's couplers and two-qubit gates, as the configuration's
    ``assumed`` states them: 91 and 455 at m=20 (Sycamore: 86, 430)."""
    import random

    from tnbench.networks import sycamore_circuit

    conf = _config("sycamore-like-6x9-m20")["network"]
    patterns = sycamore_circuit._couplers(sycamore_circuit._qubits(53))
    assert {k: len(v) for k, v in patterns.items()} == {"A": 24, "B": 23, "C": 26, "D": 18}
    inputs, _ = sycamore_circuit._circuit(
        53, conf["depth"], conf["pattern"], random.Random(0), conf["dtype"]
    )
    assert sum(1 for t in inputs if len(t) == 4) == 455
