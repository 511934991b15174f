"""The compressed (chi-truncated) reference, ``tnbench/reference/
compressed.py``, on the CPU: the plan file keeps the surface order, no
truncation gives the exact walk, a truncating chi gives the program's
``contract_compressed`` to rounding and not the exact value, and each
fault planted in the program (a compression skipped, chi off by one,
the neighbour order reversed, a conjugating transpose) fails the
check that a compressed cell would make."""

import inspect
import math

import numpy as np
import pytest
import torch

from conftest import compressed_plan

# between the sound program (<= 2e-6 on these networks: its float32 sum
# of log10 exponents) and the faults (>= 7e-2 on the seeds below)
LIMIT = 1e-4
LOG10_2 = math.log10(2.0)


def _network(dims, d, seed, cplx=False):
    """A lattice with signed entries (truncation then moves the value
    far), complex ones with a signed imaginary part."""
    from tnbench.networks import lattice

    rec = {"dims": dims, "d_min": d, "low": -1.0, "high": 1.0, "dtype": "float64"}
    inputs, output, size_dict, (arrays,) = lattice.make_sets(rec, seed, 1)
    if cplx:
        rng = np.random.default_rng([seed, 1])
        arrays = [a + 1j * rng.uniform(-1.0, 1.0, size=a.shape) for a in arrays]
    return inputs, output, size_dict, arrays


def _reference(plan, inputs, output, size_dict, chi, late=False):
    from tnbench.reference import compressed

    return compressed.CompressedPlan(plan, inputs, output, size_dict, chi, late)


def _check(got, arrays, ref, device="cpu"):
    """``slice_norm_err`` of the program's stripped result ``got``
    against the reference in float64, as a compressed cell's check."""
    from tnbench.checks.slice_norm_err import number
    from tnbench.entries import pull

    v, n, e = ref.contract(arrays, [0], torch.float64, device, strip=True)
    return number(pull(got), (v, e * LOG10_2), (n, e * LOG10_2))


def _program(tree, arrays, chi, device="cpu", **kw):
    return tree.contract_compressed([torch.as_tensor(a, device=device) for a in arrays],
                                    chi=chi, device=device, **kw)


def test_plan_file_keeps_the_surface_order():
    import cotengra_tpu_torch as ctt
    from tnbench import harness

    inputs, output, size_dict, _ = _network([5, 5], 3, 0)
    plan, tree, ssa = compressed_plan(inputs, output, size_dict, 4)
    loaded = harness._load_tree(ctt, {"plan": plan}, inputs, output, size_dict)
    assert loaded.get_ssa_path("surface_order") == tree.get_ssa_path("surface_order")
    assert tree.get_ssa_path("surface_order") == tuple(map(tuple, ssa))
    # the reference walks the file's order, which is the surface order
    ref = _reference(plan, inputs, output, size_dict, 4)
    order = [(p, l, r) for p, l, r in loaded.traverse("surface_order")]
    assert ref.steps == order


@pytest.mark.parametrize("cplx", [False, True])
def test_no_truncation_is_the_exact_walk(cplx, monkeypatch):
    from tnbench.reference import compressed
    from tnbench.reference.contract import Plan, contract_slices

    inputs, output, size_dict, arrays = _network([4, 4], 4, 5, cplx)
    chi = math.prod(size_dict.values())  # at or above every bond product
    plan, _, _ = compressed_plan(inputs, output, size_dict, 8)
    truncations, truncate = [], compressed.truncate
    monkeypatch.setattr(compressed, "truncate",
                        lambda *a, **k: truncations.append(a) or truncate(*a, **k))
    ref = _reference(plan, inputs, output, size_dict, chi)
    dtype = torch.complex128 if cplx else torch.float64
    for strip in (False, True):
        v, n, e = ref.contract(arrays, [0], torch.float64, "cpu", strip=strip)
        x, xn, xe = contract_slices(Plan(plan, inputs, output, size_dict), arrays, [0], dtype,
                                    "cpu", strip=strip)
        assert abs(v * 2.0 ** (e - xe) - x) <= 1e-12 * xn
        assert n * 2.0 ** (e - xe) == pytest.approx(xn, rel=1e-12)
    assert truncations == []


@pytest.mark.parametrize("dims,d,chi,cplx,late", [
    ([4, 4], 4, 8, False, False),
    ([5, 5], 3, 4, True, False),
    ([5, 5], 3, 4, False, True),
])
@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_truncation_equals_the_program(dims, d, chi, cplx, late, seed, device, request):
    from tnbench.reference.contract import Plan, contract_slices

    if device == "cuda":
        request.getfixturevalue("cuda")
    inputs, output, size_dict, arrays = _network(dims, d, seed, cplx)
    plan, tree, _ = compressed_plan(inputs, output, size_dict, chi)
    ref = _reference(plan, inputs, output, size_dict, chi, late)
    v, n, e = ref.contract(arrays, [0], torch.float64, device, strip=True)
    # the program unstripped, in float64 throughout: rounding alone
    got = complex(_program(tree, arrays, chi, device, compress_late=late).item())
    assert abs(got * 2.0 ** -e - v) <= 1e-12 * n
    # stripped, the program sums its log10 exponents in float32
    assert _check(_program(tree, arrays, chi, device, compress_late=late, strip_exponent=True),
                  arrays, ref, device) <= 2e-6
    # the truncation moves the value far beyond that
    dtype = torch.complex128 if cplx else torch.float64
    x, _, xe = contract_slices(Plan(plan, inputs, output, size_dict), arrays, [0], dtype, "cpu",
                               strip=True)
    assert abs(x * 2.0 ** (xe - e) - v) > 1e-3 * n


def _skip_first_compression(monkeypatch, ops):
    orig, calls = ops.compress_bond, []

    def compress_bond(ta, legs_a, tb, legs_b, *rest):
        calls.append(1)
        if len(calls) == 1:
            return ta, tuple(legs_a), tb, tuple(legs_b)
        return orig(ta, legs_a, tb, legs_b, *rest)

    monkeypatch.setattr(ops, "compress_bond", compress_bond)


def _chi_off_by_one(monkeypatch, ops):
    orig = ops.contract_compressed

    def contract_compressed(tree, arrays, chi=None, **kw):
        return orig(tree, arrays, chi=chi - 1, **kw)

    monkeypatch.setattr(ops, "contract_compressed", contract_compressed)


def _planted(monkeypatch, ops, name, line, fault):
    """``ops.<name>`` rebuilt from its source with ``line`` replaced by
    ``fault``, in the module's namespace."""
    src = inspect.getsource(getattr(ops, name))
    assert line in src, f"{name} no longer has {line!r}"
    space = dict(vars(ops))
    exec(src.replace(line, fault), space)
    monkeypatch.setattr(ops, name, space[name])


def _neighbours_reversed(monkeypatch, ops):
    line = "for other in list(neighbors_of(node)):"
    _planted(monkeypatch, ops, "contract_compressed", line,
             line.replace("list(neighbors_of(node))", "list(neighbors_of(node))[::-1]"))


def _conjugating_transpose(monkeypatch, ops):
    src = "M = _mm(Ra, Rb.T)"
    _planted(monkeypatch, ops, "_compress_pair_core", src, "M = _mm(Ra, Rb.mH)")


FAULTS = {
    "sound": lambda monkeypatch, ops: None,
    "compression_skipped": _skip_first_compression,
    "chi_off_by_one": _chi_off_by_one,
    "neighbours_reversed": _neighbours_reversed,
    "conjugating_transpose": _conjugating_transpose,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_fault_turns_correct_false(fault, seed, monkeypatch):
    """On a complex signed 5x5 bond-3 lattice at chi=4 (16 truncations a
    value), each fault moves the value by 7e-2 or more against the
    reference, the sound program by 2e-6 at most."""
    from cotengra_tpu_torch.ops import compressed as ops

    inputs, output, size_dict, arrays = _network([5, 5], 3, seed, cplx=True)
    plan, tree, _ = compressed_plan(inputs, output, size_dict, 4)
    ref = _reference(plan, inputs, output, size_dict, 4)
    FAULTS[fault](monkeypatch, ops)
    err = _check(_program(tree, arrays, 4, strip_exponent=True), arrays, ref)
    assert (err <= LIMIT) == (fault == "sound"), err


def test_conjugating_transpose_on_real_entries_changes_nothing(monkeypatch):
    """On real entries a conjugate is the transpose: that fault shows on
    complex entries only, and real ones read the sound value."""
    from cotengra_tpu_torch.ops import compressed as ops

    inputs, output, size_dict, arrays = _network([5, 5], 3, 1)
    plan, tree, _ = compressed_plan(inputs, output, size_dict, 4)
    sound = _program(tree, arrays, 4)
    _conjugating_transpose(monkeypatch, ops)
    assert torch.equal(_program(tree, arrays, 4), sound)


def test_options_that_differ_are_refused():
    from tnbench.reference import compressed

    inputs, output, size_dict, _ = _network([4, 4], 4, 0)
    plan, _, _ = compressed_plan(inputs, output, size_dict, 8)
    conf = {"plan": plan, "reference": {"kind": "compressed", "chi": 8},
            "options": {"chi": 8, "strip_exponent": True}}
    assert compressed.prepare(conf, inputs, output, size_dict).chi == 8
    for opts in ({"chi": 9}, {"chi": 8, "compress_late": True}, {"chi": 8, "order": "x"}, {}):
        with pytest.raises(ValueError):
            compressed.prepare(dict(conf, options=opts), inputs, output, size_dict)
    with pytest.raises(ValueError):
        compressed.CompressedPlan(dict(plan, sliced_inds=["a"]), inputs, output, size_dict, 8)
