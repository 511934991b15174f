"""Mixed real and complex inputs on every route of the port: each pair
step promotes its operands to their common dtype, as the JAX package's
``dot_general`` does, so a real input meets a complex one as complex.

Each route is held to the JAX package on the same numpy inputs and the
same tree: float64 at rtol 1e-10, float32 planes at 1e-5. The routes:
``contract_tree`` (plain, stripped, batched, ``implementation="pallas"``
and ``"grouped"``) on sliced and unsliced trees, the front end
(``einsum``, ``array_contract``, ``ncon``, expressions with real and
complex constants), ``contract_compressed`` and ``contract_sharded``
over 2 gloo ranks. A real x complex step never reaches the fused
kernel, whose operands are real float32."""

import io
import json

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import cotengra_tpu as ctg
from cotengra_tpu.tree_compressed import (
    ContractionTreeCompressed as RefTreeCompressed,
)

import cotengra_tpu_torch as ctt
from cotengra_tpu_torch.ops import executor
from cotengra_tpu_torch.ops.lowering import PairStep

torch.set_num_threads(1)

COMPLEX = (0, 3)  # inputs made complex; the rest stay real


def _mixed(shapes, seed, complex_at=COMPLEX):
    rng = np.random.default_rng(seed)
    out = []
    for i, s in enumerate(shapes):
        a = rng.normal(size=s)
        if i in complex_at:
            a = a + 1j * rng.normal(size=s)
        out.append(a)
    return out


def _instance(seed, sliced):
    """A 14-tensor contraction with one output index planned by the
    reference (sliced 4 ways or not), the port's copy of its tree, and
    mixed inputs."""
    inputs, output, shapes, size_dict = ctg.rand_equation(
        14, 3, n_out=1, seed=seed
    )
    ref = ctg.array_contract_tree(
        inputs, output, size_dict=size_dict, optimize="greedy"
    )
    if sliced:
        ref.slice_(target_slices=4)
    buf = io.StringIO()
    ctg.save_tree(buf, ref)
    buf.seek(0)
    tree = ctt.load_tree(buf, ref.inputs, ref.output, ref.size_dict)
    return ref, tree, _mixed(shapes, seed)


def _value(res):
    if isinstance(res, tuple):
        m, e = (np.asarray(r) for r in res)
        return m * 10.0 ** e.astype(np.float64)
    return np.asarray(res)


def test_einsum_mixed_equals_numpy():
    """The reproduction: a complex matrix against two real ones."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(3, 4)) + 1j * rng.normal(size=(3, 4))
    b, c = rng.normal(size=(4, 5)), rng.normal(size=(5, 3))
    exp = np.einsum("ij,jk,ki->", A, b, c)
    for optimize in ("greedy", "auto"):
        got = ctt.einsum("ij,jk,ki->", A, b, c, optimize=optimize,
                         device="cpu")
        assert got.dtype == torch.complex128
        assert_allclose(got.numpy(), exp, rtol=1e-10)


ROUTES = [
    {},
    {"strip_exponent": True},
    {"slice_batch": 2},
    {"strip_exponent": True, "slice_batch": 2},
    {"strip_exponent": True, "implementation": "pallas"},
    {"implementation": "grouped"},
    {"implementation": "grouped", "strip_exponent": True},
]


def _ids(o):
    return "-".join(f"{k}={v}" for k, v in o.items()) or "plain"


@pytest.mark.parametrize("plane", ["float64", "float32"])
@pytest.mark.parametrize("sliced", [True, False], ids=["sliced", "unsliced"])
@pytest.mark.parametrize("opts", ROUTES, ids=_ids)
def test_contract_tree_mixed_matches_reference(opts, sliced, plane):
    rtree, tree, arrays = _instance(0, sliced)
    assert bool(tree.sliced_inds) == sliced
    # "pallas" is held to the reference's implementation=None stripped
    # path, as its kernel steps are real only
    ropts = {k: v for k, v in opts.items() if k != "implementation"}
    if opts.get("implementation") == "grouped":
        ropts["implementation"] = "grouped"
    exp = _value(rtree.contract(arrays, **ropts))
    got = ctt.contract_tree(tree, arrays, device="cpu",
                            plane_dtype=getattr(torch, plane), **opts)
    assert isinstance(got, tuple) == bool(opts.get("strip_exponent"))
    m = got[0] if isinstance(got, tuple) else got
    assert m.is_complex()
    rtol = 1e-10 if plane == "float64" else 1e-5
    assert_allclose(_value(got), exp, rtol=rtol, atol=0)


def test_stripped_mantissa_is_complex_and_exponent_real():
    _, tree, arrays = _instance(2, False)  # one slice: |mantissa| <= 1
    for plane in (torch.float32, torch.float64):
        m, e = ctt.contract_tree(tree, arrays, device="cpu",
                                 plane_dtype=plane, strip_exponent=True)
        assert m.dtype == plane.to_complex()
        assert e.dtype == plane and not e.is_complex()
        assert float(m.abs().max()) <= 1.0 + 1e-6


@pytest.mark.parametrize("seed", range(3))
def test_front_end_mixed_matches_reference(seed):
    inputs, output, shapes, _ = ctg.rand_equation(10, 3, n_out=2, seed=seed)
    arrays = _mixed(shapes, seed, complex_at=(seed,))
    eq = ctg.utils.inds_to_eq(inputs, output)
    exp = np.einsum(eq, *arrays, optimize=True)
    ref = np.asarray(ctg.einsum(eq, *arrays, optimize="greedy"))
    assert_allclose(ref, exp, rtol=1e-10)
    got = ctt.einsum(eq, *arrays, optimize="greedy", device="cpu")
    assert_allclose(got.numpy(), ref, rtol=1e-10)
    got = ctt.array_contract(arrays, inputs, output, optimize="greedy",
                             device="cpu")
    assert_allclose(got.numpy(), ref, rtol=1e-10)
    # the same contraction in ncon's labels: outputs -1, -2, ...
    labels = {ix: -1 - output.index(ix) for ix in output}
    for term in inputs:
        for ix in term:
            labels.setdefault(ix, len(labels) + 1)
    indices = [[labels[ix] for ix in term] for term in inputs]
    got = ctt.ncon(arrays, indices, optimize="greedy", device="cpu")
    assert_allclose(got.numpy(), ref, rtol=1e-10)


@pytest.mark.parametrize("const_complex", [False, True],
                         ids=["real_consts", "complex_consts"])
@pytest.mark.parametrize("opts", [
    {}, {"strip_exponent": True}, {"implementation": "grouped"},
    {"slice_batch": 2},
], ids=_ids)
def test_expression_with_constants_mixed(opts, const_complex):
    """Constants of one kind, variable inputs of the other: the folded
    steps hold the constants' dtype and meet the variables promoted."""
    rtree, tree, _ = _instance(2, True)
    shapes = [tuple(tree.size_dict[ix] for ix in term)
              for term in tree.inputs]
    variables = (0, 1)
    arrays = _mixed(shapes, 5, complex_at=(
        [i for i in range(tree.N) if i not in variables] if const_complex
        else variables
    ))
    consts = {i: a for i, a in enumerate(arrays) if i not in variables}
    var = [arrays[i] for i in variables]
    ref = ctg.interface.Expression(rtree, constants=consts, **opts)
    expr = ctt.interface.Expression(tree, constants=consts, device="cpu",
                                    **opts)
    plain = ctt.interface.Expression(tree, device="cpu", **opts)
    exp = _value(ref(*var))
    for _ in range(2):  # the first call folds, the second reuses
        got = expr(*var)
        assert_allclose(_value(got), exp, rtol=1e-10, atol=0)
    assert_allclose(_value(plain(*arrays)), exp, rtol=1e-10, atol=0)


def test_einsum_expression_mixed_constants_positions():
    inputs, output, shapes, _ = ctg.rand_equation(8, 3, n_out=1, seed=4)
    arrays = _mixed(shapes, 4, complex_at=(1,))
    eq = ctg.utils.inds_to_eq(inputs, output)
    args = [arrays[i] if i in (0, 1) else shapes[i]
            for i in range(len(arrays))]
    ref = ctg.einsum_expression(eq, *args, constants=[0, 1],
                                optimize="greedy")
    expr = ctt.einsum_expression(eq, *args, constants=[0, 1],
                                 optimize="greedy", device="cpu")
    exp = np.asarray(ref(*arrays[2:]))
    assert_allclose(expr(*arrays[2:]).numpy(), exp, rtol=1e-10)
    expr = ctt.einsum_expression(eq, *shapes, optimize="greedy",
                                 device="cpu")
    assert_allclose(expr(*arrays).numpy(), exp, rtol=1e-10)


def test_contract_compressed_mixed_matches_reference():
    inputs, output, shapes, size_dict = ctg.lattice_equation(
        [4, 4], d_min=3
    )
    rng = np.random.default_rng(0)
    arrays = [rng.uniform(size=s) for s in shapes]
    arrays[5] = arrays[5] * np.exp(1j * np.pi / 3) + 0.1j * rng.uniform(
        size=shapes[5]
    )
    path = ctg.array_contract_path(
        inputs, output, size_dict=size_dict, optimize="greedy-compressed"
    )
    rtree = RefTreeCompressed.from_path(inputs, output, size_dict,
                                        path=path)
    tree = ctt.ContractionTreeCompressed.from_path(
        inputs, output, size_dict, path=path
    )
    exp = _value(rtree.contract_compressed(arrays, chi=4))
    for strip in (False, True):
        got = tree.contract_compressed(arrays, chi=4, strip_exponent=strip,
                                       device="cpu")
        m = got[0] if strip else got
        assert m.dtype == torch.complex128
        # the stripped value against the reference's unstripped one: its
        # stripped exponent is a float32 sum, the port's a float64 one
        assert_allclose(_value(got), exp, rtol=1e-10, atol=0)
    rm, _ = rtree.contract_compressed(arrays, chi=4, strip_exponent=True)
    assert_allclose(m.numpy(), np.asarray(rm), rtol=1e-10, atol=0)


def test_compressed_pair_core_promotes():
    """A real factor compressed against a complex one (the QR of each in
    its own dtype, the products promoted), as the reference's."""
    from cotengra_tpu.ops.compressed import _compress_pair_core as ref_core
    from cotengra_tpu_torch.ops.compressed import _compress_pair_core

    rng = np.random.default_rng(1)
    A = rng.normal(size=(6, 8))
    B = rng.normal(size=(5, 8)) + 1j * rng.normal(size=(5, 8))
    ra, rb = ref_core(A, B, 3)
    ga, gb = _compress_pair_core(torch.from_numpy(A), torch.from_numpy(B), 3)
    # columns agree up to the SVD's phase per singular vector
    assert_allclose(ga.numpy() @ gb.numpy().T, np.asarray(ra) @
                    np.asarray(rb).T, rtol=1e-10, atol=1e-12)


def test_pallas_refuses_a_complex_operand_on_either_side():
    step = PairStep(l=0, r=1, out=2, l_legs=("a", "b", "c"),
                    r_legs=("c", "d"), out_legs=("a", "b", "d"))
    real = torch.zeros(32, 32, 32)
    real_y = torch.zeros(32, 512)
    cplx = real.to(torch.complex64)
    cplx_y = real_y.to(torch.complex64)
    assert executor._pallas_step_ok(real, real_y, step)
    assert not executor._pallas_step_ok(real, cplx_y, step)
    assert not executor._pallas_step_ok(cplx, real_y, step)
    assert not executor._pallas_step_ok(cplx, cplx_y, step)


def test_pallas_route_sends_only_real_steps_to_the_kernel(monkeypatch):
    """A stripped ``"pallas"`` run on mixed inputs: the kernel's wrapper
    sees real operands only, and the real x real steps still reach it."""
    from cotengra_tpu_torch.ops import bmm_absmax

    seen = []
    real_fn = bmm_absmax.bmm_absmax

    def spy(x, y):
        seen.append((x.dtype, y.dtype))
        return real_fn(x, y)

    monkeypatch.setattr(bmm_absmax, "bmm_absmax", spy)
    inputs, output, shapes, size_dict = ctg.lattice_equation(
        [3, 3], d_min=12
    )
    rng = np.random.default_rng(3)
    arrays = [rng.uniform(size=s) for s in shapes]
    arrays[0] = arrays[0] * np.exp(1j * np.pi / 3)
    tree = ctt.array_contract_tree(inputs, output, size_dict=size_dict,
                                   optimize="greedy")
    m, e = ctt.contract_tree(tree, arrays, device="cpu",
                             plane_dtype=torch.float64,
                             strip_exponent=True, implementation="pallas")
    exp = np.einsum(ctg.utils.inds_to_eq(inputs, output), *arrays,
                    optimize=True)
    assert_allclose(complex(m) * 10 ** float(e), exp, rtol=1e-10)
    assert seen and all(not a.is_complex and not b.is_complex
                        for a, b in seen)


def test_mesh_mixed_matches_reference(tmp_path):
    """``contract_sharded`` over 2 gloo ranks, launched as
    ``tests/test_torch_mesh.py`` launches them, against the JAX
    package's on a mesh of 2 virtual devices."""
    from cotengra_tpu.parallel.mesh import get_default_mesh
    from test_torch_mesh import _launch, _reference, _write_case

    names = []
    for k, strip in enumerate((False, True)):
        rtree, _, arrays = _instance(k, True)
        for plane in ("float64", "float32"):
            name = f"mixed{k}_{plane}"
            names.append((name, rtree, arrays, strip, plane))
            _write_case(tmp_path, name, rtree, arrays, strip, True, plane,
                        True)
    (tmp_path / "cases.json").write_text(json.dumps([n[0] for n in names]))
    _launch(tmp_path, ["main", str(tmp_path), "2"],
            [{"RANK": str(r)} for r in range(2)])
    mesh = get_default_mesh(2)
    for name, rtree, arrays, strip, plane in names:
        exp = _value(_reference(rtree, arrays, strip, True, mesh))
        rtol = 1e-10 if plane == "float64" else 1e-5
        for r in range(2):
            with np.load(tmp_path / f"{name}.rank{r}.npz") as data:
                got = (data["m"], data["e"]) if strip else data["x"]
            assert np.iscomplexobj(got[0] if strip else got)
            assert_allclose(_value(got), exp, rtol=rtol, atol=0)
