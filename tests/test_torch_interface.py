"""The port's front end (``einsum``, ``array_contract``, ``ncon``,
expressions, presets) and basic path finders against the JAX package's,
on the CPU: the same numpy inputs through both, float64, rtol 1e-10
(stripped values: |delta log10| <= 1e-10); the same paths from the same
seeds, each package's pure-Python finders (``accel=False``) against the
other's, and their native ones (the default ``accel="auto"``, where
``g++`` builds them, and ``accel=True``) against each other. Also the
default device and the contractor cache."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import cotengra_tpu as ctg
from cotengra_tpu.utils.eqs import parse_einsum_input as ref_parse
from cotengra_tpu.utils.eqs import parse_eq_ellipses as ref_ellipses

import cotengra_tpu_torch as ctt
from cotengra_tpu_torch import interface
from cotengra_tpu_torch.ops import executor
from cotengra_tpu_torch.utils.eqs import (
    canonicalize_inputs,
    eq_to_inputs_output,
    hash_contraction,
    inputs_output_to_eq,
    parse_einsum_input,
    parse_eq_ellipses,
)

torch.set_num_threads(1)

F64_RTOL = 1e-10
LOG10_ATOL = 1e-10


@pytest.fixture(autouse=True)
def _fresh_caches():
    interface.clear_caches()
    yield
    interface.clear_caches()


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _rand(seed, n=10):
    inputs, output, shapes, size_dict = ctt.rand_equation(
        n, 3, n_out=2, n_hyper_in=1, seed=seed
    )
    rng = np.random.default_rng(seed)
    return inputs, output, size_dict, [rng.normal(size=s) for s in shapes]


# -- caches, parsing, dispatch (the cases of tests/test_interface.py) -----


def test_expression_cache_hits(monkeypatch):
    calls = {"n": 0}
    real = interface._build_expression

    def counting(*args, **kwargs):
        calls["n"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(interface, "_build_expression", counting)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 4))
    y = rng.normal(size=(4, 5))
    ctt.einsum("ab,bc->ac", x, y, optimize="greedy", device="cpu")
    assert calls["n"] == 1
    # same contraction, different labels: canonicalization -> cache hit
    got = ctt.einsum("xy,yz->xz", x, y, optimize="greedy", device="cpu")
    assert calls["n"] == 1
    assert_allclose(got.numpy(), x @ y, rtol=F64_RTOL)
    # different shapes -> miss
    ctt.einsum("ab,bc->ac", x.T.copy(), rng.normal(size=(3, 5)),
               optimize="greedy", device="cpu")
    assert calls["n"] == 2
    # other options -> another expression
    ctt.einsum("ab,bc->ac", x, y, optimize="greedy", device="cpu",
               strip_exponent=True)
    assert calls["n"] == 3


def test_path_cache(monkeypatch):
    calls = {"n": 0}
    real = interface.find_path

    def counting(*args, **kwargs):
        calls["n"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(interface, "find_path", counting)
    inputs, output, shapes, size_dict = ctt.rand_equation(8, 3, seed=0)
    p1 = ctt.array_contract_path(
        inputs, output, size_dict=size_dict, optimize="greedy"
    )
    p2 = ctt.array_contract_path(
        inputs, output, size_dict=size_dict, optimize="greedy"
    )
    assert p1 == p2
    assert calls["n"] == 1
    # the greedy preset runs the native greedy, as the reference's does
    assert p1 == ctg.optimize_greedy(inputs, output, size_dict)


@pytest.mark.parametrize(
    "eq,shapes",
    [
        ("...ab,bc->...ac", [(2, 3, 4, 5), (5, 6)]),
        ("a...b,...b", [(2, 3, 4), (3, 4)]),
        ("...,...->...", [(2, 3), (3,)]),
    ],
)
def test_parse_ellipses(eq, shapes):
    got = parse_eq_ellipses(eq, shapes)
    assert got == ref_ellipses(eq, shapes)
    lhs, rhs = got.split("->")
    assert [len(t) for t in lhs.split(",")] == [len(s) for s in shapes]


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_parse_interleaved(kind):
    make = np.zeros if kind == "numpy" else torch.zeros
    args = (make((2, 3)), ("i", "j"), make((3, 4)), ("j", "k"), ("i", "k"))
    eq, arrays = parse_einsum_input(args)
    assert eq == "ab,bc->ac"
    assert len(arrays) == 2
    ref_args = tuple(
        np.zeros(tuple(a.shape)) if i % 2 == 0 and i < 4 else a
        for i, a in enumerate(args)
    )
    assert eq == ref_parse(ref_args)[0]
    # the interleaved form contracts as the string form does
    rng = np.random.default_rng(1)
    x, y = rng.normal(size=(2, 3)), rng.normal(size=(3, 4))
    got = ctt.einsum(x, [0, 1], y, [1, 2], [0, 2], device="cpu",
                     optimize="greedy")
    assert_allclose(got.numpy(), x @ y, rtol=F64_RTOL)


def test_canonicalize_broadcast_conflict():
    with pytest.raises(ValueError):
        canonicalize_inputs([("a",), ("a",)], None, shapes=[(3,), (4,)])
    # size 1 broadcasts against the other size
    _, _, sizes, _ = canonicalize_inputs(
        [("a",), ("a",)], None, shapes=[(1,), (4,)]
    )
    assert sizes == {"a": 4}


def test_many_indices_round_trip():
    """Past 52 indices the symbols leave ASCII: the equation forms and
    the hash still round-trip (the 7x7 lattice has 84)."""
    inputs, output, shapes, size_dict = ctt.lattice_equation([7, 7], d_min=2)
    eq = inputs_output_to_eq(inputs, output)
    assert any(ord(c) > 127 for c in eq)
    assert eq_to_inputs_output(eq) == (
        tuple(map(tuple, inputs)), tuple(output)
    )
    got_eq, _ = parse_einsum_input((eq, *shapes), shapes=True)
    assert got_eq == eq
    relabel = [tuple(f"x{ix}" for ix in t) for t in inputs]
    assert hash_contraction(inputs, output, size_dict) == hash_contraction(
        relabel, output, {f"x{ix}": d for ix, d in size_dict.items()}
    )


def test_optimize_dispatch_types():
    inputs, output, size_dict, arrays = _rand(1, n=6)
    expected = np.asarray(
        ctg.array_contract(arrays, inputs, output, optimize="greedy")
    )
    kw = dict(device="cpu", cache_expression=False)
    # 1. preset string
    r1 = ctt.array_contract(arrays, inputs, output, optimize="greedy",
                            device="cpu")
    # 2. explicit path
    path = ctt.array_contract_path(
        inputs, output, size_dict=size_dict, optimize="greedy"
    )
    r2 = ctt.array_contract(arrays, inputs, output, optimize=path, **kw)
    # 3. optimizer instance
    r3 = ctt.array_contract(
        arrays, inputs, output, optimize=ctt.GreedyOptimizer(), **kw
    )
    # 4. the port's tree, used as it is
    tree = ctt.array_contract_tree(
        inputs, output, size_dict=size_dict, optimize="greedy"
    )
    assert interface.find_tree(None, None, None, tree) is tree
    r4 = ctt.array_contract(arrays, inputs, output, optimize=tree, **kw)
    for r in (r1, r2, r3, r4):
        assert_allclose(r.numpy(), expected, rtol=F64_RTOL)


def test_register_preset_custom(monkeypatch):
    # registered into copies, so that the preset leaves with the test
    monkeypatch.setattr(interface, "_PRESETS", dict(interface._PRESETS))
    monkeypatch.setattr(
        interface, "_PRESETS_TREE", dict(interface._PRESETS_TREE)
    )

    def my_opt(inputs, output, size_dict):
        return ctt.optimize_greedy(inputs, output, size_dict)

    ctt.register_preset("my-test-preset", my_opt)
    assert "my-test-preset" in ctt.list_presets()
    inputs, output, shapes, size_dict = ctt.rand_equation(6, 3, seed=2)
    tree = ctt.array_contract_tree(
        inputs, output, size_dict=size_dict, optimize="my-test-preset"
    )
    assert tree.is_complete()
    with pytest.raises(KeyError, match="valid presets"):
        ctt.array_contract_tree(
            inputs, output, size_dict=size_dict, optimize="no-such-preset"
        )


def test_reference_compat_exports():
    assert ctt.contract is ctt.einsum
    assert ctt.contract_expression is ctt.einsum_expression
    assert set(ctt.list_presets()) >= {
        "auto", "auto-hq", "dp", "edgesort", "greedy", "optimal",
        "optimal-outer", "random", "random-greedy", "random-greedy-128",
        "simplify",
    }
    inputs, output, shapes, size_dict = ctt.rand_equation(10, 3, seed=0)
    for fn in (ctt.greedy_optimize, ctt.optimal_optimize,
               ctt.optimal_outer_optimize):
        t = ctt.ContractionTree.from_path(
            inputs, output, size_dict, path=fn(inputs, output, size_dict),
        )
        assert t.is_complete()
    assert ctt.AutoHQOptimizer().optimal_cutoff == 650
    assert ctt.AutoOptimizer().optimal_cutoff == 250


def test_edge_path_converters():
    inputs = [("a", "b"), ("b", "c"), ("a", "c")]
    ssa = ctt.edge_path_to_ssa(["a", "b", "c"], inputs)
    assert ssa == ((0, 2), (1, 3))
    lin = ctt.edge_path_to_linear(["a", "b", "c"], inputs)
    tree = ctt.ContractionTree.from_path(
        inputs, (), {"a": 2, "b": 3, "c": 4}, path=lin
    )
    assert tree.is_complete()
    inputs, output, _, _ = ctt.rand_equation(9, 3, seed=4)
    order = sorted({ix for t in inputs for ix in t}, reverse=True)
    assert ctt.edge_path_to_ssa(order, inputs) == ctg.edge_path_to_ssa(
        order, inputs
    )
    assert ctt.edge_path_to_linear(order, inputs) == (
        ctg.edge_path_to_linear(order, inputs)
    )


# -- the same values as the JAX package ------------------------------------


@pytest.mark.parametrize("entry", ["einsum", "array_contract", "ncon"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_front_end_matches_reference(entry, seed):
    """The default ``optimize="auto"`` in the port (the hyper-optimizer
    at this hardness) against the JAX package's greedy plan: the value
    does not depend on the path."""
    inputs, output, _, arrays = _rand(seed)
    eq = inputs_output_to_eq(inputs, output)
    expected = np.asarray(ctg.einsum(eq, *arrays, optimize="greedy"))
    if entry == "einsum":
        got = ctt.einsum(eq, *arrays, device="cpu")
    elif entry == "array_contract":
        got = ctt.array_contract(arrays, inputs, output, device="cpu")
    else:
        # contracted indices positive, output -1, -2, ... in order
        ids = {ix: i + 1 for i, ix in enumerate(
            sorted({ix for t in inputs for ix in t}))}
        ids.update({ix: -(k + 1) for k, ix in enumerate(output)})
        got = ctt.ncon(arrays, [[ids[ix] for ix in t] for t in inputs],
                       device="cpu")
    assert got.dtype == torch.float64
    assert tuple(got.shape) == expected.shape
    assert_allclose(got.numpy(), expected, rtol=F64_RTOL)


def test_plane_dtype_follows_the_inputs():
    inputs, output, _, arrays = _rand(0, n=6)
    eq = inputs_output_to_eq(inputs, output)
    f32 = [a.astype(np.float32) for a in arrays]
    assert ctt.einsum(eq, *f32, device="cpu").dtype == torch.float32
    c64 = [a.astype(np.complex64) for a in arrays]
    assert ctt.einsum(eq, *c64, device="cpu").dtype == torch.complex64
    c128 = [torch.from_numpy(a.astype(np.complex128)) for a in arrays]
    assert ctt.einsum(eq, *c128, device="cpu").dtype == torch.complex128
    # an explicit plane dtype wins
    got = ctt.einsum(eq, *arrays, device="cpu", plane_dtype=torch.float32)
    assert got.dtype == torch.float32


def _finder_paths(finder, seed, inputs, output, size_dict):
    # pure Python in both packages (test_torch_native.py compares the
    # native finders)
    if finder == "greedy":
        kw = dict(use_ssa=True, accel=False)
        return (
            ctt.optimize_greedy(inputs, output, size_dict, **kw),
            ctg.optimize_greedy(inputs, output, size_dict, **kw),
        )
    if finder == "greedy-noisy":
        kw = dict(temperature=0.3, costmod=1.5, seed=seed, use_ssa=True,
                  accel=False)
        return (
            ctt.optimize_greedy(inputs, output, size_dict, **kw),
            ctg.optimize_greedy(inputs, output, size_dict, **kw),
        )
    if finder == "optimal":
        kw = dict(minimize="combo", use_ssa=True, accel=False)
        return (
            ctt.optimize_optimal(inputs, output, size_dict, **kw),
            ctg.optimize_optimal(inputs, output, size_dict, **kw),
        )
    if finder == "random-greedy":
        kw = dict(ntrials=6, seed=seed, use_ssa=True, accel=False)
        return (
            ctt.optimize_random_greedy_track_flops(
                inputs, output, size_dict, **kw),
            ctg.optimize_random_greedy_track_flops(
                inputs, output, size_dict, **kw),
        )
    if finder == "simplify":
        return (
            ctt.optimize_simplify(inputs, output, size_dict),
            ctg.optimize_simplify(inputs, output, size_dict),
        )
    if finder == "edgesort":
        return (
            ctt.optimize_edgesort(inputs, output, size_dict),
            ctg.optimize_edgesort(inputs, output, size_dict),
        )
    return (
        ctt.optimize_random(inputs, output, size_dict, seed=seed),
        ctg.optimize_random(inputs, output, size_dict, seed=seed),
    )


@pytest.mark.parametrize(
    "finder",
    ["greedy", "greedy-noisy", "optimal", "random-greedy", "simplify",
     "edgesort", "random"],
)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paths_match_reference(finder, seed):
    inputs, output, shapes, size_dict = ctt.rand_equation(
        9, 3, n_out=2, n_hyper_in=1, seed=seed
    )
    got, ref = _finder_paths(finder, seed, inputs, output, size_dict)
    assert got == ref


def test_optimizers_match_reference():
    inputs, output, _, size_dict = ctt.rand_equation(12, 3, seed=5)
    rg = dict(max_repeats=6, seed=11, accel=False)
    assert ctt.RandomGreedyOptimizer(**rg).ssa_path(
        inputs, output, size_dict
    ) == ctg.RandomGreedyOptimizer(**rg).ssa_path(inputs, output, size_dict)
    # batches on an executor: one batch per worker, seeds drawn alike
    with ThreadPoolExecutor(2) as pool:
        got = ctt.RandomGreedyOptimizer(parallel=pool, **rg)
        ref = ctg.RandomGreedyOptimizer(parallel=pool, **rg)
        assert got.ssa_path(inputs, output, size_dict) == ref.ssa_path(
            inputs, output, size_dict
        )
        assert got.best_flops == ref.best_flops
    small = ctt.rand_equation(6, 3, seed=5)
    for accel in (False, "auto", True):
        assert ctt.OptimalOptimizer(
            search_outer=True, accel=accel
        ).ssa_path(*small[:2], small[3]) == ctg.OptimalOptimizer(
            search_outer=True, accel=accel
        ).ssa_path(*small[:2], small[3])
    # the auto preset's small branch is the reference's (native) optimal DP
    tree = ctt.auto_optimize.search(*small[:2], small[3])
    assert tree.get_ssa_path() == ctg.ContractionTree.from_path(
        *small[:2], small[3], ssa_path=ctg.optimize_optimal(
            *small[:2], small[3], minimize="combo", use_ssa=True,
        ),
    ).get_ssa_path()
    # accel=True: the native greedy, the reference's path
    assert ctt.optimize_greedy(
        inputs, output, size_dict, accel=True
    ) == ctg.optimize_greedy(inputs, output, size_dict, accel=True)
    # named pools (parallel/pools.py): one batch per worker, as the
    # reference's
    got = ctt.RandomGreedyOptimizer(parallel="threads:2", **rg)
    ref = ctg.RandomGreedyOptimizer(parallel="threads:2", **rg)
    assert got.ssa_path(inputs, output, size_dict) == ref.ssa_path(
        inputs, output, size_dict
    )
    assert got.best_flops == ref.best_flops


@pytest.mark.parametrize("form", ["array_contract", "einsum"])
def test_expression_constants_match_reference(form):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 5))
    y = rng.normal(size=(5, 6))
    z = rng.normal(size=(6, 3))
    if form == "array_contract":
        kw = dict(
            inputs=[("a", "b"), ("b", "c"), ("c", "d")], output=("a", "d"),
            shapes=[(4, 5), (5, 6), (6, 3)], constants={1: y, 2: z},
            optimize="greedy",
        )
        ref = ctg.array_contract_expression(**kw)
        expr = ctt.array_contract_expression(device="cpu", **kw)
    else:
        ref = ctg.einsum_expression(
            "ab,bc,cd->ad", (4, 5), y, z, constants=[1, 2],
            optimize="greedy",
        )
        expr = ctt.einsum_expression(
            "ab,bc,cd->ad", (4, 5), y, z, constants=[1, 2],
            optimize="greedy", device="cpu",
        )
    for xx in (x, rng.normal(size=(4, 5))):
        got = expr(xx)
        assert got.dtype == torch.float64
        assert_allclose(got.numpy(), np.asarray(ref(xx)), rtol=F64_RTOL)
    # the constants were placed once for this device and dtype
    assert list(expr._placed) == [(torch.device("cpu"), torch.float64)]
    with pytest.raises(ValueError, match="variable arrays"):
        expr(x, y)


def test_via_and_expression_reuse(monkeypatch):
    inputs, output, size_dict, arrays = _rand(2, n=6)
    eq = inputs_output_to_eq(inputs, output)
    expected = np.asarray(ctg.einsum(eq, *arrays, optimize="greedy"))
    expr = ctt.einsum_expression(
        eq, *(a.shape for a in arrays), optimize="greedy", device="cpu"
    )
    builds = []
    real = executor.make_full_contractor
    monkeypatch.setattr(
        executor, "make_full_contractor",
        lambda *a, **k: builds.append(1) or real(*a, **k),
    )
    via = ctt.Via(expr, device="cpu", dtype=torch.float64,
                  extractor=lambda t: t.numpy())
    for _ in range(3):
        assert_allclose(via(*arrays), expected, rtol=F64_RTOL)
    assert len(builds) == 1  # planned once, reused by every call
    lists = [a.tolist() for a in arrays]  # anything torch.as_tensor takes
    assert_allclose(via(*lists), expected, rtol=F64_RTOL)


@pytest.mark.parametrize("d", [4, 16])
def test_stripped_lattice_through_einsum(d, monkeypatch):
    """The 4x4 lattice stripped through ``einsum(...,
    implementation="pallas")``: the steps that qualify (none at bond 4,
    some at bond 16) take ``bmm_absmax``'s plain version on the CPU; the
    value against the reference's ``implementation=None`` stripped
    one."""
    inputs, output, shapes, size_dict = ctt.lattice_equation([4, 4],
                                                             d_min=d)
    rng = np.random.default_rng(7)
    arrays = [rng.uniform(size=s) for s in shapes]
    eq = inputs_output_to_eq(inputs, output)
    m_ref, e_ref = ctg.einsum(eq, *arrays, optimize="greedy",
                              strip_exponent=True)
    log10_ref = np.log10(abs(float(m_ref))) + float(e_ref)

    calls = []
    real = executor.pairwise_bmm_absmax
    monkeypatch.setattr(
        executor, "pairwise_bmm_absmax",
        lambda *a: calls.append(1) or real(*a),
    )
    res = ctt.einsum(eq, *arrays, device="cpu", strip_exponent=True,
                     implementation="pallas")
    assert isinstance(res, tuple)  # (mantissa, exponent), not unwrapped
    m, e = res
    assert m.dtype == e.dtype == torch.float64
    log10 = np.log10(abs(float(m))) + float(e)
    assert abs(log10 - log10_ref) <= LOG10_ATOL
    assert (len(calls) > 0) == (d == 16)


def test_circuit_through_array_contract_grouped():
    """A small circuit amplitude through ``array_contract`` on the
    grouped split-complex route, with the reference tree's path."""
    inputs, output, _, _, arrays = ctt.rand_circuit_tn(12, 4, seed=3)
    inputs, arrays = ctt.absorb_simple_tensors(inputs, arrays, output)
    arrays = [np.asarray(a, np.complex128) for a in arrays]
    size_dict = {
        ix: int(d) for t, a in zip(inputs, arrays) for ix, d in zip(t, a.shape)
    }
    ref_tree = ctg.array_contract_tree(
        inputs, output, size_dict=size_dict, optimize="greedy"
    )
    expected = complex(np.asarray(ref_tree.contract(arrays)))
    got = ctt.array_contract(
        arrays, inputs, output, optimize=ref_tree.get_path(),
        implementation="grouped", device="cpu",
    )
    assert got.dtype == torch.complex128
    assert abs(complex(got) - expected) <= F64_RTOL * abs(expected)


# -- the default device and the contractor cache ---------------------------


def test_default_device_is_the_card(no_card):
    """Without ``device=`` everything runs on the card, which raises
    where there is none: never a CPU result."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.resolve_device()
    x = np.ones((2, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.einsum("ab,bc->ac", x, x.T, optimize="greedy")
    tree = ctt.einsum_tree("ab,bc->ac", x, x.T, optimize="greedy")
    for call in (
        lambda: ctt.contract_tree(tree, [x, x.T]),
        lambda: tree.contract([x, x.T]),
        lambda: ctt.make_full_contractor(tree),
        lambda: ctt.to_tensors([x]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_contract_tree_builds_one_contractor_per_options(monkeypatch):
    inputs, output, size_dict, arrays = _rand(3, n=8)
    tree = ctt.array_contract_tree(
        inputs, output, size_dict=size_dict, optimize="greedy"
    )
    builds = []
    real = executor.make_full_contractor
    monkeypatch.setattr(
        executor, "make_full_contractor",
        lambda t, dev, **k: builds.append((dev, k)) or real(t, dev, **k),
    )
    first = ctt.contract_tree(tree, arrays, device="cpu",
                              plane_dtype=torch.float64)
    again = tree.contract(arrays, device="cpu", plane_dtype=torch.float64)
    assert len(builds) == 1
    assert_allclose(again.numpy(), first.numpy(), rtol=0)
    ctt.contract_tree(tree, arrays, device="cpu")  # float32
    ctt.contract_tree(tree, arrays, device="cpu", plane_dtype=torch.float64,
                      strip_exponent=True)
    ctt.contract_tree(tree, arrays, device="cpu", plane_dtype=torch.float64,
                      implementation="grouped")
    assert len(builds) == 4
    # slicing changes the tree: its contractors are dropped
    tree.remove_ind_(inputs[0][0])
    sliced = ctt.contract_tree(tree, arrays, device="cpu",
                               plane_dtype=torch.float64)
    assert len(builds) == 5
    assert_allclose(sliced.numpy(), first.numpy(), rtol=F64_RTOL)
    # the core contractor is cached too
    core = tree.get_contractor("cpu", plane_dtype=torch.float64)
    assert tree.get_contractor(torch.device("cpu"),
                               plane_dtype=torch.float64) is core


def test_contractor_cache_tells_devices_apart(monkeypatch):
    """A contractor built for the CPU is never handed to a CUDA call
    (traced with the device check and the build stubbed out)."""
    monkeypatch.setattr(executor, "resolve_device", torch.device)
    monkeypatch.setattr(
        executor, "make_full_contractor", lambda *a, **k: object()
    )
    tree = ctt.ContractionTree.from_path(
        [("a", "b"), ("b", "c")], ("a", "c"), dict.fromkeys("abc", 2),
        path=[(0, 1)],
    )
    cpu = executor._cached_full(tree, "cpu")
    cuda = executor._cached_full(tree, "cuda")
    assert cpu is not executor._cached_full(tree, "cuda")
    assert cuda is executor._cached_full(tree, "cuda")
    assert cpu is executor._cached_full(tree, torch.device("cpu"))
    assert executor._cached_full(tree, "cpu", plane_dtype=torch.float64) \
        is not cpu
