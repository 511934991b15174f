"""The public methods of the port's ``ContractionTree``, ``HyperGraph``
and ``HyperOptimizer`` and the helper functions that go with them,
against the JAX package's on the CPU: on the committed m10-t27, m10-t29,
m20-t28 and 7x7 lattice plans and on seeded ``rand_equation`` trees,
values equal exactly (costs, navigation, orders, paths, equations, the
lowered steps) and reports equal as strings (``describe``,
``print_contractions``, ``str``); the hypergraph's Laplacian and
resistance measures at the reference's tolerance; the pairwise
``einsum`` and ``tensordot``; and the steps of the JAX package's example
``examples/ex_plan_slice_contract.py`` through both packages."""

import contextlib
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import cotengra_tpu as ctg
from cotengra_tpu.hypergraph import HyperGraph as RefHyperGraph
from cotengra_tpu.ops.lowering import effective_input_legs as ref_eff_legs
from cotengra_tpu.parallel import pools as ref_pools
from cotengra_tpu.utils.io import load_tree as ref_load_tree
from cotengra_tpu.utils.misc import interleave as ref_interleave
from cotengra_tpu.utils.misc import unique as ref_unique

import cotengra_tpu_torch as ctt
from cotengra_tpu_torch.hypergraph import HyperGraph
from cotengra_tpu_torch.ops import pairwise_einsum, tensordot
from cotengra_tpu_torch.ops.lowering import effective_input_legs
from cotengra_tpu_torch.parallel import pools
from cotengra_tpu_torch.tree import node_from_single
from cotengra_tpu_torch.utils.misc import interleave, unique

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PLANS = [
    "sycamore53_m10_t27",
    "sycamore53_m10_t29",
    "sycamore53_m20_t28",
    "lattice7x7_d16_s16",
]
_TREES = {}


def _absorbed(m):
    inputs, output, _, _, arrays = ctt.rand_circuit_tn(53, m, seed=42)
    inputs, arrays = ctt.absorb_simple_tensors(
        inputs, arrays, output, max_rank=2, max_absorb_size=2**12
    )
    size_dict = {
        ix: int(d) for t, a in zip(inputs, arrays) for ix, d in zip(t, a.shape)
    }
    return inputs, output, size_dict


def _plan_trees(plan):
    """(port tree, reference tree) loaded from the same plan file."""
    if plan not in _TREES:
        if plan.startswith("lattice"):
            with open(ROOT / "plans" / f"{plan}.json") as f:
                inst = json.load(f)["reference"]["instance"]
            inputs, output, _, size_dict = ctt.lattice_equation(
                inst["dims"], d_min=inst["d_min"]
            )
        else:
            inputs, output, size_dict = _absorbed(
                int(plan.split("_m")[1].split("_")[0])
            )
        path = str(ROOT / "plans" / f"{plan}.json")
        _TREES[plan] = (
            ctt.load_tree(path, inputs, output, size_dict),
            ref_load_tree(path, inputs, output, size_dict),
        )
    return _TREES[plan]


def _rand_trees(seed, sliced, n=16):
    """Both packages' trees from the reference's greedy path of a seeded
    ``rand_equation``, sliced alike or not."""
    inputs, output, _, size_dict = ctg.rand_equation(
        n, 3, n_out=2, n_hyper_in=1, d_min=2, d_max=4, seed=seed
    )
    ssa = ctg.optimize_greedy(inputs, output, size_dict, use_ssa=True)
    ref = ctg.ContractionTree.from_path(inputs, output, size_dict,
                                        ssa_path=ssa)
    tree = ctt.ContractionTree.from_path(inputs, output, size_dict,
                                         ssa_path=ssa)
    assert list(tree.children.items()) == list(ref.children.items())
    if sliced:
        ref.slice_(target_slices=4, allow_outer=False)
        for ix in ref.sliced_inds:
            tree.remove_ind_(ix)
    return tree, ref


CASES = [*PLANS, "rand0", "rand1-sliced", "rand2-sliced"]


def _trees(case):
    if case.startswith("rand"):
        return _rand_trees(int(case[4]), case.endswith("sliced"))
    return _plan_trees(case)


def _printed(fn, *args, **kwargs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kwargs)
    return buf.getvalue()


@pytest.mark.parametrize("case", CASES)
def test_costs_match_the_reference(case):
    tree, ref = _trees(case)
    for name in ("max_contraction_size", "contraction_cost", "naive_cost",
                 "speedup"):
        for log in (None, 2, 10):
            assert getattr(tree, name)(log=log) == getattr(ref, name)(
                log=log
            ), (name, log)
    for name in ("contraction_scaling", "arithmetic_intensity"):
        assert getattr(tree, name)() == getattr(ref, name)(), name


@pytest.mark.parametrize("case", CASES)
def test_reports_match_the_reference(case):
    tree, ref = _trees(case)
    for info in ("normal", "full", "concise"):
        for join in (" ", ", "):
            assert tree.describe(info, join=join) == ref.describe(
                info, join=join
            )
    with pytest.raises(ValueError):
        tree.describe("nope")
    assert str(tree) == str(ref)
    for sort in (None, "flops"):
        got = _printed(tree.print_contractions, sort=sort)
        assert got == _printed(ref.print_contractions, sort=sort)
        assert got.count("\n") == len(tree.children)


@pytest.mark.parametrize("case", CASES)
def test_exports_match_the_reference(case):
    tree, ref = _trees(case)
    assert tree.get_eq() == ref.get_eq()
    assert tree.path() == ref.path() == tree.get_path()
    assert tree.ssa_path() == ref.ssa_path() == tree.get_ssa_path()
    assert ctt.ContractionTree.path is ctt.ContractionTree.get_path
    assert ctt.ContractionTree.ssa_path is ctt.ContractionTree.get_ssa_path


@pytest.mark.parametrize("case", CASES)
def test_navigation_matches_the_reference(case):
    tree, ref = _trees(case)
    nodes = [*tree.children, *tree.gen_leaves()]
    for node in nodes:
        assert tree.is_leaf(node) == ref.is_leaf(node)
        assert tree.node_extent(node) == ref.node_extent(node)
        assert tree.get_leaves(node) == ref.get_leaves(node)
    for i in range(tree.N):
        assert tree.input_to_node(i) == ref.input_to_node(i)
        assert node_from_single(i) == tree.input_to_node(i)
    for mode in ("dfs", "bfs"):
        assert list(tree.descend(mode)) == list(ref.descend(mode))
    assert [p for p, _, _ in tree.descend()][0] == tree.root
    assert sorted(p for p, _, _ in tree.descend()) == sorted(tree.children)


@pytest.mark.parametrize("case", ["lattice7x7_d16_s16", "rand0",
                                  "rand1-sliced"])
def test_centrality_matches_the_reference(case):
    tree, ref = _trees(case)
    nodes = [tree.root, *list(tree.children)[:3], tree.input_to_node(0)]
    for node in nodes:
        assert tree.get_centrality(node) == ref.get_centrality(node)


@pytest.mark.parametrize("case", CASES)
def test_peak_optimized_order_matches_the_reference(case):
    tree, ref = _trees(case)
    got, exp = tree.peak_optimized_order(), ref.peak_optimized_order()
    assert (got is None) == (exp is None)
    if got is not None:
        assert list(tree.traverse(got)) == list(ref.traverse(exp))
        assert tree.peak_size(order=got) < tree.peak_size()
        assert tree.get_ssa_path(got) == ref.get_ssa_path(exp)


def test_peak_optimized_order_beats_a_deep_default():
    """A tree where depth first wins: the order exists and lowers the
    peak, in both packages alike."""
    for seed in range(12):
        tree, ref = _rand_trees(seed, False, n=30)
        order = tree.peak_optimized_order()
        if order is not None:
            assert ref.peak_optimized_order() is not None
            assert tree.peak_size(order=order) == ref.peak_size(
                order=ref.peak_optimized_order()
            )
            return
    pytest.fail("no seed where the depth-first order beats the default")


@pytest.mark.parametrize("case", CASES)
def test_extract_contractions_matches_the_reference(case):
    tree, ref = _trees(case)
    got, exp = tree.extract_contractions(), ref.extract_contractions()
    assert [tuple(s) for s in got.steps] == [tuple(s) for s in exp.steps]
    assert got.final_id == exp.final_id and got.last_use == exp.last_use
    for i in range(tree.N):
        assert effective_input_legs(tree, i) == ref_eff_legs(ref, i)


@pytest.mark.parametrize("case", ["rand1-sliced", "rand2-sliced"])
def test_slice_and_gather_wrappers(case):
    tree, ref = _trees(case)
    rng = np.random.default_rng(3)
    arrays = [rng.normal(size=s) for s in tree.get_shapes()]
    n = tree.multiplicity
    assert n > 1
    for i in range(n):
        for a, b in zip(tree.slice_arrays(arrays, i),
                        ref.slice_arrays(arrays, i)):
            assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=0)
    slices = [
        tree.contract_core(tree.slice_arrays(arrays, i), device="cpu",
                           plane_dtype=torch.float64)
        for i in range(n)
    ]
    got = tree.gather_slices(slices)
    exp = ref.gather_slices([
        ref.contract_core(ref.slice_arrays(arrays, i)) for i in range(n)
    ])
    assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-10)
    stripped = [
        tree.contract_core(tree.slice_arrays(arrays, i), device="cpu",
                           plane_dtype=torch.float64, strip_exponent=True)
        for i in range(n)
    ]
    m, e = tree.gather_slices(stripped, strip_exponent=True)
    assert_allclose(m.numpy() * 10.0 ** e.numpy(), np.asarray(exp),
                    rtol=1e-10)


def test_benchmark_wrapper():
    tree, ref = _rand_trees(1, True)
    got = tree.benchmark(device="cpu", repeats=1)
    exp = ref.benchmark(repeats=1)
    assert set(got) == set(exp)
    assert got["flops"] == exp["flops"]
    assert got["time"] > 0


def test_benchmark_synchronizes_a_cuda_device(monkeypatch):
    """On a CUDA device the clock is read after a synchronize on both
    sides of the pass (the contraction itself is stubbed: no card
    here)."""
    from cotengra_tpu_torch.ops import executor

    calls = []
    tree, _ = _rand_trees(1, True)
    monkeypatch.setattr(executor, "resolve_device",
                        lambda d: torch.device("cuda", 0))
    monkeypatch.setattr(executor, "make_full_contractor",
                        lambda *a, **k: lambda *t: calls.append("pass")
                        or torch.zeros(()))
    monkeypatch.setattr(executor, "to_tensors", lambda a, d, p: [])
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: calls.append("sync"))
    tree.benchmark(repeats=2)
    assert calls == ["sync", "pass", "sync"] * 3


# -- HyperGraph ---------------------------------------------------------------


def _hypergraphs(seed):
    inputs, output, _, size_dict = ctg.rand_equation(
        12, 3, n_out=1, n_hyper_in=2, d_min=2, d_max=5, seed=seed
    )
    return (HyperGraph(inputs, output, size_dict),
            RefHyperGraph(inputs, output, size_dict))


@pytest.mark.parametrize("seed", range(3))
def test_hypergraph_methods_match_the_reference(seed):
    hg, ref = _hypergraphs(seed)
    assert_allclose(hg.get_laplacian(), ref.get_laplacian(), rtol=1e-12,
                    atol=1e-12)
    assert_allclose(hg.resistance_distances(), ref.resistance_distances(),
                    rtol=1e-10, atol=1e-10)
    for rescale in (True, False):
        got = hg.resistance_centrality(rescale=rescale)
        exp = ref.resistance_centrality(rescale=rescale)
        assert list(got) == list(exp)
        assert_allclose(list(got.values()), list(exp.values()), rtol=1e-10,
                        atol=1e-12)
    for start, length in ((None, None), (None, 4), (0, 5)):
        assert hg.compute_loops(start, length) == ref.compute_loops(
            start, length
        )
    for wn in ("const", "log"):
        for we in ("const", "log"):
            assert hg.compute_weights(wn, we) == ref.compute_weights(wn, we)
    with pytest.raises(ValueError):
        hg.compute_weights("nope")


def test_resistance_centrality_of_a_path():
    """``tests/test_periphery.py``'s case: the centre of a path graph is
    the most central; rescaled into [0, 1]."""
    inputs = [("a",), ("a", "b"), ("b", "c"), ("c", "d"), ("d",)]
    hg = HyperGraph(inputs, (), {ix: 2 for ix in "abcd"})
    c = hg.resistance_centrality()
    assert max(c, key=c.get) == 2
    assert min(c.values()) == 0.0 and max(c.values()) == 1.0
    empty = HyperGraph([], (), {})
    assert empty.resistance_distances().shape == (0, 0)


# -- HyperOptimizer -----------------------------------------------------------


SEEDED = "test-methods-seeded-greedy"


def test_trials_introspection_matches_the_reference():
    space = {
        "costmod": {"type": "FLOAT", "min": 0.1, "max": 4.0},
        "temperature": {"type": "FLOAT_EXP", "min": 0.001, "max": 1.0},
    }
    ctt.register_hyper_function(
        SEEDED, lambda i, o, s, **p: ctt.optimize_greedy(
            i, o, s, use_ssa=True, accel=False, **p), space, {"seed": 3},
    )
    ctg.register_hyper_function(
        SEEDED, lambda i, o, s, **p: ctg.optimize_greedy(
            i, o, s, use_ssa=True, accel=False, **p), space, {"seed": 3},
    )
    inputs, output, _, size_dict = ctg.rand_equation(14, 3, seed=5)
    opts = dict(methods=[SEEDED], max_repeats=6, seed=2, parallel=False)
    got, exp = ctt.HyperOptimizer(**opts), ctg.HyperOptimizer(**opts)
    got.search(inputs, output, size_dict)
    exp.search(inputs, output, size_dict)
    for sort in (None, "score", "flops"):
        g, e = got.get_trials(sort), exp.get_trials(sort)
        assert [(t["method"], t["params"], t["score"]) for t in g] == [
            (t["method"], t["params"], t["score"]) for t in e
        ]
    assert _printed(got.print_trials) == _printed(exp.print_trials)
    assert _printed(got.print_trials, "flops").count("\n") == 6
    pd = pytest.importorskip("pandas")
    df = got.to_df()
    assert isinstance(df, pd.DataFrame)
    assert df.equals(exp.to_df())
    assert "param_costmod" in df.columns and len(df) == 6


# -- functions ----------------------------------------------------------------


def test_misc_functions_match_the_reference():
    its = ([1, 2, 3], "ab", (), [9, 8, 7, 6])
    assert list(interleave(*its)) == list(ref_interleave(*its))
    assert list(interleave()) == []
    seq = [3, 1, 3, "a", 1, None, "a"]
    assert unique(seq) == ref_unique(seq) == [3, 1, "a", None]


def test_pool_functions_match_the_reference():
    from cotengra_tpu_torch import parallel

    for name in ("set_parallel_backend", "should_nest"):
        assert name in parallel.__all__
    pool = pools.set_parallel_backend("threads:1")
    assert pool is pools.parse_parallel_arg("threads:1")
    assert pools.set_parallel_backend(False) is None
    data = [1, 2, 3]
    for mod, p in ((pools, pool), (ref_pools, ref_pools.parse_parallel_arg(
            "threads:1"))):
        assert not mod.can_scatter(p)
        assert mod.scatter(p, data) is data
        assert mod.should_nest(p) is False
        assert mod.maybe_leave_pool(p) is None
        assert mod.maybe_rejoin_pool(p, None) is None

    class Scattering:
        def scatter(self, data):
            return ("scattered", data)

    assert pools.can_scatter(Scattering())
    assert pools.scatter(Scattering(), data) == ("scattered", data)


def test_pairwise_einsum_tensordot():
    """``tests/test_periphery.py``'s standalone einsum and tensordot, on
    the port, against numpy and the reference."""
    from cotengra_tpu.ops import pairwise_einsum as ref_einsum
    from cotengra_tpu.ops import tensordot as ref_tensordot

    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 4, 5))
    b = rng.normal(size=(5, 4, 6))
    c = rng.normal(size=(3, 4, 4))
    for eq, ops in (("abc,cbd->ad", (a, b)), ("abb->a", (c,)),
                    ("abc,cbd", (a, b)), ("abb", (c,))):
        got = pairwise_einsum(eq, *ops).numpy()
        assert_allclose(got, np.einsum(eq, *ops), rtol=1e-12)
        assert_allclose(got, np.asarray(ref_einsum(eq, *ops)), rtol=1e-12)
    d = rng.normal(size=(5, 7))
    for x, y, axes in ((a, b, ([2, 1], [0, 1])), (a, d, 1),
                       (a, d, ([-1], [0]))):
        got = tensordot(x, y, axes=axes).numpy()
        assert_allclose(got, np.tensordot(x, y, axes=axes), rtol=1e-12)
        assert_allclose(got, np.asarray(ref_tensordot(x, y, axes=axes)),
                        rtol=1e-12)
    # a real operand meets a complex one promoted, as jnp's does
    z = a + 1j * rng.normal(size=a.shape)
    got = pairwise_einsum("abc,cbd->ad", z, b)
    assert got.dtype == torch.complex128
    assert_allclose(got.numpy(), np.einsum("abc,cbd->ad", z, b),
                    rtol=1e-12)
    got = tensordot(b, z, axes=([0], [2]))
    assert_allclose(got.numpy(), np.tensordot(b, z, axes=([0], [2])),
                    rtol=1e-12)
    with pytest.raises(ValueError, match="1 or 2"):
        pairwise_einsum("a,a,a->", a[0, 0], a[0, 0], a[0, 0])


# -- the JAX package's example ------------------------------------------------


def _example_steps(pkg, inputs, output, size_dict):
    """``examples/ex_plan_slice_contract.py``'s planning steps, sliced to
    a quarter of the largest intermediate (the example's 2^22 would not
    slice this small network) at temperature 0, so that both packages
    slice alike."""
    ssa, _ = pkg.optimize_random_greedy_track_flops(
        inputs, output, size_dict, ntrials=128, seed=0, use_ssa=True
    )
    tree = pkg.ContractionTree.from_path(
        inputs, output, size_dict, ssa_path=ssa
    )
    tree.subtree_reconfigure_(subtree_size=10)
    planned = tree.describe("full")
    target = max(tree.max_size() // 4, 2)
    tree.slice_and_reconfigure_(target, temperature=0)
    return tree, planned, tree.describe("full")


def test_example_steps_match_the_reference():
    from cotengra_tpu.models.circuits import rand_circuit_tn
    from cotengra_tpu.ops.preprocess import absorb_simple_tensors

    inputs, output, _, _, arrays = rand_circuit_tn(30, 4, seed=0)
    inputs, arrays = absorb_simple_tensors(inputs, arrays, output)
    size_dict = {
        ix: int(d) for t, a in zip(inputs, arrays) for ix, d in zip(t, a.shape)
    }
    p_inputs, p_output, _, _, p_arrays = ctt.rand_circuit_tn(30, 4, seed=0)
    p_inputs, p_arrays = ctt.absorb_simple_tensors(p_inputs, p_arrays,
                                                   p_output)
    assert [tuple(t) for t in p_inputs] == [tuple(t) for t in inputs]
    assert all(np.array_equal(a, b) for a, b in zip(p_arrays, arrays))
    # complex128 on both sides, so that rtol 1e-10 can hold
    arrays = [a.astype(np.complex128) for a in arrays]
    tree, planned, sliced = _example_steps(ctt, p_inputs, p_output,
                                           size_dict)
    ref, ref_planned, ref_sliced = _example_steps(ctg, inputs, output,
                                                  size_dict)
    assert planned == ref_planned
    assert sliced == ref_sliced and "NSLICES" in sliced
    assert list(tree.sliced_inds) == list(ref.sliced_inds)
    got = complex(tree.contract(arrays, device="cpu",
                                plane_dtype=torch.float64))
    exp = complex(ref.contract(arrays))
    assert abs(got - exp) <= 1e-10 * abs(exp)
