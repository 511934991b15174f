"""The port's sliced planning against the JAX package's, on the CPU: the
tree's incremental bookkeeping under ``remove_ind`` / ``restore_ind``,
``SliceFinder``, slicing, subtree reconfiguration and their forest
variants, simulated annealing and parallel tempering. Both trees start
from the same SSA path and take the same seeded steps; they must then
hold the same ``children`` in the same order, every node's legs (in
order), size and flops, the same totals and slicing, and lower to the
same steps. Each sliced, reconfigured tree then contracts in float64 on
the CPU to the JAX package's value at rtol 1e-10. Both packages' path
finders and cost replays run in pure Python (their native ones are
patched out), so that these tests hold the port's pure-Python planner to
the reference's; the native library's paths, and sliced planning on
them, are compared in ``test_torch_native.py``."""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import cotengra_tpu as ctg
import cotengra_tpu.pathfinders.basic as ref_basic
import cotengra_tpu.tree as ref_tree_mod
from cotengra_tpu.models.circuits import rand_circuit_tn as ref_circuit
from cotengra_tpu.slicing import SliceFinder as RefSliceFinder

import cotengra_tpu_torch as ctt
import cotengra_tpu_torch.pathfinders.basic as port_basic
import cotengra_tpu_torch.tree as port_tree_mod
from cotengra_tpu_torch.ops import lowering
from cotengra_tpu_torch.slicing import SliceFinder

torch.set_num_threads(1)

F64_RTOL = 1e-10


@pytest.fixture(autouse=True)
def _pure_python_reference(monkeypatch):
    """Both packages' path finders and cost replays in pure Python."""
    for basic, tree_mod in ((ref_basic, ref_tree_mod),
                            (port_basic, port_tree_mod)):
        monkeypatch.setattr(basic, "_get_native", lambda accel: None)
        monkeypatch.setattr(tree_mod, "_get_native_replay", lambda a: None)


def _networks():
    """(name, inputs, output, size_dict, arrays): a random equation with
    hyper and output indices, a 5x5 bond-4 lattice, a 20-qubit circuit."""
    nets = []
    rng = np.random.default_rng(0)
    inputs, output, shapes, size_dict = ctg.rand_equation(
        16, 3, n_out=2, n_hyper_in=1, n_hyper_out=1, d_min=2, d_max=4, seed=3
    )
    arrays = [rng.normal(size=s) for s in shapes]
    nets.append(("rand16", inputs, output, size_dict, arrays))
    inputs, output, shapes, size_dict = ctg.lattice_equation([5, 5], d_min=4)
    arrays = [rng.uniform(size=s) for s in shapes]
    nets.append(("lattice5x5", inputs, output, size_dict, arrays))
    inputs, output, _, _, arrays = ref_circuit(20, 8, seed=3)
    inputs, arrays = ctt.absorb_simple_tensors(
        inputs, arrays, output, max_rank=2, max_absorb_size=2**12
    )
    arrays = [np.asarray(a, np.complex128) for a in arrays]
    size_dict = {
        ix: int(d) for t, a in zip(inputs, arrays) for ix, d in zip(t, a.shape)
    }
    nets.append(("circuit20", inputs, output, size_dict, arrays))
    return nets


NETWORKS = _networks()
NET_IDS = [n[0] for n in NETWORKS]


def _pair(net):
    """A (port, reference) pair of trees from the reference's pure-Python
    greedy path."""
    _, inputs, output, size_dict, _ = net
    ssa = ctg.optimize_greedy(
        inputs, output, size_dict, use_ssa=True, accel=False
    )
    return (
        ctt.ContractionTree.from_path(inputs, output, size_dict, ssa_path=ssa),
        ctg.ContractionTree.from_path(inputs, output, size_dict, ssa_path=ssa),
    )


def _rebuilt(ref):
    """The reference's tree carried across into the port: its SSA path,
    then its sliced indices."""
    tree = ctt.ContractionTree.from_path(
        ref.inputs, ref.output, ref.size_dict, ssa_path=ref.get_ssa_path()
    )
    for ix, si in ref.sliced_inds.items():
        tree.remove_ind_(ix, project=si.project)
    return tree


def _state(tree):
    """Everything the executor and the planner read: the children in
    order, each node's legs (in order), size and flops, the totals and
    the slicing."""
    nodes = [*tree.children, *(1 << i for i in range(tree.N))]
    return (
        list(tree.children.items()),
        [
            (n, list(tree.get_legs(n).items()), tree.get_size(n),
             tree.get_flops(n))
            for n in nodes
        ],
        tree.total_flops(),
        tree.total_write(),
        tree.max_size(),
        tree.multiplicity,
        [
            (ix, si.inner, si.size, si.project)
            for ix, si in tree.sliced_inds.items()
        ],
        tree.sliced_inputs,
    )


def _unordered(tree):
    """``_state`` with the children as a mapping, not a sequence."""
    children, nodes, *rest = _state(tree)
    return dict(children), sorted(nodes), *rest


def _assert_same(tree, ref):
    assert _state(tree) == _state(ref)
    assert tree.get_ssa_path() == ref.get_ssa_path()
    assert tree.contract_stats() == ref.contract_stats()
    # the incremental totals equal a recount from scratch
    assert tree.copy().contract_stats(force=True) == tree.contract_stats()
    # and the tree lowers to the steps the reference's tree lowers to
    assert lowering.extract_contractions(tree) == (
        lowering.extract_contractions(ref)
    )


def _inner_inds(tree, k):
    """``k`` inner indices, the most shared first, ties by name."""
    counts = {}
    for term in tree.inputs:
        for ix in term:
            if ix not in tree.output:
                counts[ix] = counts.get(ix, 0) + 1
    return sorted(counts, key=lambda ix: (-counts[ix], str(ix)))[:k]


# -- remove_ind / restore_ind ------------------------------------------------


@pytest.mark.parametrize("net", NETWORKS, ids=NET_IDS)
def test_remove_restore_round_trip(net):
    tree, ref = _pair(net)
    fresh = _unordered(tree)
    inds = _inner_inds(tree, 3)
    steps = [(ix, None) for ix in inds]
    if tree.output:
        steps.append((tree.output[0], None))
    # a projection fixes an index without adding slices
    steps.append((_inner_inds(tree, 4)[-1], 1))
    for ix, project in steps:
        tree.remove_ind_(ix, project=project)
        ref.remove_ind_(ix, project=project)
        _assert_same(tree, ref)
    # the non-inplace form leaves the tree alone
    before = _state(tree)
    ix = next(ix for ix in tree.size_dict if ix not in tree.sliced_inds)
    sliced = tree.remove_ind(ix)
    assert _state(tree) == before
    assert _state(sliced) == _state(ref.remove_ind(ix))
    # restore in another order than the slicing
    for ix, _ in steps[1:] + steps[:1]:
        tree.restore_ind_(ix)
        ref.restore_ind_(ix)
        _assert_same(tree, ref)
    # back where it started: the same nodes, legs in the order a fresh
    # tree has them (restoring re-inserts the touched parents, so the
    # children's order is the reference's, not the fresh tree's)
    assert _unordered(tree) == fresh
    with pytest.raises(ValueError, match="already sliced"):
        tree.remove_ind_(inds[0]).remove_ind_(inds[0])


@pytest.mark.parametrize("net", NETWORKS, ids=NET_IDS)
def test_unslice_rand_and_all(net):
    tree, ref = _pair(net)
    for ix in _inner_inds(tree, 4):
        tree.remove_ind_(ix)
        ref.remove_ind_(ix)
    tree.unslice_rand_(seed=5)
    ref.unslice_rand_(seed=5)
    _assert_same(tree, ref)
    got, exp = tree.unslice_all(), ref.unslice_all()
    _assert_same(got, exp)
    assert not got.sliced_inds and got.multiplicity == 1


# -- SliceFinder -------------------------------------------------------------


SLICE_FINDER_OPTS = {
    "size": dict(target_size_div=16, seed=1),
    "size-hot": dict(target_size_div=64, seed=2, temperature=0.5),
    "slices-inner": dict(target_slices=8, seed=3, allow_outer=False),
    "overhead": dict(target_overhead=1.5, target_size_div=2**30, seed=4),
    "outer-only": dict(target_slices=4, seed=5, allow_outer="only"),
}


@pytest.mark.parametrize(
    "net, opts",
    [
        pytest.param(net, opts, id=f"{name}-{net[0]}")
        for net in NETWORKS
        for name, opts in SLICE_FINDER_OPTS.items()
        # only the random equation has output indices to slice
        if name != "outer-only" or net[2]
    ],
)
def test_slice_finder_matches_reference(net, opts):
    tree, ref = _pair(net)
    opts = dict(opts)
    div = opts.pop("target_size_div", None)
    if div is not None:
        opts["target_size"] = max(tree.max_size() // div, 2)
    sf = SliceFinder(tree, max_repeats=8, **opts)
    rsf = RefSliceFinder(ref, max_repeats=8, **opts)
    costs, inds = sf.search()
    rcosts, rinds = rsf.search()
    assert inds == rinds
    assert (costs.total_flops, costs.total_write, costs.max_size,
            costs.nslices, costs.overhead) == (
        rcosts.total_flops, rcosts.total_write, rcosts.max_size,
        rcosts.nslices, rcosts.overhead)
    assert costs.flop_reductions == rcosts.flop_reductions
    assert costs.write_reductions == rcosts.write_reductions


def test_slice_finder_needs_a_target():
    tree, _ = _pair(NETWORKS[0])
    with pytest.raises(ValueError, match="at least one"):
        SliceFinder(tree)


# -- slicing and subtree reconfiguration ----------------------------------------


@pytest.mark.parametrize("net", NETWORKS, ids=NET_IDS)
def test_slice_then_subtree_reconfigure(net):
    tree, ref = _pair(net)
    target = max(tree.max_size() // 16, 2)
    tree.slice_(target_size=target, seed=7)
    ref.slice_(target_size=target, seed=7)
    _assert_same(tree, ref)
    assert tree.max_size() <= target
    got = tree.subtree_reconfigure(select="max", subtree_search="bfs")
    exp = ref.subtree_reconfigure(select="max", subtree_search="bfs")
    _assert_same(got, exp)
    assert got.total_flops() <= tree.total_flops()
    # the reference's tree, carried into the port, lowers alike
    assert lowering.extract_contractions(_rebuilt(exp)) == (
        lowering.extract_contractions(got)
    )
    # the other selections and searches, seeded
    for select, search in [("min", "dfs"), ("random", "random")]:
        got = tree.subtree_reconfigure(
            select=select, subtree_search=search, subtree_size=6, seed=11,
            maxiter=40, minimize="combo",
        )
        exp = ref.subtree_reconfigure(
            select=select, subtree_search=search, subtree_size=6, seed=11,
            maxiter=40, minimize="combo",
        )
        _assert_same(got, exp)


@pytest.mark.parametrize("net", NETWORKS, ids=NET_IDS)
def test_slice_and_reconfigure(net):
    tree, ref = _pair(net)
    target = max(tree.max_size() // 32, 2)
    got = tree.slice_and_reconfigure(target, temperature=0)
    exp = ref.slice_and_reconfigure(target, temperature=0)
    _assert_same(got, exp)
    assert got.max_size() <= target
    # in place, with an objective
    tree.slice_and_reconfigure_(
        target, temperature=0, minimize="size", reconf_opts={"maxiter": 20}
    )
    ref.slice_and_reconfigure_(
        target, temperature=0, minimize="size", reconf_opts={"maxiter": 20}
    )
    _assert_same(tree, ref)


@pytest.mark.parametrize("net", NETWORKS, ids=NET_IDS)
def test_forest_variants(net):
    tree, ref = _pair(net)
    got = tree.subtree_reconfigure_forest(
        num_trees=4, num_restarts=2, subtree_maxiter=10, seed=5,
        parallel=False,
    )
    exp = ref.subtree_reconfigure_forest(
        num_trees=4, num_restarts=2, subtree_maxiter=10, seed=5,
        parallel=False,
    )
    _assert_same(got, exp)
    target = max(tree.max_size() // 16, 2)
    got = tree.slice_and_reconfigure_forest(
        target, num_trees=4, seed=6, parallel=False,
        reconf_opts={"maxiter": 10},
    )
    exp = ref.slice_and_reconfigure_forest(
        target, num_trees=4, seed=6, parallel=False,
        reconf_opts={"maxiter": 10},
    )
    _assert_same(got, exp)
    assert got.max_size() <= target
    tree.slice_and_reconfigure_forest_(target, num_trees=2, seed=8)
    ref.slice_and_reconfigure_forest_(target, num_trees=2, seed=8)
    _assert_same(tree, ref)


# -- simulated annealing -------------------------------------------------------


@pytest.mark.parametrize("net", NETWORKS, ids=NET_IDS)
@pytest.mark.parametrize(
    "opts",
    [
        dict(tsteps=12, seed=2),
        dict(tsteps=8, numiter=2, tstrategy="geometric", minimize="combo",
             seed=3),
    ],
    ids=["plain", "geometric-combo"],
)
def test_simulated_anneal(net, opts):
    tree, ref = _pair(net)
    _assert_same(tree.simulated_anneal(**opts), ref.simulated_anneal(**opts))
    tree.simulated_anneal_(**opts)
    ref.simulated_anneal_(**opts)
    _assert_same(tree, ref)


def _assert_consistent(tree):
    """A complete tree whose incremental caches and totals equal those of
    the same tree built afresh (legs as sets: a rotation re-derives a
    node's legs, and its parent keeps the order it cached)."""
    assert tree.is_complete()
    assert tree.copy().contract_stats(force=True) == tree.contract_stats()
    fresh = _rebuilt(tree)

    def nodes(t):
        return sorted(
            (n, sorted(t.get_legs(n).items()), t.get_size(n), t.get_flops(n))
            for n in [*t.children, *(1 << i for i in range(t.N))]
        )

    assert nodes(fresh) == nodes(tree)
    assert _state(fresh)[2:] == _state(tree)[2:]


@pytest.mark.parametrize("net", NETWORKS, ids=NET_IDS)
@pytest.mark.parametrize("mode", ["basic", "drift", 2])
def test_simulated_anneal_with_slicing(net, mode):
    """Annealing that re-slices as it goes: the slice finder it calls is
    unseeded in both packages, so the port's tree is held to its own
    invariants rather than to the reference's tree."""
    tree, _ = _pair(net)
    target = max(tree.max_size() // 8, 2)
    got = tree.simulated_anneal(
        tsteps=8, target_size=target, mode=mode, seed=4
    )
    _assert_consistent(got)
    if mode != "drift":
        assert got.max_size() <= target


@pytest.mark.parametrize("net", NETWORKS[:2], ids=NET_IDS[:2])
def test_parallel_temper(net):
    tree, ref = _pair(net)
    opts = dict(num_replicas=3, rounds=2, tsteps_per_round=4, seed=9)
    _assert_same(tree.parallel_temper(**opts), ref.parallel_temper(**opts))
    tree.parallel_temper_(num_replicas=2, rounds=1, seed=1)
    ref.parallel_temper_(num_replicas=2, rounds=1, seed=1)
    _assert_same(tree, ref)
    # with a size target the replicas drift-slice, unseeded: invariants
    got = tree.parallel_temper(
        num_replicas=2, rounds=2, tsteps_per_round=4, seed=3,
        target_size=max(tree.max_size() // 4, 2),
    )
    _assert_consistent(got)


# -- values -----------------------------------------------------------------


@pytest.mark.parametrize("net", NETWORKS, ids=NET_IDS)
def test_sliced_reconfigured_value_matches_reference(net):
    tree, ref = _pair(net)
    target = max(tree.max_size() // 16, 2)
    tree.slice_and_reconfigure_(target, temperature=0)
    ref.slice_and_reconfigure_(target, temperature=0)
    _assert_same(tree, ref)
    assert tree.multiplicity > 1
    arrays = net[4]
    got = ctt.contract_tree(
        tree, arrays, device="cpu", plane_dtype=torch.float64
    )
    exp = np.asarray(ref.contract(arrays))
    assert tuple(got.shape) == exp.shape
    assert_allclose(got.numpy(), exp, rtol=F64_RTOL)


# -- the optimal DP that reconfiguration runs -------------------------------------


@pytest.mark.parametrize(
    "minimize",
    ["flops", "size", "write", "max", "combo", "combo-32.5", "limit-16"],
)
@pytest.mark.parametrize("search_outer", [False, True])
def test_optimal_dp_matches_reference(minimize, search_outer):
    """Subtree reconfiguration's optimal DP, under each cost, against the
    reference's pure-Python DP (ties broken alike), on hyper-edged
    equations and the small subproblems a reconfiguration poses."""
    for seed in range(4):
        inputs, output, _, size_dict = ctg.rand_equation(
            9, 3, n_out=2, n_hyper_in=1, n_hyper_out=1, d_min=2, d_max=5,
            seed=seed,
        )
        kw = dict(minimize=minimize, search_outer=search_outer,
                  use_ssa=True)
        assert ctt.optimize_optimal(inputs, output, size_dict, **kw) == (
            ctg.optimize_optimal(inputs, output, size_dict, accel=False,
                                 **kw)
        )
        # the same contraction again: the kept answer, a fresh list
        again = ctt.optimize_optimal(inputs, output, size_dict, **kw)
        assert again == ctt.optimize_optimal(inputs, output, size_dict, **kw)
        assert again is not ctt.optimize_optimal(
            inputs, output, size_dict, **kw
        )
