"""Multi-contraction trees and their hyper-optimizer against the JAX
package's, on the CPU: ``ContractionTreeMulti`` costs under each multi
objective, ``exact_multi_stats`` over explicit batches of
configurations, the tree's incremental bookkeeping with its variable
indices held in ``sliced_inds`` as ``None`` (subtree reconfiguration,
copies), and a seeded ``HyperMultiOptimizer`` search. Both packages'
path finders run in pure Python, with the same seeded greedy method
registered in both."""

import itertools
import random

import pytest

import cotengra_tpu as ctg
import cotengra_tpu.hyper.driver as ref_driver
from cotengra_tpu.scoring import expected_coupons as ref_expected_coupons
from cotengra_tpu.scoring import get_multi_objective as ref_get_multi
from cotengra_tpu.tree_multi import ContractionTreeMulti as RefTreeMulti

import cotengra_tpu_torch as ctt
from cotengra_tpu_torch.hyper import driver
from cotengra_tpu_torch.scoring import (
    MultiObjective,
    MultiObjectiveDense,
    MultiObjectiveLinear,
    MultiObjectiveUniform,
    expected_coupons,
    get_multi_objective,
)
from cotengra_tpu_torch.tree_multi import ContractionTreeMulti

SEEDED = "test-multi-seeded-greedy"
GREEDY_SPACE = {
    "costmod": {"type": "FLOAT", "min": 0.1, "max": 4.0},
    "temperature": {"type": "FLOAT_EXP", "min": 0.001, "max": 1.0},
}


@pytest.fixture
def seeded_method():
    ctt.register_hyper_function(
        SEEDED, lambda i, o, s, **p: ctt.optimize_greedy(
            i, o, s, use_ssa=True, accel=False, **p), GREEDY_SPACE,
        {"seed": 7},
    )
    ctg.register_hyper_function(
        SEEDED, lambda i, o, s, **p: ctg.optimize_greedy(
            i, o, s, use_ssa=True, accel=False, **p), GREEDY_SPACE,
        {"seed": 7},
    )
    yield SEEDED
    for mod in (driver, ref_driver):
        for registry in (mod._HYPER_FNS, mod._HYPER_SPACES,
                         mod._HYPER_CONSTANTS):
            registry.pop(SEEDED, None)


def _multi_trees(n, seed, n_var, strategy="uniform", numconfigs=64):
    """Both packages' multi trees from one greedy path, the first
    ``n_var`` indices (sorted) variable."""
    inputs, output, _, size_dict = ctg.rand_equation(n, 3, seed=seed)
    var_inds = sorted(size_dict)[:n_var]
    ssa = ctg.optimize_greedy(inputs, output, size_dict, use_ssa=True,
                              accel=False)
    trees = []
    for cls, get in ((ContractionTreeMulti, get_multi_objective),
                     (RefTreeMulti, ref_get_multi)):
        t = cls.from_path(inputs, output, size_dict, ssa_path=ssa)
        t.sliced_inds = {ix: None for ix in var_inds}
        t.set_default_objective(get(strategy, numconfigs))
        trees.append(t)
    return (*trees, var_inds, size_dict)


def _state(tree):
    nodes = [*tree.children, *(1 << i for i in range(tree.N))]
    return (
        list(tree.children.items()),
        [(n, list(tree.get_legs(n).items()), tree.get_size(n),
          tree.get_flops(n), dict(tree.get_node_var_inds(n)),
          tree.get_node_mult(n), tree.get_node_is_bright(n))
         for n in nodes],
        tree.contract_stats(),
        tree.sliced_inds,
        tree.multiplicity,
    )


def _configs(var_inds, size_dict, n, seed):
    rng = random.Random(seed)
    return [{ix: rng.randrange(size_dict[ix]) for ix in var_inds}
            for _ in range(n)]


@pytest.mark.parametrize("strategy", ["dense", "uniform", "linear"])
@pytest.mark.parametrize("seed", [1, 2])
def test_multi_costs_match_the_reference(strategy, seed):
    """``tests/test_compressed.py``'s multi costs: every node's variable
    indices, multiplicity and brightness, the totals and the
    cache-aware peak equal the reference's."""
    tree, ref, var_inds, size_dict = _multi_trees(14, seed, 4, strategy)
    assert _state(tree) == _state(ref)
    for log in (None, 2):
        assert tree.total_flops(log=log) == ref.total_flops(log=log)
        assert tree.peak_size(log=log) == ref.peak_size(log=log)
    assert list(tree.children.items()) == list(ref.children.items())
    assert tree.reorder_contractions_for_peak_est() == (
        ref.reorder_contractions_for_peak_est()
    )
    tree.reorder_sliced_inds()
    ref.reorder_sliced_inds()
    assert list(tree.sliced_inds) == list(ref.sliced_inds)
    for node in tree.children:
        assert tree.get_node_cache_mult(node, var_inds) == (
            ref.get_node_cache_mult(node, var_inds)
        )
    assert tree.describe("full") == ref.describe("full")


def test_dense_multiplicity_is_at_least_uniform():
    tree, _, _, _ = _multi_trees(14, 1, 4, "dense")
    dense = tree.total_flops()
    tree._mult_cache.clear()
    tree._tracked = False
    tree.set_default_objective(get_multi_objective("uniform", 64))
    assert dense >= tree.total_flops()


@pytest.mark.parametrize("n_configs", [1, 8, 16])
@pytest.mark.parametrize("seed", [3, 5])
def test_exact_multi_stats_match_the_reference(seed, n_configs):
    tree, ref, var_inds, size_dict = _multi_trees(10, seed, 3)
    configs = _configs(var_inds, size_dict, n_configs, seed)
    got = tree.exact_multi_stats(configs)
    assert got == ref.exact_multi_stats(configs)
    assert got["flops"] > 0 and got["peak"] >= got["size"]
    # a repeated batch recomputes nothing, as in the reference
    assert tree.exact_multi_stats(configs + configs) == got


def test_exact_multi_stats_count_each_value_once():
    """Flops are charged once per distinct (node, projected
    configuration) value."""
    from cotengra_tpu_torch.tree import ContractionTree

    tree, _, var_inds, size_dict = _multi_trees(10, 3, 3)
    configs = _configs(var_inds, size_dict, 12, 7)
    seen, flops = set(), 0
    for config in configs:
        for p, _, _ in tree.traverse():
            key = (p, tuple(config[ix] for ix in tree.get_node_var_inds(p)))
            if key not in seen:
                seen.add(key)
                flops += ContractionTree.get_flops(tree, p)
    assert tree.exact_multi_stats(configs)["flops"] == flops
    every = [dict(zip(var_inds, v)) for v in itertools.product(
        *(range(size_dict[ix]) for ix in var_inds))]
    assert tree.exact_multi_stats(every)["flops"] >= flops


def test_incremental_bookkeeping_takes_none_variables():
    """The variable indices sit in ``sliced_inds`` as ``None``: subtree
    reconfiguration (``_remove_node``, ``_forget``, the leg and size
    caches) and copies keep the reference's state."""
    tree, ref, _, _ = _multi_trees(16, 4, 3)
    copy, ref_copy = tree.copy(), ref.copy()
    # with the trial's objective, as run_trial reconfigures it (the multi
    # objectives have no dynamic-programming key, in either package)
    tree.subtree_reconfigure_(subtree_size=6, minimize="flops")
    ref.subtree_reconfigure_(subtree_size=6, minimize="flops")
    assert _state(tree) == _state(ref)
    assert _state(copy) == _state(ref_copy)
    assert copy.sliced_inds == tree.sliced_inds
    assert copy.multiplicity == tree.multiplicity == 1


def test_multi_objectives_match_the_reference():
    for num, total in ((4, 1), (16, 9), (3, 100)):
        assert expected_coupons(num, total) == ref_expected_coupons(
            num, total
        )
    tree, ref, _, _ = _multi_trees(12, 2, 3)
    for strategy, cls in (("dense", MultiObjectiveDense),
                          ("uniform", MultiObjectiveUniform),
                          ("linear", MultiObjectiveLinear)):
        obj = get_multi_objective(strategy, 32)
        assert isinstance(obj, cls) and isinstance(obj, MultiObjective)
        assert repr(obj) == repr(ref_get_multi(strategy, 32))
        for dims in ([], [2], [2, 3, 4]):
            assert obj.compute_mult(dims) == ref_get_multi(
                strategy, 32).compute_mult(dims)
        trial = {"tree": tree}
        assert obj(dict(trial)) == ref_get_multi(strategy, 32)(
            {"tree": ref}
        )
    assert get_multi_objective(obj, 1) is obj
    assert get_multi_objective("linear", 8, coeff=3).coeff == 3


@pytest.mark.parametrize("strategy", ["uniform", "dense"])
def test_seeded_hyper_multi_optimizer_matches_the_reference(
    seeded_method, strategy
):
    """``tests/test_compressed.py``'s ``HyperMultiOptimizer`` search,
    seeded: the same trials and the same tree."""
    inputs, output, _, size_dict = ctg.rand_equation(12, 3, seed=2)
    var_inds = sorted(size_dict)[:3]
    opts = dict(varmults=var_inds, numconfigs=32, strategy=strategy,
                methods=[seeded_method], max_repeats=6, seed=0,
                parallel=False, on_trial_error="raise", reconf_opts={})
    got = ctt.HyperMultiOptimizer(**opts)
    exp = ctg.HyperMultiOptimizer(**opts)
    tree = got.search(inputs, output, size_dict)
    ref = exp.search(inputs, output, size_dict)
    assert isinstance(tree, ContractionTreeMulti)
    assert got.multicontraction and got.multi_opts == exp.multi_opts
    assert [(t["params"], t["score"]) for t in got.trials] == [
        (t["params"], t["score"]) for t in exp.trials
    ]
    assert _state(tree) == _state(ref)
    assert tree.total_flops() > 0
