"""The port's hyper-optimizer against the JAX package's, on the CPU: the
samplers (the same parameters asked for the same seed and scores), the
per-trial stack (``run_trial``: annealing, slicing, slice+reconfigure,
reconfigure), a whole seeded search, the disk-cached optimizer, the
compressed hyper-optimizer, the presets through ``einsum`` and the host
pools. Methods whose trees depend on a seed are given one, so that both
packages build the same trees; both packages' path finders and cost
replays run in pure Python (their native ones are patched out), so that
these tests hold the port's pure-Python planner to the reference's; the
native library's paths are compared in ``test_torch_native.py``."""

import importlib.util
import math

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import cotengra_tpu as ctg
import cotengra_tpu.hyper.driver as ref_driver
import cotengra_tpu.pathfinders.basic as ref_basic
import cotengra_tpu.tree as ref_tree_mod
from cotengra_tpu.hyper.space import get_optlib as ref_get_optlib
from cotengra_tpu.tree_compressed import (
    ContractionTreeCompressed as RefTreeCompressed,
)

import cotengra_tpu_torch as ctt
import cotengra_tpu_torch.pathfinders.basic as port_basic
import cotengra_tpu_torch.tree as port_tree_mod
from cotengra_tpu_torch import interface
from cotengra_tpu_torch.hyper import driver
from cotengra_tpu_torch.hyper.space import get_optlib
from cotengra_tpu_torch.parallel import pools
from cotengra_tpu_torch.tree_compressed import ContractionTreeCompressed
from cotengra_tpu_torch.utils.eqs import inputs_output_to_eq
from cotengra_tpu_torch.utils.io import hash_contraction_b

torch.set_num_threads(1)

F64_RTOL = 1e-10
SEEDED = "test-seeded-greedy"
GREEDY_SPACE = {
    "costmod": {"type": "FLOAT", "min": 0.1, "max": 4.0},
    "temperature": {"type": "FLOAT_EXP", "min": 0.001, "max": 1.0},
}


def _port_seeded_greedy(inputs, output, size_dict, **params):
    return ctt.optimize_greedy(inputs, output, size_dict, use_ssa=True,
                               **params)


def _ref_seeded_greedy(inputs, output, size_dict, **params):
    return ctg.optimize_greedy(inputs, output, size_dict, use_ssa=True,
                               accel=False, **params)


@pytest.fixture(autouse=True)
def _pure_python_reference(monkeypatch):
    """Both packages' path finders and cost replays in pure Python, and
    the same seeded greedy method registered in both packages (removed
    again afterwards)."""
    for basic, tree_mod in ((ref_basic, ref_tree_mod),
                            (port_basic, port_tree_mod)):
        monkeypatch.setattr(basic, "_get_native", lambda accel: None)
        monkeypatch.setattr(tree_mod, "_get_native_replay", lambda a: None)
    ctt.register_hyper_function(
        SEEDED, _port_seeded_greedy, GREEDY_SPACE, {"seed": 7}
    )
    ctg.register_hyper_function(
        SEEDED, _ref_seeded_greedy, GREEDY_SPACE, {"seed": 7}
    )
    interface.clear_caches()
    yield
    for mod in (driver, ref_driver):
        for registry in (mod._HYPER_FNS, mod._HYPER_SPACES,
                         mod._HYPER_CONSTANTS):
            registry.pop(SEEDED, None)
    interface.clear_caches()


def _net(n=18, seed=2):
    inputs, output, shapes, size_dict = ctg.rand_equation(
        n, 3, n_out=2, n_hyper_in=1, d_min=2, d_max=4, seed=seed
    )
    return inputs, output, shapes, size_dict


def _state(tree):
    """The children in order, each node's legs (in order), size and flops,
    the totals and the slicing."""
    nodes = [*tree.children, *(1 << i for i in range(tree.N))]
    return (
        list(tree.children.items()),
        [
            (n, list(tree.get_legs(n).items()), tree.get_size(n),
             tree.get_flops(n))
            for n in nodes
        ],
        tree.contract_stats(),
        tree.multiplicity,
        [
            (ix, si.inner, si.size, si.project)
            for ix, si in tree.sliced_inds.items()
        ],
    )


def _score(method, params):
    """A deterministic score of the asked parameters."""
    total = 1.0 + len(method)
    for name in sorted(params):
        v = params[name]
        if isinstance(v, str):
            total += 0.1 * len(v)
        elif isinstance(v, bool):
            total += 0.3 * v
        else:
            total += (math.log(v) - 0.5) ** 2 if v > 0 else abs(v)
    return total


# -- samplers ------------------------------------------------------------------


OPTLIBS = ["random", "evo", "sses", "nm", "sbplx", "cmaes", "de", "pe",
           "scipy"]


@pytest.mark.parametrize("name", OPTLIBS)
def test_optlib_asks_match_reference(name):
    methods = ["greedy", "labels"]
    spaces = ctt.get_hyper_space()
    ref_spaces = ctg.get_hyper_space()
    assert {m: spaces[m] for m in methods} == {
        m: ref_spaces[m] for m in methods
    }
    got = get_optlib(name)(methods, spaces, {}, seed=11)
    exp = ref_get_optlib(name)(methods, ref_spaces, {}, seed=11)
    try:
        for _ in range(50):
            method, params = got.ask()
            assert (method, params) == exp.ask()
            score = _score(method, params)
            got.tell(method, params, score)
            exp.tell(method, params, score)
    finally:
        for opt in (got, exp):
            close = getattr(opt, "close", None)
            if close is not None:
                close()


def test_optlib_registry():
    assert get_optlib("auto").__name__ == ref_get_optlib("auto").__name__
    # without optuna the ladder's next rung is the in-house CMA-ES
    if importlib.util.find_spec("optuna") is None:
        assert get_optlib("auto").__name__ == "CMAESOptLib"
    with pytest.raises(ValueError, match="Unknown optlib"):
        get_optlib("no-such-optlib")
    # the native partitioner builds here (g++), as the reference's does
    assert driver._default_methods() == ref_driver._default_methods()
    assert driver._default_methods() == ["greedy", "ctgpart"]
    with pytest.raises(ValueError, match="Unknown hyper method"):
        ctt.HyperOptimizer(methods=["no-such-method"])


# -- the per-trial stack ----------------------------------------------------------


@pytest.mark.parametrize(
    "stages",
    ["anneal", "slice", "slice-reconf", "reconf", "all"],
)
@pytest.mark.parametrize(
    "method, params",
    [
        ("greedy", {"costmod": 1.3, "temperature": 0.05, "seed": 3}),
        ("labels", {"parts": 3, "cutoff": 10, "balance_pow": 1.5,
                    "maxiter": 12, "sub_optimize": "auto", "seed": 4}),
    ],
    ids=["greedy", "labels"],
)
def test_run_trial_matches_reference(method, params, stages):
    inputs, output, _, size_dict = _net()
    probe = ctt.ContractionTree.from_path(
        inputs, output, size_dict, ssa_path=_port_seeded_greedy(
            inputs, output, size_dict, seed=1
        ),
    )
    target = max(probe.max_size() // 8, 2)
    opts = {}
    if stages in ("anneal", "all"):
        opts["simulated_annealing_opts"] = {"tsteps": 6, "seed": 2}
    if stages in ("slice", "all"):
        opts["slicing_opts"] = {"target_size": target, "seed": 5}
    if stages in ("slice-reconf", "all"):
        opts["slicing_reconf_opts"] = {
            "target_size": max(target // 2, 2), "temperature": 0,
        }
    if stages in ("reconf", "all"):
        opts["reconf_opts"] = {"maxiter": 50}
    got = driver.run_trial(
        inputs, output, size_dict, method, params, minimize="combo", **opts
    )
    exp = ref_driver.run_trial(
        inputs, output, size_dict, method, params, minimize="combo", **opts
    )
    assert _state(got["tree"]) == _state(exp["tree"])
    assert got["tree"].get_ssa_path() == exp["tree"].get_ssa_path()
    for key in ("flops", "write", "size", "method", "params"):
        assert got[key] == exp[key]


def test_run_trial_multi_not_ported():
    """The ``multi_opts`` branch, once refused, now builds the
    reference's multi-contraction tree: the same children, variable
    indices, objective and trial numbers."""
    from cotengra_tpu_torch.tree_multi import ContractionTreeMulti

    inputs, output, _, size_dict = _net(8)
    multi = {"varmults": tuple(sorted(size_dict)[:2]), "numconfigs": 8,
             "strategy": "dense"}
    got = driver.run_trial(inputs, output, size_dict, SEEDED, {"seed": 1},
                           multi_opts=multi, reconf_opts={})
    exp = ref_driver.run_trial(inputs, output, size_dict, SEEDED,
                               {"seed": 1}, multi_opts=multi,
                               reconf_opts={})
    assert isinstance(got["tree"], ContractionTreeMulti)
    assert list(got["tree"].children.items()) == list(
        exp["tree"].children.items()
    )
    assert got["tree"].sliced_inds == exp["tree"].sliced_inds == {
        ix: None for ix in multi["varmults"]
    }
    assert repr(got["tree"].get_default_objective()) == repr(
        exp["tree"].get_default_objective()
    )
    for key in ("flops", "write", "size", "score"):
        assert got.get(key) == exp.get(key)


def test_run_trial_compressed_matches_reference():
    inputs, output, _, size_dict = ctg.lattice_equation([5, 5], d_min=3)
    params = {"chi": 9, "temperature": 0.1, "seed": 2}
    opts = dict(
        minimize="peak-compressed-9",
        reconf_opts={"window_size": 6, "max_iterations": 3, "seed": 1},
        # the compressed branch skips annealing and slicing
        slicing_opts={"target_size": 2},
    )
    got = driver.run_trial(
        inputs, output, size_dict, "greedy-compressed", params,
        tree_class=ContractionTreeCompressed, **opts,
    )
    exp = ref_driver.run_trial(
        inputs, output, size_dict, "greedy-compressed", params,
        tree_class=RefTreeCompressed, **opts,
    )
    assert isinstance(got["tree"], ContractionTreeCompressed)
    assert got["tree"].get_ssa_path("surface_order") == (
        exp["tree"].get_ssa_path("surface_order")
    )
    assert got["tree"].multiplicity == 1
    for key in ("flops", "write", "size"):
        assert got[key] == exp[key]


# -- a whole search ----------------------------------------------------------------


@pytest.mark.parametrize("optlib", ["cmaes", "sbplx"])
def test_seeded_search_matches_reference(optlib):
    inputs, output, _, size_dict = _net()
    probe = ctt.ContractionTree.from_path(
        inputs, output, size_dict, ssa_path=_port_seeded_greedy(
            inputs, output, size_dict, seed=1
        ),
    )
    opts = dict(
        methods=[SEEDED], optlib=optlib, max_repeats=12, seed=5,
        minimize="flops",
        slicing_reconf_opts={
            "target_size": max(probe.max_size() // 4, 2),
            "temperature": 0,
        },
    )
    got = ctt.HyperOptimizer(**opts)
    exp = ctg.HyperOptimizer(**opts)
    tree = got.search(inputs, output, size_dict)
    ref = exp.search(inputs, output, size_dict)
    assert _state(tree) == _state(ref)
    assert [t["score"] for t in got.trials] == [
        t["score"] for t in exp.trials
    ]
    assert [t["params"] for t in got.trials] == [
        t["params"] for t in exp.trials
    ]
    assert got.best_score == exp.best_score
    assert got.path == exp.path


def test_search_answers_for_its_own_contraction():
    """An optimizer searched again on another contraction returns a tree
    of that contraction (``auto`` reuses one per thread); the reference
    returns the earlier, better-scored tree of the first one."""
    opt = ctt.HyperOptimizer(methods=[SEEDED], max_repeats=3, seed=1)
    small = ctt.rand_equation(8, 3, seed=0)
    large = ctt.rand_equation(30, 3, seed=1)
    assert opt.search(small[0], small[1], small[3]).N == 8
    assert opt.search(large[0], large[1], large[3]).N == 30
    ref = ctg.HyperOptimizer(methods=[SEEDED], max_repeats=3, seed=1)
    ref.search(small[0], small[1], small[3])
    assert ref.search(large[0], large[1], large[3]).N == 8
    for n, seed in ((14, 3), (20, 4)):
        inputs, output, _, size_dict = ctt.rand_equation(n, 3, seed=seed)
        assert ctt.auto_optimize.search(inputs, output, size_dict).N == n


def test_stopping_rules():
    inputs, output, _, size_dict = _net(12)
    opt = ctt.HyperOptimizer(methods=[SEEDED], max_repeats=50,
                             max_time="equil:3", seed=1)
    opt.search(inputs, output, size_dict)
    assert 3 <= len(opt.trials) < 50
    # the contraction is cheap at 1 GFLOP/s: one trial is enough
    opt = ctt.HyperOptimizer(methods=[SEEDED], max_repeats=50,
                             max_time="rate:1e9", seed=1)
    opt.search(inputs, output, size_dict)
    assert len(opt.trials) == 1
    opt = ctt.HyperOptimizer(methods=[SEEDED], max_repeats=50,
                             max_time=0.0, seed=1)
    with pytest.raises(RuntimeError, match="All hyper-optimizer trials"):
        opt.search(inputs, output, size_dict)
    with pytest.raises(ValueError, match="max_time"):
        ctt.HyperOptimizer(methods=[SEEDED], max_time="soon").search(
            inputs, output, size_dict
        )


# -- the disk-cached optimizer -----------------------------------------------------


def test_reusable_hyper_optimizer(tmp_path):
    inputs, output, _, size_dict = _net(14)
    probe = ctt.ContractionTree.from_path(
        inputs, output, size_dict, ssa_path=_port_seeded_greedy(
            inputs, output, size_dict, seed=1
        ),
    )
    kw = dict(
        directory=str(tmp_path), hash_method="b", methods=[SEEDED],
        max_repeats=4, optlib="random",
        slicing_opts={"target_size": max(probe.max_size() // 4, 2),
                      "seed": 1},
    )
    first = ctt.ReusableHyperOptimizer(seed=1, **kw)
    tree = first.search(inputs, output, size_dict)
    key = hash_contraction_b(inputs, output, size_dict) + "-flops"
    assert first.hash_query(inputs, output, size_dict) == key
    assert key in first._cache and len(first) == 1
    assert tree.sliced_inds
    # a hit, in a fresh optimizer on the same directory: no search
    again = ctt.ReusableHyperOptimizer(seed=1, **kw)
    hit = again.search(inputs, output, size_dict)
    assert again.last_opt is None
    assert hit.get_ssa_path() == tree.get_ssa_path()
    assert list(hit.sliced_inds) == list(tree.sliced_inds)
    assert again.ssa_path(inputs, output, size_dict) == tree.get_ssa_path()
    # overwrite="improved" searches again and keeps the better record
    cached = first._cache[key]["score"]
    better = ctt.ReusableHyperOptimizer(seed=2, overwrite="improved", **kw)
    got = better.search(inputs, output, size_dict)
    assert better.last_opt is not None
    new = better.last_opt.best_score
    kept = ctt.ReusableHyperOptimizer(seed=1, **kw)._cache[key]["score"]
    assert kept == min(cached, new)
    got_score = ctt.FlopsObjective()({"tree": got})
    assert math.isclose(got_score, kept)
    cache_only = ctt.ReusableHyperOptimizer(cache_only=True, **dict(
        kw, directory=str(tmp_path / "empty")))
    with pytest.raises(KeyError, match="cache_only"):
        cache_only.search(inputs, output, size_dict)
    first.cleanup()
    assert not tmp_path.exists() or not any(tmp_path.iterdir())


def test_reusable_random_greedy(tmp_path):
    inputs, output, _, size_dict = _net(12)
    opt = ctt.ReusableRandomGreedyOptimizer(
        directory=str(tmp_path), max_repeats=4, seed=3, accel=False
    )
    path = opt(inputs, output, size_dict)
    assert len(opt) == 1
    again = ctt.ReusableRandomGreedyOptimizer(
        directory=str(tmp_path), max_repeats=4, seed=3, accel=False
    )
    assert again(inputs, output, size_dict) == path
    assert again.last_opt is None


# -- the compressed hyper-optimizer ------------------------------------------------


def test_hyper_compressed_optimizer():
    inputs, output, shapes, size_dict = ctt.lattice_equation([6, 6], d_min=4)
    opt = ctt.HyperCompressedOptimizer(chi=16, max_repeats=4, seed=3)
    tree = opt.search(inputs, output, size_dict)
    assert isinstance(tree, ContractionTreeCompressed)
    assert tree.is_complete()
    assert opt.minimize == "peak-compressed-16"
    assert math.isclose(
        opt.best_score,
        ctt.scoring.parse_minimize("peak-compressed-16")({"tree": tree}),
    )
    assert {t["method"] for t in opt.trials} <= {
        "greedy-compressed", "greedy-span"
    }
    # untruncated, the compressed path contracts to the exact value
    rng = np.random.default_rng(1)
    arrays = [rng.uniform(size=s) for s in shapes]
    got = tree.contract_compressed(arrays, chi=10**9, device="cpu")
    exp = np.asarray(ctg.einsum(inputs_output_to_eq(inputs, output),
                                *arrays, optimize="greedy"))
    assert_allclose(got.numpy(), exp, rtol=F64_RTOL)
    rtree = ctt.ReusableHyperCompressedOptimizer(
        chi=16, max_repeats=2, seed=3
    ).search(inputs, output, size_dict)
    assert isinstance(rtree, ContractionTreeCompressed)


# -- presets through the front end -------------------------------------------------


@pytest.mark.parametrize("preset", ["hyper", "hyper-greedy", "auto",
                                    "hyper-labels"])
def test_presets_through_einsum(preset):
    inputs, output, shapes, _ = ctt.rand_equation(14, 3, n_out=2, seed=4)
    assert ctt.estimate_optimal_hardness(inputs) >= 250
    rng = np.random.default_rng(0)
    arrays = [rng.normal(size=s) for s in shapes]
    eq = inputs_output_to_eq(inputs, output)
    got = ctt.einsum(eq, *arrays, optimize=preset, device="cpu")
    exp = np.einsum(eq, *arrays, optimize="greedy")
    assert_allclose(got.numpy(), exp, rtol=F64_RTOL)


def test_hyper_presets_registered():
    presets = set(ctt.list_presets())
    assert {"hyper", "hyper-compressed", "hyper-256", "hyper-greedy",
            "hyper-labels", "hyper-kahypar", "hyper-balanced",
            "hyper-spinglass", "hyper-betweenness"} <= presets
    inputs, output, _, size_dict = ctt.lattice_equation([4, 4], d_min=2)
    tree = ctt.array_contract_tree(inputs, output, size_dict=size_dict,
                                   optimize="hyper-compressed")
    assert isinstance(tree, ContractionTreeCompressed)
    # without the kahypar package a trial that reaches the partitioner
    # fails with ImportError, as the reference's does: on 49 tensors,
    # above every cutoff of the method's space, every trial does
    big = ctt.lattice_equation([7, 7], d_min=2)
    for pkg in (ctt, ctg):
        with pytest.warns(UserWarning, match="kahypar is not installed"):
            with pytest.raises(RuntimeError, match="kahypar"):
                pkg.array_contract_tree(big[0], big[1], size_dict=big[3],
                                        optimize="hyper-kahypar")
    path = ctt.hyper_optimize(inputs, output, size_dict, max_repeats=2,
                              memory_limit=2**6)
    assert ctt.ContractionTree.from_path(
        inputs, output, size_dict, path=path
    ).is_complete()


# -- host pools --------------------------------------------------------------------


@pytest.mark.parametrize("parallel", ["threads:2", 2])
def test_pooled_search_gives_a_complete_tree(parallel):
    inputs, output, _, size_dict = _net(14)
    try:
        opt = ctt.HyperOptimizer(max_repeats=6, parallel=parallel, seed=1,
                                 reconf_opts={})
        tree = opt.search(inputs, output, size_dict)
        assert tree.is_complete() and len(opt.trials) == 6
        assert opt.best_score == min(t["score"] for t in opt.trials)
    finally:
        for pool in pools._CACHED_POOLS.values():
            pool.shutdown(wait=True)
        pools._CACHED_POOLS.clear()


def test_parse_parallel_arg():
    from concurrent.futures import ThreadPoolExecutor

    assert pools.parse_parallel_arg(False) is None
    assert pools.parse_parallel_arg(None) is None
    with ThreadPoolExecutor(1) as ex:
        assert pools.parse_parallel_arg(ex) is ex
    try:
        pool = pools.parse_parallel_arg("threads:3")
        assert pools.get_pool_size(pool) == 3
        assert pools.parse_parallel_arg("threads:3") is pool
        assert pools.submit(pool, sum, (1, 2)).result() == 3
    finally:
        for pool in pools._CACHED_POOLS.values():
            pool.shutdown(wait=True)
        pools._CACHED_POOLS.clear()
    with pytest.raises(ValueError, match="Unknown parallel backend"):
        pools.parse_parallel_arg("no-such-backend")
    with pytest.raises(ValueError, match="Can't interpret"):
        pools.parse_parallel_arg(2.5)
    for name in ("dask", "ray"):
        if importlib.util.find_spec(name) is None:
            with pytest.raises(ImportError, match=name):
                pools.parse_parallel_arg(name)
