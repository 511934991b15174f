"""The port's ctgpart partitioner (``pathfinders/partition.py``) and the
hyper-optimizer's default methods against the JAX package's, on the
CPU, where ``g++`` builds both native libraries: seeded
``optimize_ctgpart`` paths equal to the reference's (tolerance 0), the
three hyper methods with the reference's spaces, the default methods,
a default ``HyperOptimizer`` search held to invariants (its greedy and
ctgpart trials are unseeded, in both packages) and to the reference's
float64 value at rtol 1e-10, tree quality against random paths, and the
build error where the library cannot build."""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import cotengra_tpu as ctg
import cotengra_tpu.hyper.driver as ref_driver
from cotengra_tpu.pathfinders.partition import (
    optimize_ctgpart as ref_optimize_ctgpart,
)

import cotengra_tpu_torch as ctt
from cotengra_tpu_torch.hyper import driver
from cotengra_tpu_torch.ops import _build, native
from cotengra_tpu_torch.pathfinders.partition import (
    ctgpart_available,
    optimize_ctgpart,
)

torch.set_num_threads(1)

F64_RTOL = 1e-10
METHODS = ("ctgpart", "ctgpart-balanced", "ctgpart-agglom")
SEEDED = "test-seeded-ctgpart"


def _circuit(n=36, depth=10, seed=3):
    """An absorbed random circuit (one amplitude) whose greedy tree
    outgrows 2^20, so that slicing to 2^20 has work to do."""
    inputs, output, _, _, arrays = ctt.rand_circuit_tn(n, depth, seed=seed)
    inputs, arrays = ctt.absorb_simple_tensors(
        inputs, arrays, output, max_rank=2, max_absorb_size=2**12
    )
    arrays = [np.asarray(a, np.complex128) for a in arrays]
    size_dict = {
        ix: int(d) for t, a in zip(inputs, arrays) for ix, d in zip(t, a.shape)
    }
    return inputs, output, size_dict, arrays


@pytest.mark.parametrize("weight_edges", ["log", "linear", "unit"])
@pytest.mark.parametrize("agglom", [False, True])
def test_optimize_ctgpart_matches_reference(agglom, weight_edges):
    inputs, output, _, size_dict = ctg.rand_equation(
        50, 3, n_out=2, n_hyper_in=1, seed=4, d_max=3
    )
    for seed in range(3):
        kw = dict(seed=seed, agglom=agglom, weight_edges=weight_edges,
                  parts=3, imbalance=0.05, cutoff=12)
        for use_ssa in (True, False):
            assert optimize_ctgpart(
                inputs, output, size_dict, use_ssa=use_ssa, **kw
            ) == ref_optimize_ctgpart(
                inputs, output, size_dict, use_ssa=use_ssa, **kw
            )


def test_hyper_methods_registered_with_the_reference_spaces():
    for name in METHODS:
        assert name in ctt.list_hyper_functions()
        assert driver._HYPER_SPACES[name] == ref_driver._HYPER_SPACES[name]
        assert driver._HYPER_CONSTANTS[name] == (
            ref_driver._HYPER_CONSTANTS[name]
        )
    assert driver._HYPER_CONSTANTS["ctgpart-balanced"] == {"parts": 2}
    assert driver._HYPER_CONSTANTS["ctgpart-agglom"] == {"agglom": True}
    # a method's trial: the seeded registered function gives the
    # reference's path
    inputs, output, _, size_dict = ctg.rand_equation(30, 3, seed=1)
    for name in METHODS:
        kw = dict(driver._HYPER_CONSTANTS[name], seed=5)
        assert driver._HYPER_FNS[name](
            inputs, output, size_dict, **kw
        ) == ref_driver._HYPER_FNS[name](inputs, output, size_dict, **kw)


def test_default_methods_are_the_references():
    assert ctgpart_available()
    assert driver._default_methods() == ["greedy", "ctgpart"]
    assert ref_driver._default_methods() == ["greedy", "ctgpart"]
    assert ctt.HyperOptimizer()._methods == ["greedy", "ctgpart"]


def test_default_search_invariants_and_value():
    """``HyperOptimizer()`` with no methods, sliced to 2^20: both
    packages' searches are unseeded, so the trees are held to invariants
    and their float64 values to each other."""
    inputs, output, size_dict, arrays = _circuit()
    target = 2**20
    assert ctt.array_contract_tree(
        inputs, output, size_dict=size_dict, optimize="greedy"
    ).max_size() > target
    opts = dict(max_repeats=4, slicing_reconf_opts={"target_size": target},
                parallel=False)
    opt = ctt.HyperOptimizer(**opts)
    tree = opt.search(inputs, output, size_dict)
    assert opt._methods == ["greedy", "ctgpart"]
    assert {t["method"] for t in opt.trials} <= {"greedy", "ctgpart"}
    assert tree.is_complete()
    assert tree.max_size() <= target and tree.multiplicity > 1
    got = ctt.contract_tree(
        tree, arrays, device="cpu", plane_dtype=torch.float64
    )
    ref_tree = ctg.HyperOptimizer(**opts).search(inputs, output, size_dict)
    exp = np.asarray(ref_tree.contract(arrays))
    assert tuple(got.shape) == exp.shape
    assert_allclose(got.numpy(), exp, rtol=F64_RTOL)


def test_seeded_ctgpart_search_matches_reference():
    """A whole sliced search on a seeded ctgpart method, registered alike
    in both packages: the native partitioner, greedy sub-paths and the
    native DP of reconfiguration give the reference's tree."""
    space = dict(ref_driver._HYPER_SPACES["ctgpart"])

    def port_fn(inputs, output, size_dict, **params):
        return optimize_ctgpart(
            inputs, output, size_dict, use_ssa=True, **params
        )

    def ref_fn(inputs, output, size_dict, **params):
        return ref_optimize_ctgpart(
            inputs, output, size_dict, use_ssa=True, **params
        )

    ctt.register_hyper_function(SEEDED, port_fn, space, {"seed": 7})
    ctg.register_hyper_function(SEEDED, ref_fn, space, {"seed": 7})
    try:
        inputs, output, size_dict, _ = _circuit(24, 10, seed=1)
        target = ctt.array_contract_tree(
            inputs, output, size_dict=size_dict, optimize="greedy"
        ).max_size() // 8
        # the slice finder draws unseeded noise unless its temperature
        # is 0
        opts = dict(methods=[SEEDED], max_repeats=6, seed=2,
                    optlib="random", parallel=False,
                    slicing_reconf_opts={"target_size": target,
                                         "temperature": 0})
        tree = ctt.HyperOptimizer(**opts).search(inputs, output, size_dict)
        ref = ctg.HyperOptimizer(**opts).search(inputs, output, size_dict)
        assert list(tree.children.items()) == list(ref.children.items())
        assert list(tree.sliced_inds) == list(ref.sliced_inds)
        assert tree.max_size() <= target
    finally:
        for mod in (driver, ref_driver):
            for registry in (mod._HYPER_FNS, mod._HYPER_SPACES,
                             mod._HYPER_CONSTANTS):
                registry.pop(SEEDED, None)


def test_ctgpart_tree_beats_random():
    inputs, output, _, size_dict = ctg.rand_equation(70, 3, seed=3, d_max=3)
    tree = ctt.ContractionTree.from_path(
        inputs, output, size_dict,
        ssa_path=optimize_ctgpart(
            inputs, output, size_dict, seed=0, use_ssa=True
        ),
    )
    assert tree.is_complete()
    rtree = ctt.ContractionTree.from_path(
        inputs, output, size_dict,
        ssa_path=ctt.optimize_random(
            inputs, output, size_dict, seed=0, use_ssa=True
        ),
    )
    assert tree.total_flops(log=10) < rtree.total_flops(log=10)


def test_ctgpart_raises_the_build_error(monkeypatch, tmp_path):
    """Where the library cannot build, ctgpart raises the compiler's
    error (the reference would run label propagation instead), and the
    default methods fall back to greedy + labels."""
    missing = tmp_path / "no-such-g++"
    monkeypatch.setattr(_build, "HOST_CXX", str(missing))
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "build")
    native._load.cache_clear()
    try:
        inputs, output, _, size_dict = ctg.rand_equation(20, 3, seed=1)
        with pytest.raises(RuntimeError, match="no-such-g"):
            optimize_ctgpart(inputs, output, size_dict, seed=0)
        with pytest.raises(RuntimeError, match="no-such-g"):
            driver._HYPER_FNS["ctgpart"](inputs, output, size_dict, seed=0)
        assert not ctgpart_available()
        assert driver._default_methods() == ["greedy", "labels"]
    finally:
        native._load.cache_clear()
