"""The port's native planning library (``cotengra_tpu_torch/ops/native``,
built by ``ops/_build.py`` from the port's own ``kernels.cpp``) against
the JAX package's (``cotengra_tpu/ops/native``), both built here with
``g++``: seeded greedy, random-greedy, optimal DP, compressed replay and
partitioner calls return exactly the reference's result (tolerance 0;
the random-greedy log10 flops, a double, at 1e-12). Also the ``accel``
dispatch of ``pathfinders/basic.py``, the native optimal DP against the
port's pure-Python one (the same objective), the fallback past the DP's
62-term bitmask, a build that fails, and concurrent builds."""

import math
import random
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import cotengra_tpu as ctg
from cotengra_tpu.ops import native as ref_native

import cotengra_tpu_torch as ctt
import cotengra_tpu_torch.pathfinders.basic as port_basic
from cotengra_tpu_torch.ops import _build
from cotengra_tpu_torch.ops import native

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
LOG10_FLOPS_ATOL = 1e-12


@pytest.fixture
def broken_compiler(monkeypatch, tmp_path):
    """The library as a process sees it where the host compiler is
    missing: a compiler path that does not exist, an empty build
    directory, and the load cache emptied before and after."""
    monkeypatch.setattr(_build, "HOST_CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "build")
    native._load.cache_clear()
    yield tmp_path / "no-such-g++"
    native._load.cache_clear()


def _rand(seed, n=30):
    inputs, output, _, size_dict = ctg.rand_equation(
        n, 3, n_out=2, n_hyper_in=1, seed=seed
    )
    return inputs, output, size_dict


def test_library_builds_into_the_checkout():
    assert native.is_available(), native.build_error()
    assert native.build_error() is None
    path = Path(native.library()._name)
    assert path.parent == ROOT / "build" / "cotengra_tpu_torch"
    assert path == _build.host_library_path(native._SRC)
    assert native._SRC == (
        ROOT / "cotengra_tpu_torch" / "ops" / "native" / "kernels.cpp"
    )


# -- seeded calls: the reference's results, exactly ------------------------


@pytest.mark.parametrize("temperature", [0.0, 0.3])
@pytest.mark.parametrize("seed", range(4))
def test_greedy_matches_reference(seed, temperature):
    inputs, output, size_dict = _rand(seed)
    kw = dict(temperature=temperature, seed=seed)
    for use_ssa in (True, False):
        got = native.optimize_greedy(
            inputs, output, size_dict, use_ssa=use_ssa, **kw
        )
        assert got == ref_native.optimize_greedy(
            inputs, output, size_dict, use_ssa=use_ssa, **kw
        )
    # through the path finder's default accel, and through a Random
    assert ctt.optimize_greedy(inputs, output, size_dict, **kw) == (
        ctg.optimize_greedy(inputs, output, size_dict, **kw)
    )
    got = ctt.optimize_greedy(
        inputs, output, size_dict, temperature=temperature,
        seed=random.Random(seed),
    )
    assert got == ctg.optimize_greedy(
        inputs, output, size_dict, temperature=temperature,
        seed=random.Random(seed),
    )


@pytest.mark.parametrize("seed", range(4))
def test_random_greedy_matches_reference(seed):
    inputs, output, size_dict = _rand(seed)
    kw = dict(ntrials=8, seed=seed, use_ssa=True)
    path, lf = native.optimize_random_greedy_track_flops(
        inputs, output, size_dict, **kw
    )
    ref_path, ref_lf = ref_native.optimize_random_greedy_track_flops(
        inputs, output, size_dict, **kw
    )
    assert path == ref_path
    assert abs(lf - ref_lf) <= LOG10_FLOPS_ATOL
    tree = ctt.ContractionTree.from_path(
        inputs, output, size_dict, ssa_path=path
    )
    assert abs(tree.total_flops(log=10) - lf) <= 1e-9
    # the optimizer's batches on the native finder, seeds drawn alike
    rg = dict(max_repeats=6, seed=seed)
    assert ctt.RandomGreedyOptimizer(**rg).ssa_path(
        inputs, output, size_dict
    ) == ctg.RandomGreedyOptimizer(**rg).ssa_path(inputs, output, size_dict)


MINIMIZE = ["flops", "max", "size", "write", "combo-64", "limit-64"]


@pytest.mark.parametrize("search_outer", [False, True])
@pytest.mark.parametrize("minimize", MINIMIZE)
def test_optimal_matches_reference(minimize, search_outer):
    for seed in range(4):
        inputs, output, size_dict = _rand(seed, n=10)
        kw = dict(minimize=minimize, search_outer=search_outer)
        for use_ssa in (True, False):
            got = native.optimize_optimal(
                inputs, output, size_dict, use_ssa=use_ssa, **kw
            )
            assert got == ref_native.optimize_optimal(
                inputs, output, size_dict, use_ssa=use_ssa, **kw
            )
        # the path finder's default accel gives the native DP's path
        assert ctt.optimize_optimal(
            inputs, output, size_dict, use_ssa=True, **kw
        ) == native.optimize_optimal(
            inputs, output, size_dict, use_ssa=True, **kw
        )


def _dp_objective(tree, minimize):
    """What the DP minimizes, summed (or maxed) over the tree's steps."""
    additive, step = port_basic.dp_cost_fn(minimize)
    costs = [
        step(tree.get_flops(p), tree.get_size(p))
        for p, _, _ in tree.traverse()
    ]
    return sum(costs) if additive else max(costs)


@pytest.mark.parametrize("minimize", MINIMIZE)
def test_native_optimal_has_the_python_cost(minimize):
    """The native and the pure-Python DP may break ties otherwise, but
    reach the same objective exactly (integer sizes)."""
    for seed in range(6):
        inputs, output, size_dict = _rand(seed, n=10)
        trees = [
            ctt.ContractionTree.from_path(
                inputs, output, size_dict,
                ssa_path=ctt.optimize_optimal(
                    inputs, output, size_dict, minimize=minimize,
                    use_ssa=True, accel=accel,
                ),
            )
            for accel in (True, False)
        ]
        assert _dp_objective(trees[0], minimize) == _dp_objective(
            trees[1], minimize
        )


def test_optimal_falls_back_past_62_terms(monkeypatch):
    """A ring of 64 matrices is one component past the bitmask's 62
    terms: the library returns -2 and the pure-Python DP answers, as in
    the reference."""
    n = 64
    inputs = [(f"i{k}", f"i{(k + 1) % n}") for k in range(n)]
    size_dict = {f"i{k}": 2 + k % 3 for k in range(n)}
    offsets, flat, sizes, out = native._marshal(inputs, (), size_dict)
    buf = np.empty(2 * (4 * n + 16), dtype=np.int32)
    assert native.library().ctg_optimize_optimal(
        n, native._i32p(offsets), native._i32p(flat), len(sizes),
        native._f64p(sizes), native._i32p(out), len(out), 0, 64.0, 2.0,
        0, 1, native._i32p(buf),
    ) == -2
    calls = []
    python_dp = port_basic.optimize_optimal

    def spy(*args, **kwargs):
        calls.append(kwargs.get("accel"))
        return python_dp(*args, **kwargs)

    monkeypatch.setattr(port_basic, "optimize_optimal", spy)
    got = native.optimize_optimal(inputs, (), size_dict, use_ssa=True)
    assert calls == [False]
    assert got == python_dp(inputs, (), size_dict, use_ssa=True, accel=False)
    assert got == ref_native.optimize_optimal(
        inputs, (), size_dict, use_ssa=True
    )


@pytest.mark.parametrize("compress_late", [False, True])
def test_compressed_stats_match_reference(compress_late):
    inputs, output, _, size_dict = ctg.lattice_equation([6, 6], d_min=4)
    for seed in range(3):
        ssa = ctg.optimize_greedy(
            inputs, output, size_dict, use_ssa=True, temperature=0.5,
            seed=seed,
        )
        tree = ctt.ContractionTreeCompressed.from_path(
            inputs, output, size_dict, ssa_path=ssa
        )
        tree_map = dict(zip(tree.gen_leaves(), range(tree.N)))
        pairs = []
        for nid, (p, l, r) in enumerate(
            tree.traverse("surface_order"), tree.N
        ):
            pairs.extend((tree_map[l], tree_map[r]))
            tree_map[p] = nid
        for chi in (4, 16, 10**9):
            got = native.compressed_stats(
                inputs, output, size_dict, pairs, chi, compress_late
            )
            assert got == ref_native.compressed_stats(
                inputs, output, size_dict, pairs, chi, compress_late
            )
            # the tree's replay takes the library (accel="auto")
            stats = tree.compressed_contract_stats(
                chi=chi, compress_late=compress_late
            )
            assert (stats.flops, stats.write, stats.max_size,
                    stats.peak_size) == got


@pytest.mark.parametrize("parts", [2, 3, 8, 16])
def test_partition_matches_reference(parts):
    from cotengra_tpu.pathfinders.partition import (
        ctgpart_partition as ref_partition,
    )

    from cotengra_tpu_torch.pathfinders.partition import ctgpart_partition

    inputs, _, _, size_dict = ctg.rand_equation(60, 3, seed=2, d_max=3)
    subset = list(range(len(inputs)))
    for seed in range(3):
        got = ctgpart_partition(
            subset, inputs, size_dict, parts=parts, seed=seed
        )
        assert got == ref_partition(
            subset, inputs, size_dict, parts=parts, seed=seed
        )
        assert set(got) == set(range(parts))
    # the raw call: hyperedges over 5 nodes, weighted
    args = ([0, 2, 5, 7], [0, 1, 1, 2, 3, 3, 4], [1.0, 2.0, 1.5],
            [1.0] * 5, 2, 0.1, 7)
    assert list(native.partition(*args)) == list(ref_native.partition(*args))


# -- accel dispatch -------------------------------------------------------------


def test_accel_dispatch():
    assert port_basic._get_native(True) is native
    assert port_basic._get_native("auto") is native
    assert port_basic._get_native(False) is None
    assert port_basic._get_native(None) is None
    with pytest.raises(ValueError, match="accel"):
        port_basic._get_native("no-such")
    inputs, output, size_dict = _rand(1)
    kw = dict(temperature=0.3, seed=2)
    for accel in (True, "auto"):
        assert ctt.optimize_greedy(
            inputs, output, size_dict, accel=accel, **kw
        ) == native.optimize_greedy(inputs, output, size_dict, **kw)
    assert ctt.optimize_greedy(
        inputs, output, size_dict, accel=False, **kw
    ) == ctg.optimize_greedy(inputs, output, size_dict, accel=False, **kw)
    # the optimizers hand their accel on
    small = _rand(3, n=9)
    for accel in (True, False):
        assert ctt.OptimalOptimizer(accel=accel).ssa_path(*small) == (
            ctt.optimize_optimal(*small, accel=accel, use_ssa=True)
        )


def test_failed_build_keeps_its_error(broken_compiler):
    assert not native.is_available()
    err = native.build_error()
    assert isinstance(err, RuntimeError)
    assert str(broken_compiler) in str(err)
    # both attempts, with and without -march=native, are reported
    assert str(err).count(str(broken_compiler)) >= 2
    # "auto" plans in pure Python, True raises the compiler's message
    inputs, output, size_dict = _rand(0)
    assert port_basic._get_native("auto") is None
    assert ctt.optimize_greedy(inputs, output, size_dict) == (
        ctg.optimize_greedy(inputs, output, size_dict, accel=False)
    )
    for fn in (ctt.optimize_greedy, ctt.optimize_optimal):
        with pytest.raises(RuntimeError, match="no-such-g"):
            fn(inputs[:6], output, size_dict, accel=True)
    with pytest.raises(RuntimeError, match="no-such-g"):
        native.optimize_greedy(inputs, output, size_dict)


_CONCURRENT = textwrap.dedent(
    """
    import sys
    from pathlib import Path
    sys.path.insert(0, {root!r})
    from cotengra_tpu_torch.ops import _build, native

    _build.build_dir = lambda: Path({build!r})
    lib = native.library()
    print("LOADED", lib._name)
    """
)


def test_concurrent_builds_load_one_library(tmp_path):
    """Two processes building at once into an empty build directory: one
    compiles under the file lock, both load the same finished library,
    and nothing half-written is left behind."""
    build = tmp_path / "build"
    code = _CONCURRENT.format(root=str(ROOT), build=str(build))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", code], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        )
        for _ in range(2)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err
    loaded = {out.split("LOADED ", 1)[1].strip() for out, _ in outs}
    assert loaded == {str(build / _build.host_library_path(
        native._SRC).name)}
    assert sorted(p.suffix for p in build.iterdir()) == [".lock", ".so"]


# -- sliced planning on native paths ------------------------------------------


def test_slice_and_reconfigure_on_native_paths():
    """The reference's sliced planning, with both packages' native
    finders and DP under it: the same tree from the same native path."""
    inputs, output, _, size_dict = ctg.lattice_equation([5, 5], d_min=4)
    ssa = ctt.optimize_greedy(inputs, output, size_dict, use_ssa=True)
    assert ssa == ctg.optimize_greedy(inputs, output, size_dict,
                                      use_ssa=True)
    tree = ctt.ContractionTree.from_path(
        inputs, output, size_dict, ssa_path=ssa
    )
    ref = ctg.ContractionTree.from_path(
        inputs, output, size_dict, ssa_path=ssa
    )
    target = max(tree.max_size() // 16, 2)
    tree.slice_and_reconfigure_(target, temperature=0)
    ref.slice_and_reconfigure_(target, temperature=0)
    assert list(tree.children.items()) == list(ref.children.items())
    assert list(tree.sliced_inds) == list(ref.sliced_inds)
    assert tree.multiplicity > 1 and tree.max_size() <= target
    assert math.isclose(tree.total_flops(), ref.total_flops(), rel_tol=0)
