"""The port's optional path finders against the JAX package's, on the
CPU: the flowcutter and quickbb adapters driven through the same fake
solver executables on ``PATH``, the kahypar adapter through the same
fake ``kahypar`` module (``tests/test_external_adapters.py``), igraph's
behaviour without the package, the opt_einsum adapter and preset
registry, the line graph's formats, and a seeded MCTS path. Where the
two packages can give the same path, they must."""

import importlib
import sys

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import cotengra_tpu as ctg
import cotengra_tpu.pathfinders.external as ref_external
import cotengra_tpu.pathfinders.kahypar as ref_kahypar_mod
from cotengra_tpu.pathfinders.mcts import (
    optimize_mcts_compressed as ref_mcts,
)

import cotengra_tpu_torch as ctt
import cotengra_tpu_torch.pathfinders.external as external
import cotengra_tpu_torch.pathfinders.kahypar as kahypar_mod
from cotengra_tpu_torch.pathfinders.igraph import igraph_available
from cotengra_tpu_torch.pathfinders.mcts import optimize_mcts_compressed
from cotengra_tpu_torch.utils.symbols import inds_to_eq

# the fake solvers and the fake kahypar module of the JAX package's
# adapter tests, so that both packages meet the same protocols
from test_external_adapters import (  # noqa: E402
    _fake_partition,
    _FakeContext,
    _FakeHypergraph,
    fake_solvers,  # noqa: F401 (a fixture)
)

torch.set_num_threads(1)


def _check_and_contract(inputs, output, shapes, size_dict, path, seed=0):
    """The path builds a complete port tree whose float64 value equals
    numpy's."""
    tree = ctt.ContractionTree.from_path(inputs, output, size_dict,
                                         path=path)
    assert tree.is_complete()
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=s) for s in shapes]
    got = tree.contract(arrays, device="cpu", plane_dtype=torch.float64)
    exp = np.einsum(inds_to_eq(inputs, output), *arrays, optimize=True)
    assert_allclose(got.numpy(), exp, rtol=1e-8)
    return tree


@pytest.mark.parametrize("solver", ["flowcutter", "quickbb"])
@pytest.mark.parametrize("seed", [2, 4])
def test_tree_decomposition_adapters_match_the_reference(fake_solvers,
                                                         solver, seed):
    assert getattr(external, f"{solver}_available")()
    inputs, output, shapes, size_dict = ctg.rand_equation(
        10, 3, seed=seed, d_min=2, d_max=3
    )
    fn = getattr(external, f"optimize_{solver}")
    ref_fn = getattr(ref_external, f"optimize_{solver}")
    path = fn(inputs, output, size_dict, max_time=5)
    assert path == ref_fn(inputs, output, size_dict, max_time=5)
    assert fn(inputs, output, size_dict, max_time=5, use_ssa=True) == (
        ref_fn(inputs, output, size_dict, max_time=5, use_ssa=True)
    )
    _check_and_contract(inputs, output, shapes, size_dict, path)


@pytest.mark.parametrize("cls", ["FlowCutterOptimizer", "QuickBBOptimizer"])
def test_solver_optimizers_through_the_front_end(fake_solvers, cls):
    inputs, output, shapes, size_dict = ctg.rand_equation(
        8, 3, seed=3, d_min=2, d_max=3
    )
    tree = ctt.array_contract_tree(
        inputs, output, size_dict=size_dict,
        optimize=getattr(ctt, cls)(max_time=5),
    )
    assert tree.is_complete()
    ref = ctg.array_contract_tree(
        inputs, output, size_dict=size_dict,
        optimize=getattr(ctg, cls)(max_time=5),
    )
    assert tree.get_path() == ref.get_path()
    _check_and_contract(inputs, output, shapes, size_dict, tree.get_path())
    preset = "flowcutter-2" if cls.startswith("Flow") else "quickbb-2"
    assert ctt.array_contract_path(inputs, output, size_dict=size_dict,
                                   optimize=preset, cache=False) == tuple(
        ctg.array_contract_path(inputs, output, size_dict=size_dict,
                                optimize=preset, cache=False)
    )


def test_external_presets_without_binaries(monkeypatch, tmp_path):
    """Without the binaries the presets are registered all the same and
    fail at search time naming the executable, as the reference's."""
    monkeypatch.setenv("PATH", str(tmp_path))
    assert not external.flowcutter_available()
    assert not external.quickbb_available()
    presets = set(ctt.list_presets())
    for t in (2, 10, 60):
        assert {f"flowcutter-{t}", f"quickbb-{t}"} <= presets
    inputs, output, _, size_dict = ctg.rand_equation(8, 3, seed=0)
    for preset, match in (("flowcutter-2", "flow_cutter"),
                          ("quickbb-2", "quickbb")):
        with pytest.raises(RuntimeError, match=match):
            ctt.array_contract_tree(inputs, output, size_dict=size_dict,
                                    optimize=preset)


# -- kahypar -------------------------------------------------------------


@pytest.fixture
def fake_kahypar(tmp_path, monkeypatch):
    """Both packages' kahypar adapters reloaded over the same fake
    ``kahypar`` module, then restored to the real (absent) state."""
    import types

    mod = types.ModuleType("kahypar")
    mod.Hypergraph = _FakeHypergraph
    mod.Context = _FakeContext
    mod.partition = _fake_partition
    pkg_dir = tmp_path / "kahypar"
    (pkg_dir / "config").mkdir(parents=True)
    (pkg_dir / "config" / "cut_rKaHyPar_sea20.ini").write_text("# ini\n")
    mod.__file__ = str(pkg_dir / "__init__.py")
    monkeypatch.setitem(sys.modules, "kahypar", mod)
    for adapter in (kahypar_mod, ref_kahypar_mod):
        importlib.reload(adapter)
        adapter._default_profile.cache_clear()
        assert adapter.kahypar_available()
    yield kahypar_mod, ref_kahypar_mod
    monkeypatch.delitem(sys.modules, "kahypar")
    for adapter in (kahypar_mod, ref_kahypar_mod):
        importlib.reload(adapter)


def test_kahypar_partition_matches_the_reference(fake_kahypar):
    port, ref = fake_kahypar
    inputs, output, shapes, size_dict = ctg.lattice_equation([4, 4],
                                                             d_min=2)
    for parts in (2, 4):
        membership = port.kahypar_partition(
            list(range(len(inputs))), inputs, size_dict, parts=parts, seed=0
        )
        assert membership == ref.kahypar_partition(
            list(range(len(inputs))), inputs, size_dict, parts=parts, seed=0
        )
        assert set(membership) <= set(range(parts))
        assert len(set(membership)) >= 2


@pytest.mark.parametrize("agglom", [False, True])
def test_kahypar_paths_match_the_reference(fake_kahypar, agglom):
    port, ref = fake_kahypar
    inputs, output, shapes, size_dict = ctg.rand_equation(
        12, 3, seed=5, d_min=2, d_max=3
    )
    opts = dict(parts=2, cutoff=4, agglom=agglom, seed=0)
    path = port.optimize_kahypar(inputs, output, size_dict, **opts)
    assert path == ref.optimize_kahypar(inputs, output, size_dict, **opts)
    _check_and_contract(inputs, output, shapes, size_dict, path)


def test_kahypar_hyper_methods(fake_kahypar):
    port, _ = fake_kahypar
    assert port.register_kahypar_hyper_methods()
    fns = ctt.list_hyper_functions()
    assert {"kahypar", "kahypar-balanced", "kahypar-agglom"} <= set(fns)
    opt = ctt.HyperOptimizer(methods=["kahypar"], max_repeats=4,
                             parallel=False, seed=0)
    inputs, output, shapes, size_dict = ctg.rand_equation(
        10, 3, seed=6, d_min=2, d_max=3
    )
    tree = opt.search(inputs, output, size_dict)
    assert tree.is_complete()


def test_kahypar_without_the_package():
    assert not kahypar_mod.kahypar_available()
    assert ctt.path_kahypar is kahypar_mod
    with pytest.raises(ImportError, match="kahypar"):
        kahypar_mod.kahypar_partition([0, 1], [("a",), ("a",)], {"a": 2})


# -- igraph -------------------------------------------------------------------


def test_igraph_methods_register_and_fail_without_the_package():
    """``tests/test_periphery.py``'s igraph check: the methods register
    anyway and every trial fails with ImportError, surfaced in the
    all-trials-failed error."""
    assert ctt.path_igraph.igraph_available() == igraph_available()
    fns = set(ctt.list_hyper_functions())
    assert {"spinglass", "infomap", "labelprop", "multilevel",
            "eigenvector", "betweenness", "walktrap", "fastgreedy"} <= fns
    if igraph_available():
        pytest.skip("python-igraph is installed")
    inputs, output, _, size_dict = ctg.rand_equation(8, 3, seed=0)
    with pytest.warns(UserWarning, match="igraph"):
        with pytest.raises(RuntimeError, match="igraph"):
            ctt.array_contract_tree(inputs, output, size_dict=size_dict,
                                    optimize="hyper-spinglass")
    with pytest.raises(ImportError, match="igraph"):
        ctt.path_igraph.optimize_igraph(inputs, output, size_dict)


# -- opt_einsum ---------------------------------------------------------------


def test_opt_einsum_interop():
    oe = pytest.importorskip("opt_einsum")
    from cotengra_tpu_torch.oe import HAS_OPT_EINSUM, OEPathOptimizer

    assert HAS_OPT_EINSUM
    rng = np.random.default_rng(0)
    x, y, z = (rng.normal(size=(8, 9)), rng.normal(size=(9, 10)),
               rng.normal(size=(10, 8)))
    opt = OEPathOptimizer(ctt.GreedyOptimizer())
    assert isinstance(opt, oe.paths.PathOptimizer)
    got = oe.contract("ab,bc,ca->", x, y, z, optimize=opt)
    assert_allclose(got, np.einsum("ab,bc,ca->", x, y, z), rtol=1e-8)


def test_opt_einsum_preset_registration():
    oe = pytest.importorskip("opt_einsum")
    names = ctt.register_opt_einsum_presets(prefix="cotengra-torch-")
    assert "cotengra-torch-greedy" in names
    # a second call registers nothing new and does not raise
    ctt.register_opt_einsum_presets(prefix="cotengra-torch-")
    rng = np.random.default_rng(1)
    x, y = rng.normal(size=(4, 5)), rng.normal(size=(5, 6))
    got = oe.contract("ab,bc->ac", x, y, optimize="cotengra-torch-greedy")
    assert_allclose(got, x @ y, rtol=1e-8)


# -- line graph ---------------------------------------------------------------


def test_linegraph_formats_match_the_reference():
    from cotengra_tpu.pathfinders import linegraph as ref_lg

    from cotengra_tpu_torch.pathfinders.linegraph import (
        LineGraph,
        elimination_order_to_edge_path,
        td_str_to_elimination_order,
    )

    inputs = [("a", "b"), ("b", "c"), ("c", "a")]
    lg = LineGraph(inputs, ())
    assert lg.to_gr_str().startswith("p tw 3 3")
    assert lg.to_cnf_str().startswith("p cnf 3 3")
    td = "s td 2 2 3\nb 1 1 2\nb 2 2 3\n1 2\n"
    order = td_str_to_elimination_order(td)
    assert sorted(order) == [0, 1, 2]
    assert order == ref_lg.td_str_to_elimination_order(td)
    inputs, output, _, _ = ctg.rand_equation(12, 3, n_out=2, seed=1)
    lg, ref = LineGraph(inputs, output), ref_lg.LineGraph(inputs, output)
    assert lg.to_gr_str() == ref.to_gr_str()
    assert lg.to_cnf_str() == ref.to_cnf_str()
    order = list(range(lg.num_vertices))[::-1]
    assert elimination_order_to_edge_path(order, lg, output) == (
        ref_lg.elimination_order_to_edge_path(order, ref, output)
    )


# -- MCTS ---------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_mcts_seeded_path_matches_the_reference(seed, monkeypatch):
    """The same seed gives the reference's path (the compressed scoring
    in pure Python on both sides)."""
    import cotengra_tpu.tree as ref_tree_mod

    import cotengra_tpu_torch.tree as port_tree_mod

    for mod in (ref_tree_mod, port_tree_mod):
        monkeypatch.setattr(mod, "_get_native_replay", lambda a: None)
    inputs, output, _, size_dict = ctg.lattice_equation([3, 4], d_min=2)
    opts = dict(chi=4, num_simulations=12, seed=seed)
    path = optimize_mcts_compressed(inputs, output, size_dict, **opts)
    assert path == ref_mcts(inputs, output, size_dict, **opts)
    ssa = optimize_mcts_compressed(inputs, output, size_dict, use_ssa=True,
                                   **opts)
    assert ssa == ref_mcts(inputs, output, size_dict, use_ssa=True, **opts)
    tree = ctt.ContractionTreeCompressed.from_path(inputs, output,
                                                   size_dict, path=path)
    assert tree.is_complete()
    assert "mcts" not in " ".join(ctt.list_presets())
    assert not any("mcts" in m for m in ctt.list_hyper_functions())
