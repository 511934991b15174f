"""The port's compressed (chi-capped) planner and contraction against the
JAX package's, on the CPU: the hypergraph, the compressed cost model
(integer stats equal), the objectives, the compressed path finders and
refiners (the same paths from the same seeds), and
``contract_compressed(device="cpu")`` on the same numpy inputs in
float64 (rtol 1e-10; stripped values |delta log10| <= 1e-6, where the
JAX package's float32 exponent sum may round away from the port's
float64 one); the port's stripped value past float32's range equals its
unstripped float64 one. Both packages' cost replays
run in pure Python (their native engines are patched out), except where
a test compares the two native replays (``accel=True``)."""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import cotengra_tpu as ctg
import cotengra_tpu.tree as ref_tree_mod
from cotengra_tpu.hypergraph import HyperGraph as RefHyperGraph
from cotengra_tpu.pathfinders import compressed as ref_pc
from cotengra_tpu.pathfinders.basic import optimize_greedy as ref_greedy
from cotengra_tpu.scoring import parse_minimize as ref_parse_minimize
from cotengra_tpu.tree_compressed import (
    ContractionTreeCompressed as RefTreeCompressed,
)

import cotengra_tpu_torch as ctt
import cotengra_tpu_torch.tree as port_tree_mod
from cotengra_tpu_torch import interface
from cotengra_tpu_torch.hypergraph import HyperGraph
from cotengra_tpu_torch.pathfinders import compressed as pc
from cotengra_tpu_torch.pathfinders.compressed_bb import (
    CompressedTreeRefiner,
)
from cotengra_tpu_torch.scoring import (
    CompressedStatsTrackerPeak,
    parse_minimize,
)
from cotengra_tpu_torch.tree_compressed import ContractionTreeCompressed
from cotengra_tpu_torch.utils.eqs import inputs_output_to_eq

torch.set_num_threads(1)

F64_RTOL = 1e-10
# the JAX package's float32 exponent sum against the port's float64 sum
# of the same scales
LOG10_ATOL = 1e-6
NATIVE_REPLAY = {port_tree_mod: port_tree_mod._get_native_replay,
                 ref_tree_mod: ref_tree_mod._get_native_replay}


@pytest.fixture(autouse=True)
def _pure_python_reference(monkeypatch):
    """Both packages' cost replays in pure Python."""
    for mod in NATIVE_REPLAY:
        monkeypatch.setattr(mod, "_get_native_replay", lambda a: None)
    interface.clear_caches()
    yield
    interface.clear_caches()


def _networks():
    """(name, inputs, output, size_dict): a lattice and two random
    equations with hyper and output indices."""
    nets = []
    inputs, output, _, size_dict = ctg.lattice_equation([5, 6], d_min=4)
    nets.append(("lattice5x6", inputs, output, size_dict))
    for seed in (1, 2):
        inputs, output, _, size_dict = ctg.rand_equation(
            12, 3, n_out=2, n_hyper_in=1, n_hyper_out=1, seed=seed
        )
        nets.append((f"rand{seed}", inputs, output, size_dict))
    return nets


NETWORKS = _networks()
NET_IDS = [n[0] for n in NETWORKS]


def _greedy_trees():
    """Three (port, reference) tree pairs from the same SSA paths."""
    pairs = []
    _, inputs, output, size_dict = NETWORKS[0]
    for kw in ({}, {"temperature": 0.5, "seed": 1}):
        ssa = ref_greedy(
            inputs, output, size_dict, use_ssa=True, accel=False, **kw
        )
        pairs.append((inputs, output, size_dict, ssa))
    _, inputs, output, size_dict = NETWORKS[1]
    ssa = ref_greedy(inputs, output, size_dict, use_ssa=True, accel=False)
    pairs.append((inputs, output, size_dict, ssa))
    return pairs


GREEDY_TREES = _greedy_trees()


def _trees(k):
    inputs, output, size_dict, ssa = GREEDY_TREES[k]
    tree = ContractionTreeCompressed.from_path(
        inputs, output, size_dict, ssa_path=ssa
    )
    ref = RefTreeCompressed.from_path(inputs, output, size_dict, ssa_path=ssa)
    return tree, ref


def _hg_state(hg):
    return hg.nodes, hg.edges, hg.size_dict, hg.node_counter


# -- hypergraph ------------------------------------------------------------


@pytest.mark.parametrize("net", NETWORKS, ids=NET_IDS)
def test_hypergraph_matches_reference(net):
    _, inputs, output, size_dict = net
    hg = HyperGraph(inputs, output, size_dict)
    ref = RefHyperGraph(inputs, output, size_dict)
    assert _hg_state(hg) == _hg_state(ref)
    assert hg.simple_centrality() == ref.simple_centrality()
    assert hg.simple_distance([0, 3]) == ref.simple_distance([0, 3])
    ssa = ref_greedy(inputs, output, size_dict, use_ssa=True, accel=False)
    ids = {i: i for i in range(len(inputs))}
    for c, (a, b) in enumerate(ssa, len(inputs)):
        i, j = ids.pop(a), ids.pop(b)
        for chi in (None, 2, 8, 10**9):
            assert hg.candidate_contraction_size(
                i, j, chi=chi
            ) == ref.candidate_contraction_size(i, j, chi=chi)
        assert hg.contract_pair_cost(i, j) == ref.contract_pair_cost(i, j)
        assert hg.neighborhood_compress_cost(
            8, (i, j)
        ) == ref.neighborhood_compress_cost(8, (i, j))
        k = hg.contract(i, j)
        assert k == ref.contract(i, j)
        chi = (2, 8)[c % 2]
        hg.compress(chi, edges=hg.get_node(k))
        ref.compress(chi, edges=ref.get_node(k))
        assert _hg_state(hg) == _hg_state(ref)
        ids[c] = k
        if hg.get_num_nodes() > 1:
            assert hg.simple_centrality() == ref.simple_centrality()
            assert hg.simple_distance([k]) == ref.simple_distance([k])
    # compress with no edges given: every multibond at once
    hg = HyperGraph(inputs, output, size_dict)
    ref = RefHyperGraph(inputs, output, size_dict)
    hg.contract(0, 1)
    ref.contract(0, 1)
    hg.compress(3)
    ref.compress(3)
    assert _hg_state(hg) == _hg_state(ref)


def test_get_hypergraph_accel():
    inputs, output, _, size_dict = ctt.lattice_equation([3, 3], d_min=2)
    assert ctt.get_hypergraph(inputs, output, size_dict).get_num_nodes() == 9
    # every accel gives the Python hypergraph, as the reference's does
    for accel in (True, "auto", None):
        hg = ctt.get_hypergraph(inputs, output, size_dict, accel=accel)
        assert type(hg) is HyperGraph
        assert _hg_state(hg) == _hg_state(
            ctg.get_hypergraph(inputs, output, size_dict, accel=accel)
        )
    with pytest.raises(ValueError, match="accel"):
        ctt.get_hypergraph(inputs, output, size_dict, accel="no-such")


# -- the compressed cost model ---------------------------------------------


@pytest.mark.parametrize("k", range(len(GREEDY_TREES)))
def test_compressed_stats_match_reference(k, monkeypatch):
    tree, ref = _trees(k)
    assert list(tree.traverse("surface_order")) == list(
        ref.traverse("surface_order")
    )
    assert tree.get_ssa_path("surface_order") == ref.get_ssa_path(
        "surface_order"
    )
    assert list(tree.traverse(tree.get_size)) == list(
        ref.traverse(ref.get_size)
    )
    for chi in (4, 8, 16, 10**9):
        for late in (False, True):
            got = tree.compressed_contract_stats(chi=chi, compress_late=late)
            want = ref.compressed_contract_stats(
                chi=chi, compress_late=late, accel=False
            )
            for attr in ("flops", "write", "max_size", "peak_size"):
                assert getattr(got, attr) == getattr(want, attr), (
                    chi, late, attr,
                )
            assert got.describe() == want.describe()
    for method in ("total_flops", "total_write", "max_size", "peak_size",
                   "total_cost", "contraction_width"):
        assert getattr(tree, method)(chi=8) == getattr(ref, method)(chi=8)
    assert tree.describe("full") == ref.describe("full")
    assert tree.contract_stats() == ref.contract_stats()
    assert tree.peak_size_exact() == ref.peak_size_exact()
    # the native replays (accel=True): the reference's stats, equal to
    # the pure-Python replay's, and the reference's tracker fields
    for mod, hook in NATIVE_REPLAY.items():
        monkeypatch.setattr(mod, "_get_native_replay", hook)
    stats = ("flops", "write", "max_size", "peak_size", "total_size",
             "secondary_weight", "factor", "chi")
    for chi in (4, 8, 16, 10**9):
        for late in (False, True):
            got = tree.compressed_contract_stats(
                chi=chi, compress_late=late, accel=True
            )
            want = ref.compressed_contract_stats(
                chi=chi, compress_late=late, accel=True
            )
            assert type(got).__name__ == type(want).__name__
            for attr in stats:
                assert getattr(got, attr) == getattr(want, attr), (
                    chi, late, attr,
                )
            assert tuple(got.last) == tuple(want.last)
            py = tree.compressed_contract_stats(
                chi=chi, compress_late=late, accel=False
            )
            for attr in ("flops", "write", "max_size", "peak_size"):
                assert getattr(got, attr) == getattr(py, attr), (
                    chi, late, attr,
                )


def test_default_traversal_unchanged():
    """``traverse()`` with no order stays by subtree size, plan order
    among equal sizes, which the lowering relies on."""
    tree, ref = _trees(0)
    assert list(tree.traverse()) == list(ref.traverse())
    assert tree.get_ssa_path() == ref.get_ssa_path()
    assert tree.get_path() == ref.get_path()


def test_surface_order_follows_insertion_after_repairing():
    """Re-pairing an existing node moves it to the end of ``children``
    (and of the surface order) in both packages."""
    tree, ref = _trees(0)
    for t in (tree, ref):
        t.surface_order(1)  # fill the cache, which re-pairing drops
        l, r = t.children[t.root]
        t.contract_nodes_pair(l, r)
    assert list(tree.children) == list(ref.children)
    assert tree.get_ssa_path("surface_order") == ref.get_ssa_path(
        "surface_order"
    )
    assert tree.get_ssa_path("surface_order")[-1] == tree.get_ssa_path()[-1]


@pytest.mark.parametrize(
    "spec",
    ["peak-compressed", "peak-compressed-16", "max-compressed-8",
     "size-compressed", "write-compressed-4", "flops-compressed",
     "combo-compressed-32"],
)
def test_compressed_objectives_match_reference(spec):
    tree, ref = _trees(0)
    obj, ref_obj = parse_minimize(spec), ref_parse_minimize(spec)
    assert repr(obj) == repr(ref_obj)
    trial, ref_trial = {"tree": tree}, {"tree": ref}
    assert obj(trial) == ref_obj(ref_trial)
    for key in ("flops", "write", "size"):
        assert trial[key] == ref_trial[key]


@pytest.mark.parametrize("spec", ["flops", "write", "size", "combo-64",
                                  "limit:32"])
def test_exact_objectives_match_reference(spec):
    tree, ref = _trees(1)
    obj, ref_obj = parse_minimize(spec), ref_parse_minimize(spec)
    assert repr(obj) == repr(ref_obj)
    assert obj({"tree": tree}) == ref_obj({"tree": ref})
    assert ctt.get_score_fn(spec) is obj


def test_tpu_objective_not_ported():
    with pytest.raises(NotImplementedError):
        parse_minimize("tpu")
    with pytest.raises(ValueError):
        parse_minimize("bogus")


# -- compressed path finders and presets -----------------------------------


@pytest.mark.parametrize("net", NETWORKS, ids=NET_IDS)
@pytest.mark.parametrize(
    "kw",
    [{"chi": "auto"}, {"chi": 8}, {"chi": 32},
     {"chi": 8, "temperature": 0.3, "seed": 4},
     {"chi": 8, "coeff_size": 0.2, "coeff_subgraph": 0.1,
      "coeff_centrality": 0.5}],
    ids=["auto", "8", "32", "gumbel", "coeffs"],
)
def test_greedy_compressed_paths_match_reference(net, kw):
    _, inputs, output, size_dict = net
    got = pc.greedy_compressed_ssa(inputs, output, size_dict, **kw)
    assert got == ref_pc.greedy_compressed_ssa(
        inputs, output, size_dict, **kw
    )
    assert pc.optimize_greedy_compressed(
        inputs, output, size_dict, **kw
    ) == ref_pc.optimize_greedy_compressed(inputs, output, size_dict, **kw)


@pytest.mark.parametrize("net", NETWORKS, ids=NET_IDS)
@pytest.mark.parametrize(
    "kw",
    [{"start": "max"}, {"start": "min"},
     {"start": "max", "temperature": 0.5, "seed": 2},
     {"start": "random", "seed": 3, "coeff_ndim": 0.3,
      "coeff_distance": 0.2, "coeff_next_centrality": 0.4}],
    ids=["max", "min", "gumbel", "random"],
)
def test_greedy_span_paths_match_reference(net, kw):
    _, inputs, output, size_dict = net
    got = pc.greedy_span_ssa(inputs, output, size_dict, **kw)
    assert got == ref_pc.greedy_span_ssa(inputs, output, size_dict, **kw)
    assert pc.optimize_greedy_span(
        inputs, output, size_dict, use_ssa=True, **kw
    ) == got


@pytest.mark.parametrize("preset", ["greedy-compressed", "greedy-span"])
def test_presets_match_reference(preset):
    inputs, output, _, size_dict = ctg.lattice_equation([5, 5], d_min=3)
    tree = ctt.array_contract_tree(
        inputs, output, size_dict=size_dict, optimize=preset
    )
    ref = ctg.array_contract_tree(
        inputs, output, size_dict=size_dict, optimize=preset
    )
    assert isinstance(tree, ContractionTreeCompressed)
    assert tree.is_complete()
    assert tree.get_ssa_path("surface_order") == ref.get_ssa_path(
        "surface_order"
    )
    assert ctt.array_contract_path(
        inputs, output, size_dict=size_dict, optimize=preset
    ) == tuple(map(tuple, ctg.array_contract_path(
        inputs, output, size_dict=size_dict, optimize=preset
    )))
    with pytest.raises(NotImplementedError):
        tree.contract([])
    with pytest.raises(NotImplementedError):
        tree.get_contractor()


def test_module_aliases():
    assert ctt.path_compressed_greedy is pc
    assert ctt.path_compressed.WindowedOptimizer
    assert ctt.path_compressed_branchbound.CompressedExhaustive
    assert ctt.ContractionTreeCompressed is ContractionTreeCompressed
    assert ctt.HyperGraph is HyperGraph


# -- refiners --------------------------------------------------------------


def _lattice_pair(dims, d=4, seed=0):
    inputs, output, _, size_dict = ctg.lattice_equation(list(dims), d_min=d)
    path = ref_greedy(inputs, output, size_dict, seed=seed, accel=False)
    tree = ContractionTreeCompressed.from_path(
        inputs, output, size_dict, path=path
    )
    ref = RefTreeCompressed.from_path(inputs, output, size_dict, path=path)
    return tree, ref


def _same_tree(got, want, start=None):
    """``got`` (the port's) equals ``want`` (the reference's); with
    ``start``, the refiner moved away from it."""
    assert type(got).__name__ == type(want).__name__
    assert list(got.children.items()) == list(want.children.items())
    assert got.get_ssa_path("surface_order") == want.get_ssa_path(
        "surface_order"
    )
    if start is not None:
        assert want.get_ssa_path("surface_order") != start.get_ssa_path(
            "surface_order"
        )


@pytest.mark.parametrize("order_only", [False, True])
def test_windowed_reconfigure_matches_reference(order_only):
    tree, ref = _lattice_pair((4, 5))
    kw = dict(seed=0, max_iterations=30, window_size=6,
              order_only=order_only, minimize="peak-compressed-8")
    want = ref.windowed_reconfigure(**kw)
    _same_tree(tree.windowed_reconfigure(**kw), want, ref)
    out = tree.windowed_reconfigure_(**kw)
    assert out is tree
    _same_tree(tree, want)
    # the adopted structure's surface order, not a stale one
    assert tree.surface_order(tree.root) == tree.N - 2


def test_simulated_anneal_matches_reference():
    tree, ref = _lattice_pair((5, 5))
    kw = dict(seed=0, tsteps=5, numiter=5)
    _same_tree(tree.simulated_anneal(**kw), ref.simulated_anneal(**kw), ref)
    for select in ("ascend", "random", "bounce"):
        kw = dict(seed=1, tsteps=2, numiter=2, select=select)
        _same_tree(tree.simulated_anneal(**kw), ref.simulated_anneal(**kw))


@pytest.mark.parametrize("order_only", [False, True])
def test_compressed_reconfigure_matches_reference(order_only):
    tree, ref = _lattice_pair((4, 4))
    kw = dict(max_nodes=2000, order_only=order_only)
    _same_tree(
        tree.compressed_reconfigure(**kw), ref.compressed_reconfigure(**kw),
        ref,
    )


def test_compressed_exhaustive_search_matches_reference():
    from cotengra_tpu.pathfinders.compressed_bb import (
        CompressedExhaustive as RefExhaustive,
    )
    from cotengra_tpu_torch.pathfinders.compressed_bb import (
        CompressedExhaustive,
    )

    inputs, output, _, size_dict = ctg.lattice_equation([3, 3], d_min=4)
    for kw in ({}, {"exploration_power": 2.0}):
        opt = CompressedExhaustive("peak", max_nodes=1500, **kw)
        ref = RefExhaustive("peak", max_nodes=1500, **kw)
        _same_tree(
            opt.search(inputs, output, size_dict),
            ref.search(inputs, output, size_dict),
        )
        assert opt.best_score == ref.best_score
        assert opt.path == ref.path


def test_tree_refiner_never_worse():
    """``CompressedTreeRefiner`` is bounded by time, so only the
    reference test's property holds: no tree gets worse."""

    def score(t):
        return t.compressed_contract_stats(
            tracker_cls=CompressedStatsTrackerPeak
        ).score

    trees = {seed: _lattice_pair((4, 4), seed=seed)[0] for seed in range(3)}
    before = {k: score(t) for k, t in trees.items()}
    out = CompressedTreeRefiner(
        trees, minimize="peak-compressed", max_refine_time=2
    ).refine(num_its=3)
    for k, t in out.items():
        assert isinstance(t, ContractionTreeCompressed)
        assert score(t) <= before[k]


# -- contract_compressed ---------------------------------------------------


@pytest.mark.parametrize("late", [False, True])
def test_contract_compressed_exact_at_large_chi(late):
    inputs, output, shapes, size_dict = ctt.lattice_equation([4, 4], d_min=2)
    rng = np.random.default_rng(0)
    arrays = [rng.normal(size=s) for s in shapes]
    tree = ctt.array_contract_tree(
        inputs, output, size_dict=size_dict, optimize="greedy-compressed"
    )
    got = tree.contract_compressed(
        arrays, chi=10**6, compress_late=late, device="cpu"
    )
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    exact = np.einsum(inputs_output_to_eq(inputs, output), *arrays,
                      optimize=True)
    assert_allclose(got.numpy(), exact, rtol=F64_RTOL)


def _lattice5(dtype):
    inputs, output, shapes, size_dict = ctg.lattice_equation([5, 5], d_min=3)
    rng = np.random.default_rng(2)
    if dtype == "complex128":
        # noisier tensors, so that truncation at chi=4 moves the value
        arrays = [
            np.ones(s) + 0.3 * rng.normal(size=s)
            + 0.3j * rng.normal(size=s) for s in shapes
        ]
    else:
        arrays = [np.ones(s) + 0.05 * rng.normal(size=s) for s in shapes]
    ssa = ref_pc.greedy_compressed_ssa(inputs, output, size_dict, chi=9)
    tree = ContractionTreeCompressed.from_path(
        inputs, output, size_dict, ssa_path=ssa
    )
    ref = RefTreeCompressed.from_path(inputs, output, size_dict, ssa_path=ssa)
    return tree, ref, arrays


@pytest.mark.parametrize("late", [False, True])
def test_contract_compressed_matches_reference(late):
    tree, ref, arrays = _lattice5("float64")
    got = tree.contract_compressed(
        arrays, chi=9, compress_late=late, device="cpu"
    )
    want = np.asarray(ref.contract_compressed(arrays, chi=9,
                                              compress_late=late))
    assert got.dtype == torch.float64
    assert_allclose(got.numpy(), want, rtol=F64_RTOL)

    m, e = tree.contract_compressed(
        arrays, chi=9, compress_late=late, strip_exponent=True,
        device="cpu",
    )
    rm, re_ = ref.contract_compressed(
        arrays, chi=9, compress_late=late, strip_exponent=True
    )
    assert m.dtype == torch.float64 and e.dtype == torch.float64
    log10 = np.log10(abs(m.item())) + e.item()
    ref_log10 = np.log10(abs(float(rm))) + float(re_)
    assert abs(log10 - ref_log10) <= LOG10_ATOL
    assert abs(log10 - np.log10(abs(want))) <= LOG10_ATOL


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("late", [False, True])
def test_stripped_exponent_is_summed_in_float64(late, dtype):
    """An 8x8 bond-4 lattice on 1 + 0.05 * normal entries at chi=8 (value
    about 10^67, past float32's range; 49 truncations a value): the
    stripped log10 value equals the unstripped float64 run's to 1e-12 in
    float64 (a float32 sum of the 63 log10 scales errs by ~1e-6 there),
    and its exponent is float64 for float32 inputs too, whose float32
    arithmetic over 63 steps may err by 63 float32 epsilons in log10
    (3.3e-6)."""
    inputs, output, shapes, size_dict = ctt.lattice_equation([8, 8], d_min=4)
    rng = np.random.default_rng(0)
    arrays = [np.ones(s) + 0.05 * rng.normal(size=s) for s in shapes]
    tree = ContractionTreeCompressed.from_path(
        inputs, output, size_dict,
        ssa_path=pc.greedy_compressed_ssa(inputs, output, size_dict, chi=8),
    )
    exact = tree.contract_compressed(
        arrays, chi=8, compress_late=late, device="cpu"
    ).item()
    assert 1e60 < exact < 1e75
    m, e = tree.contract_compressed(
        [a.astype(dtype) for a in arrays], chi=8, compress_late=late,
        strip_exponent=True, device="cpu",
    )
    assert m.dtype == getattr(torch, dtype) and e.dtype == torch.float64
    log10 = np.log10(abs(m.item())) + e.item()
    atol = 1e-12 if dtype == "float64" else 1e-5
    assert abs(log10 - np.log10(exact)) <= atol


@pytest.mark.parametrize("late", [False, True])
def test_contract_compressed_complex_transposes(late):
    """Complex inputs: the core is ``Ra @ Rb.T`` and the new factor
    ``Vh.T``, bilinear transposes as in the reference; adjoints there
    would move the value far beyond rtol."""
    tree, ref, arrays = _lattice5("complex128")
    got = tree.contract_compressed(
        arrays, chi=4, compress_late=late, device="cpu"
    )
    want = np.asarray(ref.contract_compressed(arrays, chi=4,
                                              compress_late=late))
    assert got.dtype == torch.complex128
    assert_allclose(got.numpy(), want, rtol=F64_RTOL)
    exact = tree.contract_compressed(arrays, chi=10**6, device="cpu").item()
    assert abs(got.item() - exact) > 1e-6 * abs(exact)


def test_contract_compressed_output_and_torch_inputs():
    """Open output indices come back in the tree's output order; torch
    inputs are taken as they are, in their dtype."""
    inputs, output, shapes, size_dict = ctg.rand_equation(
        8, 3, n_out=3, seed=5
    )
    rng = np.random.default_rng(5)
    arrays = [rng.normal(size=s) for s in shapes]
    ssa = ref_pc.greedy_compressed_ssa(inputs, output, size_dict, chi=4)
    tree = ContractionTreeCompressed.from_path(
        inputs, output, size_dict, ssa_path=ssa
    )
    ref = RefTreeCompressed.from_path(inputs, output, size_dict, ssa_path=ssa)
    got = tree.contract_compressed(
        [torch.from_numpy(a) for a in arrays], chi=4, device="cpu"
    )
    want = np.asarray(ref.contract_compressed(arrays, chi=4))
    assert tuple(got.shape) == want.shape
    assert_allclose(got.numpy(), want, rtol=F64_RTOL)
    got32 = tree.contract_compressed(
        [a.astype(np.float32) for a in arrays], chi=4, device="cpu"
    )
    assert got32.dtype == torch.float32
    assert_allclose(got32.numpy(), want, rtol=1e-4)


def test_contract_compressed_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree, _, arrays = _lattice5("float64")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tree.contract_compressed(arrays, chi=9)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tree.contract_compressed(arrays, chi=9, device="cuda")


# -- the truncation core's top-k SVD (ops/svd_core.py) ---------------------

SVD_SHAPES = [(1, 1), (32, 32), (64, 64), (256, 32), (256, 128)]
SVD_KINDS = ["random", "rank-deficient", "zero", "degenerate"]


def _svd_core(shape, kind, seed=0):
    """A float64 core: Gaussian; of rank min(m, n) // 4 (at least 1); all
    zero; or with exactly repeated singular values (4, 2 and 1 in groups
    of a multiple of 8, the rest 0.5), so that a top-k cut may split a
    group, where only the singular values and the truncation's error are
    fixed, not its vectors."""
    m, n = shape
    p = min(m, n)
    rng = np.random.default_rng(seed)
    if kind == "random":
        return torch.from_numpy(rng.standard_normal(shape))
    if kind == "rank-deficient":
        r = max(1, p // 4)
        a = rng.standard_normal((m, r)) @ rng.standard_normal((r, n))
        return torch.from_numpy(a)
    if kind == "zero":
        return torch.zeros(shape, dtype=torch.float64)
    qa = np.linalg.qr(rng.standard_normal((m, p)))[0]
    qb = np.linalg.qr(rng.standard_normal((n, p)))[0]
    third = max(1, (p // 24) * 8)
    s = np.full(p, 0.5)
    for g, v in enumerate((4.0, 2.0, 1.0)):
        s[g * third:(g + 1) * third] = v
    return torch.from_numpy((qa * s) @ qb.T)


@pytest.mark.parametrize("kind", SVD_KINDS)
@pytest.mark.parametrize("shape", SVD_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_svd_topk_plain_reconstructs_the_library_truncation(shape, kind):
    """``svd_topk`` on the CPU keeps the library's k largest triplets:
    ``U diag(s) V^T`` equals the library's rank-k truncation, the full
    rank reconstructs the core, the truncation error is the optimum
    (Eckart-Young, which holds whichever vectors a degenerate group
    gives), and s comes out descending."""
    from cotengra_tpu_torch.ops.svd_core import svd_topk

    M = _svd_core(shape, kind)
    p = min(shape)
    k = min(32, p)
    U, s, V = svd_topk(M, k)
    assert (U.shape, s.shape, V.shape) == ((shape[0], k), (k,), (shape[1], k))
    Uf, sf, Vhf = torch.linalg.svd(M, full_matrices=False)
    scale = max(float(torch.linalg.norm(M)), 1e-300)
    want = (Uf[:, :k] * sf[:k]) @ Vhf[:k]
    got = (U * s) @ V.T
    assert float(torch.linalg.norm(got - want)) <= 1e-13 * scale
    assert torch.all(s[:-1] >= s[1:])
    opt = float(torch.sqrt((sf[k:] ** 2).sum()))
    assert abs(float(torch.linalg.norm(M - got)) - opt) <= 1e-13 * scale
    Ua, sa, Va = svd_topk(M, p)
    assert float(torch.linalg.norm((Ua * sa) @ Va.T - M)) <= 1e-13 * scale


@pytest.mark.parametrize("kind", ["random", "rank-deficient", "degenerate"])
def test_compress_pair_core_keeps_the_truncated_product(kind):
    """``_compress_pair_core`` through ``svd_topk``: ``newA @ newB.T`` equals
    ``Qa (U_k s_k V_k^T) Qb^T`` of the library's SVD of ``Ra Rb^T``, and
    each factor carries sqrt(s)."""
    from cotengra_tpu_torch.ops.compressed import _compress_pair_core

    rng = np.random.default_rng(3)
    core = _svd_core((64, 64), kind, seed=4).numpy()
    # A B^T = core through random orthogonal sides: Ra Rb^T has core's
    # singular values
    qa = np.linalg.qr(rng.standard_normal((96, 64)))[0]
    qb = np.linalg.qr(rng.standard_normal((80, 64)))[0]
    A = torch.from_numpy(qa @ core)
    B = torch.from_numpy(qb)
    newA, newB = _compress_pair_core(A, B, 16)
    assert newA.shape == (96, 16) and newB.shape == (80, 16)
    Qa, Ra = torch.linalg.qr(A)
    Qb, Rb = torch.linalg.qr(B)
    U, s, Vh = torch.linalg.svd(Ra @ Rb.T, full_matrices=False)
    want = Qa @ ((U[:, :16] * s[:16]) @ Vh[:16]) @ Qb.T
    got = newA @ newB.T
    scale = float(torch.linalg.norm(A @ B.T))
    assert float(torch.linalg.norm(got - want)) <= 1e-12 * scale
    assert_allclose(
        torch.linalg.norm(newA, dim=0).numpy() ** 2, s[:16].numpy(),
        rtol=1e-10, atol=1e-12 * float(s[0]),
    )


def test_svd_topk_dispatch(monkeypatch):
    """CPU cores take the plain version, complex ones too (on the card
    they go to the library by dtype); the kernel's wrapper refuses what
    the kernel does not take before it reaches the card."""
    from cotengra_tpu_torch.ops import svd_core

    calls = []
    real = svd_core.svd_topk_plain

    def plain(M, k):
        calls.append((M.dtype, k))
        return real(M, k)

    monkeypatch.setattr(svd_core, "svd_topk_plain", plain)
    monkeypatch.setattr(
        svd_core, "svd_topk_cuda",
        lambda M, k: pytest.fail("a CPU or complex core reached the kernel"),
    )
    M = _svd_core((8, 6), "random")
    svd_core.svd_topk(M, 3)
    svd_core.svd_topk(M.to(torch.complex128), 2)
    svd_core.svd_topk(M.to(torch.float32), 1)
    assert calls == [(torch.float64, 3), (torch.complex128, 2),
                     (torch.float32, 1)]


@pytest.mark.parametrize(
    "M, k, match",
    [
        (torch.zeros(4, 4, 2, dtype=torch.float64), 1, "takes a matrix"),
        (torch.zeros(4, 3, dtype=torch.float64), 4, "outside"),
        (torch.zeros(4, 3, dtype=torch.float64), 0, "outside"),
        (torch.zeros(4, 3, dtype=torch.float16), 2, "float32 or float64"),
        (torch.zeros(4, 3, dtype=torch.complex128), 2, "float32 or float64"),
        (torch.zeros(3, 4, dtype=torch.float64).T, 2, "contiguous"),
        (torch.zeros(4, 3, dtype=torch.float64), 2, "CUDA tensor"),
    ],
    ids=["3-d", "k-too-large", "k-zero", "float16", "complex", "strided",
         "cpu"],
)
def test_svd_topk_cuda_refuses_what_the_kernel_does_not_take(M, k, match):
    from cotengra_tpu_torch.ops.svd_core import svd_topk, svd_topk_cuda

    with pytest.raises(ValueError, match=match):
        svd_topk_cuda(M, k)
    if match in ("takes a matrix", "outside"):
        with pytest.raises(ValueError, match=match):
            svd_topk(M, k)


def test_svd_core_unconverged_reads_zero_where_the_kernel_never_ran():
    """The count of kernel launches that hit the sweep cap lives on the
    device the kernel ran on; a device it never ran on reads 0, without
    touching the card."""
    from cotengra_tpu_torch.ops.svd_core import unconverged

    assert unconverged("cpu") == 0
    assert unconverged(torch.device("cuda", 7)) == 0


@pytest.mark.parametrize("fault", ["none", "skips-the-top", "loose-vectors"])
def test_smoke_svd_core_check_catches_a_wrong_top_k(fault):
    """``chip_smoke.py``'s check of the truncation-core kernel, run here on
    the plain version's own triplets: it reads 0 for them, and more than
    its limit where the top triplet is left out or the vectors are off by
    1e-9, as an unconverged kernel's would be."""
    import chip_smoke
    from cotengra_tpu_torch.ops.svd_core import svd_topk_plain

    M = _svd_core((64, 48), "random", seed=5)
    k = 8
    U, s, V = svd_topk_plain(M, k)
    if fault == "skips-the-top":
        U, s, V = svd_topk_plain(M, k + 1)
        U, s, V = U[:, 1:], s[1:], V[:, 1:]
    elif fault == "loose-vectors":
        gen = torch.Generator().manual_seed(0)
        U = U + 1e-9 * torch.randn(U.shape, generator=gen, dtype=U.dtype)
    err, over_s0, cut, excess = chip_smoke._svd_core_errors(M, k, U, s, V)
    limit = chip_smoke.SVD_CORE_ATOL[torch.float64]
    if fault == "none":
        assert err == 0.0 and over_s0 == 0.0 and cut == 0.0
        assert abs(excess) <= limit
    elif fault == "skips-the-top":
        assert over_s0 > limit and cut > limit and excess > limit
    else:
        assert over_s0 == 0.0 and cut > limit
