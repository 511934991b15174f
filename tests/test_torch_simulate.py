"""The port's cost model of the grouped executor on the card
(``cotengra_tpu_torch/ops/simulate.py``, ``H100_CONSTANTS``) and its
``"gpu"`` objective, mirrored from the reference's ``tests/test_simulate.py``
and ``test_tpu_time_objective``; the tallies that do not depend on the
chip against the reference's ``simulate_grouped``; the copy term; the
batch modes' host counts; and the fit to the warm times measured on the
card (``H100_MEASURED``)."""

import itertools
import math
from pathlib import Path

import numpy as np
import pytest

from cotengra_tpu.ops.simulate import simulate_grouped as ref_simulate
from cotengra_tpu.utils.io import load_tree as ref_load_tree

import cotengra_tpu_torch as ctt
from cotengra_tpu_torch.ops.grouped_plan import plan_grouped
from cotengra_tpu_torch.ops.lowering import (
    extract_contractions,
    sliced_input_legs,
)
from cotengra_tpu_torch.ops.simulate import (
    H100_CONSTANTS,
    H100_MEASURED,
    simulate_grouped,
)
from cotengra_tpu_torch.scoring import GpuTimeObjective, parse_minimize
from cotengra_tpu_torch.slicing import SliceFinder
from cotengra_tpu_torch.utils.misc import prod

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-12
# the calibration's limits: each plan within this share of its measured
# warm time, and any two m=10 plans whose measured times differ by more
# than RANK_GAP ranked as measured
FIT_RTOL = 0.20
RANK_GAP = 0.15


@pytest.fixture
def tree():
    inputs, output, shapes, size_dict = ctt.rand_equation(
        12, 3, seed=7, d_max=4
    )
    return ctt.array_contract_tree(
        inputs, output, size_dict=size_dict, optimize="greedy"
    )


def test_simulate_basic(tree):
    sec = simulate_grouped(tree)
    assert np.isfinite(sec) and sec > 0

    rep = simulate_grouped(tree, detail=True)
    c = H100_CONSTANTS
    assert rep["seconds"] == pytest.approx(sec)
    assert rep["mode"] is None and rep["n_calls"] == rep["nslices"]
    # per-slice = the device's buckets
    buckets = rep["chain_s"] + rep["copy_s"] + rep["dot_s"] + rep["other_s"]
    assert rep["per_slice_s"] == pytest.approx(buckets)
    # the host: a step call each, the launches they make, the slices
    assert rep["step_calls"] == rep["n_plans"] * rep["nslices"]
    assert rep["host_s"] == pytest.approx(
        rep["step_calls"] * c["step_s"] + rep["launches"] * c["launch_s"]
        + rep["nslices"] * c["slice_overhead_s"]
    )
    # the device: every slice's work and a floor per launch
    assert rep["device_s"] == pytest.approx(
        rep["nslices"] * rep["per_slice_s"] + rep["launches"] * c["kernel_s"]
    )
    # the two timelines overlap: the wall is at least the longer one
    # and at most both end to end
    assert max(rep["host_s"], rep["device_s"]) <= rep["seconds"] * (1 + RTOL)
    assert rep["seconds"] <= (rep["host_s"] + rep["device_s"]) * (1 + RTOL)
    assert rep["idle_share"] == pytest.approx(
        1 - rep["device_s"] / rep["seconds"]
    )


def test_simulate_constants_scale(tree):
    base = simulate_grouped(tree)
    doubled = {
        k: 2 * H100_CONSTANTS[k]
        for k in ("chain_gbps", "chain_gflops", "copy_gbps", "dot_gbps",
                  "gemm_tflops", "einsum_gbps")
    }
    fast = simulate_grouped(tree, constants=dict(
        doubled, slice_overhead_s=0.0, step_s=0.0, launch_s=0.0,
        kernel_s=0.0,
    ))
    # doubling every rate and dropping the fixed costs is strictly
    # faster (on tiny trees the fixed costs dominate: no tighter ratio)
    assert 0 < fast < base


def test_simulate_slicing_overhead(tree):
    """Slicing splits the work but pays the per-slice costs, so the
    modelled total grows."""
    base = simulate_grouped(tree)
    sliced = tree.copy()
    sliced.slice_(target_slices=4)
    assert sliced.multiplicity >= 4
    assert simulate_grouped(sliced) > base


def test_simulate_matches_objective():
    """GpuTimeObjective.estimated_seconds is the simulator, and the
    trial score its log2."""
    inputs, output, shapes, size_dict = ctt.rand_equation(10, 3, seed=3)
    tree = ctt.array_contract_tree(
        inputs, output, size_dict=size_dict, optimize="greedy"
    )
    obj = parse_minimize("gpu")
    sec = obj.estimated_seconds(tree)
    assert sec == pytest.approx(simulate_grouped(tree))
    assert obj({"tree": tree}) == pytest.approx(math.log2(sec))


def test_gpu_time_objective():
    obj = parse_minimize("gpu")
    assert isinstance(obj, GpuTimeObjective)
    # default operating point: 8 B/elem x the GEMM rate / the streaming
    # rate of the fitted constants
    fpe = 8 * H100_CONSTANTS["gemm_tflops"] * 1e12 / (
        H100_CONSTANTS["dot_gbps"] * 1e9
    )
    assert obj.flops_per_elem == pytest.approx(fpe)
    assert parse_minimize("gpu-1000").flops_per_elem == 1000.0
    assert parse_minimize("gpu:250").flops_per_elem == 250.0
    assert parse_minimize("gpu") is obj

    inputs, output, shapes, size_dict = ctt.rand_equation(10, 3, seed=0)
    tree = ctt.array_contract_tree(
        inputs, output, size_dict=size_dict, optimize="greedy"
    )
    score = obj({"tree": tree})
    assert math.isfinite(score)
    sec = obj.estimated_seconds(tree)
    assert sec > 0
    assert 2**score == pytest.approx(sec)
    assert sec == pytest.approx(simulate_grouped(tree))

    # sim_constants re-price the simulator: double the rates and no
    # fixed costs is strictly faster
    fast = GpuTimeObjective(sim_constants={
        "chain_gbps": 2 * H100_CONSTANTS["chain_gbps"],
        "copy_gbps": 2 * H100_CONSTANTS["copy_gbps"],
        "dot_gbps": 2 * H100_CONSTANTS["dot_gbps"],
        "gemm_tflops": 2 * H100_CONSTANTS["gemm_tflops"],
        "einsum_gbps": 2 * H100_CONSTANTS["einsum_gbps"],
        "slice_overhead_s": 0.0, "step_s": 0.0, "launch_s": 0.0,
        "kernel_s": 0.0,
    })
    assert fast.estimated_seconds(tree) < sec

    # the hooks
    node = next(iter(tree.children))
    assert obj.cost_local_tree_node(tree, node) > 0
    assert obj.get_dynamic_programming_minimize() == f"limit-{int(fpe)}"
    assert math.isfinite(obj.score_local(flops=(8.0, 16.0), size=(4.0, 2.0)))
    assert math.isfinite(obj.score_local(flops=8.0, size=4.0))

    # the whole hook stack through reconfiguration and slicing
    tree2 = tree.copy()
    tree2.subtree_reconfigure_(subtree_size=6, maxiter=20, minimize="gpu")
    assert tree2.is_complete()
    assert math.isfinite(obj({"tree": tree2}))
    sf = SliceFinder(tree, target_slices=4, minimize="gpu", max_repeats=4,
                     seed=0)
    costs, inds = sf.search()
    assert len(inds) >= 1


def test_tpu_objective_points_to_gpu():
    with pytest.raises(NotImplementedError, match="minimize='gpu'"):
        parse_minimize("tpu")


# -- the committed plans in both packages -------------------------------------

_PLANS = {}


def _plan_trees(name):
    """(port tree, reference tree) of a committed Sycamore-53 plan."""
    if name not in _PLANS:
        depth = int(name.split("_m")[1].split("_")[0])
        inputs, output, _, _, arrays = ctt.rand_circuit_tn(53, depth,
                                                           seed=42)
        inputs, arrays = ctt.absorb_simple_tensors(
            inputs, arrays, output, max_rank=2, max_absorb_size=2**12
        )
        size_dict = {
            ix: int(d) for t, a in zip(inputs, arrays)
            for ix, d in zip(t, a.shape)
        }
        path = str(ROOT / "plans" / f"{name}.json")
        _PLANS[name] = (
            ctt.load_tree(path, inputs, output, size_dict),
            ref_load_tree(path, inputs, output, size_dict),
        )
    return _PLANS[name]


_M10_PLANS = [
    "sycamore53_m10_t27", "sycamore53_m10_t29",
    "sycamore53_m10_t27_combo", "sycamore53_m10_t27_combo-256",
    "sycamore53_m10_t27_tpu", "r5b_m10_tpu",
]


@pytest.mark.parametrize("name", _M10_PLANS)
def test_chip_free_tallies_equal_the_reference(name):
    """The steps planned, the slices and the dot flops are the
    reference's on the same tree; the rates, chain bytes and copy term
    differ by design."""
    tree, ref_tree = _plan_trees(name)
    got = simulate_grouped(tree, detail=True)
    ref = ref_simulate(ref_tree, detail=True)
    for key in ("n_plans", "nslices", "dot_tflop"):
        assert got[key] == pytest.approx(ref[key], rel=RTOL), key


@pytest.mark.parametrize("name", ["sycamore53_m10_t27",
                                  "sycamore53_m10_t29"])
def test_copy_bytes_are_one_read_and_write(name):
    """The copy term: one read and one write of both planes of every
    realigned operand (the pair steps' x and y, the chains' gates, the
    final rearrangement), nothing else."""
    tree, _ = _plan_trees(name)
    ir = extract_contractions(tree)
    orders = [sliced_input_legs(tree, i) for i in range(tree.N)]
    plans, _, out_plan, out_shape, _ = plan_grouped(
        ir, tree.size_dict, orders, gate_mode="inplace"
    )
    elems = prod(out_shape) if out_plan is not None else 0
    for kind, info in plans:
        if kind == "pair":
            elems += info.B * info.M * info.K * (info.x_plan is not None)
            elems += info.B * info.K * info.N * (info.y_plan is not None)
        elif kind == "inplace":
            elems += sum(K * N for _, plan, K, N in info.ys
                         if plan is not None)
    pb = H100_CONSTANTS["plane_bytes"]
    got = simulate_grouped(tree, detail=True)
    assert elems > 0
    assert got["copy_gb"] == pytest.approx(2 * 2 * pb * elems / 1e9,
                                           rel=RTOL)


def test_batch_modes_count_the_host_as_the_executor_runs():
    """Slice by slice every step runs per slice; "scan" runs the
    slice-invariant steps once per call; "vmap" runs every step once per
    call. The device's work differs only by the invariant steps."""
    tree, _ = _plan_trees("sycamore53_m10_t27")
    n = tree.multiplicity
    fn = ctt.make_grouped_contractor(tree, "cpu", slice_batch=2,
                                     slice_batch_mode="scan")
    once, each = len(fn.batch.steps_once), len(fn.batch.steps_each)
    loop = simulate_grouped(tree, detail=True)
    scan = simulate_grouped(tree, slice_batch=2, slice_batch_mode="scan",
                            detail=True)
    vmap = simulate_grouped(tree, slice_batch=2, slice_batch_mode="vmap",
                            detail=True)
    assert (loop["mode"], scan["mode"], vmap["mode"]) == (None, "scan",
                                                          "vmap")
    assert loop["step_calls"] == (once + each) * n
    assert scan["step_calls"] == once * 2 + each * n
    assert vmap["step_calls"] == (once + each) * 2
    assert vmap["host_s"] < scan["host_s"] < loop["host_s"]
    # the same work; a batched step launches once for its slices
    k = H100_CONSTANTS["kernel_s"]
    assert scan["device_s"] - vmap["device_s"] == pytest.approx(
        (scan["launches"] - vmap["launches"]) * k, rel=1e-9
    )
    assert loop["device_s"] - scan["device_s"] == pytest.approx(
        (n - 2) * scan["once_s"], rel=1e-9
    )
    # "auto" takes the mode the executor's rule takes on the card
    auto = simulate_grouped(tree, slice_batch=4, detail=True)
    assert auto["mode"] == "vmap"
    # the first slices only
    part = simulate_grouped(tree, slice_batch=2, slice_batch_mode="vmap",
                            nslices=2, detail=True)
    assert (part["nslices"], part["n_calls"]) == (2, 1)


@pytest.mark.parametrize("gate_mode,fuse", [("window", False),
                                            (None, True),
                                            ("inplace", True)])
def test_window_and_fused_steps_are_priced(gate_mode, fuse):
    """The window and fused engines on t27: the steps planned are
    plan_grouped's; the GEMM flops are the window steps' 8 S_in S_out M
    and the pairs' and fused chains' 8 B M K N; a window operator build
    is one step call per call where the executor runs it once (no
    sliced index reaches its gates), per slice where it does not."""
    tree, _ = _plan_trees("sycamore53_m10_t27")
    ir = extract_contractions(tree)
    orders = [sliced_input_legs(tree, i) for i in range(tree.N)]
    plans = plan_grouped(ir, tree.size_dict, orders, gate_mode=gate_mode,
                         fuse_gates=fuse)[0]
    flops = 0.0
    for kind, info in plans:
        if kind == "window":
            M = prod(info.out_shape) // info.S_out
            flops += 8.0 * info.S_in * info.S_out * M
        elif kind in ("pair", "fusedchain"):
            flops += 8.0 * getattr(info, "B", 1) * info.M * info.K * info.N
    got = simulate_grouped(tree, gate_mode=gate_mode, fuse_gates=fuse,
                           slice_batch=2, slice_batch_mode="scan",
                           detail=True)
    assert got["n_plans"] == len(plans)
    assert got["dot_tflop"] == pytest.approx(flops / 1e12, rel=RTOL)
    fn = ctt.make_grouped_contractor(
        tree, "cpu", slice_batch=2, slice_batch_mode="scan",
        gate_mode=gate_mode, fuse_gates=fuse,
    )
    once, each = len(fn.batch.steps_once), len(fn.batch.steps_each)
    assert got["step_calls"] == once * 2 + each * tree.multiplicity
    builds = [si for si, (k, _) in enumerate(fn.plans) if k == "w2build"]
    assert len(builds) == (15 if gate_mode == "window" else 0)
    assert set(builds) <= set(fn.batch.steps_once) | set(
        fn.batch.steps_each)
    # the model's time grows with the window steps' identity-inflated
    # flops: above the in-place chains' on the same tree
    if gate_mode == "window":
        inplace = simulate_grouped(tree, slice_batch=2,
                                   slice_batch_mode="scan")
        assert got["seconds"] > inplace


# -- the fit to the card ----------------------------------------------------


def test_measured_runs_name_the_card():
    """The calibration set: each m=10 plan, t27 and m20 under both batch
    modes, measured on a named H100."""
    card = H100_MEASURED["card"]
    assert card.startswith("NVIDIA H100") and card.endswith(" W")
    runs = H100_MEASURED["runs"]
    assert {r["plan"] for r in runs} == set(_M10_PLANS) | {
        "sycamore53_m20_t28"}
    for plan in ("sycamore53_m10_t27", "sycamore53_m20_t28"):
        assert {r["mode"] for r in runs if r["plan"] == plan} == {
            "scan", "vmap"}


_SMALL = {}


def _measured_tree(plan):
    """The port's tree of a run of ``H100_MEASURED``: a committed plan,
    or the example's m10 tree sliced small (``chip_smoke.py`` phase
    34: seed 0, temperature 0)."""
    if plan != "example_m10_2^22":
        return _plan_trees(plan)[0]
    if not _SMALL:
        committed = _plan_trees("sycamore53_m10_t27")[0]
        ssa, _ = ctt.optimize_random_greedy_track_flops(
            committed.inputs, committed.output, committed.size_dict,
            ntrials=128, seed=0, use_ssa=True,
        )
        tree = ctt.ContractionTree.from_path(
            committed.inputs, committed.output, committed.size_dict,
            ssa_path=ssa,
        )
        tree.subtree_reconfigure_(subtree_size=10)
        tree.slice_and_reconfigure_(2**22, temperature=0)
        _SMALL["tree"] = tree
    return _SMALL["tree"]


def _modelled(run):
    tree = _measured_tree(run["plan"])
    nsl = run["nslices"] if run["nslices"] != tree.multiplicity else None
    # one constants table for every plan: no per-plan terms
    return simulate_grouped(
        tree, slice_batch=run["slice_batch"],
        slice_batch_mode=run["mode"] or "auto", nslices=nsl,
    )


def _run_id(run):
    return f"{run['plan']}-{run['slice_batch']}-{run['mode']}"


@pytest.mark.parametrize("run", H100_MEASURED["runs"], ids=_run_id)
def test_model_fits_the_measured_warm_time(run):
    model = _modelled(run)
    assert abs(model / run["seconds"] - 1) <= FIT_RTOL, (
        model, run["seconds"]
    )


def test_model_ranks_the_m10_plans_as_measured():
    runs = [r for r in H100_MEASURED["runs"] if "_m10" in r["plan"]]
    assert len(runs) >= 6
    model = {_run_id(r): _modelled(r) for r in runs}
    ranked = 0
    for a, b in itertools.combinations(runs, 2):
        fast, slow = sorted((a, b), key=lambda r: r["seconds"])
        if slow["seconds"] > (1 + RANK_GAP) * fast["seconds"]:
            ranked += 1
            assert model[_run_id(fast)] < model[_run_id(slow)], (
                _run_id(fast), _run_id(slow)
            )
    assert ranked > 0
