"""The port's staged and jitted contractors against the JAX package's, on
the same numpy inputs: ``make_grouped_staged_contractor`` (its stages
run eagerly on the CPU, where the reference jits each) in both slice
batch modes, plain and stripped, at several stage sizes, with folded
constants and without a batch; its stage bounds and carried ids on the
committed plans; ``make_staged_contractor``; ``make_traced_slicer``
under ``jax.jit``; selection by device digits; ``autojit`` on the
other entry points. A capture-safety proxy runs the staged step program
on ``meta`` tensors under a dispatch mode that refuses host syncs and
any CPU tensor: what a CUDA graph capture would refuse. Float64 on the
CPU; the captured graphs themselves run in ``test_torch_cuda.py``."""

import inspect
from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

import jax
import jax.numpy as jnp

import cotengra_tpu as ctg
from cotengra_tpu.ops import executor as ref_executor
from cotengra_tpu.ops import grouped as ref_grouped
from cotengra_tpu.utils.io import load_tree as ref_load_tree

import cotengra_tpu_torch as ctt
from cotengra_tpu_torch.ops import grouped, slices
from cotengra_tpu_torch.ops.capture import run_stages
from cotengra_tpu_torch.ops.executor import (
    make_staged_contractor,
    make_traced_slicer,
)
from cotengra_tpu_torch.ops.gate_chains import _kernel_args, _slices_of
from cotengra_tpu_torch.ops.grouped import make_grouped_staged_contractor
from cotengra_tpu_torch.tracing import STEP_CALLS

from test_torch_slices import (
    _CASES,
    _complex_arrays,
    _gates_chunked,
    _per_slice,
    _port_tree,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
# float64 in both packages; the port's stages sum the stripped exponents
# and run the invariant steps in another order than the reference's
F64_RTOL = 1e-10
STAGE_SIZES = [1, 5, 12, 10**6]  # 10**6: more than any plan's steps


def _ref_planes(arrays):
    return [jnp.asarray(ref_grouped.to_plane_array(a)) for a in arrays]


def _assert_per_slice(got, ref):
    assert got.shape == ref.shape
    for g, r in zip(got, ref):
        assert_allclose(g, r, rtol=F64_RTOL, atol=F64_RTOL * np.abs(r).max())


def _got(res, strip):
    if strip:
        return _per_slice(tuple(r.numpy() for r in res), strip)
    return _per_slice(res.numpy(), strip)


_LATTICE_CASE = "lattice4x4"


def _lattice(sliced=False):
    """The 4x4 lattice of bond 4 (the reference's tree), uniform [0, 1)
    entries from a seed; sliced 4 ways or not."""
    inputs, output, shapes, size_dict = ctg.lattice_equation(
        [4, 4], d_min=4
    )
    path, _ = ctg.optimize_random_greedy_track_flops(
        inputs, output, size_dict, ntrials=8, seed=0
    )
    tree = ctg.ContractionTree.from_path(
        inputs, output, size_dict, path=path
    )
    if sliced:
        tree.slice_(target_slices=4)
    rng = np.random.default_rng(7)
    return tree, [rng.uniform(size=s) for s in shapes]


def _case(case):
    """(reference tree, port tree, complex or real inputs, slice ids)."""
    if case == _LATTICE_CASE:
        ref_tree, arrays = _lattice(sliced=True)
        return ref_tree, _port_tree(ref_tree), arrays, [3, 1, 2]
    make, ids = _CASES[case]
    ref_tree = make()
    tree = _port_tree(ref_tree)
    return ref_tree, tree, _complex_arrays(tree), ids


@pytest.mark.parametrize("stage_size", STAGE_SIZES)
@pytest.mark.parametrize("strip", [False, True])
@pytest.mark.parametrize("mode", ["scan", "vmap"])
@pytest.mark.parametrize("case", [*_CASES, _LATTICE_CASE])
def test_staged_grouped_call_matches_reference(case, mode, strip,
                                               stage_size):
    ref_tree, tree, arrays, ids = _case(case)
    nsl = tree.multiplicity
    ref_fn = ref_grouped.make_grouped_staged_contractor(
        ref_tree, stage_size=stage_size, split_complex=True, plane_io=True,
        slice_batch=nsl, slice_batch_mode=mode, strip_exponent=strip,
    )
    ref = _per_slice(ref_fn(_ref_planes(arrays), np.asarray(ids)), strip)
    fn = make_grouped_staged_contractor(
        tree, stage_size=stage_size, strip_exponent=strip,
        plane_dtype=torch.float64, slice_batch=nsl, slice_batch_mode=mode,
        device="cpu",
    )
    assert fn.mode == mode
    assert len(fn.stages) == len(fn.bounds) - 1
    planes = ctt.to_plane_tensors(arrays, "cpu", torch.float64)
    _assert_per_slice(_got(fn(planes, ids), strip), ref)
    # the stages on the CPU run eagerly; precompile counts them
    assert fn.precompile(planes, ids) == len(fn.stages)


@pytest.mark.parametrize("strip", [False, True])
@pytest.mark.parametrize("stage_size", [3, 12])
def test_staged_grouped_core_matches_reference(stage_size, strip):
    """Without a batch: ``fn(*planes)`` on one slice's inputs."""
    ref_tree, tree, arrays, _ = _case("circuit")
    sid = 5
    sliced = ctt.slice_arrays(tree, arrays, sid)
    ref_fn = ref_grouped.make_grouped_staged_contractor(
        ref_tree, stage_size=stage_size, split_complex=True, plane_io=True,
        strip_exponent=strip,
    )
    fn = make_grouped_staged_contractor(
        tree, stage_size=stage_size, strip_exponent=strip,
        plane_dtype=torch.float64, device="cpu",
    )
    ref = ref_fn(*_ref_planes(sliced))
    got = fn(*ctt.to_plane_tensors(sliced, "cpu", torch.float64))
    if strip:
        ref, got = (ref[0], ref[1]), tuple(g.numpy() for g in got)
        ref = np.asarray(ref[0]) * 10.0 ** float(ref[1])
        got = got[0] * 10.0 ** float(got[1])
    else:
        ref, got = np.asarray(ref), got.numpy()
    assert_allclose(got, ref, rtol=F64_RTOL, atol=F64_RTOL * abs(ref).max())
    assert fn.mode is None and fn.batch is None


@pytest.mark.parametrize("strip", [False, True])
@pytest.mark.parametrize("mode", ["scan", "vmap"])
def test_staged_grouped_with_folded_constants(mode, strip, monkeypatch):
    """Constants on the chunked gate construction (its first chain reads
    only them): folded once, at the first call; the staged values equal
    the reference's (which has no constants) and later calls run no
    folded step."""
    ref_tree = _gates_chunked()
    tree = _port_tree(ref_tree)
    arrays = _complex_arrays(tree, seed=3)
    nsl = tree.multiplicity
    ids = [2, 0, 3]
    ref_fn = ref_grouped.make_grouped_staged_contractor(
        ref_tree, stage_size=4, split_complex=True, plane_io=True,
        slice_batch=nsl, slice_batch_mode=mode, strip_exponent=strip,
    )
    ref = _per_slice(ref_fn(_ref_planes(arrays), np.asarray(ids)), strip)
    planes = ctt.to_plane_tensors(arrays, "cpu", torch.float64)
    eager = ctt.make_grouped_contractor(
        tree, "cpu", torch.float64, slice_batch=nsl, slice_batch_mode=mode,
        strip_exponent=strip,
    )
    # the inputs of the first, slice-invariant chain
    first = eager.batch.steps_once[0]
    constants = {
        vid for vid in (eager.plans[first][1].x_id,
                        *(y[0] for y in eager.plans[first][1].ys))
        if vid < tree.N
    }
    fn = make_grouped_staged_contractor(
        tree, stage_size=4, strip_exponent=strip, plane_dtype=torch.float64,
        slice_batch=nsl, slice_batch_mode=mode, device="cpu",
        constants=constants,
    )
    assert fn.batch.steps_fold
    _assert_per_slice(_got(fn(planes, ids), strip), ref)
    ran = []
    real = grouped._exec_steps_split
    monkeypatch.setattr(
        grouped, "_exec_steps_split",
        lambda plans, steps, *a: ran.extend(steps) or real(plans, steps, *a),
    )
    _assert_per_slice(_got(fn(planes, ids), strip), ref)
    assert ran and not set(ran) & set(fn.batch.steps_fold)


@pytest.mark.parametrize("plan", ["sycamore53_m10_t27",
                                  "sycamore53_m10_t29",
                                  "sycamore53_m20_t28"])
def test_stage_bounds_and_carries_are_the_reference_s(plan):
    """On the committed plans (host only): the reference's stage bounds
    and the ids it carries out of each stage, read from its stages."""
    inputs, output, size_dict = _instance(plan)
    path = str(ROOT / "plans" / f"{plan}.json")
    ref_tree = ref_load_tree(path, inputs, output, size_dict)
    tree = ctt.load_tree(path, inputs, output, size_dict)
    ref_fn = ref_grouped.make_grouped_staged_contractor(
        ref_tree, split_complex=True, plane_io=True, autojit=False,
    )
    stages = inspect.getclosurevars(ref_fn).nonlocals["stages"]
    ref_bounds, ref_carries = [0], [list(range(tree.N))]
    for sf, carry_out in stages:
        cv = inspect.getclosurevars(sf).nonlocals
        assert cv["start"] == ref_bounds[-1]
        ref_bounds.append(cv["end"])
        ref_carries.append(list(carry_out))
    kw = {"slice_batch": 2} if tree.sliced_inds else {}
    fn = make_grouped_staged_contractor(tree, device="cpu", **kw)
    assert fn.bounds == ref_bounds
    assert fn.carries == ref_carries
    assert len(fn.stages) == len(stages)


def _instance(plan):
    depth = int(plan.split("_m")[1].split("_")[0])
    inputs, output, _, _, arrays = ctt.rand_circuit_tn(53, depth, seed=42)
    inputs, arrays = ctt.absorb_simple_tensors(
        inputs, arrays, output, max_rank=2, max_absorb_size=2**12
    )
    size_dict = {
        ix: int(d) for term, arr in zip(inputs, arrays)
        for ix, d in zip(term, arr.shape)
    }
    return inputs, output, size_dict


def _direct_trees():
    """(reference tree, inputs) on the direct route: a random equation
    with complex inputs, and the unsliced 4x4 lattice (real)."""
    inputs, output, shapes, size_dict = ctg.rand_equation(
        10, 3, n_out=2, seed=5, d_min=2, d_max=4
    )
    path, _ = ctg.optimize_random_greedy_track_flops(
        inputs, output, size_dict, ntrials=4, seed=0
    )
    tree = ctg.ContractionTree.from_path(inputs, output, size_dict,
                                         path=path)
    rng = np.random.default_rng(5)
    arrays = [rng.normal(size=s) + 1j * rng.normal(size=s) for s in shapes]
    yield "rand_equation", tree, arrays
    yield "lattice4x4", *_lattice()


@pytest.mark.parametrize("strip", [False, True])
@pytest.mark.parametrize("num_stages", [1, 2, 3, 4])
@pytest.mark.parametrize("which", ["rand_equation", "lattice4x4"])
def test_staged_contractor_matches_reference(which, num_stages, strip):
    _, ref_tree, arrays = next(c for c in _direct_trees() if c[0] == which)
    tree = _port_tree(ref_tree)
    ref_fn = ref_executor.make_staged_contractor(
        ref_tree, num_stages=num_stages, strip_exponent=strip
    )
    ref = ref_fn(*(jnp.asarray(a) for a in arrays))
    fn = make_staged_contractor(tree, num_stages=num_stages,
                                strip_exponent=strip, device="cpu")
    got = fn(*(torch.from_numpy(a) for a in arrays))
    if strip:
        assert_allclose(float(got[1]), float(ref[1]), rtol=F64_RTOL)
        ref, got = ref[0], got[0]
    ref = np.asarray(ref)
    assert_allclose(got.numpy(), ref, rtol=F64_RTOL,
                    atol=F64_RTOL * abs(ref).max())
    if num_stages > 1:
        ref_vars = inspect.getclosurevars(ref_fn).nonlocals
        assert len(fn.stages) == len(ref_vars["stages"]) == num_stages
        sigs = [inspect.getclosurevars(st.__wrapped__).nonlocals
                for st in ref_vars["stages"]]
        ref_carries = [sigs[0]["in_ids"]] + [v["out_ids"] for v in sigs]
        assert fn.carries == [list(c) for c in ref_carries]


def test_traced_slicer_matches_reference_on_t27_and_m20():
    """Every t27 slice id and 64 seeded m20 ids: the port's slicer on a
    0-d id tensor gives the reference's jitted slicer's arrays."""
    rng = np.random.default_rng(64)
    for plan in ("sycamore53_m10_t27", "sycamore53_m20_t28"):
        inputs, output, size_dict = _instance(plan)
        path = str(ROOT / "plans" / f"{plan}.json")
        ref_tree = ref_load_tree(path, inputs, output, size_dict)
        tree = ctt.load_tree(path, inputs, output, size_dict)
        n = tree.multiplicity
        ids = range(n) if n <= 64 else rng.integers(0, n, 64)
        arrays = [
            rng.normal(size=s).astype(np.float32) for s in tree.get_shapes()
        ]
        ref_slicer = jax.jit(ref_executor.make_traced_slicer(ref_tree))
        slicer = make_traced_slicer(tree)
        tensors = [torch.from_numpy(a) for a in arrays]
        jarrays = [jnp.asarray(a) for a in arrays]
        for sid in ids:
            ref = ref_slicer(jarrays, jnp.asarray(int(sid)))
            got = slicer(tensors, torch.tensor(int(sid)))
            assert len(got) == len(ref)
            for g, r in zip(got, ref):
                assert np.array_equal(g.numpy(), np.asarray(r))
            # the host's slicing of the same id
            for g, h in zip(got, ctt.slice_arrays(tree, tensors, int(sid))):
                assert torch.equal(g, h)


def test_device_digits_select_as_the_host_does():
    """``gather_input`` by a digit tensor (the grouped contractors'
    digits on the device) gives what the host digits give (copied there
    first) and the stack of ``_select_input`` views, a batch at once and
    one row at a time (``"scan"``), on the m20 planes."""
    inputs, output, size_dict = _instance("sycamore53_m20_t28")
    tree = ctt.load_tree(
        str(ROOT / "plans" / "sycamore53_m20_t28.json"), inputs, output,
        size_dict,
    )
    rng = np.random.default_rng(20)
    planes = [
        torch.from_numpy(rng.normal(size=(2,) + s)) for s in tree.get_shapes()
    ]
    meta = slices._slice_meta(tree)
    axes = slices._sliced_axes_per_input(tree)
    ids = [int(i) for i in rng.integers(0, tree.multiplicity, 6)]
    digits = slices._ids_to_digits(ids, meta)
    dev_digits = torch.from_numpy(digits)
    varying = [i for i, a in enumerate(axes)
               if any(meta[ix][2] is None for _, ix in a)]
    assert varying
    for i in varying:
        host = slices.gather_input(planes[i], axes[i], meta, digits, 1)
        dev = slices.gather_input(planes[i], axes[i], meta, dev_digits, 1)
        assert torch.equal(host, dev)
        for r in range(len(ids)):
            one = slices.gather_input(planes[i], axes[i], meta,
                                      dev_digits[r:r + 1], 1)
            want = slices._select_input(planes[i], axes[i], meta, digits[r], 1)
            assert torch.equal(one[0], want)


# -- the capture-safety proxy ----------------------------------------------


class _NoHostTraffic(TorchDispatchMode):
    """Fails on what a CUDA graph capture refuses or silently bakes in: a
    host sync (``aten._local_scalar_dense``: ``.item()``, ``.tolist()``,
    ``bool()``) and any op that reads a CPU tensor (a copy from the
    host, or a CPU scalar tensor read as a kernel argument)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError(f"host sync: {func}")
        flat, _ = tree_flatten((args, kwargs))
        for t in flat:
            if isinstance(t, torch.Tensor) and t.device.type == "cpu":
                raise AssertionError(f"{func} reads a CPU tensor")
        return func(*args, **kwargs)


def _meta_chain(spec, x, ys):
    """The chain step on meta tensors: its device tables must be there
    already (a copy made now would happen inside a capture)."""
    _kernel_args(spec, x.device)
    S = _slices_of(x, ys)
    lead = () if S is None else (S,)
    return x.new_empty(lead + (2 * spec.gate_strides[-1].numel_out,))


@pytest.mark.parametrize("mode", ["scan", "vmap"])
@pytest.mark.parametrize("plan,gate_mode", [
    ("sycamore53_m10_t27", "inplace"),
    ("sycamore53_m20_t28", "inplace"),
    ("sycamore53_m10_t27", "window"),
])
def test_staged_program_is_capture_safe_on_meta(plan, gate_mode, mode,
                                                monkeypatch):
    """The captured-mode step program of the staged contractor at full
    width, on meta tensors with the digit buffer a meta tensor: no host
    sync, no CPU tensor read, no table copied to the device after plan
    time; every chain runs (once a call where slice-invariant); the
    output has the batch's shape."""
    monkeypatch.setattr(grouped, "resolve_device", torch.device)
    chains = []
    monkeypatch.setattr(
        grouped, "run_chain",
        lambda spec, x, ys: chains.append(spec) or _meta_chain(spec, x, ys),
    )
    inputs, output, size_dict = _instance(plan)
    tree = ctt.load_tree(str(ROOT / "plans" / f"{plan}.json"), inputs,
                         output, size_dict)
    S = 3
    fn = make_grouped_staged_contractor(
        tree, device="meta", slice_batch=S, slice_batch_mode=mode,
        gate_mode=gate_mode, strip_exponent=True,
    )
    planes = [torch.empty((2,) + s, device="meta") for s in tree.get_shapes()]
    digits = torch.empty((S, len(slices._digit_columns(fn.batch.meta))),
                         dtype=torch.int64, device="meta")
    calls = STEP_CALLS["_exec_steps_split"]
    with _NoHostTraffic():
        out, e = run_stages(fn.stages, (planes, digits, None))
    assert STEP_CALLS["_exec_steps_split"] > calls
    assert tuple(out.shape) == (S, 2) and tuple(e.shape) == (S,)
    inplace = [si for si, (k, _) in enumerate(fn.plans) if k == "inplace"]
    once = set(fn.batch.steps_once)
    expect = sum(1 if si in once or mode == "vmap" else S for si in inplace)
    assert len(chains) == expect
    if gate_mode == "window":
        assert not inplace
        assert all(info.index is not None
                   for kind, info in fn.plans if kind == "w2build")


# -- the rest of the public surface -------------------------------------------


def test_staged_grouped_gate_modes_match_the_eager_contractor():
    """``gate_mode=None`` (pair steps only), ``"window"`` (its operator
    builds as steps of their own) and ``fuse_gates`` through the stages
    equal the eager contractor's; ``precompile`` returns None under
    window, as the reference's."""
    _, tree, arrays, ids = _case("circuit")
    planes = ctt.to_plane_tensors(arrays, "cpu", torch.float64)
    for kw in ({"gate_mode": None}, {"gate_mode": "window"},
               {"fuse_gates": True}):
        for mode in ("scan", "vmap"):
            eager = ctt.make_grouped_contractor(
                tree, "cpu", torch.float64, slice_batch=4,
                slice_batch_mode=mode, **kw,
            )
            fn = make_grouped_staged_contractor(
                tree, stage_size=5, plane_dtype=torch.float64,
                slice_batch=4, slice_batch_mode=mode, device="cpu", **kw,
            )
            want = eager(planes, ids).numpy()
            assert_allclose(fn(planes, ids).numpy(), want, rtol=F64_RTOL,
                            atol=F64_RTOL * abs(want).max())
            window = kw.get("gate_mode") == "window"
            expect = None if window else len(fn.stages)
            assert fn.precompile(planes, ids) == expect


def test_staged_grouped_refuses_bad_calls():
    _, tree, arrays, _ = _case("gates")
    planes = ctt.to_plane_tensors(arrays, "cpu", torch.float64)
    fn = make_grouped_staged_contractor(
        tree, plane_dtype=torch.float64, slice_batch=2, device="cpu"
    )
    with pytest.raises(ValueError, match="on the host"):
        fn(planes, torch.zeros(2, dtype=torch.int64, device="meta"))
    for bad in ([4], [-1], []):
        with pytest.raises(ValueError):
            fn(planes, bad)
    with pytest.raises(ValueError, match="expected"):
        fn(planes[1:], [0])
    with pytest.raises(ValueError, match="slice_batch_mode"):
        make_grouped_staged_contractor(tree, slice_batch=2, device="cpu",
                                       slice_batch_mode="map")
    # autojit=False runs the same stages and precompiles nothing
    off = make_grouped_staged_contractor(
        tree, plane_dtype=torch.float64, slice_batch=2, device="cpu",
        autojit=False,
    )
    assert torch.equal(off(planes, [1, 0]), fn(planes, [1, 0]))
    assert off.precompile(planes, [1, 0]) is None


@pytest.mark.parametrize("strip", [False, True])
@pytest.mark.parametrize("which", ["gates-chunked", _LATTICE_CASE])
def test_autojit_entry_points_run_eagerly_on_the_cpu(which, strip):
    """``autojit=True`` on ``make_full_contractor``, ``make_contractor``,
    ``contract_tree`` and an expression with constants: on the CPU the
    same eager call, equal to ``autojit=False`` bit for bit."""
    _, tree, arrays, _ = _case(which)
    tensors = ctt.to_tensors(arrays, "cpu", torch.float64)

    def same(a, b):
        if isinstance(a, tuple):
            return all(torch.equal(x, y) for x, y in zip(a, b))
        return torch.equal(a, b)

    for slice_batch in (None, 2):
        kw = dict(device="cpu", plane_dtype=torch.float64,
                  strip_exponent=strip, slice_batch=slice_batch)
        want = ctt.make_full_contractor(tree, **kw)(*tensors)
        assert same(
            ctt.make_full_contractor(tree, autojit=True, **kw)(*tensors), want
        )
        assert same(ctt.contract_tree(tree, arrays, autojit=True, **kw), want)
    sliced = ctt.slice_arrays(tree, tensors, 1)
    kw = dict(device="cpu", plane_dtype=torch.float64, strip_exponent=strip)
    assert same(ctt.make_contractor(tree, autojit=True, **kw)(*sliced),
                ctt.make_contractor(tree, **kw)(*sliced))
    expr = ctt.array_contract_expression(
        tree.inputs, tree.output, shapes=tree.get_shapes(), optimize=tree,
        constants={0: arrays[0], 2: arrays[2]},
    )
    rest = [a for i, a in enumerate(arrays) if i not in (0, 2)]
    kw = dict(device="cpu", plane_dtype=torch.float64, strip_exponent=strip)
    assert same(expr(*rest, autojit=True, **kw), expr(*rest, **kw))
