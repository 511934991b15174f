"""The port's direct executor with exponent stripping against the JAX
package's, on the same numpy inputs: kernel routing on the committed
7x7 lattice plan, whole stripped contractions (lattice, output-sliced
random equation, zeros), the grouped split-complex strip, and the
pairwise pre-sum."""

from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

import cotengra_tpu as ctg
from cotengra_tpu.ops import executor as ref_executor
from cotengra_tpu.ops import pairwise as ref_pairwise
from cotengra_tpu.ops import pallas_bmm as ref_pallas_bmm
from cotengra_tpu.ops.grouped import make_grouped_staged_contractor
from cotengra_tpu.utils.io import load_tree

import cotengra_tpu_torch as ctt
from cotengra_tpu_torch.ops import executor
from cotengra_tpu_torch.ops.lowering import PairStep, extract_contractions
from cotengra_tpu_torch.ops.lowering import sliced_input_legs
from cotengra_tpu_torch.ops.pairwise import apply_pairwise

from test_torch_contract import _state_network

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
F64_RTOL = 1e-10  # float64 in both packages, summed in another order
F32_LOG10_ATOL = 1e-5  # a float32 contraction's log10 value vs float64


def _lattice(side, sliced=False):
    inputs, output, shapes, size_dict = ctg.lattice_equation(
        [side, side], d_min=16
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


def _chunked(seed=19, dtype=np.float64):
    """An output-sliced random equation: chunks x inner slices."""
    inputs, output, shapes, size_dict = ctg.rand_equation(
        12, 3, n_out=3, seed=seed, d_min=2, d_max=3
    )
    rng = np.random.default_rng(seed)
    arrays = [10.0 * rng.normal(size=s) for s in shapes]
    if dtype == np.complex128:
        arrays = [a + 10j * rng.normal(size=a.shape) for a in arrays]
    tree = ctg.array_contract_tree(
        inputs, output, size_dict=size_dict, optimize="greedy"
    )
    tree.slice_(target_slices=8, allow_outer="only")
    tree.slice_(target_slices=2 * tree.multiplicity)
    n_inner, n_chunks, _ = executor._chunk_structure(tree)
    assert n_inner > 1 and n_chunks > 1
    return tree, arrays


def _value(m, e, e_ref):
    """``m * 10**(e - e_ref)`` as numpy."""
    return np.asarray(m.numpy()) * 10.0 ** (float(e) - float(e_ref))


class _Recorder:
    """Stands in for ``pairwise_bmm_absmax``: records each routed step's
    legs and returns zeros of the output's shape."""

    def __init__(self, zeros):
        self.zeros = zeros
        self.steps = []

    def __call__(self, x, y, l_legs, r_legs, out_legs):
        self.steps.append((tuple(l_legs), tuple(r_legs), tuple(out_legs)))
        sizes = dict(zip(l_legs, x.shape)) | dict(zip(r_legs, y.shape))
        return self.zeros(tuple(sizes[ix] for ix in out_legs)), self.zeros(())


def test_kernel_routing_matches_reference_on_lattice_plan(monkeypatch):
    """On the committed 7x7 plan the port routes exactly the steps to the
    fused kernel that the reference routes, traced without computing:
    the reference under ``jax.eval_shape``, the port on meta tensors."""
    inputs, output, shapes, size_dict = ctg.lattice_equation(
        [7, 7], d_min=16
    )
    tree = load_tree(
        str(ROOT / "plans" / "lattice7x7_d16_s16.json"),
        inputs, output, size_dict,
    )
    assert tree.multiplicity == 16
    sliced = [
        tuple(size_dict[ix] for ix in sliced_input_legs(tree, i))
        for i in range(tree.N)
    ]

    ref_rec = _Recorder(lambda s: jnp.zeros(s, jnp.float32))
    monkeypatch.setattr(ref_pallas_bmm, "pairwise_bmm_absmax", ref_rec)
    ref_core = ref_executor.build_core_fn(
        ref_executor.extract_contractions(tree),
        strip_exponent=True, implementation="pallas",
    )
    jax.eval_shape(
        ref_core, *(jax.ShapeDtypeStruct(s, jnp.float32) for s in sliced)
    )

    rec = _Recorder(lambda s: torch.zeros(s, device="meta"))
    monkeypatch.setattr(executor, "pairwise_bmm_absmax", rec)
    ir = extract_contractions(tree)
    core = executor.build_core_fn(
        ir, strip_exponent=True, implementation="pallas"
    )
    core(*(torch.empty(s, device="meta") for s in sliced))

    assert rec.steps == ref_rec.steps
    n_pairs = sum(isinstance(s, PairStep) for s in ir.steps)
    assert (n_pairs, len(rec.steps)) == (48, 29)


@pytest.mark.parametrize("implementation", [None, "pallas", "grouped"])
@pytest.mark.parametrize("sliced", [False, True])
def test_stripped_lattice_matches_reference(implementation, sliced,
                                            monkeypatch):
    tree, arrays = _lattice(4, sliced)
    m_ref, e_ref = tree.contract(arrays, strip_exponent=True)
    m_ref, e_ref = np.asarray(m_ref), float(e_ref)
    log10_ref = np.log10(abs(float(m_ref))) + e_ref

    calls = []
    real = executor.pairwise_bmm_absmax
    monkeypatch.setattr(
        executor, "pairwise_bmm_absmax",
        lambda *a: calls.append(a[2:]) or real(*a),
    )
    m, e = ctt.contract_tree(
        tree, arrays, device="cpu", plane_dtype=torch.float64,
        strip_exponent=True, implementation=implementation,
    )
    # real inputs give a real result on every route, the grouped
    # split-complex one included
    assert m.dtype == torch.float64
    assert_allclose(_value(m, e, e_ref), m_ref, rtol=F64_RTOL)
    n_routed = len(calls)
    if implementation == "pallas":
        # unsliced, 6 of the 15 pair steps qualify (2 once sliced)
        assert n_routed == (2 if sliced else 6) * tree.multiplicity
    else:
        assert n_routed == 0

    m32, e32 = ctt.contract_tree(
        tree, [a.astype(np.float32) for a in arrays], device="cpu",
        strip_exponent=True, implementation=implementation,
    )
    assert m32.dtype == e32.dtype == torch.float32
    log10 = np.log10(abs(float(m32))) + float(e32)
    assert abs(log10 - log10_ref) <= F32_LOG10_ATOL
    # without stripping float32 holds the 4x4 value (~1e24) fine: the
    # stripped and plain routes agree
    plain = float(ctt.contract_tree(
        tree, [a.astype(np.float32) for a in arrays], device="cpu",
    ))
    assert abs(np.log10(plain) - log10_ref) <= F32_LOG10_ATOL


def test_benchmark_tree_and_slice_batch():
    tree, arrays = _chunked()
    res = ctt.benchmark_tree(tree, "cpu", repeats=1)
    assert res["time"] > 0
    assert res["flops"] == tree.total_flops(dtype="float32")
    # batches of 4 inner slices (output chunks reassembled) give the
    # unbatched value
    tensors = ctt.to_tensors(arrays, "cpu", torch.float64)
    batched = ctt.make_full_contractor(tree, "cpu", slice_batch=4,
                                       plane_dtype=torch.float64)
    plain = ctt.make_full_contractor(tree, "cpu", plane_dtype=torch.float64)
    assert_allclose(batched(*tensors).numpy(), plain(*tensors).numpy(),
                    rtol=F64_RTOL)


def test_config_default_implementation_reaches_the_kernel(monkeypatch):
    """The port's own config (not the JAX package's) sets the default
    route, on the port's own tree."""
    from cotengra_tpu_torch.config import default_implementation

    ref_tree, arrays = _lattice(4)
    tree = ctt.ContractionTree.from_path(
        ref_tree.inputs, ref_tree.output, ref_tree.size_dict,
        path=ref_tree.get_path(),
    )
    assert dict(tree.children) == dict(ref_tree.children)
    calls = []
    real = executor.pairwise_bmm_absmax
    monkeypatch.setattr(
        executor, "pairwise_bmm_absmax",
        lambda *a: calls.append(1) or real(*a),
    )
    with default_implementation("pallas"):
        ctt.contract_tree(tree, arrays, device="cpu", strip_exponent=True)
    assert len(calls) == 6
    with pytest.raises(ValueError):
        ctt.contract_tree(tree, arrays, device="cpu",
                          implementation="fused")


@pytest.mark.parametrize(
    "implementation,dtype",
    # complex inputs of low rank run as complex tensors on the direct
    # route, never through the kernel
    [(None, np.float64), ("pallas", np.float64), ("pallas", np.complex128)],
)
def test_stripped_output_chunks_match_reference(implementation, dtype):
    tree, arrays = _chunked(dtype=dtype)
    m_ref, e_ref = tree.contract(arrays, strip_exponent=True)
    m_ref, e_ref = np.asarray(m_ref), float(e_ref)
    kw = dict(plane_dtype=torch.float64, implementation=implementation)

    # make_full_contractor: inner sums, chunks stacked and reassembled
    m, e = ctt.contract_tree(
        tree, arrays, device="cpu", strip_exponent=True, **kw
    )
    assert m.shape == m_ref.shape
    assert m.is_complex() == (dtype == np.complex128)
    assert_allclose(_value(m, e, e_ref), m_ref, rtol=F64_RTOL)

    # the same through make_full_contractor on device tensors
    fn = ctt.make_full_contractor(
        tree, "cpu", strip_exponent=True, **kw
    )
    m2, e2 = fn(*ctt.to_tensors(arrays, "cpu", torch.float64))
    assert_allclose(_value(m2, e2, e_ref), m_ref, rtol=F64_RTOL)

    # gen_output_chunks, chunk by chunk against the reference's
    ref_chunks = dict(
        (tuple(sorted(k.items())), c)
        for k, c in ref_executor.gen_output_chunks(
            tree, arrays, strip_exponent=True
        )
    )
    seen = 0
    for key, (cm, ce) in ctt.gen_output_chunks(
        tree, arrays, "cpu", strip_exponent=True, **kw
    ):
        rm, re_ = ref_chunks[tuple(sorted(key.items()))]
        assert_allclose(_value(cm, ce, float(re_)), np.asarray(rm),
                        rtol=F64_RTOL)
        seen += 1
    assert seen == tree.nchunks

    # gather_slices over per-slice results of contract_slice
    slices = [
        ctt.contract_slice(tree, arrays, i, "cpu", strip_exponent=True,
                           **kw)
        for i in range(tree.multiplicity)
    ]
    m3, e3 = ctt.gather_slices(tree, slices, strip_exponent=True)
    assert_allclose(_value(m3, e3, e_ref), m_ref, rtol=F64_RTOL)

    # unstripped, the same machinery gives the plain value
    got = ctt.contract_tree(tree, arrays, device="cpu", **kw).numpy()
    assert_allclose(got, np.asarray(tree.contract(arrays)), rtol=F64_RTOL)


@pytest.mark.parametrize("implementation", [None, "pallas"])
def test_zero_array_strip_exponent(implementation):
    inputs = [("a", "b"), ("b", "c")]
    output = ("a", "c")
    arrays = [np.zeros((3, 3)), np.ones((3, 3))]
    tree = ctg.array_contract_tree(
        inputs, output, shapes=[(3, 3), (3, 3)], optimize="greedy"
    )
    m, e = ctt.contract_tree(
        tree, arrays, device="cpu", plane_dtype=torch.float64,
        strip_exponent=True, implementation=implementation,
    )
    assert float(e) == 0.0
    assert_allclose(m.numpy() * 10.0 ** float(e), np.zeros((3, 3)))


def test_grouped_strip_matches_reference():
    """The split-complex strip of the grouped executor (pair steps, not
    chains) equals the reference's staged contractor slice by slice,
    and its slice sums equal the reference's ``_add_stripped`` sum."""
    tree, arrays = _state_network()
    arrays = [np.asarray(a, np.complex128) for a in arrays]
    core = ctt.make_grouped_contractor(
        tree, "cpu", torch.float64, strip_exponent=True
    )
    assert any(kind == "inplace" for kind, _ in core.plans)
    jcore = make_grouped_staged_contractor(
        tree, stage_size=1000, strip_exponent=True, split_complex=True,
        plane_io=True, gate_mode="inplace",
    )
    planes = ctt.to_plane_tensors(arrays, "cpu", torch.float64)
    host_planes = [ctt.to_plane_array(a) for a in arrays]
    ref = None
    for i in range(tree.multiplicity):
        m, e = core(*ctt.slice_arrays(tree, planes, i, axis_offset=1))
        rm, re_ = jcore(
            *ctt.slice_arrays(tree, host_planes, i, axis_offset=1)
        )
        assert_allclose(_value(m, e, float(re_)), np.asarray(rm),
                        rtol=F64_RTOL)
        ref = (rm, re_) if ref is None else ref_executor._add_stripped(
            ref, (rm, re_)
        )
    m_ref, e_ref = np.asarray(ref[0]), float(ref[1])
    m_ref = m_ref[0] + 1j * m_ref[1]

    m, e = ctt.contract_tree(
        tree, arrays, device="cpu", plane_dtype=torch.float64,
        strip_exponent=True,
    )
    assert m.is_complex()
    assert_allclose(_value(m, e, e_ref), m_ref, rtol=F64_RTOL)
    ms, es = ctt.contract_slices(tree, core, planes)
    assert_allclose(
        _value(torch.complex(ms[0], ms[1]), es, e_ref), m_ref,
        rtol=F64_RTOL,
    )


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_pairwise_sums_one_sided_legs(dtype):
    """Legs on one side only and not kept are summed, as the reference's
    defensive pre-sum does."""
    rng = np.random.default_rng(3)

    def rnd(*shape):
        a = rng.normal(size=shape)
        if dtype == np.complex128:
            a = a + 1j * rng.normal(size=shape)
        return a

    x, y = rnd(2, 3, 4), rnd(4, 5, 6)
    legs = (("a", "b", "k"), ("k", "c", "d"), ("c", "a"))
    ref = np.asarray(ref_pairwise.apply_pairwise(
        jnp.asarray(x), jnp.asarray(y), *legs
    ))
    got = apply_pairwise(torch.from_numpy(x), torch.from_numpy(y), *legs)
    assert_allclose(got.numpy(), ref, rtol=1e-12)
    assert_allclose(
        got.numpy(), np.einsum("abk,kcd->ca", x, y), rtol=1e-12
    )
