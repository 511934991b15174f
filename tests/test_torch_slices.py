"""Slice batching in the port against the JAX package's, on the same
numpy inputs: the batched grouped call (``fn(planes, slice_ids)`` on the
raw plane stacks) against the reference's in both of its batch modes,
slice-id decoding (ids beyond int64, ``tree.slice_key`` order), input
selection on the committed m=20 plan, the split of the m=20 and m=10
t27 plans into slice-invariant and per-slice steps (the invariant steps
run once per call), and ``make_full_contractor(slice_batch=B)`` on both
routes. Float64 planes on the CPU; no m=20 slice is contracted."""

from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

import cotengra_tpu as ctg
from cotengra_tpu.ops import executor as ref_executor
from cotengra_tpu.ops import grouped as ref_grouped
from cotengra_tpu.utils.io import load_tree as ref_load_tree

import cotengra_tpu_torch as ctt
from cotengra_tpu_torch import config
from cotengra_tpu_torch.ops import grouped, slices
from cotengra_tpu_torch.ops.gate_chains import (
    build_chain_spec,
    run_chain_plain,
)
from cotengra_tpu_torch.ops.lowering import extract_contractions

from test_torch_chains import CASES as CHAIN_CASES
from test_torch_chains import _gates as _chain_gates
from test_torch_plans import _circuit_tree, _gate_tree

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
F64_RTOL = 1e-10  # float64 in both packages, summed in another order


def _port_tree(ref):
    """The port's tree with the reference tree's structure and slicing."""
    tree = ctt.ContractionTree(
        ref.inputs, ref.output, ref.size_dict, children=dict(ref.children)
    )
    for ix, si in ref.sliced_inds.items():
        tree.remove_ind_(ix, project=si.project)
    assert list(tree.sliced_inds) == list(ref.sliced_inds)
    assert (tree.nslices, tree.nchunks) == (ref.nslices, ref.nchunks)
    assert extract_contractions(tree) == extract_contractions(ref)
    return tree


def _gates_sliced():
    """The gate construction sliced by the reference's slicer."""
    tree = _gate_tree()
    tree.slice_(target_slices=4)
    return tree


def _gates_chunked():
    """The gate construction with one inner and one output-sliced index
    that only later gates reach (so its first chain is slice-invariant),
    and a projected index."""
    tree = _gate_tree()
    for ix, project in [("b5", None), ("b7", None), ("b9", 1)]:
        tree.remove_ind_(ix, project=project)
    return tree


def _circuit_sliced():
    return _circuit_tree(20, 8, 2, 8)


_CASES = {
    "gates": (_gates_sliced, [3, 0, 2]),
    "gates-chunked": (_gates_chunked, [3, 0, 2]),
    "circuit": (_circuit_sliced, [5, 0, 3]),
}


def _complex_arrays(tree, seed=0):
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=s) + 1j * rng.normal(size=s)
        for s in tree.get_shapes()
    ]


def _per_slice(res, strip):
    """Per-slice complex values from (B, 2, ...) planes (and exponents)."""
    if strip:
        planes, e = (np.asarray(r) for r in res)
        scale = 10.0 ** e.reshape((-1,) + (1,) * (planes.ndim - 1))
        planes = planes * scale
    else:
        planes = np.asarray(res)
    return planes[:, 0] + 1j * planes[:, 1]


@pytest.mark.parametrize("strip", [False, True])
@pytest.mark.parametrize("mode", ["scan", "vmap"])
@pytest.mark.parametrize("case", list(_CASES))
def test_batched_grouped_call_matches_reference(case, mode, strip):
    make, ids = _CASES[case]
    ref_tree = make()
    tree = _port_tree(ref_tree)
    nsl = tree.multiplicity
    arrays = _complex_arrays(tree)
    ref_fn = ref_grouped.make_grouped_staged_contractor(
        ref_tree, split_complex=True, plane_io=True, slice_batch=nsl,
        slice_batch_mode=mode, strip_exponent=strip,
    )
    ref = _per_slice(ref_fn(
        [jnp.asarray(ref_grouped.to_plane_array(a)) for a in arrays],
        np.asarray(ids),
    ), strip)
    fn = ctt.make_grouped_contractor(
        tree, "cpu", torch.float64, strip_exponent=strip, slice_batch=nsl,
        slice_batch_mode=mode,
    )
    assert fn.mode == mode
    res = fn(ctt.to_plane_tensors(arrays, "cpu", torch.float64), ids)
    if strip:
        assert res[1].shape == (len(ids),)
        got = _per_slice(tuple(r.numpy() for r in res), strip)
    else:
        got = _per_slice(res.numpy(), strip)
    assert got.shape == ref.shape
    for g, r in zip(got, ref):
        assert_allclose(g, r, rtol=F64_RTOL, atol=F64_RTOL * np.abs(r).max())


def test_invariant_steps_run_once_per_call(monkeypatch):
    """On the chunked gate construction the first chain reads no sliced
    index: one run per call, the other chain one per slice; the result
    equals the slice-by-slice contractor's."""
    tree = _port_tree(_gates_chunked())
    arrays = _complex_arrays(tree, seed=1)
    fn = ctt.make_grouped_contractor(tree, "cpu", torch.float64,
                                     slice_batch=4)
    kinds = [[fn.plans[si][0] for si in steps]
             for steps in (fn.batch.steps_once, fn.batch.steps_each)]
    assert kinds[0] == ["inplace"]
    assert kinds[1].count("inplace") == 1
    calls = []
    real = grouped.run_chain
    monkeypatch.setattr(
        grouped, "run_chain",
        lambda spec, x, ys: calls.append(spec) or real(spec, x, ys),
    )
    planes = ctt.to_plane_tensors(arrays, "cpu", torch.float64)
    ids = [2, 3, 1]
    res = fn(planes, ids)
    assert len(calls) == 1 + len(ids)
    one = ctt.make_grouped_contractor(tree, "cpu", torch.float64)
    for r, sid in zip(res, ids):
        want = one(*ctt.slice_arrays(tree, planes, sid, axis_offset=1))
        assert_allclose(r.numpy(), want.numpy(), rtol=F64_RTOL,
                        atol=F64_RTOL * want.abs().max().item())


def test_vmap_equals_scan_with_the_invariant_chain_once(monkeypatch):
    """On the chunked gate construction, ``"vmap"`` gives ``"scan"``'s
    per-slice planes and exponents; the invariant chain runs once per
    call in both, the other chain once per slice under scan and once
    per call (one batched run) under vmap."""
    tree = _port_tree(_gates_chunked())
    planes = ctt.to_plane_tensors(_complex_arrays(tree, seed=2), "cpu",
                                  torch.float64)
    calls = []
    real = grouped.run_chain
    monkeypatch.setattr(
        grouped, "run_chain",
        lambda spec, x, ys: calls.append(
            x.dim() == 2 or any(y.dim() == 4 for y in ys)
        ) or real(spec, x, ys),
    )
    ids = [2, 3, 1]
    got = {}
    for mode in ("scan", "vmap"):
        for strip in (False, True):
            calls.clear()
            fn = ctt.make_grouped_contractor(
                tree, "cpu", torch.float64, slice_batch=4,
                slice_batch_mode=mode, strip_exponent=strip,
            )
            got[mode, strip] = fn(planes, ids)
            # the invariant chain unbatched; the other on each slice's
            # operands (scan) or once on the batch's (vmap: its x is
            # shared, its gate batched)
            want = (
                [False] * (1 + len(ids)) if mode == "scan" else [False, True]
            )
            assert calls == want
    for strip in (False, True):
        scan, vmap = got["scan", strip], got["vmap", strip]
        if strip:
            assert vmap[1].shape == (len(ids),)
            scan = _per_slice(tuple(r.numpy() for r in scan), strip)
            vmap = _per_slice(tuple(r.numpy() for r in vmap), strip)
        else:
            scan, vmap = scan.numpy(), vmap.numpy()
        assert_allclose(vmap, scan, rtol=F64_RTOL,
                        atol=F64_RTOL * np.abs(scan).max())


@pytest.mark.parametrize("batched", ["x", "gates", "both"])
@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_batched_plain_chain_equals_per_slice(case, batched):
    """``run_chain_plain`` on a batch of 3 slices (x ``(S, 2 * numel)``,
    gates ``(S, 2, K, N)``, or both) equals the plain chain of each
    slice."""
    n, picks = CHAIN_CASES[case]
    spec, _, c_orders = build_chain_spec(*_chain_gates(n, picks))
    rng = np.random.default_rng(5)
    S = 3
    n_in = spec.gate_strides[0].numel_in
    xs = torch.from_numpy(rng.normal(size=(S, 2 * n_in)))
    ys = [
        torch.from_numpy(rng.normal(size=(S, 2, 2 ** len(c), 2 ** len(ny))))
        for c, ny in c_orders
    ]
    x_arg = xs if batched in ("x", "both") else xs[0]
    y_args = ys if batched in ("gates", "both") else [y[0] for y in ys]
    out = run_chain_plain(spec, x_arg, y_args)
    assert out.shape == (S, 2 * spec.gate_strides[-1].numel_out)
    for s in range(S):
        want = run_chain_plain(
            spec, x_arg[s] if x_arg.dim() == 2 else x_arg,
            [y[s] if y.dim() == 4 else y for y in y_args],
        )
        assert_allclose(out[s].numpy(), want.numpy(), rtol=1e-12,
                        atol=1e-12 * want.abs().max().item())


def _pair(mode, layout, B, M, K, N, scatter=None):
    from cotengra_tpu_torch.ops.grouped_plan import _GroupedPair

    p = _GroupedPair()
    p.x_id, p.y_id, p.out_id = 0, 1, 2
    p.x_plan = p.y_plan = None
    p.mode, p.x_layout = mode, layout
    p.B, p.M, p.K, p.N = B, M, K, N
    p.scatter = scatter
    return p


# (mode, x layout, B, M, K, N, scatter): every branch of a pair step
_PAIRS = {
    "mac-cm": ("mac", "cm", 1, 48, 4, 2, None),
    "mac-mc": ("mac", "mc", 1, 48, 4, 2, None),
    "matvec-cm": ("matvec", "cm", 1, 40, 16, 2, None),
    "matvec-mc": ("matvec", "mc", 1, 40, 16, 2, None),
    "mm-cm": ("mm", "cm", 1, 24, 16, 8, None),
    "mm-mc": ("mm", "mc", 1, 24, 16, 8, None),
    "bmm": ("bmm", "cm", 3, 10, 8, 4, None),
    # a stored (4, 2, 6, 4) view contracting its blocks 1 and 3 (K = 8)
    "scatter-mm": ("mm", "scat", 1, 24, 8, 8, ((4, 2, 6, 4), (1, 3))),
    "scatter-matvec": ("matvec", "scat", 1, 24, 8, 2,
                       ((4, 2, 6, 4), (1, 3))),
}

# the fallback einsum step: x (a, b, c), y (c, b, d) -> (b, a, d), the
# leg b kept as a batch leg
_FALLBACK = (("a", "b", "c"), ("c", "b", "d"), ("b", "a", "d"),
             (3, 4, 5), (5, 4, 2))


def _step_plans(pair):
    """(the port's plan entry, the reference's, x numel, y numel) of a
    pair step of ``_PAIRS`` or of ``"fallback"``: ids 0 and 1 into 2."""
    if pair == "fallback":
        from cotengra_tpu_torch.ops.lowering import PairStep

        x_order, y_order, out_legs, x_dims, y_dims = _FALLBACK
        step = PairStep(out=2, l=0, r=1, l_legs=x_order, r_legs=y_order,
                        out_legs=out_legs)
        info = (step, 0, 1, x_order, y_order, x_dims, y_dims)
        return ("fallback", info), ("fallback", info), 60, 40
    mode, layout, B, M, K, N, scatter = _PAIRS[pair]
    p = _pair(mode, layout, B, M, K, N, scatter)
    q = ref_grouped._GroupedPair()
    for field in ("x_id", "y_id", "out_id", "x_plan", "y_plan", "mode",
                  "x_layout", "B", "M", "K", "N", "scatter"):
        setattr(q, field, getattr(p, field))
    return ("pair", p), ("pair", q), B * M * K, B * K * N


def _ref_step(plan, flats, shapes, out_id, strip):
    """One reference plan entry through the reference's
    ``_exec_steps_split`` on one slice's float64 planes ``flats`` (ids
    0, 1, ...): (its output planes, its exponent or None)."""
    temps = {i: jnp.asarray(f.numpy()) for i, f in enumerate(flats)}
    e = ref_grouped._exec_steps_split(
        [plan], [0], temps, dict(shapes), {}, strip,
        jax.lax.Precision.HIGHEST, jnp.float64, None, jnp.float64,
    )
    return np.asarray(temps[out_id]), e


@pytest.mark.parametrize("strip", [False, True])
@pytest.mark.parametrize("batched", ["x", "y", "both", "neither"])
@pytest.mark.parametrize("pair", sorted(_PAIRS) + ["fallback"])
def test_batched_pair_step_equals_per_slice(pair, batched, strip):
    """Each branch of a pair step, and the fallback einsum step, on a
    batch of slices (x, y, both or neither with a leading slice dim)
    equals the step run slice by slice, its strip per slice included;
    each slice's result and exponent equal the reference's step
    (``ref_grouped._exec_steps_split``) on that slice's planes."""
    plan, ref_plan, nx, ny = _step_plans(pair)
    rng = np.random.default_rng(11)
    S = 3
    x = torch.from_numpy(rng.normal(size=(S, 2 * nx)))
    y = torch.from_numpy(rng.normal(size=(S, 2 * ny)))
    x_arg = x if batched in ("x", "both") else x[0]
    y_arg = y if batched in ("y", "both") else y[0]

    def run(xv, yv):
        temps = {0: xv, 1: yv}
        e = grouped._exec_steps_split(
            [plan], [0], temps, {}, {0: 0, 1: 0}, strip
        )
        assert set(temps) == {2}
        return temps[2], e

    out, e = run(x_arg, y_arg)
    if batched == "neither":
        assert out.dim() == 1
        if strip:
            assert e.shape == ()
        rows = [(0, out, e)]
    else:
        assert out.shape[0] == S and out.dim() == 2
        if strip:
            assert e.shape == (S,)
        rows = [(s, out[s], e[s] if strip else None) for s in range(S)]
    for s, got, got_e in rows:
        xs = x_arg[s] if x_arg.dim() == 2 else x_arg
        ys = y_arg[s] if y_arg.dim() == 2 else y_arg
        if batched != "neither":
            want, we = run(xs, ys)
            assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                            atol=1e-12 * want.abs().max().item())
            if strip:
                assert_allclose(got_e.item(), we.item(), rtol=1e-12)
        ref, ref_e = _ref_step(ref_plan, (xs, ys), {}, 2, strip)
        assert_allclose(got.numpy(), ref, rtol=F64_RTOL,
                        atol=F64_RTOL * np.abs(ref).max())
        if strip:
            assert_allclose(got_e.item(), float(ref_e), rtol=F64_RTOL)


def test_batched_single_step_equals_per_slice():
    """A single step (a trace and a transposition) on a batch of slices
    equals the step of each slice, and each slice's the reference's
    step on its planes."""
    from cotengra_tpu_torch.ops.lowering import SingleStep

    step = SingleStep(inp=0, out=1, in_legs=("a", "b", "a", "c"),
                      out_legs=("c", "a"))
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=(3, 2 * 3 * 4 * 3 * 5)))
    shapes = {0: (3, 4, 3, 5)}

    def run(xv):
        temps = {0: xv}
        grouped._exec_steps_split([("single", step)], [0], temps,
                                  dict(shapes), {0: 0})
        return temps[1]

    out = run(x)
    for s in range(3):
        want = run(x[s])
        assert_allclose(out[s].numpy(), want.numpy(), rtol=1e-12)
        ref, _ = _ref_step(("single", step), (x[s],), shapes, 1, False)
        assert_allclose(want.numpy(), ref, rtol=F64_RTOL)


# -- slice ids and selection ------------------------------------------------


def test_ids_to_digits_beyond_int64():
    """Digit decoding is exact for flat ids beyond int64, in every form
    the port takes, and equals the reference's."""
    meta = {f"i{k}": (4 ** (20 * k), 4, None) for k in range(5)}
    meta["p"] = (1, 1, 0)  # a projected index has no digit column
    ids = [0, 1, 4**20, 3 * 4**80 + 2 * 4**20 + 1]
    got = slices._ids_to_digits(np.asarray(ids, object), meta)
    ref = np.asarray(ref_grouped._ids_to_digits(np.asarray(ids, object), meta))
    assert slices._digit_columns(meta) == ref_grouped._digit_columns(meta)
    assert np.array_equal(got, ref)
    assert got[3].tolist() == [1, 2, 0, 0, 3]
    assert np.array_equal(slices._ids_to_digits(ids, meta), got)
    small = [0, 5, 4**20 + 7]
    want = slices._ids_to_digits(small, meta)
    for form in (torch.tensor(small), np.asarray(small, np.int64)):
        assert np.array_equal(slices._ids_to_digits(form, meta), want)
    assert np.array_equal(slices._ids_to_digits(range(3), meta),
                          slices._ids_to_digits([0, 1, 2], meta))
    assert slices._ids_to_digits(7, meta).tolist() == [[3, 0, 0, 0, 0]]


_M20 = {}


def _m20():
    """(port tree, reference tree, raw plane arrays) of the committed
    Sycamore-53 m=20 t28 plan."""
    if not _M20:
        inputs, output, _, _, arrays = ctt.rand_circuit_tn(53, 20, seed=42)
        inputs, arrays = ctt.absorb_simple_tensors(
            inputs, arrays, output, max_rank=2, max_absorb_size=2**12
        )
        size_dict = {
            ix: int(d) for t, a in zip(inputs, arrays)
            for ix, d in zip(t, a.shape)
        }
        path = str(ROOT / "plans" / "sycamore53_m20_t28.json")
        _M20["trees"] = (
            ctt.load_tree(path, inputs, output, size_dict),
            ref_load_tree(path, inputs, output, size_dict),
            [ctt.to_plane_array(a) for a in arrays],
        )
    return _M20["trees"]


_M20_IDS = [0, 1, 2**28, 2**29 - 1]


def test_ids_to_digits_follow_slice_key_on_m20():
    tree, ref, _ = _m20()
    assert tree.nslices == 2**29
    meta = slices._slice_meta(tree)
    assert meta == ref_executor._slice_meta(ref)
    cols = slices._digit_columns(meta)
    digits = slices._ids_to_digits(_M20_IDS, meta)
    for sid, row in zip(_M20_IDS, digits):
        key = tree.slice_key(sid)
        assert row.tolist() == [key[ix] for ix in cols]
    assert np.array_equal(digits, np.asarray(
        ref_grouped._ids_to_digits(np.asarray(_M20_IDS, object), meta)
    ))


def test_select_input_on_m20_planes():
    """The views of the raw m20 plane stacks for four slice ids equal
    the reference's selection and the host-sliced inputs."""
    tree, _, planes = _m20()
    meta = slices._slice_meta(tree)
    axes = slices._sliced_axes_per_input(tree)
    digits = slices._ids_to_digits(_M20_IDS, meta)
    touched = [i for i, ax in enumerate(axes) if ax]
    assert len(touched) > 29  # every sliced bond touches two tensors
    host = [slices.slice_arrays(tree, planes, sid, 1) for sid in _M20_IDS]
    for i in touched:
        ref = np.asarray(ref_grouped._select_input(
            jnp.asarray(planes[i]), axes[i], meta, jnp.asarray(digits),
            axis_offset=1,
        ))
        t = torch.from_numpy(planes[i])
        for r in range(len(_M20_IDS)):
            got = slices._select_input(t, axes[i], meta, digits[r], 1)
            assert np.array_equal(got.numpy(), ref[r])
            assert np.array_equal(got.numpy(), host[r][i])


def test_gather_input_on_m20_planes():
    """One gather per input of the four slice ids' digit rows (``"vmap"``)
    stacks the views that ``_select_input`` takes slice by slice."""
    tree, _, planes = _m20()
    meta = slices._slice_meta(tree)
    axes = slices._sliced_axes_per_input(tree)
    digits = slices._ids_to_digits(_M20_IDS, meta)
    for i in [i for i, ax in enumerate(axes) if ax]:
        t = torch.from_numpy(planes[i])
        got = slices.gather_input(t, axes[i], meta, digits, 1)
        assert got.is_contiguous()
        for r in range(len(_M20_IDS)):
            assert torch.equal(
                got[r], slices._select_input(t, axes[i], meta, digits[r], 1)
            )


def _sycamore(m, t):
    if m == 20:
        return _m20()[0]
    inputs, output, _, _, arrays = ctt.rand_circuit_tn(53, m, seed=42)
    inputs, arrays = ctt.absorb_simple_tensors(
        inputs, arrays, output, max_rank=2, max_absorb_size=2**12
    )
    size_dict = {
        ix: int(d) for tm, a in zip(inputs, arrays)
        for ix, d in zip(tm, a.shape)
    }
    return ctt.load_tree(
        str(ROOT / "plans" / f"sycamore53_m{m}_t{t}.json"),
        inputs, output, size_dict,
    )


@pytest.mark.parametrize(
    "m,t,once,each",
    [
        (20, 28, {"fallback": 172, "pair": 2, "inplace": 1},
         {"fallback": 82, "pair": 9, "inplace": 37}),
        (10, 27, {"fallback": 117}, {"fallback": 18, "pair": 11,
                                     "inplace": 13}),
    ],
)
def test_slice_invariant_partition_of_committed_plans(m, t, once, each):
    tree = _sycamore(m, t)
    fn = ctt.make_grouped_contractor(tree, "cpu", torch.float32,
                                     slice_batch=2)
    counts = []
    for steps in (fn.batch.steps_once, fn.batch.steps_each):
        kinds = {}
        for si in steps:
            kinds[fn.plans[si][0]] = kinds.get(fn.plans[si][0], 0) + 1
        counts.append(kinds)
    assert counts == [once, each]
    assert len(fn.plans) == sum(once.values()) + sum(each.values())


# the card's memory as torch reports an H100 80GB HBM3's (chip_smoke.py
# phase 33: 79.18 GiB)
_CARD_BYTES = 79.18 * 2**30


@pytest.mark.parametrize(
    "m,t,batch,mode",
    [
        (10, 27, 4, "vmap"),     # 4 x 3.0 GiB a slice
        (20, 28, 16, "scan"),    # 16 x 6.0 GiB do not fit
        (20, 28, 11, "vmap"),    # the most that fit
        (20, 28, 12, "scan"),
    ],
)
def test_auto_mode_of_committed_plans_on_the_card(m, t, batch, mode):
    """``"auto"``'s decisions on an 80 GB card, reckoned on the CPU from
    the plans' per-slice live peaks; on CPU tensors it takes "scan"."""
    from cotengra_tpu_torch.ops.simulate import step_records

    recs = step_records(_sycamore(m, t))
    got = grouped.auto_slice_batch_mode(
        torch.device("cuda"), batch, recs["slice_bytes"], recs["raw_bytes"],
        _CARD_BYTES,
    )
    assert got == mode
    assert grouped.auto_slice_batch_mode(
        "cpu", batch, recs["slice_bytes"], recs["raw_bytes"], _CARD_BYTES
    ) == "scan"
    if m == 20:
        assert grouped.vmap_max_batch(
            recs["slice_bytes"], recs["raw_bytes"], _CARD_BYTES) == 11


def test_m20_invariant_chain_runs_once_per_call(monkeypatch):
    """The whole m20 batched call, traced on meta tensors (shapes only,
    no data): the slice-invariant chain runs once per call, the other
    37 once per slice."""
    tree = _m20()[0]
    monkeypatch.setattr(grouped, "resolve_device", torch.device)
    calls = []

    def chain(spec, x, ys):
        calls.append(spec)
        return x.new_empty(2 * spec.gate_strides[-1].numel_out)

    monkeypatch.setattr(grouped, "run_chain", chain)
    fn = ctt.make_grouped_contractor(tree, "meta", torch.float32,
                                     slice_batch=2)
    planes = [torch.empty((2,) + s, device="meta")
              for s in tree.get_shapes()]
    out = fn(planes, [0, 2**29 - 1])
    assert tuple(out.shape) == (2, 2)
    assert len(calls) == 1 + 2 * 37


def test_slice_ids_and_modes_are_checked():
    tree = _port_tree(_gates_sliced())
    planes = ctt.to_plane_tensors(_complex_arrays(tree), "cpu",
                                  torch.float64)
    fn = ctt.make_grouped_contractor(tree, "cpu", torch.float64,
                                     slice_batch=2)
    # ids on a device (a CUDA tensor; a meta one stands in here) would
    # need a hidden sync
    with pytest.raises(ValueError, match="on the host"):
        fn(planes, torch.zeros(2, dtype=torch.int64, device="meta"))
    for bad in ([4], [-1], []):
        with pytest.raises(ValueError):
            fn(planes, bad)
    with pytest.raises(ValueError, match="expected"):
        fn(planes[1:], [0])
    # an explicit mode is kept on the CPU too; "auto" takes "scan" there
    for mode, want in [("vmap", "vmap"), ("scan", "scan"), ("auto", "scan")]:
        fn = ctt.make_grouped_contractor(tree, "cpu", torch.float64,
                                         slice_batch=2, slice_batch_mode=mode)
        assert fn.mode == want
        with pytest.raises(ValueError, match="on the host"):
            fn(planes, torch.zeros(2, dtype=torch.int64, device="meta"))
        with pytest.raises(ValueError, match="out of range"):
            fn(planes, [4])
    with pytest.raises(ValueError, match="slice_batch_mode"):
        ctt.make_grouped_contractor(tree, "cpu", torch.float64,
                                    slice_batch=2, slice_batch_mode="map")


# -- the full contraction in batches ------------------------------------------


def _six_slices():
    """A real equation sliced 2 x 3 ways: 6 inner slices, not a multiple
    of 4, so batches of 4 end short."""
    inputs, output, shapes, size_dict = ctg.rand_equation(
        9, 3, n_out=1, seed=6, d_min=2, d_max=3
    )
    ref = ctg.array_contract_tree(
        inputs, output, size_dict=size_dict, optimize="greedy"
    )
    ref.remove_ind_("d")
    ref.remove_ind_("b")
    assert ref.multiplicity == 6
    rng = np.random.default_rng(6)
    return ref, [rng.normal(size=s) for s in shapes]


@pytest.mark.parametrize("strip", [False, True])
@pytest.mark.parametrize("batch", [2, 4])
@pytest.mark.parametrize("route", [None, "grouped"])
def test_full_contractor_in_batches(route, batch, strip):
    ref_tree, arrays = _six_slices()
    tree = _port_tree(ref_tree)
    ref = ref_executor.make_full_contractor(
        ref_tree, slice_batch=batch, strip_exponent=strip,
        implementation=route,
    )(*arrays)
    tensors = ctt.to_tensors(arrays, "cpu", torch.float64)
    got, plain = (
        ctt.make_full_contractor(
            tree, "cpu", strip_exponent=strip, slice_batch=b,
            implementation=route, plane_dtype=torch.float64,
        )(*tensors)
        for b in (batch, None)
    )
    if strip:
        ref = np.asarray(ref[0]) * 10.0 ** float(ref[1])
        got = got[0].numpy() * 10.0 ** float(got[1])
        plain = plain[0].numpy() * 10.0 ** float(plain[1])
    else:
        got, plain = got.numpy(), plain.numpy()
    assert_allclose(got, np.asarray(ref), rtol=F64_RTOL)
    assert_allclose(got, plain, rtol=F64_RTOL)


def test_contract_tree_takes_slice_batch_from_config(monkeypatch):
    """The config default reaches the batched core: 6 slices in batches
    of 4 and 2, the same value."""
    ref_tree, arrays = _six_slices()
    tree = _port_tree(ref_tree)
    calls = []
    real = slices.SliceBatch.run

    def run(self, arrays, slice_ids, *args, **kwargs):
        calls.append(list(slice_ids))
        return real(self, arrays, slice_ids, *args, **kwargs)

    monkeypatch.setattr(slices.SliceBatch, "run", run)
    plain = ctt.contract_tree(tree, arrays, "cpu", plane_dtype=torch.float64)
    assert calls == []
    with config.default_options(slice_batch=4):
        got = ctt.contract_tree(tree, arrays, "cpu",
                                plane_dtype=torch.float64)
    assert calls == [[0, 1, 2, 3], [4, 5]]
    assert_allclose(got.numpy(), plain.numpy(), rtol=F64_RTOL)
