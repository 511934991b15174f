"""The window engine (``gate_mode="window"``, ``ops/windowed.py``)
against the JAX package's on the same numpy inputs: the planner's
records field by field, the operator ``build_w4`` bit for bit in
float64, ``exec_window`` in every form, whole contractions (plain,
stripped, sliced under ``"scan"`` and ``"vmap"``), the layout
lookahead, and the operator hoist (``hoist_window_operators``): a
window step's operator built once per call where no sliced index
reaches its gates, per slice (or stacked for a batch) where one does.
Float64 planes on the CPU."""

import collections

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax.numpy as jnp

import cotengra_tpu as ctg
from cotengra_tpu.ops import grouped as ref_grouped
from cotengra_tpu.ops import windowed as ref_windowed
from cotengra_tpu.ops.grouped import make_grouped_staged_contractor

import cotengra_tpu_torch as ctt
from cotengra_tpu_torch.ops import grouped, grouped_plan, windowed

from test_torch_plans import _circuit_tree, canon_window

torch.set_num_threads(1)

F64_RTOL = 1e-10  # float64 in both packages, summed in another order


def make_gate_chain_instance(n_ax=17, n_gates=10, seed=0):
    """A big rank-``n_ax`` tensor with a sequence of small-gate
    absorptions (1- and 2-axis gates at assorted depths), contracted by
    a linear path (the instance of the JAX package's window tests).
    Returns (inputs, output, size_dict, arrays), complex128."""
    rng = np.random.default_rng(seed)
    axes = [f"x{i}" for i in range(n_ax)]
    sizes = {a: 2 for a in axes}
    inputs = [tuple(axes)]
    arrays = [
        rng.standard_normal(tuple(sizes[a] for a in axes))
        + 1j * rng.standard_normal(tuple(sizes[a] for a in axes))
    ]
    live = list(axes)
    nxt = 0
    for g in range(n_gates):
        nq = 1 + (g % 2)
        pos = rng.choice(len(live), size=nq, replace=False)
        c_legs = tuple(live[p] for p in sorted(pos))
        ny_legs = []
        for _ in range(nq):
            nm = f"n{nxt}"
            nxt += 1
            sizes[nm] = 2
            ny_legs.append(nm)
        K = 2 ** nq
        y = (
            rng.standard_normal((K, K))
            + 1j * rng.standard_normal((K, K))
        ) / np.sqrt(K)
        inputs.append(c_legs + tuple(ny_legs))
        arrays.append(y.reshape(tuple(2 for _ in range(2 * nq))))
        for cl, nl in zip(c_legs, ny_legs):
            live[live.index(cl)] = nl
    output = tuple(live)
    size_dict = {ix: 2 for term in inputs for ix in term}
    return inputs, output, size_dict, arrays


def linear_tree(inputs, output, size_dict):
    ssa = [(0, 1)]
    n = len(inputs)
    for k in range(2, n):
        ssa.append((n + k - 2, k))
    return ctg.ContractionTree.from_path(
        inputs, output, size_dict, ssa_path=ssa
    )


def _chain_instance(n_gates=12, seed=3):
    inputs, output, size_dict, arrays = make_gate_chain_instance(
        n_ax=17, n_gates=n_gates, seed=seed
    )
    return linear_tree(inputs, output, size_dict), arrays


def _chain_sliced():
    """The chain instance with two gate-input legs sliced: 4 slices,
    summands (not output chunks); the two gates read a sliced index."""
    inputs, output, size_dict, arrays = make_gate_chain_instance()
    tree = linear_tree(inputs, output, size_dict)
    for ix in (inputs[1][0], inputs[2][0]):
        assert ix not in output
        tree.remove_ind_(ix)
    assert tree.multiplicity == 4
    return tree, arrays


def _circuit():
    """A small random circuit whose largest intermediates take windows."""
    tree = _circuit_tree(24, 14, 2, 1)
    rng = np.random.default_rng(1)
    arrays = [
        rng.normal(size=s) + 1j * rng.normal(size=s)
        for s in tree.get_shapes()
    ]
    return tree, arrays


def _circuit_sliced():
    tree = _circuit_tree(24, 14, 2, 4)
    rng = np.random.default_rng(2)
    arrays = [
        rng.normal(size=s) + 1j * rng.normal(size=s)
        for s in tree.get_shapes()
    ]
    return tree, arrays


# -- the planner -----------------------------------------------------------


def _random_window_gates(rng, n):
    """An order of ``n`` legs (sizes 2 and 4) and a random chain of gate
    absorptions in ``plan_window_chain``'s form."""
    order0 = tuple(f"a{k}" for k in range(n))
    sizes = {ix: int(rng.choice([2, 2, 2, 4])) for ix in order0}
    cur = list(order0)
    gates = []
    for g in range(int(rng.integers(1, 12))):
        k = int(rng.integers(1, 4))
        c = tuple(str(ix) for ix in rng.choice(cur, size=k, replace=False))
        ny = tuple(f"g{g}_{j}" for j in range(int(rng.integers(1, 3))))
        for ix in ny:
            sizes[ix] = 2
        cur = [ix for ix in cur if ix not in c] + list(ny)
        gates.append((100 + g, None, c, ny, 200 + g))
    return order0, sizes, gates


@pytest.mark.parametrize("seed", range(12))
def test_window_records_equal(seed):
    """``plan_window_chain`` and ``plan_rotation`` give the reference's
    records (or its rejection reason) for every prefix of a random
    chain, field by field."""
    rng = np.random.default_rng(seed)
    order0, sizes, gates = _random_window_gates(rng, int(rng.integers(12, 20)))
    planned = 0
    for k in range(1, len(gates) + 1):
        got = windowed.plan_window_chain(order0, sizes, gates[:k])
        ref = ref_windowed.plan_window_chain(order0, sizes, gates[:k])
        if ref[0] is None:
            assert got == ref
            continue
        planned += 1
        assert got[1] is None
        assert [canon_window(r) for r in got[0]] == [
            canon_window(r) for r in ref[0]
        ]
    axes = [str(ix) for ix in rng.choice(order0, size=3, replace=False)]
    got = windowed.plan_rotation(order0, sizes, axes, 7)
    ref = ref_windowed.plan_rotation(order0, sizes, axes, 7)
    if ref[0] is None:
        assert got == ref
    else:
        assert canon_window(got[0]) == canon_window(ref[0])
    assert planned or seed % 2  # most chains plan


def _form_chain(form):
    """A one-gate chain on 18 binary legs whose window takes ``form``."""
    pos = {"prefix": (0, 1), "suffix": (16, 17), "interior": (13, 14),
           "multi": (3, 15)}[form]
    order0 = tuple(f"a{k}" for k in range(18))
    sizes = {ix: 2 for ix in order0}
    c = tuple(order0[p] for p in pos)
    ny = ("n0", "n1")
    sizes.update(n0=2, n1=2)
    return order0, sizes, [(1, None, c, ny, 2)]


def _planes(rng, shape, lead=()):
    return rng.normal(size=lead + (2,) + tuple(shape))


def _ref_exec(rec, x, ys):
    """The reference's exec_window (operator built inline) on numpy
    planes: ``x`` (2, *shape) of id 0 and gate planes by id."""
    temps = {0: jnp.asarray(x.reshape(-1))}
    for (y_id, _, K, N), y in zip(rec.gates, ys):
        temps[y_id] = jnp.asarray(y.reshape(-1))
    return np.asarray(
        ref_windowed.exec_window(rec, temps, {}, None, jnp.float64)
    )


@pytest.mark.parametrize("form", ["prefix", "suffix", "interior", "multi"])
def test_exec_window_forms(form):
    """Each form of one window step equals the reference's; a batch
    (x, the operator or both with a slice dim) equals its slices."""
    order0, sizes, gates = _form_chain(form)
    (rec,), why = windowed.plan_window_chain(order0, sizes, gates)
    (ref,), _ = ref_windowed.plan_window_chain(order0, sizes, gates)
    assert rec.form == ref.form == form
    rec.x_id = ref.x_id = 0
    rng = np.random.default_rng(0)
    x = _planes(rng, [sizes[a] for a in order0])
    ys = [_planes(rng, (K, N)) for _, _, K, N in rec.gates]
    w2 = windowed.build_w4(
        rec.recipe, [torch.from_numpy(y) for y in ys], torch.float64
    )
    got = windowed.exec_window(rec, torch.from_numpy(x).reshape(-1), w2)
    assert_allclose(got.numpy(), _ref_exec(ref, x, ys), rtol=1e-13,
                    atol=1e-13 * np.abs(x).max())

    xs = _planes(rng, [sizes[a] for a in order0], (3,))
    yb = [_planes(rng, (K, N), (3,)) for _, _, K, N in rec.gates]
    w2b = windowed.build_w4(
        rec.recipe, [torch.from_numpy(y) for y in yb], torch.float64
    )
    xsf = torch.from_numpy(xs).reshape(3, -1)
    for xb, wb in [(xsf, w2), (torch.from_numpy(x).reshape(-1), w2b),
                   (xsf, w2b)]:
        out = windowed.exec_window(rec, xb, wb)
        assert out.shape[0] == 3
        for s in range(3):
            xs_s = xb[s] if xb.dim() == 2 else xb
            w_s = wb[s] if wb.dim() == 3 else wb
            want = windowed.exec_window(rec, xs_s, w_s)
            assert torch.equal(out[s], want)


@pytest.mark.parametrize("seed", range(6))
def test_build_w4_bit_equal(seed):
    """The operator of every cluster of a random chain, and of a
    rotation, is the reference's in float64: bit for bit where the
    cluster has at most one gate (the expansion by one-hot products is
    exact), within a few ulps of its largest entry where gates are
    composed (the two packages' einsums sum a contraction in another
    order, with or without fused multiply-adds). A batched build equals
    the per-slice builds."""
    rng = np.random.default_rng(seed)
    order0, sizes, gates = _random_window_gates(rng, 14)
    recs, why = windowed.plan_window_chain(order0, sizes, gates)
    rot, _ = windowed.plan_rotation(order0, sizes, order0[-3:], 7)
    recs = (recs or []) + [rot]
    assert len(recs) > 1
    for rec in recs:
        ys = [_planes(rng, (K, N)) for _, _, K, N in rec.gates]
        got = windowed.build_w4(
            rec.recipe, [torch.from_numpy(y) for y in ys], torch.float64
        ).numpy()
        want = np.asarray(ref_windowed.build_w4(
            rec.recipe, [jnp.asarray(y) for y in ys], jnp.float64
        ))
        assert got.shape == (2 * rec.S_out, 2 * rec.S_in)
        if len(ys) <= 1:
            assert np.array_equal(got, want)
        else:
            eps = np.finfo(np.float64).eps
            assert_allclose(got, want, rtol=0,
                            atol=8 * eps * np.abs(want).max())
        if not ys:
            continue
        yb = [np.stack([y, 2 * y]) for y in ys]
        yb[0] = _planes(rng, yb[0].shape[2:], (2,))
        batched = windowed.build_w4(
            rec.recipe, [torch.from_numpy(y) for y in yb], torch.float64
        )
        for s in range(2):
            one = windowed.build_w4(
                rec.recipe, [torch.from_numpy(y[s]) for y in yb],
                torch.float64,
            )
            assert_allclose(batched[s].numpy(), one.numpy(), rtol=1e-14,
                            atol=1e-14)


# -- whole contractions ------------------------------------------------------


# The reference's operator hoist builds W2 from its gates' lineage run
# unstripped, while its per-slice program still strips that lineage and
# adds the exponent: a stripped value whose window gate comes from a
# stripped step is off by that exponent (cotengra_tpu/ops/grouped.py:
# 2049-2052 against 1591-1593). Its stripped runs are taken with the
# hoist off (CTG_HOIST_W2=0, read when the contractor is made: the
# operator built per slice from the stripped gates), which the port
# equals; the port's own hoist is exact.
def _ref_staged(tree, strip, **kw):
    with pytest.MonkeyPatch.context() as mp:
        if strip:
            mp.setenv("CTG_HOIST_W2", "0")
        return make_grouped_staged_contractor(
            tree, split_complex=True, plane_io=True,
            plane_dtype=jnp.float64, strip_exponent=strip, **kw
        )


def _ref_contract(tree, arrays, strip=False, fuse_gates=False,
                  gate_mode="window"):
    """The reference's staged split-complex contractor, slice by slice,
    summed (values: mantissa x 10^exponent)."""
    jcore = _ref_staged(tree, strip, stage_size=12, gate_mode=gate_mode,
                        fuse_gates=fuse_gates)
    planes = [ctt.to_plane_array(a) for a in arrays]
    acc = 0
    for i in range(tree.multiplicity):
        res = jcore(*ctt.slice_arrays(tree, planes, i, axis_offset=1))
        if strip:
            res = np.asarray(res[0]) * 10.0 ** float(np.asarray(res[1]))
        acc = acc + np.asarray(res)
    return acc[0] + 1j * acc[1]


def _port_contract(tree, arrays, strip=False, **kw):
    core = ctt.make_grouped_contractor(
        tree, "cpu", torch.float64, strip_exponent=strip, **kw
    )
    planes = ctt.to_plane_tensors(arrays, "cpu", torch.float64)
    acc = 0
    for i in range(tree.multiplicity):
        res = core(*ctt.slice_arrays(tree, planes, i, axis_offset=1))
        if strip:
            res = res[0].numpy() * 10.0 ** float(res[1])
        else:
            res = res.numpy()
        acc = acc + res
    return core, acc[0] + 1j * acc[1]


_CONTRACTIONS = {
    "chain": _chain_instance,
    "chain-sliced": _chain_sliced,
    "circuit": _circuit,
}


@pytest.mark.parametrize("strip", [False, True])
@pytest.mark.parametrize("case", list(_CONTRACTIONS))
def test_window_contraction_matches_reference(case, strip):
    tree, arrays = _CONTRACTIONS[case]()
    core, got = _port_contract(tree, arrays, strip, gate_mode="window")
    kinds = collections.Counter(k for k, _ in core.plans)
    assert kinds["window"] >= 1
    assert kinds["w2build"] == kinds["window"]
    want = _ref_contract(tree, arrays, strip)
    assert_allclose(got, want, rtol=F64_RTOL, atol=F64_RTOL * np.abs(want).max())
    exact = np.asarray(tree.contract(arrays))
    assert_allclose(got, exact, rtol=F64_RTOL,
                    atol=F64_RTOL * np.abs(exact).max())


def _per_slice(res, strip):
    if strip:
        planes, e = (np.asarray(r) for r in res)
        planes = planes * 10.0 ** e.reshape((-1,) + (1,) * (planes.ndim - 1))
    else:
        planes = np.asarray(res)
    return planes[:, 0] + 1j * planes[:, 1]


_SLICED = {"chain-sliced": _chain_sliced, "circuit-sliced": _circuit_sliced}


@pytest.mark.parametrize("strip", [False, True])
@pytest.mark.parametrize("mode", ["scan", "vmap"])
@pytest.mark.parametrize("case", list(_SLICED))
def test_batched_window_call_matches_reference(case, mode, strip):
    """``fn(raw planes, slice_ids)`` under ``gate_mode="window"`` equals
    the reference's batched call in the same mode, slice by slice (ids
    out of order)."""
    tree, arrays = _SLICED[case]()
    nsl = tree.multiplicity
    ids = [3, 0, 2]
    ref_fn = _ref_staged(tree, strip, slice_batch=nsl,
                         slice_batch_mode=mode, gate_mode="window")
    want = _per_slice(ref_fn(
        [jnp.asarray(ctt.to_plane_array(a)) for a in arrays],
        np.asarray(ids),
    ), strip)
    fn = ctt.make_grouped_contractor(
        tree, "cpu", torch.float64, strip_exponent=strip, slice_batch=nsl,
        slice_batch_mode=mode, gate_mode="window",
    )
    assert fn.mode == mode
    assert any(k == "window" for k, _ in fn.plans)
    res = fn(ctt.to_plane_tensors(arrays, "cpu", torch.float64), ids)
    got = _per_slice(
        tuple(r.numpy() for r in res) if strip else res.numpy(), strip
    )
    assert got.shape == want.shape
    for g, r in zip(got, want):
        assert_allclose(g, r, rtol=F64_RTOL, atol=F64_RTOL * np.abs(r).max())


@pytest.mark.parametrize("gate_mode,fuse", [("window", False),
                                            ("inplace", False),
                                            (None, True)])
def test_layout_lookahead_values_match_reference(gate_mode, fuse,
                                                 monkeypatch):
    """With the lookahead on in both packages the plans stay equal (see
    ``test_torch_plans.py``) and so do the values. The fused chains are
    held to the reference's unfused plan: the reference rounds a kron
    product to float32 (``test_torch_fused.py``)."""
    monkeypatch.setattr(ref_grouped, "_LAYOUT_LOOKAHEAD", True)
    monkeypatch.setattr(grouped_plan, "_LAYOUT_LOOKAHEAD", True)
    tree, arrays = _circuit()
    _, got = _port_contract(tree, arrays, gate_mode=gate_mode,
                            fuse_gates=fuse)
    want = _ref_contract(tree, arrays, gate_mode=gate_mode)
    assert_allclose(got, want, rtol=F64_RTOL,
                    atol=F64_RTOL * np.abs(want).max())


# -- the operator hoist -----------------------------------------------------


def _count_builds(monkeypatch):
    """Record the leading (slice) dims of every operator built."""
    builds = []
    build = grouped.build_w4

    def counted(recipe, ys, dtype, device=None):
        w2 = build(recipe, ys, dtype, device)
        builds.append(tuple(w2.shape[:-2]))
        return w2

    monkeypatch.setattr(grouped, "build_w4", counted)
    return builds


@pytest.mark.parametrize("mode", ["scan", "vmap"])
def test_operator_hoist_builds_once_per_call(mode, monkeypatch):
    """On the sliced chain instance the window steps whose gates no
    sliced index reaches build their operator once per call, the others
    once per slice (``"scan"``) or once stacked over the batch
    (``"vmap"``); values equal the unhoisted slice-by-slice run, where
    every step runs per slice. Folding the gates as constants leaves the
    later calls only the sliced operators."""
    tree, arrays = _chain_sliced()
    planes = ctt.to_plane_tensors(arrays, "cpu", torch.float64)
    ids = [0, 1, 2, 3]
    builds = _count_builds(monkeypatch)
    fn = ctt.make_grouped_contractor(
        tree, "cpu", torch.float64, slice_batch=4, slice_batch_mode=mode,
        gate_mode="window",
    )
    kinds = [fn.plans[si][0] for si in range(len(fn.plans))]
    once = [si for si in fn.batch.steps_once if kinds[si] == "w2build"]
    each = [si for si in fn.batch.steps_each if kinds[si] == "w2build"]
    assert once and each
    assert len(once) + len(each) == kinds.count("window")
    got = _per_slice(fn(planes, ids).numpy(), False)
    if mode == "scan":
        assert sorted(builds) == [()] * (len(once) + 4 * len(each))
    else:
        assert sorted(builds) == [()] * len(once) + [(4,)] * len(each)

    # unhoisted: every step of the plain contractor, slice by slice
    builds.clear()
    core = ctt.make_grouped_contractor(
        tree, "cpu", torch.float64, gate_mode="window"
    )
    for i in ids:
        out = core(*ctt.slice_arrays(tree, planes, i, axis_offset=1))
        assert_allclose(got[i], out[0].numpy() + 1j * out[1].numpy(),
                        rtol=1e-12, atol=1e-12 * np.abs(got[i]).max())
    assert len(builds) == 4 * (len(once) + len(each))

    # the gates as constants: folded operators are built by fold only
    builds.clear()
    fn = ctt.make_grouped_contractor(
        tree, "cpu", torch.float64, slice_batch=4, slice_batch_mode=mode,
        gate_mode="window", constants=range(1, tree.N),
    )
    folded = fn.fold(planes)
    assert len(builds) == len(once)
    builds.clear()
    again = _per_slice(fn(planes, ids, folded).numpy(), False)
    assert len(builds) == (4 if mode == "scan" else 1) * len(each)
    assert_allclose(again, got, rtol=1e-12, atol=1e-12 * np.abs(got).max())


def test_executor_plan_hoists_each_window_step():
    """Each window step of the executor plan reads its operator from the
    step just before it, which reads only the step's gates."""
    tree, _ = _chain_instance()
    fn = ctt.make_grouped_contractor(
        tree, "cpu", torch.float64, gate_mode="window"
    )
    io = list(grouped._step_io(fn.plans))
    for si, (kind, info) in enumerate(fn.plans):
        if kind != "window":
            continue
        assert fn.plans[si - 1] == ("w2build", info)
        assert io[si - 1] == (tuple(g[0] for g in info.rec.gates),
                              info.w2_id)
        assert io[si] == ((info.rec.x_id, info.w2_id), info.rec.out_id)
