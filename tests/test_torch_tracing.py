"""The program's spans (``cotengra_tpu_torch.tracing``) on the CPU: off
they record nothing; on, under a torch profiler session or
``tracing.record()``, each entry call's spans share its id and nest in
their parents, self times are spans less their children, the ring keeps
its bound and counts what it drops, and tiny contractions on each route
give the span names and one ``executor.step`` per step run, and a
compressed contraction its ``compressed.*`` spans, nested step,
neighbour pass, truncation, and its ``COUNTS``.
``tracing.STEP_CALLS`` counts the executors' step calls."""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cotengra_tpu_torch as ctt
from cotengra_tpu_torch import tracing

torch.set_num_threads(1)


def _gate_tree():
    """18 size-2 axes and six 2-qubit gates (a grouped route with
    in-place chains), sliced 4 ways, and complex64 inputs."""
    state = [f"a{k}" for k in range(18)]
    inputs = [tuple(state)]
    cur = list(state)
    for n, (i, j) in enumerate([(0, 1), (5, 6), (16, 17), (2, 12), (8, 9),
                                (13, 17)]):
        bi, bj = f"b{2 * n}", f"b{2 * n + 1}"
        inputs.append((bi, bj, cur[i], cur[j]))
        cur[i], cur[j] = bi, bj
    size_dict = {ix: 2 for t in inputs for ix in t}
    tree = ctt.ContractionTree.from_path(
        inputs, tuple(cur), size_dict, path=[(0, 1)] * (len(inputs) - 1)
    )
    tree.slice_(target_slices=4)
    rng = np.random.default_rng(0)
    arrays = [
        (rng.normal(size=s) + 1j * rng.normal(size=s)).astype(np.complex64)
        for s in ([2] * len(t) for t in inputs)
    ]
    return tree, arrays


def _stripped_tree():
    """Three float32 tensors on [-1, 1) closed into a scalar, sliced
    over ``i``: each slice's two steps are large enough for the
    matmul+|max| route."""
    inputs = [("i", "j", "k"), ("k", "l"), ("l", "j", "i")]
    size_dict = {"i": 3, "j": 128, "k": 128, "l": 128}
    tree = ctt.ContractionTree.from_path(
        inputs, (), size_dict, path=[(0, 1), (0, 1)]
    )
    tree.remove_ind_("i")
    rng = np.random.default_rng(1)
    arrays = [
        rng.uniform(-1, 1, size=[size_dict[ix] for ix in t]).astype(np.float32)
        for t in inputs
    ]
    return tree, arrays


def _slice_call():
    tree, arrays = _gate_tree()
    tensors = ctt.to_tensors(arrays, "cpu")
    return lambda: ctt.contract_slice(tree, tensors, 3, device="cpu"), 1


def _tree_call():
    tree, arrays = _stripped_tree()
    return lambda: ctt.contract_tree(
        tree, arrays, device="cpu", strip_exponent=True,
        implementation="pallas",
    ), tree.multiplicity


def _grouped_call(mode):
    tree, arrays = _gate_tree()
    planes = ctt.to_plane_tensors(arrays, "cpu")
    fn = ctt.make_grouped_contractor(
        tree, "cpu", slice_batch=4, slice_batch_mode=mode
    )
    return lambda: fn(planes, [0, 1, 2, 3]), 4


CALLS = {
    "slice": _slice_call,
    "tree-stripped": _tree_call,
    "grouped-scan": lambda: _grouped_call("scan"),
    "grouped-vmap": lambda: _grouped_call("vmap"),
}
# the entry kind each call opens (the CPU launches no kernel)
KINDS = {"slice": "slice", "tree-stripped": "tree", "grouped-scan": "grouped",
         "grouped-vmap": "grouped"}
NAMES = {"slices.select", "inputs.upload", "executor.steps", "executor.step"}


def _new(before):
    return [r for r in tracing.records() if r.index > before]


def _last_index():
    recs = tracing.records()
    return recs[-1].index if recs else -1


def _check_tree(recs):
    """One entry; every span in it shares its id and lies inside its
    parent, which is in the same entry."""
    entries = [r for r in recs if r.name == "entry"]
    assert len(entries) == 1
    (ent,) = entries
    by_index = {r.index: r for r in recs}
    assert ent.parent is None
    for r in recs:
        assert r.entry == ent.index
        assert r.start <= r.end
        if r is not ent:
            parent = by_index[r.parent]
            assert parent.start <= r.start and r.end <= parent.end
        assert set(r.attrs) == set(tracing.ATTRS[r.name])
    return ent


@pytest.mark.parametrize("case", sorted(CALLS))
def test_off_records_nothing(case):
    call, _ = CALLS[case]()
    before, dropped = tracing.records(), tracing.dropped()
    call()
    assert not tracing.ON
    assert tracing.records() == before and tracing.dropped() == dropped


@pytest.mark.parametrize("how", ["profiler", "record"])
@pytest.mark.parametrize("case", sorted(CALLS))
def test_spans_of_tiny_calls(case, how):
    call, slices = CALLS[case]()
    if how == "profiler":
        before = _last_index()
        with profile(activities=[ProfilerActivity.CPU]):
            call()
        recs = _new(before)
    else:
        with tracing.record():
            call()
        recs = tracing.records()
    assert not tracing.ON
    ent = _check_tree(recs)
    assert ent.attrs == {"kind": KINDS[case], "slices": slices}
    assert {r.name for r in recs} - {"entry"} == NAMES
    # one executor.step a step run, each inside its loop
    loops = [r for r in recs if r.name == "executor.steps"]
    steps = [r for r in recs if r.name == "executor.step"]
    assert len(steps) == sum(r.attrs["steps"] for r in loops)
    assert {r.parent for r in steps} <= {r.index for r in loops}


def test_step_kinds_and_upload_bytes():
    tree, arrays = _stripped_tree()
    with tracing.record():
        ctt.contract_tree(tree, arrays, device="cpu", strip_exponent=True,
                          implementation="pallas")
    recs = tracing.records()
    (up,) = [r for r in recs if r.name == "inputs.upload"]
    assert up.attrs == {"tensors": len(arrays),
                        "bytes": sum(a.nbytes for a in arrays)}
    kinds = collections.Counter(
        r.attrs["kind"] for r in recs if r.name == "executor.step"
    )
    assert kinds["bmm_absmax"] > 0 and set(kinds) <= {"pair", "bmm_absmax"}
    selects = [r for r in recs if r.name == "slices.select"]
    assert len(selects) == tree.multiplicity


def test_host_tensors_on_the_device_take_no_host_bytes():
    tree, arrays = _gate_tree()
    tensors = ctt.to_tensors(arrays, "cpu")
    assert tracing.host_bytes(tensors) == sum(a.nbytes for a in arrays)
    assert tracing.host_bytes(
        [torch.empty(3, device="meta")]) == 0


def test_inner_entries_open_no_entry():
    tree, arrays = _gate_tree()
    tensors = ctt.to_tensors(arrays, "cpu")
    with tracing.record():
        ctt.contract_slice(tree, tensors, 0, device="cpu")
        ctt.contract_core(tree, ctt.ops.slices.slice_arrays(tree, tensors, 1),
                          device="cpu")
    entries = [r for r in tracing.records() if r.name == "entry"]
    assert [r.attrs["kind"] for r in entries] == ["slice", "core"]


def test_a_raising_call_leaves_no_span_open():
    tree, arrays = _gate_tree()
    tensors = ctt.to_tensors(arrays, "cpu")
    with tracing.record():
        with pytest.raises(Exception):
            ctt.contract_slice(tree, tensors[:-1], 0, device="cpu")
        before = _last_index()
        ctt.contract_slice(tree, tensors, 0, device="cpu")
    _check_tree(_new(before))


def test_self_time_is_the_span_less_its_children():
    with tracing.record():
        tracing.begin()
        tracing.begin()
        tracing.end("executor.step", 0, "pair")
        tracing.begin()
        tracing.begin()
        tracing.end("kernel.launch", "gate_chain", 0, ((2,), (2,), []),
                    tracing.now())
        tracing.end("executor.step", 1, "inplace")
        tracing.end("executor.steps", 2)
    recs = tracing.records()
    assert [r.name for r in recs] == [
        "executor.steps", "executor.step", "executor.step", "kernel.launch"
    ]
    first = recs[0].index
    assert [r.index - first for r in recs] == [0, 1, 2, 3]
    assert [r.parent for r in recs] == [None, first, first, first + 2]
    own = tracing.self_ns(recs)
    for r in recs:
        kids = [c for c in recs if c.parent == r.index]
        assert own[r.index] == (r.end - r.start) - sum(
            c.end - c.start for c in kids
        )
        assert own[r.index] >= 0
    # planted times
    R = tracing.Record
    planted = [R(0, "entry", 0, 100, None, 0, {}),
               R(1, "executor.steps", 10, 90, 0, 0, {}),
               R(2, "kernel.launch", 20, 50, 1, 0, {}),
               R(3, "slices.select", 92, 99, 0, 0, {})]
    assert tracing.self_ns(planted) == {0: 13, 1: 50, 2: 30, 3: 7}


@pytest.mark.parametrize("capacity,spans", [(5, 8), (5, 5), (1, 3)])
def test_ring_keeps_its_bound_and_counts_drops(capacity, spans, monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", capacity)
    with tracing.record():
        for k in range(spans):
            tracing.begin()
            tracing.end("executor.steps", k)
    recs = tracing.records()
    kept = min(capacity, spans)
    assert len(recs) == kept
    assert [r.attrs["steps"] for r in recs] == list(range(spans - kept, spans))
    assert tracing.dropped() == spans - kept
    with tracing.record():
        pass
    assert tracing.records() == [] and tracing.dropped() == 0


def test_step_calls_is_the_tracers_counter():
    before = tracing.STEP_CALLS["_exec_steps_split"]
    _slice_call()[0]()
    assert tracing.STEP_CALLS["_exec_steps_split"] > before


def test_launch_attributes_a_site_leaves_out_read_none():
    """A chain pass's ``kernel.launch`` carries its gates in register
    groups, on the per-item path and its groups; the product's gives
    none of them, and reads None there."""
    with tracing.record():
        tracing.begin()
        tracing.end("kernel.launch", "bmm_absmax", 0, ((2,), (2,)),
                    tracing.now())
        tracing.begin()
        tracing.end("kernel.launch", "gate_chain", 0, ((2,), (2,), []),
                    tracing.now(), 5, 1, 3)
    bmm, chain = tracing.records()
    assert set(bmm.attrs) == set(chain.attrs) == set(
        tracing.ATTRS["kernel.launch"])
    assert [bmm.attrs[k] for k in ("reg_gates", "item_gates", "groups")] == [
        None, None, None]
    assert [chain.attrs[k] for k in ("reg_gates", "item_gates", "groups")] == [
        5, 1, 3]


def _launches(passes, kernel="gate_chain", step=0):
    """``passes`` as ``kernel.launch`` spans of one wrapper call inside
    an ``executor.step`` span."""
    tracing.begin()
    for shapes in passes:
        tracing.begin()
        tracing.end("kernel.launch", kernel, 0, shapes, tracing.now())
    tracing.end("executor.step", step, "inplace")


@pytest.mark.parametrize("on", [False, True])
def test_kernel_log_records_launches_on_or_off(on):
    """``kernel_log`` (what a capture keeps) logs each ``kernel.launch``
    as (kernel, the span it was opened in, shapes), in launch order;
    where spans were off it keeps none of them, and ``ON`` is as it
    was."""
    chain = [((8,), (16,), [(2, 2, 4)]), ((16,), (16,), [(2, 4, 4), (2, 2, 2)])]
    other = [((16,), (4,), [(2, 4, 1)])]
    bmm = [((1, 2, 3), (1, 3, 4))]
    with tracing.record():
        tracing.ON = on
        before = tracing.records()
        with tracing.kernel_log() as log:
            assert tracing.ON
            _launches(chain, step=0)
            _launches(bmm, "bmm_absmax", step=1)
            _launches(other, step=2)
        assert tracing.ON is on
        made = tracing.records()[len(before):]
    steps = [p for _, p, _ in log]
    assert steps[0] == steps[1] < steps[2] < steps[3]
    assert [(k, shapes) for k, _, shapes in log] == [
        ("gate_chain", chain[0]), ("gate_chain", chain[1]),
        ("bmm_absmax", bmm[0]), ("gate_chain", other[0]),
    ]
    assert len(made) == (7 if on else 0)
    if on:
        launches = [r for r in made if r.name == "kernel.launch"]
        assert [r.parent for r in launches] == steps


def test_capture_load_span_counts_the_copies():
    """``capture.load`` is one span a call: the tensors it copied into
    the static buffers and their bytes (none where the caller passed the
    buffers themselves)."""
    from cotengra_tpu_torch.ops.capture import load

    static = [torch.zeros(3, 2), torch.zeros(5, dtype=torch.complex64)]
    tensors = [torch.ones(3, 2), torch.ones(5, dtype=torch.complex64)]
    with tracing.record():
        load(static, tensors)
        load(static, static)
    first, second = tracing.records()
    assert first.name == second.name == "capture.load"
    assert first.attrs == {"tensors": 2, "bytes": 24 + 40}
    assert second.attrs == {"tensors": 0, "bytes": 0}
    assert all(torch.equal(s, t) for s, t in zip(static, tensors))


def _compressed_call():
    """A 5x5 bond-3 lattice at chi=4 (truncating), stripped, float64."""
    from cotengra_tpu_torch.pathfinders.compressed import (
        greedy_compressed_ssa,
    )

    inputs, output, shapes, size_dict = ctt.lattice_equation([5, 5],
                                                             d_min=3)
    rng = np.random.default_rng(3)
    arrays = [np.ones(s) + 0.05 * rng.normal(size=s) for s in shapes]
    tree = ctt.ContractionTreeCompressed.from_path(
        inputs, output, size_dict,
        ssa_path=greedy_compressed_ssa(inputs, output, size_dict, chi=4),
    )
    return lambda: tree.contract_compressed(
        arrays, chi=4, strip_exponent=True, device="cpu"
    ), tree


@pytest.mark.parametrize("how", ["profiler", "record"])
def test_spans_of_a_compressed_call(how):
    """One ``entry`` of kind ``compressed``; a ``compressed.step`` a
    contraction, each neighbour pass inside its step and each
    truncation inside a neighbour pass; ``COUNTS`` grows by the
    truncations recorded and their library QR operands."""
    from cotengra_tpu_torch.ops import compressed

    call, tree = _compressed_call()
    before = dict(compressed.COUNTS)
    if how == "profiler":
        first = _last_index()
        with profile(activities=[ProfilerActivity.CPU]):
            call()
        recs = _new(first)
    else:
        with tracing.record():
            call()
        recs = tracing.records()
    assert not tracing.ON
    ent = _check_tree(recs)
    assert ent.attrs == {"kind": "compressed", "slices": 1}
    by_index = {r.index: r for r in recs}
    names = collections.Counter(r.name for r in recs)
    steps = [r for r in recs if r.name == "compressed.step"]
    cuts = [r for r in recs if r.name == "compressed.truncate"]
    assert set(names) == {"entry", "compressed.step", "compressed.neighbours",
                          "compressed.truncate"}
    assert [r.attrs["index"] for r in steps] == list(range(tree.N - 1))
    assert {r.parent for r in steps} == {ent.index}
    assert names["compressed.neighbours"] == len(steps)
    for r in recs:
        if r.name == "compressed.neighbours":
            assert by_index[r.parent].name == "compressed.step"
            assert r.attrs["live"] >= 1
    assert cuts and all(
        by_index[r.parent].name == "compressed.neighbours"
        and r.attrs["k"] <= 4 < r.attrs["bond"] for r in cuts
    )
    grown = {k: compressed.COUNTS[k] - before[k] for k in before}
    # on the CPU both sides of every truncation take the library's QR
    assert grown == {"truncations": len(cuts), "qr_kernel": 0,
                     "qr_library": 2 * len(cuts)}


def test_a_compressed_call_off_records_nothing_and_counts():
    from cotengra_tpu_torch.ops import compressed

    call, _ = _compressed_call()
    with tracing.record():
        call()
    cuts = sum(r.name == "compressed.truncate" for r in tracing.records())
    before, dropped = tracing.records(), tracing.dropped()
    counts = dict(compressed.COUNTS)
    call()
    assert not tracing.ON
    assert tracing.records() == before and tracing.dropped() == dropped
    assert compressed.COUNTS["truncations"] == counts["truncations"] + cuts > 0
