"""Calls that replay captured CUDA graphs (``tnbench/replays.py``) read
against a synthetic device timeline: the stretch cut into calls at
their pulls, a call whole where its records are all there and the
profiler's kernels equal the wrappers' launches plus those the replays'
``capture.replay`` spans carry; the self times of the capture spans,
the idle share, its split by span and the chain roofline over those
calls; None on a program that records no ``capture.replay`` (the parent
of the cell ``m10-amplitudes``). And the cell itself, resolved from its
files in a copy of the benchmark, run on the CPU at a small size."""

import io
import json

import pytest

from cotengra_tpu_torch import tracing
from cotengra_tpu_torch.ops import capture
from conftest import ROOT, _plan, make_tiny
from tnbench import harness, program_spans, replays, roofline, trace

CHAIN = "gate_chain_kernel(float const*, float*, long const*, long const*, int)"
SPIN = "at::cuda::(anonymous namespace)::spin_kernel(long)"
HTOD = "Memcpy HtoD (Pageable -> Device)"
DTOH = "Memcpy DtoH (Device -> Pageable)"
OFFSET = 250.000123
MS = 1e-3
SHAPES = [((2 * 2**20,), (2 * 2**20,), [(2, 4, 4)]), ((2 * 2**20,), (2 * 2**19,), [(2, 4, 2)])]
# one graph's capture: two run_chain_cuda calls of one pass each
GRAPH = [("gate_chain", 7, SHAPES[0]), ("gate_chain", 9, SHAPES[1])]
SPANS = ("device.idle_share.amplitudes", "device.idle_inputs_share.amplitudes",
         "inputs.upload_ms.amplitudes", "capture.load_ms", "capture.chain_roofline")
# busy in a call: the upload's copy 0.5-0.6 ms, the chains 2.1-9.0, the pull 9.9-10.0
BUSY = 7.1 * MS
# idle on the host's clock: 0-0.5 (outside 0-0.1, inputs.upload 0.1-0.5),
# 0.6-2.1 (inputs.upload to 1.5, capture.load to 1.8, capture.replay to
# 2.0, entry), 9.0-9.9 (outside)
IDLE = {"outside": 1.0, "inputs.upload": 1.3, "capture.load": 0.3, "capture.replay": 0.2,
        "entry": 0.1}


def _ns(t):
    return round(t * 1e9)


def _call(base, first, graphs=(GRAPH,)):
    """One replayed call at host time ``base`` (s), records from index
    ``first``. In ms from ``base``: the entry 0.1-3.0, tiled by
    inputs.upload 0.1-1.5, capture.load 1.5-1.8 and capture.replay
    1.8-2.0; on the device (``OFFSET`` on), the marker, the upload's
    copy 0.5-0.6, the graph's two chain kernels 2.1-4.0 and 4.0-9.0 and
    the pull 9.9-10.0, which the host's pull returns at."""
    R = tracing.Record
    spans = [
        (0, "entry", 0.1, 3.0, None, ("tree", 4)),
        (1, "inputs.upload", 0.1, 1.5, 0, (182, 22528)),
        (2, "capture.load", 1.5, 1.8, 0, (182, 22528)),
        (3, "capture.replay", 1.8, 2.0, 0, (len(graphs), graphs)),
    ]
    recs = [
        R(first + i, name, _ns(base + a * MS), _ns(base + b * MS),
          None if p is None else first + p, first, dict(zip(tracing.ATTRS[name], attrs)))
        for i, name, a, b, p, attrs in spans
    ]
    dev = base + OFFSET
    events = {
        "marker": {"name": SPIN, "t0": dev + 0.02 * MS, "t1": dev + 0.021 * MS},
        "upload": {"name": HTOD, "t0": dev + 0.5 * MS, "t1": dev + 0.6 * MS},
        "chain": {"name": CHAIN, "t0": dev + 2.1 * MS, "t1": dev + 4.0 * MS},
        "chain2": {"name": CHAIN, "t0": dev + 4.0 * MS, "t1": dev + 9.0 * MS},
        "pull": {"name": DTOH, "t0": dev + 9.9 * MS, "t1": dev + 10.0 * MS},
    }
    info = {
        "host": (base, base + 3.1 * MS, base + 10.0 * MS),
        "launches": {"gate_chain": 0, "bmm_absmax": 0},
        "shapes": {"gate_chain": [], "bmm_absmax": []},
    }
    return recs, info, events


def _run(n_calls=2, lose=(), graphs=(GRAPH,)):
    """``n_calls`` such calls one second apart; ``lose`` holds ``(call,
    record)`` pairs that the profiler lost (a key of ``_call``'s
    events)."""
    recs, per_call, events = [], [], []
    for k in range(n_calls):
        r, info, ev = _call(1.0 + k, 100 * (k + 1), graphs)
        recs += r
        per_call.append(info)
        events += [e for name, e in ev.items() if (k, name) not in lose]
    events.sort(key=lambda e: e["t0"])
    for e in events:
        e["short"] = trace._short(e["name"])

    class Run:
        profile = trace.cut_calls(events, per_call)

    return Run, recs


@pytest.fixture
def use(monkeypatch):
    def put(recs):
        monkeypatch.setattr(tracing, "records", lambda: recs)

    return put


def _whole(run):
    return [c.info["host"][0] for c, _ in replays._whole(run)]


def test_replayed_calls_are_whole_counting_the_graphs_kernels(use):
    run, recs = _run()
    use(recs)
    # the wrappers counted no launch, the profiler saw two a call
    assert not run.profile.whole() and program_spans.calls(run) == []
    read = replays.calls(run)
    assert [c.info["host"][0] for c in read] == [1.0, 2.0] == _whole(run)
    assert read[0].chains() == SHAPES
    assert replays.self_ms(run, ("capture.load",)) == pytest.approx(0.3)
    assert replays.self_ms(run, ("capture.replay",)) == pytest.approx(0.2)
    assert replays.self_ms(run, ("inputs.upload",)) == pytest.approx(1.4)
    assert replays.idle_share(run) == pytest.approx(1 - BUSY / (10.0 * MS))
    idle = replays.idle_by_span(run)
    assert set(idle) == set(IDLE)
    for name, ms in IDLE.items():
        assert idle[name] == pytest.approx(2 * ms * MS, abs=1e-9), name
    assert replays.idle_share_in(run, program_spans.INPUT_SPANS) == pytest.approx(1.3 / 2.9)
    bound = sum(roofline.chain_bound_s(*s) for s in SHAPES)
    assert replays.chain_roofline(run) == pytest.approx(bound / (6.9 * MS))


def test_a_chains_passes_compose_as_the_recorder_logs_them(use):
    """Launches one after another in one span are one ``run_chain_cuda``
    call's passes: x of the first, the result of the last, every gate;
    a launch in another span starts a new call, and so does each
    graph."""
    passes = [("gate_chain", 7, SHAPES[0]), ("gate_chain", 7, SHAPES[1])]
    run, recs = _run(graphs=(passes, GRAPH))
    use(recs)
    chains = replays.calls(run)[0].chains()
    assert chains == [(SHAPES[0][0], SHAPES[1][1], SHAPES[0][2] + SHAPES[1][2])] + SHAPES
    assert replays.calls(run)[0].ran("gate_chain") == 4


@pytest.mark.parametrize("lost", ["chain", "upload", "marker", "pull"])
def test_a_call_with_a_lost_device_record_is_skipped(use, lost):
    """The second call of four lost a record: a chain kernel, a copy of
    the upload or its pull (which merges it with the next call: that
    part stands for two calls, neither read); its host spans are read
    all the same. A lost marker loses no work: every call is whole,
    where ``trace.cut_calls`` can cut none."""
    run, recs = _run(4, lose={(1, lost)})
    use(recs)
    assert [c.info["host"][0] for c in replays.calls(run)] == [1.0, 2.0, 3.0, 4.0]
    assert replays.self_ms(run, ("capture.load",)) == pytest.approx(0.3)
    whole = {"chain": [1.0, 3.0, 4.0], "upload": [1.0, 3.0, 4.0],
             "marker": [1.0, 2.0, 3.0, 4.0], "pull": [1.0, 4.0]}[lost]
    assert _whole(run) == whole
    if lost == "marker":
        assert all(not c["own"] for c in run.profile.calls)
    assert replays.idle_share(run) == pytest.approx(1 - BUSY / (10.0 * MS))
    assert replays.idle_share_in(run, program_spans.INPUT_SPANS) == pytest.approx(1.3 / 2.9)
    bound = sum(roofline.chain_bound_s(*s) for s in SHAPES)
    assert replays.chain_roofline(run) == pytest.approx(bound / (6.9 * MS))


def test_a_stretch_that_lost_its_end_reads_the_calls_before(use):
    """The stretch's last pull lost: its last call's records end the
    stretch without one, and stand for that call, not read."""
    run, recs = _run(3, lose={(2, "pull")})
    use(recs)
    assert _whole(run) == [1.0, 2.0]
    assert replays.idle_share(run) == pytest.approx(1 - BUSY / (10.0 * MS))


@pytest.mark.parametrize("lose", [
    {(0, "chain"), (1, "chain")},
    {(0, "pull"), (1, "pull"), (2, "pull")},
    {(0, "pull"), (2, "upload")},
])
def test_a_stretch_that_cannot_be_cut_reads_none(use, lose):
    """No more than half of the parts alike: two of three calls lost
    the same record, every pull was lost, or the first two calls merged
    and the last lost a copy. No call is whole and the device metrics
    read None; the host spans are read."""
    run, recs = _run(3, lose=lose)
    use(recs)
    assert _whole(run) == []
    assert replays.self_ms(run, ("capture.load",)) == pytest.approx(0.3)
    assert replays.idle_share(run) is None and replays.chain_roofline(run) is None
    assert replays.idle_share_in(run, program_spans.INPUT_SPANS) is None


def test_readers_of_the_new_metrics(use, monkeypatch):
    run, recs = _run()
    use(recs)
    bench = harness.load_benchmark(ROOT)
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in SPANS + ("capture.capture_s", "capture.replay_ms",
                         "executor.dispatch_ms.amplitudes"):
        assert entries[name]["workloads"] == ["m10-amplitudes"], name
    assert harness.metric_reader(ROOT, "capture.chain_roofline")(run) == pytest.approx(
        100 * replays.chain_roofline(run))
    assert harness.metric_reader(ROOT, "capture.load_ms")(run) == pytest.approx(0.3)
    assert harness.metric_reader(ROOT, "inputs.upload_ms.amplitudes")(run) == pytest.approx(1.4)
    assert harness.metric_reader(ROOT, "device.idle_inputs_share.amplitudes")(
        run) == pytest.approx(1.3 / 2.9)
    for name in SPANS:
        assert harness.metric_reader(ROOT, name)(run) is not None, name
    monkeypatch.setattr(capture, "COUNTS", {"captures": 1, "capture_s": 2.5,
                                            "replay_calls": 4, "replay_s": 0.0006})
    assert harness.metric_reader(ROOT, "capture.capture_s")(run) == 2.5
    assert harness.metric_reader(ROOT, "capture.replay_ms")(run) == pytest.approx(0.15)


@pytest.mark.parametrize("what", ["no capture spans", "no records", "no profile",
                                  "no tracer", "an old tracer"])
def test_readers_give_none_on_a_program_without_them(use, monkeypatch, what):
    """The parent's side: no ``capture.replay`` span (its calls replay
    all the same, so the profiler's kernels match nothing), no records,
    no profile, no tracer, a tracer that names no capture span; and no
    capture count, or none of the counts made."""
    run, recs = _run()
    if what == "no capture spans":
        recs = [r for r in recs if not r.name.startswith("capture.")]
    use([] if what == "no records" else recs)
    if what == "no profile":
        run.profile = None
    if what == "no tracer":
        monkeypatch.setattr(replays, "_tracer", lambda: None)
    if what == "an old tracer":
        attrs = {k: v for k, v in tracing.ATTRS.items() if not k.startswith("capture.")}
        monkeypatch.setattr(tracing, "ATTRS", attrs)
    for name in SPANS:
        assert harness.metric_reader(ROOT, name)(run) is None, (name, what)
    counts = ("capture.capture_s", "capture.replay_ms")
    monkeypatch.setattr(capture, "COUNTS", {"captures": 0, "capture_s": 0.0,
                                            "replay_calls": 0, "replay_s": 0.0})
    for name in counts:
        assert harness.metric_reader(ROOT, name)(run) is None, (name, what)
    monkeypatch.delattr(capture, "COUNTS")
    for name in counts:
        assert harness.metric_reader(ROOT, name)(run) is None, (name, what)


def test_m10_amplitudes_cell_from_its_files_in_a_copy(tmp_path):
    """The cell resolves from the files this benchmark has, in a copy;
    with its configuration cut to a 12-qubit m=4 circuit and a plan of
    the program's own (4 slices), a short run on the CPU (where
    ``autojit`` runs eagerly) reads correct against the complex128
    reference, bitstring after bitstring."""
    root = make_tiny(tmp_path)
    cell = harness.resolve_cell(root, "m10-amplitudes")
    assert cell.traffic["entry"] == {"kind": "full", "function": "contract_tree",
                                     "options": {"autojit": True}}
    assert cell.config["network"]["generator"] == "sycamore_bitstrings"
    path = root / "tnbench" / "configs" / "sycamore-like-6x9-m10.json"
    conf = json.loads(path.read_text())
    conf["network"].update(n_qubits=12, depth=4)
    gen = harness.plugin("networks", "sycamore_bitstrings")
    inputs, output, size_dict, _ = gen.make_sets(conf["network"], 0, 1)
    conf["plan"] = _plan(inputs, output, size_dict, 4)
    path.write_text(json.dumps(conf))
    res = harness.run_cell(root, "m10-amplitudes", 2**31 + 9, 0.3, False, "cpu")
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1, res
    assert set(res["metrics"]) == {"setup_s", "call_s"}
    check = res["check"]["slice_norm_err"]
    assert check["calls"] == min(4, res["attempted"]) and check["value"] <= 1e-5, check


def test_the_m10_plan_loads_on_every_bitstring():
    """The configuration's plan loads by its ``hash_b`` on the
    generator's network (``load_tree`` checks it), 4 slices of up to
    2^27."""
    import cotengra_tpu_torch as ctt

    cell = harness.resolve_cell(ROOT, "m10-amplitudes")
    gen = harness.plugin("networks", cell.config["network"]["generator"])
    inputs, output, size_dict, sets = gen.make_sets(cell.config["network"], 2**40 + 1, 16)
    assert len(sets) == 16 and len(inputs) == 182
    tree = ctt.load_tree(io.StringIO(json.dumps(cell.config["plan"])), inputs, output, size_dict)
    assert tree.multiplicity == 4 and tree.max_size() == 2**27
