"""The program's spans read against a synthetic device timeline
(``program_spans.py``): the host-to-device offset recovered from the
kernels' launches, idle device time given to the innermost span open on
the host, calls with lost records skipped, and the readers of the new
per-layer metrics, which give None where there is nothing to read."""

import pytest

from cotengra_tpu_torch import tracing
from conftest import ROOT
from tnbench import harness, program_spans, trace

CHAIN = "gate_chain_kernel(float const*, float*, long const*, long const*, int)"
SPIN = "at::cuda::(anonymous namespace)::spin_kernel(long)"
OFFSET = 250.000123  # device clock less host clock, planted
LATENCY = (3e-6, 7e-6)  # launch to kernel start, the least first
MS = 1e-3

NEW = {
    "slices.select_ms": "m20-slices", "slices.select_ms.tasks": "m20-slice-tasks",
    "slices.select_ms.values": "lattice-values",
    "inputs.upload_ms": "m20-slices", "inputs.upload_ms.tasks": "m20-slice-tasks",
    "inputs.upload_ms.values": "lattice-values",
    "executor.steps_ms": "m20-slices", "executor.steps_ms.tasks": "m20-slice-tasks",
    "executor.steps_ms.values": "lattice-values",
    "gate_chain.launch_us": "m20-slices", "gate_chain.launch_us.tasks": "m20-slice-tasks",
    "bmm_absmax.launch_us": "lattice-values",
    "device.idle_steps_share": "m20-slices",
    "device.idle_steps_share.tasks": "m20-slice-tasks",
    "device.idle_steps_share.values": "lattice-values",
    "device.idle_inputs_share": "m20-slices",
    "device.idle_inputs_share.tasks": "m20-slice-tasks",
    "device.idle_inputs_share.values": "lattice-values",
}


def _ns(t):
    return round(t * 1e9)


def _call(base, first):
    """One call at host time ``base`` (s) whose records start at index
    ``first``: ``(records, per_call info, device events)``. In ms from
    ``base``: the entry 0.1-10.1, tiled by slices.select 0.1-1.2,
    inputs.upload 1.2-2.5 and executor.steps 2.5-10.1, whose two steps
    (2.5-6.0, 6.0-10.1) each end their work with a chain launch (5.0-5.5,
    9.0-9.5, the launch call at 5.4 and 9.4). The first kernel runs from
    3 us after its launch call until 8.0, the second from 7 us after
    until 29.0; the pull ends at 30.0."""
    R = tracing.Record
    e = first
    spans = [
        (0, "entry", 0.1, 10.1, None, ("slice", 1)),
        (1, "slices.select", 0.1, 1.2, 0, (49,)),
        (2, "inputs.upload", 1.2, 2.5, 0, (413, 0)),
        (3, "executor.steps", 2.5, 10.1, 0, (2,)),
        (4, "executor.step", 2.5, 6.0, 3, (0, "inplace")),
        (5, "kernel.launch", 5.0, 5.5, 4, ("gate_chain", 0, ((8,), (8,), []), 5.4)),
        (6, "executor.step", 6.0, 10.1, 3, (1, "inplace")),
        (7, "kernel.launch", 9.0, 9.5, 6, ("gate_chain", 1, ((8,), (8,), []), 9.4)),
    ]
    recs = [
        R(e + i, name, _ns(base + a * MS), _ns(base + b * MS),
          None if p is None else e + p, e, dict(zip(tracing.ATTRS[name], attrs)))
        for i, name, a, b, p, attrs in spans
    ]
    for r in recs:  # the launch calls' times, ms from base, in ns
        if r.name == "kernel.launch":
            r.attrs["launched"] = _ns(base + r.attrs["launched"] * MS)
    dev = base + OFFSET
    events = [
        {"name": SPIN, "t0": dev + 0.02 * MS, "t1": dev + 0.021 * MS},
        {"name": CHAIN, "t0": dev + 5.4 * MS + LATENCY[0], "t1": dev + 8.0 * MS},
        {"name": CHAIN, "t0": dev + 9.4 * MS + LATENCY[1], "t1": dev + 29.0 * MS},
    ]
    info = {
        "host": (base, base + 10.2 * MS, base + 30.0 * MS),
        "launches": {"gate_chain": 2, "bmm_absmax": 0},
        "shapes": {"gate_chain": [], "bmm_absmax": []},
    }
    return recs, info, events


def _run(n_calls=2, lose=None, lose_device=None):
    """A run whose profile holds ``n_calls`` such calls one second apart,
    with earlier entries (an earlier profile attempt) before them; the
    call ``lose`` lost its second launch record, ``lose_device`` one of
    its device records."""
    recs, per_call, events = list(_call(0.5, 0)[0]), [], []
    for k in range(n_calls):
        r, info, ev = _call(1.0 + k, 100 * (k + 1))
        if k == lose:
            r = [x for x in r if x.index != 100 * (k + 1) + 7]
        if k == lose_device:
            ev = ev[:-1]
        recs += r
        per_call.append(info)
        events += ev
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


def test_offset_is_recovered(use):
    run, recs = _run()
    use(recs)
    calls = program_spans.calls(run)
    assert len(calls) == 2
    for c in calls:
        assert abs(c.offset - OFFSET) < 20e-6
        assert abs(c.offset - OFFSET) == pytest.approx(LATENCY[0], abs=1e-6)


def test_idle_goes_to_the_innermost_span(use):
    run, recs = _run()
    use(recs)
    idle = program_spans.idle_by_span(run)
    # the offset reads late by the least latency, which shifts the idle
    # stretches on the host's clock: the call's start and the pull's
    # tail go outside, the steps' work before their launches to the
    # steps, each launch up to its kernel's start to the launch
    L0, L1 = LATENCY
    per_call = {
        "outside": 0.1 * MS + 1.0 * MS + L0,
        "slices.select": 1.1 * MS,
        "inputs.upload": 1.3 * MS,
        "executor.step": 2.5 * MS + 1.0 * MS + L0,
        "kernel.launch": 0.4 * MS + 0.4 * MS + L1 - L0,
    }
    assert set(idle) == set(per_call)
    for name, seconds in per_call.items():
        assert idle[name] == pytest.approx(2 * seconds, abs=2e-8), name
    total = sum(idle.values())
    steps = program_spans.idle_share(run, program_spans.STEP_SPANS)
    inputs = program_spans.idle_share(run, program_spans.INPUT_SPANS)
    assert steps + inputs + idle["outside"] / total == pytest.approx(1.0)
    assert inputs == pytest.approx(2 * 2.4 * MS / total)


def test_self_times_and_launches(use):
    run, recs = _run()
    use(recs)
    assert program_spans.self_ms(run, ("slices.select",)) == pytest.approx(1.1)
    assert program_spans.self_ms(run, ("inputs.upload",)) == pytest.approx(1.3)
    assert program_spans.self_ms(
        run, ("executor.steps", "executor.step")) == pytest.approx(7.6 - 1.0)
    assert program_spans.launch_us(run, "gate_chain") == pytest.approx(500.0)
    assert program_spans.launch_us(run, "bmm_absmax") is None


@pytest.mark.parametrize("lost", ["record", "device"])
def test_a_call_with_lost_records_is_skipped(use, lost):
    run, recs = _run(3, **{"lose" if lost == "record" else "lose_device": 1})
    use(recs)
    calls = program_spans.calls(run)
    assert [c.info["host"][0] for c in calls] == [1.0, 3.0]


def test_only_the_last_entries_are_the_profiled_calls(use):
    run, recs = _run(1)
    use(recs)
    (call,) = program_spans.calls(run)
    assert call.spans[0].index == 100


@pytest.mark.parametrize("what", ["no records", "no whole call", "no profile",
                                  "no tracer"])
def test_readers_give_none(use, monkeypatch, what):
    run, recs = _run(1, lose_device=0 if what == "no whole call" else None)
    use([] if what == "no records" else recs)
    if what == "no profile":
        run.profile = None
    if what == "no tracer":
        monkeypatch.setattr(program_spans, "_tracer", lambda: None)
    for name in NEW:
        assert harness.metric_reader(ROOT, name)(run) is None, name


def test_readers_of_the_new_metrics(use):
    run, recs = _run()
    use(recs)
    bench = harness.load_benchmark(ROOT)
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name, cell in NEW.items():
        assert entries[name]["workloads"] == [cell]
        value = harness.metric_reader(ROOT, name)(run)
        assert (value is None) == name.startswith("bmm_absmax"), name
