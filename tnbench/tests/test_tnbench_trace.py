"""The traced stretch's arithmetic on a synthetic device timeline: calls
cut at the marker kernels, whole calls told from calls with lost
records, idle gaps named by the host's span, and the readers of the
idle share and the rooflines on it."""

import json

import pytest

from tnbench import roofline, trace
from tnbench.readers import idle_share

CHAIN = "gate_chain_kernel(float const*, float*, long const*, long const*, int)"
BMM = "void (anonymous namespace)::bmm_absmax_kernel<true>(CUtensorMap_st, int)"
SPIN = "at::cuda::(anonymous namespace)::spin_kernel(long)"


def _ev(name, t0, t1):
    return {"name": name, "short": trace._short(name), "t0": t0, "t1": t1}


def _call(t0, t1, t2, chains, shapes=()):
    return {
        "host": (t0, t1, t2),
        "launches": {"gate_chain": chains, "bmm_absmax": 0},
        "shapes": {"gate_chain": list(shapes), "bmm_absmax": []},
    }


def test_short_names():
    assert trace._short(BMM) == "bmm_absmax_kernel"
    assert trace._short(CHAIN) == "gate_chain_kernel"
    assert trace._short("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"


def test_calls_cut_at_markers():
    # device clock = host clock + 100; two calls of 1 s wall each
    shape = ((2 * 2**20,), (2 * 2**20,), [(2, 4, 4)])
    events = [
        _ev(SPIN, 100.0, 100.001),
        _ev(CHAIN, 100.1, 100.3), _ev(CHAIN, 100.5, 100.6),
        _ev(SPIN, 101.0, 101.001),
        _ev(CHAIN, 101.2, 101.4),  # the second call's other launch was lost
    ]
    per_call = [_call(0.0, 0.4, 1.0, 2, [shape, shape]), _call(1.0, 1.4, 2.0, 2, [shape, shape])]
    prof = trace.cut_calls(events, per_call)
    first, second = prof.calls
    assert first["whole"] and not second["whole"]
    assert first["busy"] == pytest.approx(0.3) and first["wall"] == pytest.approx(1.0)
    assert first["own"]["gate_chain"] == (2, pytest.approx(0.3))
    # gaps: before the first kernel and between them under dispatch, the
    # tail under pull
    names = sorted(first["gaps"], key=lambda g: -g[1])
    assert names[0][0] == "pull" and names[0][1] == pytest.approx(0.4)
    assert {n for n, _ in first["gaps"]} == {"dispatch", "pull"}
    assert prof.whole() == [first]
    assert prof.busy_s == pytest.approx(0.5) and prof.window_s == pytest.approx(2.0)

    class Run:
        profile = prof

    assert idle_share(Run) == pytest.approx(0.7)
    bound = 2 * roofline.chain_bound_s(*shape)
    assert roofline.roofline(prof, "gate_chain") == pytest.approx(bound / 0.3)
    assert roofline.roofline(prof, "bmm_absmax") is None
    bd = prof.breakdown("vmap", {"slices_per_call": 11})
    assert bd["device_ops"][0][0] == "gate_chain_kernel" and len(bd["idle_gaps"]) <= 10
    assert bd["counters"]["calls_whole"] == 1
    json.dumps(bd)


def test_lost_marker_leaves_no_whole_call():
    events = [_ev(SPIN, 10.0, 10.001), _ev(CHAIN, 10.1, 10.2)]
    per_call = [_call(0.0, 0.1, 0.5, 1), _call(0.5, 0.6, 1.0, 1)]
    prof = trace.cut_calls(events, per_call)
    assert prof.whole() == []

    class Run:
        profile = prof

    assert idle_share(Run) is None and roofline.roofline(prof, "gate_chain") is None


def test_parse_reads_device_records(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": CHAIN, "ts": 2000000.0, "dur": 500.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1000000.0, "dur": 10.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1.0, "dur": 1.0},
        {"ph": "i", "cat": "kernel", "name": "x", "ts": 3.0},
    ]}))
    events = trace._parse(path)
    assert [e["short"] for e in events] == ["Memcpy HtoD", "gate_chain_kernel"]
    assert events[1]["t1"] - events[1]["t0"] == pytest.approx(500e-6)


def test_sync_site_is_the_programs_line():
    import traceback

    def frame(path, line):
        return traceback.FrameSummary(path, line, "f")

    stack = [
        frame("/x/tnbench/harness.py", 10),
        frame("/x/cotengra_tpu_torch/ops/executor.py", 694),
        frame("/x/cotengra_tpu_torch/convert.py", 46),
        frame("/venv/torch/cuda/__init__.py", 1270),
    ]
    assert trace.sync_site(stack, "w.py", 1) == "cotengra_tpu_torch/convert.py:46"
    assert trace.sync_site(stack[:1], "w.py", 1) == "tnbench/harness.py:10"
    assert trace.sync_site([frame("/venv/torch/a.py", 3)], "w.py", 1) == "w.py:1"


def test_entry_syncs_count_the_entry_alone(monkeypatch):
    """The synchronising calls made inside the entry are counted at the
    program's line; one made around it (here by switching the debug
    mode) is not."""
    import warnings

    import torch

    SYNC = "called a synchronizing CUDA operation"
    mode = [0]

    def set_mode(m):
        warnings.warn(SYNC)
        mode[0] = m

    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode[0])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)

    class Session:
        pulled = 0

        def call(self, k):
            for _ in range(k):
                warnings.warn(SYNC)
            warnings.warn("something else")
            return k

        def value(self, res):
            Session.pulled += 1

    got = trace.entry_syncs(Session(), 2)
    assert got["per_call"] == 2 and Session.pulled == 1
    [(site, n)] = got["sites"]
    assert site.startswith("tnbench/tests/test_tnbench_trace.py:") and n == 2
    assert mode[0] == 0
