"""The traced stretch: ``torch.profiler`` over a few whole calls after
the window, the kernels' launch shapes recorded at the program's kernel
wrappers, and the device timeline cut into calls (``profile_calls``).

The profiler now and then loses a block of records, so a call counts as
whole only where the profiler's count of each hand-written kernel
equals the launches its wrapper counted in that call; the device
metrics read whole calls only.
"""

import json
import math
import os
import tempfile
import time

# kernel wrappers of the program: (module, function, the profiler's
# names of the kernels one launch runs, the one counted per launch)
WRAPPERS = {
    "gate_chain": (
        "cotengra_tpu_torch.ops.gate_chains", "run_chain_cuda",
        ("gate_chain_kernel",), "gate_chain_kernel",
    ),
    "bmm_absmax": (
        "cotengra_tpu_torch.ops.bmm_absmax", "bmm_absmax_cuda",
        ("bmm_absmax_kernel", "presplit_kernel", "splitk_reduce_absmax_kernel"),
        "bmm_absmax_kernel",
    ),
}
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the kernel of ``torch.cuda._sleep``, launched at each profiled call's start
MARKER = "spin_kernel"


def _shape_of(t):
    return tuple(int(d) for d in t.shape)


class Recorder:
    """Wraps the program's kernel wrappers for the stretch: each call's
    operand shapes go to ``self.log[kernel]``; the wrappers' own
    ``launches`` counters keep counting (a wrapper increments the
    attribute of whatever its module's name is bound to)."""

    def __init__(self):
        self.log = {k: [] for k in WRAPPERS}
        self.saved = []

    def launches(self):
        import importlib

        out = {}
        for k, (mod, fn, _, _) in WRAPPERS.items():
            out[k] = getattr(getattr(importlib.import_module(mod), fn), "launches", 0)
        return out

    def __enter__(self):
        import importlib

        for k, (mod_name, fn_name, _, _) in WRAPPERS.items():
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, fn_name)
            log = self.log[k]
            if k == "gate_chain":
                def wrapped(spec, x_flat, ys, _orig=orig, _log=log):
                    out = _orig(spec, x_flat, ys)
                    _log.append((_shape_of(x_flat), _shape_of(out), [_shape_of(y) for y in ys]))
                    return out
            else:
                def wrapped(x, y, _orig=orig, _log=log):
                    res = _orig(x, y)
                    _log.append((_shape_of(x), _shape_of(y)))
                    return res
            wrapped.launches = getattr(orig, "launches", 0)
            setattr(mod, fn_name, wrapped)
            self.saved.append((mod, fn_name, orig))
        return self

    def __exit__(self, *exc):
        for mod, fn_name, orig in self.saved:
            orig.launches = getattr(getattr(mod, fn_name), "launches", 0)
            setattr(mod, fn_name, orig)
        self.saved = []


def _union(intervals):
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _short(name):
    """A kernel's name without its return type, namespaces' anonymous
    marks, argument list and template arguments."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].split("<")[0].strip() or name


class Profile:
    """The traced stretch, cut into calls (times in seconds)."""

    def __init__(self, events, calls, window_s):
        self.calls = calls
        self.window_s = window_s
        self.events = events
        self.busy_s = _union([(e["t0"], e["t1"]) for e in events])

    def whole(self):
        return [c for c in self.calls if c["whole"]]

    def breakdown(self, mode, counters):
        by_name = {}
        for e in self.events:
            by_name[e["short"]] = by_name.get(e["short"], 0.0) + e["t1"] - e["t0"]
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted((g for c in self.calls for g in c["gaps"]), key=lambda g: -g[1])[:10]
        n = max(1, len(self.calls))
        info = dict(counters)
        info["slice_batch_mode"] = mode
        info["launches_per_call"] = {
            k: sum(c["launches"][k] for c in self.calls) / n for k in WRAPPERS
        }
        info["calls_profiled"] = len(self.calls)
        info["calls_whole"] = len(self.whole())
        return {
            "device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps],
            "counters": info,
        }


def _parse(path):
    """The device records of a chrome trace: kernels, copies and
    memsets, times in seconds on the device's clock."""
    with open(path) as f:
        trace = json.load(f)
    events = []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "X" and ev.get("cat") in _DEVICE_CATS:
            t0 = float(ev["ts"]) * 1e-6
            t1 = t0 + float(ev.get("dur", 0.0)) * 1e-6
            events.append({"name": ev["name"], "short": _short(ev["name"]), "t0": t0, "t1": t1})
    return sorted(events, key=lambda e: e["t0"])


def _gaps(events, start, end, host, offset):
    """Idle stretches of the device from ``start`` to ``end`` (device
    clock), each named by the benchmark's span that was open on the
    host at its middle: ``dispatch`` (the entry had not returned),
    ``pull`` (the host waited for the result) or ``call``."""
    idle, last = [], start
    for e in events:
        if e["t0"] > last:
            idle.append((last, e["t0"]))
        last = max(last, e["t1"])
    if end > last:
        idle.append((last, end))
    t0, t1, t2 = host
    named = []
    for a, b in idle:
        mid = (a + b) / 2 - offset
        name = "dispatch" if t0 <= mid < t1 else "pull" if t1 <= mid <= t2 else "call"
        named.append((name, b - a))
    return named


def profile_calls(session, k0, n_calls, device):
    """Profile ``n_calls`` calls of ``session`` from call index ``k0``.

    Only the device is traced (no host operator records, which would
    slow the host and read as idle device time). Each call starts with
    a marker kernel (``torch.cuda._sleep``), which cuts the device's
    timeline into calls and ties the device's clock to the host's at
    the call's start; the host's clock gives each call's wall and its
    ``dispatch`` and ``pull`` spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    rec = Recorder()
    per_call = []
    with rec, tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for k in range(k0, k0 + n_calls):
                before = rec.launches()
                n_logs = {key: len(v) for key, v in rec.log.items()}
                t0 = time.perf_counter()
                torch.cuda._sleep(1)
                res = session.call(k)
                t1 = time.perf_counter()
                session.value(res)
                t2 = time.perf_counter()
                after = rec.launches()
                per_call.append({
                    "host": (t0, t1, t2),
                    "launches": {key: after[key] - before[key] for key in after},
                    "shapes": {key: rec.log[key][n_logs[key]:] for key in rec.log},
                })
            torch.cuda.synchronize(device)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = _parse(path)
    return cut_calls(events, per_call)


def cut_calls(events, per_call):
    """The ``Profile`` of a traced stretch: the device records
    ``events`` (``_parse``) cut into the calls of ``per_call`` (each
    with its host times ``(start, returned, end)``, the launches its
    wrappers counted and the shapes they recorded) at the marker
    kernels, one at each call's start."""
    markers = [e for e in events if MARKER in e["name"]]
    work = [e for e in events if MARKER not in e["name"]]
    calls = []
    for i, info in enumerate(per_call):
        t0, t1, t2 = info["host"]
        if len(markers) != len(per_call):
            # a marker was lost: the calls cannot be told apart
            calls.append(dict(info, wall=t2 - t0, busy=0.0, own={}, whole=False, gaps=[]))
            continue
        start = markers[i]["t0"]
        stop = markers[i + 1]["t0"] if i + 1 < len(markers) else math.inf
        offset = start - t0
        evs = [e for e in work if start <= e["t0"] < stop]
        own = {
            k: (
                sum(1 for e in evs if counted in e["name"]),
                sum(e["t1"] - e["t0"] for e in evs if any(n in e["name"] for n in names)),
            )
            for k, (_, _, names, counted) in WRAPPERS.items()
        }
        calls.append(dict(
            info, wall=t2 - t0, busy=_union([(e["t0"], e["t1"]) for e in evs]), own=own,
            whole=all(own[k][0] == info["launches"][k] for k in WRAPPERS),
            gaps=_gaps(evs, markers[i]["t1"], t2 + offset, info["host"], offset),
        ))
    window_s = per_call[-1]["host"][2] - per_call[0]["host"][0]
    return Profile(work, calls, window_s)


def entry_syncs(session, k):
    """The synchronising operations (``torch.cuda.set_sync_debug_mode``)
    that the program's entry runs in call ``k`` before it returns, where
    the host waits for the card inside the entry, so that
    ``executor.dispatch_ms`` holds device time too: ``{"per_call": n,
    "sites": [[file:line, n], ...]}``, the five commonest places
    (``sync_site``) that asked for them."""
    import traceback
    import warnings
    from collections import Counter

    import torch

    sites = Counter()
    inside = [False]  # counting only while the entry runs

    def record(message, category, filename, lineno, file=None, line=None):
        if inside[0] and "synchroniz" in str(message):
            sites[sync_site(traceback.extract_stack()[:-1], filename, lineno)] += 1

    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            inside[0] = True
            res = session.call(k)
        finally:
            inside[0] = False
            torch.cuda.set_sync_debug_mode(prev)
    session.value(res)
    return {
        "per_call": sum(sites.values()),
        "sites": [[site, n] for site, n in sites.most_common(5)],
    }


def sync_site(stack, filename, lineno):
    """``file:line`` of the innermost frame of ``stack`` in the program
    or the benchmark (the line that called into torch), else the
    warning's own place."""
    for frame in reversed(stack):
        path = frame.filename.replace(os.sep, "/")
        for top in ("cotengra_tpu_torch/", "tnbench/"):
            if top in path:
                return f"{top}{path.split(top)[-1]}:{frame.lineno}"
    return f"{filename}:{lineno}"


def kernel_seconds(call, kernel):
    """Device seconds of one wrapper's kernels in a profiled call (every
    kernel one of its launches runs)."""
    return call["own"][kernel][1]
