"""The program's own spans (``cotengra_tpu_torch.tracing``) over the
profiled calls, tied to the device trace.

The program records spans only while a torch profiler session records,
and ``trace.profile_calls`` opens one around exactly its calls, so the
program's last ``len(run.profile.calls)`` entry calls are the profiled
stretch that was kept (earlier attempts come before it). A call is read
where its device records arrived whole (``trace.py``) and its own
records are all there: its entry lies inside the call on the host's
clock, its spans' indices run on without a gap, and it holds one
``kernel.launch`` per launch that the wrappers counted.

The clocks are tied per call: the k-th device record of each
hand-written kernel in the call pairs with its k-th ``kernel.launch``
span, and the host-to-device offset is the least device start less the
span's host time just before its launch call (``launched``): a kernel
starts no earlier than that call, so each pair bounds the offset from
above, and the least is the tightest bound. Each stretch of
the call in which the device is idle, from the host start of the call
to the end of its pull, goes to the innermost span open on the host at
that time, or to ``"outside"`` where none is.

A program without the tracer, or a run without a profile, gives no
calls, and the readers None.
"""

from tnbench.trace import WRAPPERS

STEP_SPANS = ("executor.steps", "executor.step", "kernel.launch")
INPUT_SPANS = ("slices.select", "inputs.upload")
OUTSIDE = "outside"
NS = 1e-9


def _tracer():
    try:
        from cotengra_tpu_torch import tracing
    except ImportError:  # a program without the tracer
        return None
    return tracing


class Call:
    """A profiled call read with its spans: ``info`` is the profile's
    call (``trace.cut_calls``), ``spans`` its entry's records, ``own``
    their self times in ns (``tracing.self_ns``)."""

    def __init__(self, info, spans, own, kernel_events):
        self.info = info
        self.spans = spans
        self.own = own
        # device clock less host clock (s), None without a launch
        self.offset = min(
            (
                ev["t0"] - rec.attrs["launched"] * NS
                for kernel, events in kernel_events.items()
                for ev, rec in zip(events, self.launches(kernel))
            ),
            default=None,
        )

    def launches(self, kernel):
        return [
            r for r in self.spans
            if r.name == "kernel.launch" and r.attrs["kernel"] == kernel
        ]


def _kernel_events(profile):
    """Per profiled call, ``{kernel: its counted device records}``: each
    kernel's records in order, split between the calls by the calls'
    own counts."""
    per_call = [{} for _ in profile.calls]
    for kernel, (_, _, _, counted) in WRAPPERS.items():
        events = [e for e in profile.events if counted in e["name"]]
        at = 0
        for i, call in enumerate(profile.calls):
            n = call["own"].get(kernel, (0, 0.0))[0]
            per_call[i][kernel] = events[at:at + n]
            at += n
    return per_call


def _intact(info, entry, spans):
    t0, t1, _ = info["host"]
    if not (t0 <= entry.start * NS and entry.end * NS <= t1):
        return False
    if [r.index for r in spans] != list(range(entry.index, entry.index + len(spans))):
        return False
    return all(
        sum(1 for r in spans if r.name == "kernel.launch" and r.attrs["kernel"] == k)
        == info["launches"][k]
        for k in WRAPPERS
    )


def calls(run):
    """The whole profiled calls of ``run`` whose records (the program's
    ``tracing.records()``) are intact, as ``Call``s."""
    if run.profile is None:
        return []
    tracing = _tracer()
    if tracing is None:
        return []
    records = tracing.records()
    entries = [r for r in records if r.name == "entry"]
    by_entry = {}
    for r in records:
        by_entry.setdefault(r.entry, []).append(r)
    profiled = run.profile.calls
    events = _kernel_events(run.profile)
    n = min(len(profiled), len(entries))
    out = []
    for i, entry in zip(range(len(profiled) - n, len(profiled)), entries[len(entries) - n:]):
        info, spans = profiled[i], by_entry[entry.index]
        if info["whole"] and _intact(info, entry, spans):
            out.append(Call(info, spans, tracing.self_ns(spans), events[i]))
    return out


def self_ms(run, names):
    """Host ms per call in spans named ``names``, less their children:
    the mean over the calls read."""
    read = calls(run)
    if not read:
        return None
    total = sum(c.own[r.index] for c in read for r in c.spans if r.name in names)
    return total * NS * 1e3 / len(read)


def launch_us(run, kernel):
    """Host us per ``kernel.launch`` of ``kernel`` over the calls read."""
    spans = [r for c in calls(run) for r in c.launches(kernel)]
    if not spans:
        return None
    return sum(r.end - r.start for r in spans) * NS * 1e6 / len(spans)


def _segments(spans):
    """``[(start, end, name)]`` in host seconds, in order: where each
    span of one entry is the innermost one open."""
    kids = {}
    for r in spans:
        kids.setdefault(r.parent, []).append(r)
    out = []

    def walk(r):
        t = r.start
        for c in sorted(kids.get(r.index, ()), key=lambda c: c.start):
            if c.start > t:
                out.append((t * NS, c.start * NS, r.name))
            walk(c)
            t = max(t, c.end)
        if r.end > t:
            out.append((t * NS, r.end * NS, r.name))

    walk(next(r for r in spans if r.name == "entry"))
    return out


def _idle(events, start, end):
    """The device's idle stretches in ``[start, end]``, in order."""
    idle, last = [], start
    for e in sorted(events, key=lambda e: e["t0"]):
        if e["t1"] <= start or e["t0"] >= end:
            continue
        if e["t0"] > last:
            idle.append((last, e["t0"]))
        last = max(last, e["t1"])
    if end > last:
        idle.append((last, end))
    return idle


def idle_by_span(run):
    """``{span name or "outside": idle device seconds}`` over the calls
    read that have a clock tie; None where none has."""
    tied = [c for c in calls(run) if c.offset is not None]
    if not tied:
        return None
    out = {}
    for c in tied:
        t0, _, t2 = c.info["host"]
        off = c.offset
        segs = _segments(c.spans)
        j = 0
        for a, b in _idle(run.profile.events, t0 + off, t2 + off):
            a, b = a - off, b - off
            inside = 0.0
            while j < len(segs) and segs[j][1] <= a:
                j += 1
            k = j
            while k < len(segs) and segs[k][0] < b:
                s, e, name = segs[k]
                d = min(b, e) - max(a, s)
                if d > 0:
                    out[name] = out.get(name, 0.0) + d
                    inside += d
                k += 1
            out[OUTSIDE] = out.get(OUTSIDE, 0.0) + (b - a) - inside
    return out


def idle_share(run, names):
    """The share of the device's idle time in the calls read during
    which the host's innermost span is one of ``names``."""
    idle = idle_by_span(run)
    if idle is None:
        return None
    total = sum(idle.values())
    if total <= 0.0:
        return None
    return sum(v for k, v in idle.items() if k in names) / total
