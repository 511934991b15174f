"""Profiled calls that replay captured CUDA graphs, read with the
program's spans.

A replay calls no kernel wrapper, so ``trace.Recorder`` counts none of
its launches, and ``trace.cut_calls`` finds no such call whole: the
profiler sees the graph's kernels, the wrappers count none. The
program's ``capture.replay`` span (``cotengra_tpu_torch.tracing``)
carries, per graph, the kernel launches that its capture recorded
(``kernels``: ``(kernel, parent span, shapes)`` each), so here:

- a profiled call is *read* where it replayed a graph and its own
  records are intact (``program_spans``' rule: its entry inside the
  call on the host's clock, indices without a gap, one ``kernel.launch``
  per launch that the wrappers counted). Host spans' self times need no
  more (``self_ms``);
- the stretch's device records are cut into calls after each copy from
  the device to the host (``PULL``): the harness's pull ends every call
  with one (``_cut``). The profiler now and then loses records, at
  either end of a stretch most often and the marker kernels among
  them, so the markers are not used. Every call of a cell runs the same
  records: a part that holds each name as often as more than half of
  the parts do is one call whole, and any other part lost records and
  stands for as many calls as its size rounds to, none read;
- a read call is *whole* where its part is, and holds each hand-written
  kernel as often as the wrappers launched it plus the replays ran it.
  The device's idle share, its idle time by span and the chain roofline
  read the whole calls (``_whole``).

A program without the tracer or without these spans, or a run without a
profile, gives no calls, and the readers None.
"""

from collections import Counter

from tnbench.program_spans import NS, OUTSIDE, _idle, _intact, _segments, _tracer
from tnbench.roofline import chain_bound_s
from tnbench.trace import WRAPPERS, _union

# the device record that ends each call: the pull's copy to the host
PULL = "Memcpy DtoH"


class Replayed:
    """The ``i``-th profiled call (``info``, ``trace.cut_calls``) with its
    entry's records (``spans``), their self times in ns (``own``) and
    the kernels its replays ran (``replayed``: ``{kernel: {"launches",
    "shapes"}}``)."""

    def __init__(self, i, info, spans, own, replayed):
        self.i = i
        self.info = info
        self.spans = spans
        self.own = own
        self.replayed = replayed

    def ran(self, kernel):
        """Launches of ``kernel`` in the call: the wrappers' and the
        replays'."""
        return self.info["launches"][kernel] + self.replayed.get(kernel, {}).get("launches", 0)

    def chains(self):
        """The chain shapes of the call: the replays', then the
        wrappers'."""
        return self.replayed.get("gate_chain", {}).get("shapes", []) + self.info["shapes"]["gate_chain"]


def _replayed(spans):
    """``{kernel: {"launches", "shapes"}}`` that the call's
    ``capture.replay`` spans ran, the shapes as ``trace.Recorder`` logs
    a wrapper call: a chain's passes (its launches one after another in
    one span, one ``run_chain_cuda`` call) as the first pass's x, the
    last pass's result and every pass's gates."""
    out = {}
    for r in spans:
        if r.name != "capture.replay":
            continue
        for graph in r.attrs["kernels"] or ():
            last = None
            for kernel, parent, shapes in graph:
                rec = out.setdefault(kernel, {"launches": 0, "shapes": []})
                rec["launches"] += 1
                if kernel != "gate_chain":
                    rec["shapes"].append(shapes)
                elif last == (kernel, parent):
                    x, _, gates = rec["shapes"][-1]
                    rec["shapes"][-1] = (x, shapes[1], gates + list(shapes[2]))
                else:
                    rec["shapes"].append((shapes[0], shapes[1], list(shapes[2])))
                last = (kernel, parent)
    return out


def calls(run):
    """The profiled calls of ``run`` that replayed a graph and whose
    records are intact, as ``Replayed``s."""
    if run.profile is None:
        return []
    tracing = _tracer()
    if tracing is None or "capture.replay" not in tracing.ATTRS:
        return []
    records = tracing.records()
    entries = [r for r in records if r.name == "entry"]
    by_entry = {}
    for r in records:
        by_entry.setdefault(r.entry, []).append(r)
    profiled = run.profile.calls
    n = min(len(profiled), len(entries))
    out = []
    for i, entry in zip(range(len(profiled) - n, len(profiled)), entries[len(entries) - n:]):
        info, spans = profiled[i], by_entry[entry.index]
        replayed = _replayed(spans)
        if replayed and _intact(info, entry, spans):
            out.append(Replayed(i, info, spans, tracing.self_ns(spans), replayed))
    return out


def _names(part):
    return frozenset(Counter(e["name"] for e in part).items())


def _cut(profile):
    """The profile's device records per call, None for a call that lost
    some; None where the parts do not add up to the calls."""
    parts, part = [], []
    for e in profile.events:
        part.append(e)
        if PULL in e["name"]:
            parts.append(part)
            part = []
    if part:  # the stretch's last pull was lost
        parts.append(part)
    names = [_names(p) for p in parts]
    if not names:
        return None
    common, seen = Counter(names).most_common(1)[0]
    if 2 * seen <= len(parts):
        return None
    size = sum(n for _, n in common)
    out = []
    for p, k in zip(parts, names):
        out += [p] if k == common else [None] * max(1, round(len(p) / size))
    return out if len(out) == len(profile.calls) else None


def _whole(run):
    """``[(call, its device records)]`` over the whole replayed calls."""
    read = calls(run)
    parts = _cut(run.profile) if read else None
    if parts is None:
        return []
    return [
        (c, parts[c.i]) for c in read
        if parts[c.i] is not None and all(
            sum(counted in e["name"] for e in parts[c.i]) == c.ran(k)
            for k, (_, _, _, counted) in WRAPPERS.items()
        )
    ]


def self_ms(run, names):
    """Host ms per replayed call in spans named ``names``, less their
    children: the mean over the calls read."""
    read = calls(run)
    if not read:
        return None
    total = sum(c.own[r.index] for c in read for r in c.spans if r.name in names)
    return total * NS * 1e3 / len(read)


def idle_share(run):
    """1 - (union of the device's records) / host wall, over the whole
    replayed calls (``readers.idle_share`` over these calls)."""
    whole = _whole(run)
    wall = sum(c.info["wall"] for c, _ in whole)
    if wall <= 0.0:
        return None
    busy = sum(_union([(e["t0"], e["t1"]) for e in part]) for _, part in whole)
    return 1.0 - busy / wall


def idle_by_span(run):
    """``{span name or "outside": idle device seconds}`` over the whole
    replayed calls (``program_spans.idle_by_span``'s split), or None.
    The clocks are tied at each call's pull: its last record ends
    before the host's pull returns, so the record's end less the call's
    host end bounds the offset from below, a few microseconds off."""
    whole = _whole(run)
    if not whole:
        return None
    out = {}
    for c, part in whole:
        t0, _, t2 = c.info["host"]
        off = part[-1]["t1"] - t2
        segs = _segments(c.spans)
        for a, b in _idle(part, t0 + off, t2 + off):
            a, b = a - off, b - off
            inside = 0.0
            for s, e, name in segs:
                d = min(b, e) - max(a, s)
                if d > 0:
                    out[name] = out.get(name, 0.0) + d
                    inside += d
            out[OUTSIDE] = out.get(OUTSIDE, 0.0) + (b - a) - inside
    return out


def idle_share_in(run, names):
    """The share of the device's idle time in the whole replayed calls
    during which the host's innermost span is one of ``names``."""
    idle = idle_by_span(run)
    total = sum(idle.values()) if idle else 0.0
    if total <= 0.0:
        return None
    return sum(v for k, v in idle.items() if k in names) / total


def chain_roofline(run):
    """The gate-chain kernel's least time over its device time in the
    whole replayed calls: ``roofline.chain_bound_s`` over the chains
    that the replayed graphs' captures recorded, and over any the
    wrappers recorded in the calls, against every device record of the
    kernel there."""
    whole = _whole(run)
    bound = sum(chain_bound_s(*rec) for c, _ in whole for rec in c.chains())
    names = WRAPPERS["gate_chain"][2]
    spent = sum(
        e["t1"] - e["t0"] for _, part in whole for e in part
        if any(n in e["name"] for n in names)
    )
    if bound <= 0.0 or spent <= 0.0:
        return None
    return bound / spent
