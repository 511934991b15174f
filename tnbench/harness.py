"""One run of one cell: resolve it by name, set up, run the closed loop
for a fixed time, profile a stretch (``trace``), judge the calls against
the plain reference, and build the result line.

Nothing here is particular to a cell: the cell's configuration, traffic,
metrics and comparison come from files found by name (see
``tnbench/__init__.py``).
"""

import dataclasses
import gc
import importlib
import importlib.util
import io
import json
import math
import random
import sys
import time
import traceback
from pathlib import Path

import numpy as np

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "cotengra_tpu")
PROFILE_ATTEMPTS = 3


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_benchmark(root):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def resolve_cell(root, name):
    """The cell ``name`` of the ``BENCHMARK.json`` at ``root``: its
    configuration and traffic files and the metrics it reports."""
    root = Path(root)
    bench = load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(root / "tnbench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=config,
        traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def load_file_module(path, name):
    """Import the Python file at ``path`` as module ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_path(root, metric):
    """The reader file of ``metric``: ``metrics/<metric>.py``, or, where
    there is none, that of the longest part of the name before a ``.``
    that has one. A split such as ``device.idle_share.values`` (the
    same quantity, moving another end-to-end metric) so reads with
    ``metrics/device.idle_share.py`` and needs no file of its own."""
    metrics = Path(root) / "tnbench" / "metrics"
    name = metric
    while not (metrics / f"{name}.py").is_file():
        if "." not in name:
            raise FileNotFoundError(f"no reader for metric {metric!r} in {metrics}")
        name = name.rsplit(".", 1)[0]
    return metrics / f"{name}.py"


def metric_reader(root, metric):
    """The ``read`` of ``metric``'s reader file (``metric_path``)."""
    path = metric_path(root, metric)
    mod = load_file_module(path, "tnbench_metric_" + path.stem.replace(".", "_").replace("-", "_"))
    return mod.read


def plugin(kind, name):
    """``tnbench/<kind>/<name>.py`` as a module (networks, entries,
    checks, reference)."""
    return importlib.import_module(f"tnbench.{kind}.{name}")


def forbidden_loaded():
    """Top-level module names of JAX or the JAX package in
    ``sys.modules``, compared whole (``cotengra_tpu_torch`` is not
    ``cotengra_tpu``)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


class Spans:
    """The benchmark's own spans around its calls into the program:
    ``{name: [(start, end), ...]}`` on the host's ``perf_counter``."""

    def __init__(self):
        self.spans = {}
        self.failures = 0

    def add(self, name, t0, t1):
        self.spans.setdefault(name, []).append((t0, t1))

    def span(self, name):
        spans = self

        class _Span:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                spans.add(name, self.t0, time.perf_counter())

        return _Span()

    def total(self, name):
        return sum(t1 - t0 for t0, t1 in self.spans.get(name, ()))


@dataclasses.dataclass
class CallRecord:
    index: int
    start: float
    returned: float
    end: float
    ok: bool
    value: tuple = None


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    setup_s: float
    spans: Spans
    calls: list
    window_s: float
    peak_bytes: int
    profile: object = None
    counters: dict = dataclasses.field(default_factory=dict)

    @property
    def completed(self):
        return [c for c in self.calls if c.ok]


@dataclasses.dataclass
class Context:
    """What an entry's ``prepare`` gets."""

    ctt: object
    tree: object
    sets: list
    device: object
    config: dict
    traffic: dict
    rng: random.Random
    spans: Spans


def _load_tree(ctt, config, inputs, output, size_dict):
    return ctt.load_tree(
        io.StringIO(json.dumps(config["plan"])), inputs, output, size_dict
    )


def _finite(value):
    mantissa, exponent = value
    return bool(np.isfinite(mantissa)) and bool(np.isfinite(exponent))


_REPORTED_FAILURES = 3


def _report(spans, k, what):
    """Print a failed call's reason, the first few of a run only."""
    spans.failures += 1
    if spans.failures <= _REPORTED_FAILURES:
        print(f"tnbench: call {k} {what}", file=sys.stderr)


def _run_call(session, k, spans):
    t0 = time.perf_counter()
    try:
        res = session.call(k)
        t1 = time.perf_counter()
        value = session.value(res)
        ok = _finite(value)
        if not ok:
            _report(spans, k, f"gave a non-finite value {value}")
    except Exception:  # a failed call is counted, the loop goes on
        t1 = time.perf_counter()
        value, ok = None, False
        _report(spans, k, f"raised:\n{traceback.format_exc()}")
    return CallRecord(k, t0, t1, time.perf_counter(), ok, value)


def setup(cell, seed, device, spans):
    """Inputs, plan, contractor and warm-up: returns ``(session, sets,
    inputs, output, size_dict, next call index)``."""
    import cotengra_tpu_torch as ctt

    config, traffic = cell.config, cell.traffic
    rng = random.Random(seed)
    with spans.span("setup.inputs"):
        gen = plugin("networks", config["network"]["generator"])
        inputs, output, size_dict, sets = gen.make_sets(
            config["network"], seed, int(traffic.get("input_sets", 1))
        )
    entry = plugin("entries", traffic["entry"]["kind"])
    with spans.span("setup.plan"):
        tree = _load_tree(ctt, config, inputs, output, size_dict)
    session = entry.prepare(Context(ctt, tree, sets, device, config, traffic, rng, spans))
    with spans.span("setup.warm"):
        k = 0
        for _ in range(int(traffic.get("warmup_calls", 1))):
            rec = _run_call(session, k, Spans())
            if not rec.ok:
                raise RuntimeError(f"warm-up call {k} failed")
            k += 1
    return session, sets, inputs, output, size_dict, k


def window(session, k0, seconds, spans):
    """The closed loop: whole calls, one after another, until
    ``seconds`` have passed. Returns ``(calls, window seconds, start)``."""
    calls = []
    t_first = time.perf_counter()
    k = k0
    while True:
        calls.append(_run_call(session, k, spans))
        k += 1
        if calls[-1].end - t_first >= seconds:
            break
    return calls, calls[-1].end - t_first, t_first


def _sample(calls, n, seed):
    """``n`` of the window's calls drawn from the seed (all if fewer)."""
    rng = random.Random(f"check:{seed}")
    if len(calls) <= n:
        return list(calls)
    return sorted(rng.sample(calls, n), key=lambda c: c.index)


def check_spec(cell):
    """The configuration's ``"check"``, with the traffic's overrides."""
    return dict(cell.config["check"], **cell.traffic.get("check", {}))


def program_options(cell):
    """The program's keyword options as the cell's files give them: the
    configuration's ``"options"``, then the traffic entry's."""
    return dict(cell.config.get("options", {}), **cell.traffic["entry"].get("options", {}))


def reference(cell, inputs, output, size_dict):
    """The plain reference that the configuration names, prepared for
    its network: ``tnbench/reference/<kind>.py`` for the ``"kind"`` of
    its ``"reference"`` (``contract``, the exact walk of the plan, where
    it names none). Its ``prepare`` gets the configuration with the
    options that the entry passes the program (``program_options``)."""
    conf = dict(cell.config, options=program_options(cell))
    kind = cell.config["reference"].get("kind", "contract")
    return plugin("reference", kind).prepare(conf, inputs, output, size_dict)


def judge(cell, session, calls, sets, inputs, output, size_dict, device, seed,
          controls=()):
    """Compare the window's sampled calls with the plain reference.

    Returns ``(worst, compared)``: ``worst["program"]`` is the check's
    number at its worst over the sampled calls, and ``worst[i]`` the
    same for ``controls[i]`` (``{"dtype", "tf32"}``: the reference in a
    lower precision put in the program's place, on the same calls)."""
    import torch

    conf = cell.config
    number = plugin("checks", check_spec(cell)["number"]).number
    plain = reference(cell, inputs, output, size_dict)
    strip = bool(conf["reference"].get("strip", False))
    sampled = _sample([c for c in calls if c.ok], int(cell.traffic["check_calls"]), seed)
    worst = {key: 0.0 if sampled else math.inf for key in ["program", *range(len(controls))]}
    log10_2 = math.log10(2.0)

    def contract(ids, s, prec):
        m, n, e = plain.contract(
            sets[s], ids, getattr(torch, prec["dtype"]), device,
            strip=strip, tf32=prec.get("tf32", False),
        )
        return (m, e * log10_2), (n, e * log10_2)

    for c in sampled:
        ids, s = session.describe(c.index)
        ref, norm = contract(ids, s, conf["reference"])
        worst["program"] = max(worst["program"], number(c.value, ref, norm))
        for i, prec in enumerate(controls):
            worst[i] = max(worst[i], number(contract(ids, s, prec)[0], ref, norm))
    return worst, len(sampled)


def verdict(cell, value, compared):
    """``({number: {"value", "limit", "calls"}}, within the limit)``."""
    spec = check_spec(cell)
    limit = float(spec["limit"])
    return {spec["number"]: {"value": value, "limit": limit, "calls": compared}}, value <= limit


def free_program(session):
    """Drop the program's device state (contractor, inputs, caches)
    before the reference runs on the card."""
    session.release()
    free_memory()


def free_memory():
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def device_info(chips):
    """``{"platform", "kind", "count", "power_limit_w"}`` of the card."""
    import subprocess

    import torch

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30,
        )
        power = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        power = None
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": chips,
        "power_limit_w": power,
    }


def run_cell(root, name, seed, seconds, trace, device="cuda", t_start=None,
             process=None):
    """Run cell ``name`` and return the result line's object (without
    ``device``'s card fields when ``device`` is the CPU, which only the
    tests use). ``t_start`` is the process's start; ``process`` the
    seconds of its steps before the call (imports, CUDA context), which
    the traced run's breakdown lists beside set-up's spans."""
    import torch

    t_entry = time.perf_counter()
    t_start = t_entry if t_start is None else t_start
    cell = resolve_cell(root, name)
    dev = torch.device(device)
    spans = Spans()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    session, sets, inputs, output, size_dict, k = setup(cell, seed, dev, spans)
    calls, window_s, t_first = window(session, k, seconds, spans)
    setup_s = t_first - t_start
    profile = None
    if trace:
        from tnbench import trace as tracing

        # the profiler now and then loses records; a stretch with no
        # whole call is profiled again, up to PROFILE_ATTEMPTS times
        n = int(cell.traffic.get("profile_calls", 3))
        k = calls[-1].index + 1
        for _ in range(PROFILE_ATTEMPTS):
            profile = tracing.profile_calls(session, k, n, dev)
            k += n
            if profile.whole():
                break
        syncs = tracing.entry_syncs(session, k)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    counters = dict(session.counters())
    if trace:
        counters["entry_syncs"] = syncs
    counters["setup_spans_s"] = dict(
        process or {"process": t_entry - t_start},
        **{n: spans.total(n) for n in ("setup.inputs", "setup.upload", "setup.plan", "setup.warm")},
    )
    run = Run(cell, setup_s, spans, calls, window_s, peak, profile, counters)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = metric_reader(root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    mode = getattr(session, "mode", None)
    free_program(session)
    worst, compared = judge(
        cell, session, calls, sets, inputs, output, size_dict, dev, seed
    )
    checked, within = verdict(cell, worst["program"], compared)
    failed = sum(1 for c in calls if not c.ok)
    result = {
        "correct": bool(within and failed == 0),
        "attempted": len(calls),
        "failed": failed,
        "metrics": metrics,
        "device": {"memory_peak_bytes": int(peak)},
    }
    if profile is not None:
        result["device"]["busy_s"] = profile.busy_s
        result["device"]["window_s"] = profile.window_s
        result["breakdown"] = profile.breakdown(mode, run.counters)
    result["check"] = checked
    return result
