"""CUDA graphs: the port's counterpart of the reference's ``jax.jit``.

The reference compiles a contraction into one XLA program per call, or
one per stage (``make_staged_contractor``,
``make_grouped_staged_contractor``), so that the host pays one dispatch
per program and none per step. Here a program is a list of *stages*:
functions from a state (a structure of tensors) to the next state, the
last returning the outputs. ``Graphs`` captures each stage into a
``torch.cuda.CUDAGraph`` of its own, all in one memory pool, so that
the tensors one stage leaves for the next keep their addresses from one
replay to the next; replaying every graph in order then runs the whole
program with no Python step in between. The first stage reads static
buffers that the caller fills before each replay (``load``).

Capture has rules that eager code does not: no host sync (``.item()``,
``.tolist()``), no copy from pageable host memory, and a step must not
pick its work by a value that changes between calls (a slice id read on
the host is baked into the graph at its first value). A stage that
breaks one raises ``CaptureError`` naming the plan step that refused;
nothing is rerun eagerly, and nothing falls back to the CPU. (torch
leaves its CUDA random generator in capture mode after a capture that
failed: draw no random numbers on the card after a ``CaptureError``.)

On the CPU (and on ``meta`` tensors) the same stages run eagerly.

A replay runs no Python wrapper of a kernel, so what it runs is known
from its capture: each graph keeps the kernels its capture recorded
(``Graphs.kernels``, ``tracing.kernel_log``), and the spans
``capture.capture``, ``capture.load`` and ``capture.replay``
(``tracing``) carry it. ``COUNTS`` adds up the captures made and their
seconds, traced or not, and the replays made while spans are off with
their host seconds (a traced replay is timed by its span, and a
profiler's launch callbacks slow it many times over).
"""

import time

import torch

from .. import tracing

# cumulative: Graphs made and the seconds of their warm-up and
# capture; calls of Graphs.replay while spans are off, and their seconds
COUNTS = {"captures": 0, "capture_s": 0.0, "replay_calls": 0,
          "replay_s": 0.0}


class CaptureError(RuntimeError):
    """A stage refused CUDA graph capture (the step is in the message)."""


def note_step(err, where):
    """Add ``where`` (the plan step that raised) to ``err``'s notes."""
    err.add_note(f"at {where}")


def stage_carries(step_io, last_use, final_id, num_inputs, bounds):
    """The ids each stage hands to the next, for stages of steps split at
    ``bounds`` (0, ..., n): the inputs into the first, then at each bound
    ``b`` every id made before ``b`` (an input at -1) that a step at or
    after ``b`` reads (``last_use``), and the final id after the last;
    the reference's carries (``cotengra_tpu/ops/grouped.py:2302-2312``,
    ``cotengra_tpu/ops/executor.py:452``). ``step_io`` lists (source ids,
    output id) per step."""
    made_at = dict.fromkeys(range(num_inputs), -1)
    for si, (_, out) in enumerate(step_io):
        made_at[out] = si
    n = len(step_io)

    def live(b):
        return sorted(
            vid for vid, d in made_at.items()
            if d < b and (vid == final_id or last_use.get(vid, -1) >= b)
        )

    return [list(range(num_inputs))] + [
        live(b) if b < n else [final_id] for b in bounds[1:]
    ]


def run_stages(stages, state):
    """Run ``stages`` eagerly, in order, from ``state``."""
    for stage in stages:
        state = stage(state)
    return state


def _capture_one(graph, pool, stream, stage, state, k):
    """Capture ``stage(state)`` into ``graph`` on ``stream``; return the
    next state."""
    current = torch.cuda.current_stream()
    failure = None
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            try:
                state = stage(state)
            except Exception as err:  # reported below, with its step
                failure = err
    except Exception as err:  # capture_end on a capture the step broke
        failure = failure or err
    if failure is not None:
        # torch.cuda.graph leaves its capture stream current when
        # capture_end raises (and that stream, used by no later capture,
        # may still allocate from this pool)
        torch.cuda.set_stream(current)
        notes = "; ".join(getattr(failure, "__notes__", ()))
        raise CaptureError(
            f"CUDA graph capture of stage {k} failed"
            f"{' ' + notes if notes else ''}: "
            f"{type(failure).__name__}: {failure}"
        ) from failure
    return state


class Graphs:
    """``stages`` captured as one CUDA graph each, in one memory pool.

    ``state`` is what the first stage reads: static buffers, which the
    caller refills before each ``replay``. Every stage first runs once
    eagerly on a side stream of its own (the warm-up: kernels load,
    libraries initialise and take their workspaces), then each is
    captured on that stream in order, each reading the tensors the
    previous capture left. ``outputs`` are the last stage's results,
    rewritten by every replay; ``replays`` counts graph replays and
    ``capture_s`` is the seconds of warm-up and capture. ``kernels``
    holds, per graph, the hand-written kernel launches its capture
    recorded (``tracing.kernel_log``), which each replay runs once.
    """

    def __init__(self, stages, state, device):
        if tracing.ON:
            tracing.begin()
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            warm = run_stages(stages, state)
        main.wait_stream(side)
        del warm
        self.pool = torch.cuda.graph_pool_handle()
        graphs, kernels = [], []
        with torch.cuda.device(device):
            for k, stage in enumerate(stages):
                graph = torch.cuda.CUDAGraph()
                with tracing.kernel_log() as log:
                    state = _capture_one(graph, self.pool, side, stage,
                                         state, k)
                graphs.append(graph)
                kernels.append(log)
        torch.cuda.synchronize(device)
        self.graphs = tuple(graphs)
        self.kernels = tuple(kernels)
        self.outputs = state
        self.replays = 0
        self.capture_s = time.perf_counter() - t0
        COUNTS["captures"] += 1
        COUNTS["capture_s"] += self.capture_s
        if tracing.ON:
            tracing.end("capture.capture", len(graphs), self.capture_s)

    def replay(self):
        """Replay every graph in order; returns ``outputs``."""
        traced = tracing.ON
        if traced:
            tracing.begin()
        t0 = time.perf_counter()
        for graph in self.graphs:
            graph.replay()
        self.replays += len(self.graphs)
        if traced:
            tracing.end("capture.replay", len(self.graphs), self.kernels)
        else:
            COUNTS["replay_calls"] += 1
            COUNTS["replay_s"] += time.perf_counter() - t0
        return self.outputs


def load(static, tensors):
    """Copy ``tensors`` into the ``static`` buffers, one
    ``torch._foreach_copy_`` for all (none where the caller passed the
    buffers themselves)."""
    if len(static) != len(tensors):
        raise ValueError(f"expected {len(static)} tensors, got {len(tensors)}")
    if tracing.ON:
        tracing.begin()
    pairs = [(s, t) for s, t in zip(static, tensors) if s is not t]
    for s, t in pairs:
        if s.shape != t.shape or s.dtype != t.dtype or s.device != t.device:
            raise ValueError(
                f"a {t.dtype} {tuple(t.shape)} tensor on {t.device} for a "
                f"static {s.dtype} {tuple(s.shape)} buffer on {s.device}"
            )
    if pairs:
        torch._foreach_copy_([s for s, _ in pairs], [t for _, t in pairs])
    if tracing.ON:
        tracing.end("capture.load", len(pairs),
                    sum(t.nbytes for _, t in pairs))


def clone_outputs(outs):
    """Fresh copies of a replay's outputs (a tensor or a tuple of them),
    which the next replay would overwrite."""
    if isinstance(outs, tuple):
        return tuple(o.clone() for o in outs)
    return outs.clone()


def _signature(tensors):
    return tuple((tuple(t.shape), t.dtype, t.device) for t in tensors)


def capture_call(stages, device):
    """``fn(*tensors)`` running ``stages`` (the first takes the tuple of
    tensors) as CUDA graphs on a CUDA ``device``: at the first call with
    a new signature (shapes, dtypes, devices) the tensors are copied to
    static buffers of their own and the stages captured (``Graphs``);
    every call then loads its tensors into those buffers, replays, and
    returns copies of the outputs. Elsewhere ``fn`` runs the stages
    eagerly.

    ``fn.graphs`` maps each signature to its ``Graphs`` and static
    buffers."""
    stages = tuple(stages)
    if device.type != "cuda":
        def fn(*tensors):
            return run_stages(stages, tensors)

        fn.graphs = {}
        return fn

    graphs = {}

    def fn(*tensors):
        key = _signature(tensors)
        entry = graphs.get(key)
        if entry is None:
            for t in tensors:
                if t.device != device:
                    raise ValueError(
                        f"a tensor on {t.device}; the graphs run on {device}"
                    )
            static = tuple(
                t.clone(memory_format=torch.contiguous_format)
                for t in tensors
            )
            entry = graphs[key] = (Graphs(stages, static, device), static)
        captured, static = entry
        load(static, tensors)
        return clone_outputs(captured.replay())

    fn.graphs = graphs
    return fn
