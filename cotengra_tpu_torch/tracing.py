"""The program's spans and counters: where the host spends a call.

A span is one record: its name, its start and end on
``time.perf_counter_ns`` (the clock of ``time.perf_counter``), the index
of the span it was opened in, the id of the entry call it belongs to
(the index of that call's ``entry`` record) and a few attributes, fixed
per name (``ATTRS``). The spans, each opened where its work happens:

- ``entry``: the outermost call of ``contract_tree``,
  ``contract_slice``, ``contract_core``, ``contract_compressed`` and
  the functions that ``make_grouped_contractor`` and
  ``make_full_contractor`` return (``entry``). An entry called inside
  another opens no span of its own: its spans nest in the outer call's;
- ``inputs.upload``: ``convert.to_tensors``, ``convert.to_plane_tensors``
  and ``slices.device_digits``, with the bytes taken from host memory
  (numpy arrays and CPU tensors);
- ``slices.select``: ``slices.slice_arrays``, ``SliceBatch``'s
  selections and gathers, and the host decoding of a batch's slice ids
  (``grouped._StagedProgram.digits``: 0 inputs);
- ``executor.steps`` and ``executor.step``: the executors' step loops
  (``executor._run_ir_steps``, ``grouped._exec_steps_split``) and each
  step in them, with the plan's kind of the step;
- ``kernel.launch``: the host work of a hand-written kernel's wrapper up
  to and including the launch (``gate_chains.run_chain_cuda``, one a
  pass; ``bmm_absmax.bmm_absmax_cuda``; ``svd_core.svd_topk_cuda``;
  ``qr_core.qr_factor_cuda`` and ``qr_apply_cuda``, kernel ``qr_core``,
  two a truncation), with the kernel's sequence
  number (its wrapper's ``launches`` before the launch), the operand
  shapes (``(x, out, gates)`` of the pass, ``(x, y)`` of the product,
  ``(m, n, k)`` of the SVD's core, the phase and each side's ``(m, n,
  k)`` of the QR),
  the host time just before the launch call (``launched``: the kernel
  starts on the device after it) and, for a chain pass, its gates in
  register groups and on the per-item path and its groups
  (``reg_gates``, ``item_gates``, ``groups``; None for the product);
- ``compressed.step``, ``compressed.neighbours`` and
  ``compressed.truncate``: in ``ops.compressed.contract_compressed``,
  one step of its loop (the step's index, the element count of its
  pairwise result), one neighbour and index-holder pass over the live
  tensors (how many were live) and one bond's truncation, its QR, SVD
  and products (the rows of each side, the fused bond, the kept k; the
  kernels' launches are its children);
- ``capture.capture``, ``capture.load`` and ``capture.replay``: in
  ``ops.capture``, the first call's warm-up and capture of a program's
  stages (how many, and the seconds they took), a call's copy of its
  tensors into the static buffers (how many copied, their bytes) and
  the replay of every graph (how many graphs, and per graph the
  kernel launches its capture recorded: ``kernel_log``). A replay
  calls no kernel wrapper and opens no ``kernel.launch``: its
  ``kernels`` say what it ran.

Spans are recorded only inside ``record()`` (tests, operators) or in an
entry call that starts while a torch profiler session records
(``torch.autograd.profiler._is_profiler_enabled``); ``kernel_log``
turns them on for a capture and keeps only its log. Off, a span site
costs one check of ``ON``. Recording makes no device work and no host
sync.

Records go to a ring of ``CAPACITY``; when it is full the oldest are
dropped and counted (``dropped()``). ``records()`` reads them.
``STEP_CALLS`` counts the executors' step-loop calls, traced or not.
"""

import collections
import contextlib
import functools
import itertools
import time

import numpy as np
import torch
from torch.autograd import profiler as _profiler

CAPACITY = 1 << 18

ATTRS = {
    "entry": ("kind", "slices"),
    "inputs.upload": ("tensors", "bytes"),
    "slices.select": ("inputs",),
    "executor.steps": ("steps",),
    "executor.step": ("index", "kind"),
    "kernel.launch": ("kernel", "seq", "shapes", "launched", "reg_gates",
                      "item_gates", "groups"),
    "compressed.step": ("index", "size"),
    "compressed.neighbours": ("live",),
    "compressed.truncate": ("rows_a", "rows_b", "bond", "k"),
    "capture.capture": ("stages", "seconds"),
    "capture.load": ("tensors", "bytes"),
    "capture.replay": ("graphs", "kernels"),
}

# Python step calls of the executors, by function
# (``grouped._exec_steps_split``, ``executor._run_ir_steps``): a replay
# of captured graphs makes none.
STEP_CALLS = collections.Counter()

Record = collections.namedtuple(
    "Record", "index name start end parent entry attrs"
)

ON = False  # span sites record while this is set

_ring = collections.deque(maxlen=CAPACITY)
_dropped = 0
_next = 0  # the index of the next span opened
_open = []  # (index, start) of the spans open, innermost last
_entry = None  # the index of the open entry call's record

now = time.perf_counter_ns


def begin():
    """Open a span (call only while ``ON``): ``end`` writes it."""
    global _next
    _open.append((_next, now()))
    _next += 1


def end(name, *attrs):
    """Close the innermost open span as ``name`` with ``attrs``
    (``ATTRS[name]``, in order)."""
    global _dropped
    t1 = now()
    index, t0 = _open.pop()
    parent = _open[-1][0] if _open else None
    if len(_ring) == _ring.maxlen:
        _dropped += 1
    _ring.append((index, name, t0, t1, parent, _entry, attrs))


def entry(kind, slices):
    """Decorate an entry of the program: while a profiler session
    records (or inside ``record()``), its outermost call is an
    ``entry`` span of ``kind`` with ``slices`` (an int, or a function of
    the call's arguments), which every span of the call shares."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if ON or _profiler._is_profiler_enabled:
                return _entry_call(fn, kind, slices, args, kwargs)
            return fn(*args, **kwargs)

        return call

    return wrap


def _entry_call(fn, kind, slices, args, kwargs):
    global ON, _entry
    if _entry is not None:
        return fn(*args, **kwargs)
    was_on, depth = ON, len(_open)
    ON = True
    begin()
    _entry = _open[-1][0]
    n = None
    try:
        n = slices(*args, **kwargs) if callable(slices) else slices
        return fn(*args, **kwargs)
    finally:
        del _open[depth + 1:]  # spans left open by an exception
        end("entry", kind, n)
        _entry, ON = None, was_on


def host_bytes(arrays):
    """Bytes of the numpy arrays and CPU tensors among ``arrays``: what
    a conversion to device tensors takes from host memory."""
    total = 0
    for a in arrays:
        if isinstance(a, torch.Tensor):
            if a.device.type == "cpu":
                total += a.nbytes
        else:
            total += np.asarray(a).nbytes
    return total


@contextlib.contextmanager
def record():
    """Record spans inside the block, into a fresh ring of ``CAPACITY``
    records (the count of dropped records starts at 0)."""
    global ON, _ring, _dropped
    was_on = ON
    _ring, _dropped = collections.deque(maxlen=CAPACITY), 0
    _open.clear()
    ON = True
    try:
        yield
    finally:
        ON = was_on
        _open.clear()


@contextlib.contextmanager
def kernel_log():
    """Log the hand-written kernels launched inside the block, whether
    spans are recorded or not (a capture keeps what its graph will run,
    ``capture.Graphs``). Yields a list, filled when the block ends with
    ``(kernel, parent, shapes)`` for each ``kernel.launch`` record, in
    launch order: the launching wrapper's attributes and the index of
    the span it was opened in. The spans recorded only for the log are
    not kept."""
    global ON
    was_on, first = ON, _next
    log = []
    ON = True
    try:
        yield log
    finally:
        ON = was_on
        made = []
        while _ring and _ring[-1][0] >= first:
            made.append(_ring.pop())
        if was_on:
            _ring.extend(reversed(made))
        log.extend(
            (attrs[0], parent, attrs[2])
            for _, name, _, _, parent, _, attrs in sorted(made)
            if name == "kernel.launch"
        )


def records():
    """The records kept, in the order their spans opened, attributes as
    ``{name: value}`` (None for those a site does not give)."""
    return [
        Record(i, name, t0, t1, parent, ent,
               dict(itertools.zip_longest(ATTRS[name], attrs)))
        for i, name, t0, t1, parent, ent, attrs in sorted(_ring)
    ]


def dropped():
    """How many records the ring dropped, oldest first, since it was
    made (at import, or by ``record()``)."""
    return _dropped


def self_ns(recs):
    """``{index: nanoseconds}``: each record's span less the spans of
    its children among ``recs``."""
    own = {r.index: r.end - r.start for r in recs}
    for r in recs:
        if r.parent in own:
            own[r.parent] -= r.end - r.start
    return own
