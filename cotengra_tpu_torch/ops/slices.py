"""Slices of a sliced tree: flat slice ids, their digits, the selection
of one slice's inputs from the raw (unsliced) inputs, and the split of a
step plan into the steps that depend on the slice and those that do not.

The counterparts of the reference's ``_sliced_axes_per_input`` and
``_slice_meta`` (``cotengra_tpu/ops/executor.py``), ``_digit_columns``,
``_ids_to_digits`` and ``_select_input`` (``cotengra_tpu/ops/grouped.py``)
and of the varying-id propagation of its batched call, which also
splits off the steps that only an expression's constants reach (the
folding that the reference's jit does). Selection is
eager: ``Tensor.select`` views on the inputs' device, one slice at a
time, where the reference gathered a whole batch inside jit.
"""

import numpy as np
import torch

from ..tree import get_slice_strides


def _sliced_axes_per_input(tree):
    """For each input: the (axis, ind) pairs of sliced indices, in
    descending axis order (so successive removals keep positions
    valid)."""
    out = []
    for term in tree.inputs:
        axes = [
            (ax, ix)
            for ax, ix in enumerate(term)
            if ix in tree.sliced_inds
        ]
        axes.sort(reverse=True)
        out.append(tuple(axes))
    return tuple(out)


def slice_arrays(tree, arrays, i, axis_offset=0):
    """The input arrays of slice number ``i``.

    ``arrays`` are numpy arrays (host) or torch tensors (selected as
    views on their device); ``axis_offset=1`` addresses plane stacks,
    whose leading axis is the plane.
    """
    key = tree.slice_key(i)
    out = []
    for arr, axes in zip(arrays, _sliced_axes_per_input(tree)):
        for ax, ix in axes:
            if isinstance(arr, torch.Tensor):
                arr = arr.select(ax + axis_offset, key[ix])
            else:
                arr = np.take(arr, key[ix], axis=ax + axis_offset)
        out.append(arr)
    return out


def _slice_meta(tree):
    """{ind: (stride, size, project)} for the current slicing state."""
    strides = get_slice_strides(tree.sliced_inds)
    return {
        ix: (stride, si.size, si.project)
        for (ix, si), stride in zip(tree.sliced_inds.items(), strides)
    }


def _digit_columns(meta):
    """Stable column order for the mixed-radix digits of a flat slice
    id: one column per non-projected sliced index."""
    return [ix for ix, (_, _, project) in meta.items() if project is None]


def _flat_ids(slice_ids):
    """``slice_ids`` as a list of Python ints (see ``_ids_to_digits``)."""
    if isinstance(slice_ids, torch.Tensor):
        if slice_ids.device.type != "cpu":
            raise ValueError(
                f"slice ids on {slice_ids.device}: pass them on the host "
                "(ints, a range, a numpy array or a CPU tensor)"
            )
        slice_ids = slice_ids.tolist()
    return [int(s) for s in np.asarray(slice_ids, dtype=object).reshape(-1)]


def _ids_to_digits(slice_ids, meta):
    """Decode flat slice ids into an ``(n, ncols)`` int64 digit matrix
    (columns as ``_digit_columns``), as ``tree.slice_key`` does.

    ``slice_ids`` is an int, a sequence or range of ints, a numpy array
    (object arrays hold ids beyond int64) or a CPU tensor. Decoding runs
    on the host in exact Python integers, so the flat id space may
    exceed int64 (deep instances slice 2^39+ ways). A CUDA tensor raises:
    reading it would be a hidden device sync.
    """
    ids = _flat_ids(slice_ids)
    cols = _digit_columns(meta)
    digs = np.empty((len(ids), len(cols)), np.int64)
    for j, ix in enumerate(cols):
        stride, size, _ = meta[ix]
        digs[:, j] = [(s // stride) % size for s in ids]
    return digs


def _select_input(a, axes, meta, digits, axis_offset=0):
    """The view of raw input ``a`` for one row of slice-id ``digits``
    (see ``_ids_to_digits``), by ``Tensor.select`` on its device.
    ``axes`` are its sliced (axis, ind) pairs in descending axis order
    (``_sliced_axes_per_input``); projected indices take their fixed
    value, so an input touched by no other sliced index needs no digits
    (``digits=None``). ``axis_offset=1`` addresses plane stacks."""
    cols = _digit_columns(meta)
    for ax, ix in axes:
        project = meta[ix][2]
        if project is None:
            project = int(digits[cols.index(ix)])
        a = a.select(ax + axis_offset, project)
    return a


def _reached(ids, step_io):
    """``ids`` and every step output ``out`` of ``step_io`` ((sources,
    out) per step, in execution order) that one of them reaches."""
    reached = set(ids)
    for srcs, out in step_io:
        if any(s in reached for s in srcs):
            reached.add(out)
    return reached


def varying_ids(tree, step_io):
    """The ids whose value depends on the slice: every input that a
    non-projected sliced index touches, then every step output
    ``out`` of ``step_io`` ((sources, out) per step, in execution
    order) with a varying source."""
    meta = _slice_meta(tree)
    return _reached(
        (
            i
            for i, axes in enumerate(_sliced_axes_per_input(tree))
            if any(meta[ix][2] is None for _, ix in axes)
        ),
        step_io,
    )


def _add_exponents(a, b):
    if a is None:
        return b
    return a if b is None else a + b


class SliceBatch:
    """A step plan split by slice dependence, for contracting a batch of
    slices from the raw inputs: the steps that no sliced index reaches
    run once per batch, the others once per slice.

    ``step_io`` lists (sources, out) per step in execution order;
    ``last_use`` maps an id to the index of the last step reading it
    (the executors free it there).

    ``constants`` (input positions whose values never change) splits the
    slice-invariant steps once more: those that only constants reach
    are *folded* (``steps_fold``, run once by ``fold`` and kept), the
    others (``steps_once``) run once per batch. Without ``constants``
    nothing is folded.
    """

    def __init__(self, tree, step_io, last_use, constants=None):
        self.meta = _slice_meta(tree)
        self.axes = _sliced_axes_per_input(tree)
        self.nslices = tree.multiplicity
        self.varying = varying_ids(tree, step_io)
        if constants is None:
            dynamic = None
        else:
            dynamic = _reached(
                (i for i in range(tree.N) if i not in constants), step_io
            )

        def invariant_kind(vid):
            if vid in self.varying:
                return "each"
            if dynamic is None or vid in dynamic:
                return "once"
            return "fold"

        kinds = [invariant_kind(out) for _, out in step_io]
        self.steps_fold, self.steps_once, self.steps_each = (
            [si for si, kind in enumerate(kinds) if kind == k]
            for k in ("fold", "once", "each")
        )
        self.inputs_fold, self.inputs_once, self.inputs_each = (
            [i for i in range(tree.N) if invariant_kind(i) == k]
            for k in ("fold", "once", "each")
        )
        # an id that a later class of steps reads must outlive its own
        # class: it is shared by every batch (folded) or every slice
        shared_each = {s for si in self.steps_each for s in step_io[si][0]}
        shared_once = shared_each | {
            s for si in self.steps_once for s in step_io[si][0]
        }
        self.last_use_fold = {
            vid: si for vid, si in last_use.items() if vid not in shared_once
        }
        self.last_use_once = {
            vid: si for vid, si in last_use.items() if vid not in shared_each
        }
        self.last_use = last_use

    def _select(self, arrays, i, prepare, axis_offset, digits=None):
        return prepare(_select_input(
            arrays[i], self.axes[i], self.meta, digits, axis_offset
        ))

    def fold(self, arrays, run_steps, prepare, axis_offset=0):
        """Run the folded steps once over the constant inputs of
        ``arrays`` (the others are not read). Returns ``(temps,
        exponent)``: what the later steps read of them, and their summed
        log10 exponent (or None); ``run`` takes the pair as
        ``folded``."""
        temps = {
            i: self._select(arrays, i, prepare, axis_offset)
            for i in self.inputs_fold
        }
        return temps, run_steps(self.steps_fold, temps, self.last_use_fold)

    def run(self, arrays, slice_ids, run_steps, prepare, axis_offset=0,
            folded=None):
        """Generate ``(temps, exponent)`` for each slice of
        ``slice_ids`` in turn.

        ``arrays`` are the raw inputs; ``prepare`` turns a selected view
        into the executor's stored form; ``run_steps(steps, temps,
        last_use)`` runs the given step indices over ``temps`` and
        returns their summed log10 exponent (or None). ``folded`` is
        ``fold``'s result, made here when not given. The invariant
        steps run once, into a dict that each slice's steps see through
        a shallow copy of their own, so freeing at last use never drops
        what a later slice still needs; a slice's temps die when the
        next slice starts. ``exponent`` adds the folded and invariant
        steps' exponents to the slice's own.
        """
        ids = _flat_ids(slice_ids)
        if not ids:
            raise ValueError("no slice ids given")
        bad = [s for s in ids if not 0 <= s < self.nslices]
        if bad:
            raise ValueError(
                f"slice ids {bad[:4]} out of range [0, {self.nslices})"
            )
        digits = _ids_to_digits(ids, self.meta)
        if folded is None:
            folded = self.fold(arrays, run_steps, prepare, axis_offset)
        base = dict(folded[0])
        for i in self.inputs_once:
            base[i] = self._select(arrays, i, prepare, axis_offset)
        e_once = _add_exponents(
            folded[1], run_steps(self.steps_once, base, self.last_use_once)
        )
        for row in digits:
            temps = dict(base)
            for i in self.inputs_each:
                temps[i] = self._select(arrays, i, prepare, axis_offset, row)
            e = run_steps(self.steps_each, temps, self.last_use)
            yield temps, _add_exponents(e_once, e)
            del temps
