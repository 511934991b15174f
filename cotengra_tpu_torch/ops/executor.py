"""The direct executor, exponent stripping, and the sliced contraction of
a whole tree.

The counterpart of ``cotengra_tpu/ops/executor.py``:

1. ``build_core_fn`` runs the flat einsum-IR (``lowering.py``) step by
   step on torch tensors (real or complex), freeing each intermediate
   after its last use. With ``strip_exponent`` every pairwise result is
   renormalised by its absolute max and the log10 exponents are summed
   (reference ``_strip``); with ``implementation="pallas"`` the steps
   that qualify (``_pallas_step_ok``) go through the fused matmul+|max|
   kernel (``bmm_absmax.py``), the others through ``torch.einsum``.
   Each pair step promotes its operands to their common dtype
   (``apply_pairwise``), as JAX does, so real and complex inputs mix,
   folded constants included; only real x real steps take the kernel.
2. ``_build_best_core`` picks that direct core, or the grouped
   split-complex executor (``grouped.py``) for IRs above
   ``MAX_RANK_DIRECT``, by the reference's rule.
3. ``make_full_contractor`` sums inner slices in a host loop and stacks
   and reassembles output-sliced chunks. Slices are visited in flat
   slice-id order (``tree.slice_key``), the order of the reference
   sidecars under ``plans/``. With ``slice_batch=B`` it sums batches of
   B slices, each contracted from the raw inputs by a batched core
   (``build_batched_core_fn``, or the grouped one) that runs the steps
   no sliced index reaches once per batch (``slices.SliceBatch``).
   With ``constants`` it closes over those inputs and folds the steps
   that only they reach, and no sliced index: they run at its first
   call only (the front end's expressions with constants,
   ``interface.Expression``).

4. ``contract_tree`` and ``contract_core`` reuse the contractor planned
   for the tree (``_cached_full``, ``_cached_core``): it is kept in
   ``tree.contraction_cores`` under a key made of every option that
   shapes it (device, plane dtype, ``strip_exponent``,
   ``implementation``, ``slice_batch``), so that repeated calls, and the
   front end's expressions (``interface.py``), plan once.

5. ``autojit=True`` (``make_contractor``, ``make_full_contractor``,
   ``contract_tree``) captures the whole call as one CUDA graph on the
   card (``capture.capture_call``), the counterpart of the reference's
   ``jax.jit``: after the first call, a call copies its inputs into
   static buffers and replays the graph, with no Python step. The
   slices of a full contraction are fixed, so they are selected in the
   graph as at the first call. ``make_staged_contractor`` splits the
   direct route into ``num_stages`` graphs, and ``make_traced_slicer``
   (``slices.py``) selects a slice by a 0-d id on the device. The
   default stays ``autojit=False`` (eager) for the first three, where
   the reference defaults to jit; the staged contractors default to
   ``autojit=True``. On the CPU ``autojit`` runs eagerly. The
   reference's ``precision`` and ``preferred_element_type`` arguments
   have no counterpart: the port runs true float32 everywhere
   (``_device.full_fp32_matmuls``).
"""

import time

import numpy as np
import torch

from .. import tracing
from .._device import resolve_device, resolve_plane_dtype
from ..config import get_default
from ..convert import to_tensors
from ..tracing import STEP_CALLS
from ..utils.misc import prod
from .bmm_absmax import _bmm_layout, pairwise_bmm_absmax
from .capture import (
    capture_call,
    note_step,
    run_stages,
    stage_carries,
)
from .grouped import _to_planes, make_grouped_contractor
from .lowering import SingleStep, extract_contractions
from .pairwise import apply_pairwise, apply_single
from .slices import SliceBatch, make_traced_slicer, slice_arrays

IMPLEMENTATIONS = (None, "auto", "grouped", "pallas")


def _real_dtype(dtype):
    return dtype.to_real()


def _strip(x):
    """Renormalize ``x`` by its absolute max, returning (mantissa,
    log10-exponent). Zero-safe."""
    absmax = x.abs().amax()
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    return x / scale, torch.log10(scale)


def _add_stripped(a, b):
    """Add two (mantissa, exponent) pairs stably."""
    am, ae = a
    bm, be = b
    e = torch.maximum(ae, be)
    m = am * 10.0 ** (ae - e) + bm * 10.0 ** (be - e)
    return m, e


def _pallas_step_ok(x, y, step):
    """The reference's rule for the fused kernel
    (``executor.py::_try_pallas_step``): a real step whose operands both
    hold at least 2^14 elements and that is a clean batched matmul."""
    # both sides, where the reference looks at x only: the kernel takes
    # real float32 operands, and a complex y would reach it otherwise
    if x.dtype.is_complex or y.dtype.is_complex:
        return False
    if x.numel() < 2**14 or y.numel() < 2**14:
        return False  # too small to benefit
    return _bmm_layout(step.l_legs, step.r_legs, step.out_legs) is not None


def _run_ir_steps(ir, steps, temps, last_use, strip_exponent=False,
                  implementation=None):
    """Run the IR steps ``steps`` (indices, in order) over ``temps`` (id
    -> tensor, freed after its last use). Returns the summed log10
    exponent of the stripped steps (None if nothing was stripped).
    ``tracing.STEP_CALLS`` counts the calls: a replay of captured
    graphs makes none."""
    STEP_CALLS["_run_ir_steps"] += 1
    if tracing.ON:
        tracing.begin()
    use_pallas = strip_exponent and implementation == "pallas"
    exponent = None
    for si in steps:
        try:
            out, e = _run_ir_step(ir, si, temps, last_use, strip_exponent,
                                  use_pallas)
        except Exception as err:
            note_step(err, f"IR step {si}")
            raise
        if e is not None:
            exponent = e if exponent is None else exponent + e
        temps[ir.steps[si].out] = out
    if tracing.ON:
        tracing.end("executor.steps", len(steps))
    return exponent


def _run_ir_step(ir, si, temps, last_use, strip_exponent, use_pallas):
    """One IR step over ``temps``: ``(out, log10 exponent or None)``,
    its operands freed at their last use."""
    if tracing.ON:
        tracing.begin()
    e = None
    step = ir.steps[si]
    if isinstance(step, SingleStep):
        kind = "single"
        out = apply_single(temps[step.inp], step.in_legs, step.out_legs)
        if last_use.get(step.inp) == si:
            del temps[step.inp]
    else:
        x, y = temps[step.l], temps[step.r]
        if use_pallas and _pallas_step_ok(x, y, step):
            kind = "bmm_absmax"
            out, absmax = pairwise_bmm_absmax(
                x, y, step.l_legs, step.r_legs, step.out_legs
            )
            scale = torch.where(
                absmax == 0, torch.ones_like(absmax), absmax
            ).to(_real_dtype(out.dtype))
            out = out / scale
            e = torch.log10(scale)
        else:
            kind = "pair"
            out = apply_pairwise(
                x, y, step.l_legs, step.r_legs, step.out_legs
            )
            if strip_exponent:
                out, e = _strip(out)
        del x, y  # operands die at their last use below
        if last_use.get(step.l) == si:
            del temps[step.l]
        if last_use.get(step.r) == si:
            del temps[step.r]
    if tracing.ON:
        tracing.end("executor.step", si, kind)
    return out, e


def _zero_exponent(result):
    return torch.zeros(
        (), dtype=_real_dtype(result.dtype), device=result.device
    )


def build_core_fn(ir, strip_exponent=False, implementation=None):
    """Build the function executing the IR on a list of (already sliced)
    tensors. Intermediates are freed as soon as dead (liveness from the
    IR).

    ``implementation="pallas"`` (the fused hand-written kernels where a
    step qualifies) routes exponent-stripped batched-matmul steps
    through ``bmm_absmax``, which takes max|out| while it forms the
    product; other steps use ``torch.einsum``.
    """

    def core(*arrays):
        temps = dict(enumerate(arrays))
        exponent = _run_ir_steps(
            ir, range(len(ir.steps)), temps, ir.last_use, strip_exponent,
            implementation,
        )
        result = temps[ir.final_id]
        if strip_exponent:
            if exponent is None:
                exponent = _zero_exponent(result)
            return result, exponent
        return result

    return core


def _ir_step_io(ir):
    for step in ir.steps:
        if isinstance(step, SingleStep):
            yield (step.inp,), step.out
        else:
            yield (step.l, step.r), step.out


def build_batched_core_fn(tree, ir, strip_exponent=False,
                          implementation=None, constants=None):
    """The direct core over a batch of slices: ``fn(arrays, slice_ids)``
    on the RAW (unsliced) tensors, returning the per-slice results
    stacked on a leading axis (and a ``(len(slice_ids),)`` exponent
    vector with ``strip_exponent``). The steps that no sliced index
    reaches run once per call, the others once per slice on views
    selected from the raw tensors (``slices.SliceBatch``).

    With ``constants`` (input positions), ``fn.fold(arrays)`` runs the
    steps that only constants reach once, and ``fn(arrays, slice_ids,
    folded)`` reuses its result."""
    batch = SliceBatch(tree, list(_ir_step_io(ir)), ir.last_use, constants)

    def run_steps(steps, temps, last_use):
        return _run_ir_steps(
            ir, steps, temps, last_use, strip_exponent, implementation
        )

    def fn(arrays, slice_ids, folded=None):
        outs, exps = [], []
        for temps, e in batch.run(
            arrays, slice_ids, run_steps, _identity, folded=folded
        ):
            result = temps[ir.final_id]
            outs.append(result)
            exps.append(_zero_exponent(result) if e is None else e)
        res = torch.stack(outs)
        return (res, torch.stack(exps)) if strip_exponent else res

    fn.batch = batch
    fn.fold = lambda arrays: batch.fold(arrays, run_steps, _identity)
    return fn


def _identity(v):
    return v


# IRs whose tensors exceed this rank run on the grouped split-complex
# executor, as in the reference (which routed them there for the TPU
# compiler); kept so that both packages take the same route
MAX_RANK_DIRECT = 12


def _ir_max_rank(ir):
    mx = 0
    for step in ir.steps:
        if isinstance(step, SingleStep):
            mx = max(mx, len(step.in_legs), len(step.out_legs))
        else:
            mx = max(
                mx,
                len(step.l_legs),
                len(step.r_legs),
                len(step.out_legs),
            )
    return mx


def _build_best_core(
    tree, ir, device, strip_exponent=False, implementation=None,
    plane_dtype=torch.float32, slice_batch=None, constants=None,
):
    """Pick the core: grouped split-complex for high-rank IRs (bond-2
    circuit networks) or ``implementation="grouped"``, direct per-step
    execution otherwise. Returns ``(core, plane_io)``: a grouped core
    takes and returns ``(2, *shape)`` planes of ``plane_dtype``
    (the port's grouped executor is split-complex only). With
    ``slice_batch`` the core is batched: ``core(raw inputs, slice_ids)``
    returns the per-slice results stacked; ``constants`` (input
    positions, batched cores only) adds ``core.fold``."""
    if implementation not in IMPLEMENTATIONS:
        raise ValueError(
            f"implementation must be one of {IMPLEMENTATIONS}, got "
            f"{implementation!r}"
        )
    if (
        implementation in (None, "auto", "grouped")
        and _ir_max_rank(ir) > MAX_RANK_DIRECT
    ) or implementation == "grouped":
        core = make_grouped_contractor(
            tree, device, plane_dtype, strip_exponent=strip_exponent,
            slice_batch=slice_batch, constants=constants,
        )
        return core, True
    if slice_batch:
        core = build_batched_core_fn(
            tree, ir, strip_exponent, implementation, constants
        )
        return core, False
    return build_core_fn(ir, strip_exponent, implementation), False


def _sum_slices(run, ids):
    """Sum ``run(sid)`` over ``ids``; (mantissa, exponent) pairs add
    with ``_add_stripped``."""
    acc = None
    for sid in ids:
        res = run(sid)
        if acc is None:
            acc = res
        elif isinstance(res, tuple):
            acc = _add_stripped(acc, res)
        else:
            acc = acc + res
    return acc


def contract_slices(tree, core, planes):
    """Sum ``core`` over all slices of ``tree``.

    ``planes`` are the raw (unsliced) inputs as ``(2, *shape)`` plane
    tensors; returns the ``(2, *out_shape)`` planes of the sum, or the
    ``(planes, exponent)`` pair of a core built with ``strip_exponent``.
    """
    return _sum_slices(
        lambda i: core(*slice_arrays(tree, planes, i, axis_offset=1)),
        range(tree.multiplicity),
    )


def _chunk_structure(tree):
    """(n_inner, n_chunks, chunk_dims) of the current slicing state."""
    infos = list(tree.sliced_inds.values())
    n_inner = prod(si.size for si in infos if si.inner)
    chunk_dims = tuple(si.size for si in infos if not si.inner)
    return n_inner, prod(chunk_dims), chunk_dims


def _reassemble(tree, chunks, output_legs):
    """Reshape/transpose stacked output chunks (leading axis = flat chunk
    id) into the full output in ``tree.output`` order. Projected output
    indices appear with size 1.
    """
    chunk_dims = tuple(
        si.size for si in tree.sliced_inds.values() if not si.inner
    )
    chunk_legs = tuple(
        ix for ix, si in tree.sliced_inds.items() if not si.inner
    )
    reshaped = chunks.reshape(chunk_dims + tuple(chunks.shape[1:]))
    cur_legs = chunk_legs + tuple(output_legs)
    perm = tuple(cur_legs.index(ix) for ix in tree.output)
    return reshaped.permute(perm)


def _stack_chunks(tree, results, output_legs):
    """Stack per-chunk results (``(m, e)`` pairs when stripped, brought
    to their common exponent) and reassemble the full output."""
    if isinstance(results[0], tuple):
        es = torch.stack([e for _, e in results])
        e = es.amax()
        ms = torch.stack(
            [m * 10.0 ** (ce - e) for m, ce in results]
        )
        return _reassemble(tree, ms, output_legs), e
    return _reassemble(tree, torch.stack(results), output_legs)


def _user_result(res, any_complex):
    """Grouped-core planes (or (planes, e)) -> the complex result, or its
    real part when no input was complex."""
    if isinstance(res, tuple):
        return _user_result(res[0], any_complex), res[1]
    return torch.complex(res[0], res[1]) if any_complex else res[0]


def _autojit(fn, dev):
    """``fn(*tensors)`` as one CUDA graph a call on a CUDA ``dev``
    (``capture.capture_call``); eager elsewhere."""
    return capture_call([lambda tensors: fn(*tensors)], dev)


def make_contractor(
    tree, device="cuda", strip_exponent=False, implementation=None,
    plane_dtype=torch.float32, autojit=False,
):
    """The *core* (single slice) contraction of ``tree`` on ``device``:
    ``fn(*tensors)`` on one slice's inputs (real or complex tensors on
    ``device``), returning the result, or ``(mantissa, exponent)`` with
    ``strip_exponent``. On the grouped route the inputs are split into
    ``plane_dtype`` planes on the device and the result joined again.
    ``autojit=True`` captures the call as one CUDA graph on the card
    (``capture.capture_call``; eager on the CPU)."""
    dev = resolve_device(device)
    pdt = resolve_plane_dtype(plane_dtype)
    ir = extract_contractions(tree)
    core, plane_io = _build_best_core(
        tree, ir, dev, strip_exponent, implementation, pdt
    )
    if not plane_io:
        return _autojit(core, dev) if autojit else core

    def fn(*arrays):
        res = core(*(_to_planes(a, pdt) for a in arrays))
        return _user_result(res, any(a.is_complex() for a in arrays))

    return _autojit(fn, dev) if autojit else fn


def make_staged_contractor(tree, num_stages=2, strip_exponent=False,
                           autojit=True, device="cuda"):
    """The core (single slice) contraction of ``tree`` on the direct
    route as ``num_stages`` stages of about equal step counts (the
    reference's ``make_staged_contractor``,
    ``cotengra_tpu/ops/executor.py:452``): ``fn(*tensors)`` as
    ``make_contractor``'s. The ids live across each boundary are handed
    on, as the reference's; ``fn.bounds`` and ``fn.carries`` hold them.
    With ``autojit`` each stage is a CUDA graph on the card, all in one
    memory pool (``capture.capture_call``); on the CPU the stages run
    eagerly. ``num_stages <= 1`` (or no step) is ``make_contractor``."""
    dev = resolve_device(device)
    ir = extract_contractions(tree)
    n = len(ir.steps)
    if n == 0 or num_stages <= 1:
        return make_contractor(tree, dev, strip_exponent=strip_exponent,
                               autojit=autojit)
    num_stages = min(num_stages, n)
    bounds = [n * i // num_stages for i in range(num_stages + 1)]
    carries = stage_carries(list(_ir_step_io(ir)), ir.last_use,
                            ir.final_id, ir.num_inputs, bounds)

    def make_stage(s):
        keep, last = carries[s + 1], s == num_stages - 1

        def stage(state):
            if s == 0:
                state = (dict(enumerate(state)), None)
            temps, exponent = state
            e = _run_ir_steps(ir, range(bounds[s], bounds[s + 1]), temps,
                              ir.last_use, strip_exponent)
            if e is not None:
                exponent = e if exponent is None else exponent + e
            temps = {vid: temps[vid] for vid in keep}
            if not last:
                return temps, exponent
            result = temps[ir.final_id]
            if not strip_exponent:
                return result
            if exponent is None:
                exponent = _zero_exponent(result)
            return result, exponent

        return stage

    stages = [make_stage(s) for s in range(num_stages)]
    if autojit:
        fn = capture_call(stages, dev)
    else:
        def fn(*tensors):
            return run_stages(stages, tensors)

    fn.stages, fn.bounds, fn.carries = stages, bounds, carries
    return fn


def _sum_batch(res):
    """Sum a batched core's per-slice results over the leading axis; a
    stripped batch is brought to its largest exponent first."""
    if not isinstance(res, tuple):
        return res.sum(0)
    ms, es = res
    e = es.amax()
    scale = (10.0 ** (es - e)).reshape(es.shape + (1,) * (ms.dim() - 1))
    return (ms * scale.to(ms.dtype)).sum(0), e


def make_full_contractor(
    tree, device="cuda", strip_exponent=False, slice_batch=None,
    implementation=None, plane_dtype=torch.float32, constants=None,
    autojit=False,
):
    """The FULL contraction of ``tree`` on ``device``: ``fn(*tensors)``
    on the raw (unsliced) inputs, summing inner slices in a host loop and
    stacking and reassembling output-sliced chunks. Returns the result,
    or ``(mantissa, exponent)`` with ``strip_exponent``.

    On the grouped route the raw inputs are split into ``plane_dtype``
    planes once, and slices select views of the planes.
    ``slice_batch=B`` contracts the inner slices in batches of ``B``
    (the last one may be short) through a batched core that runs the
    steps no sliced index reaches once per batch; batches add as slices
    do (stripped: each batch brought to its largest exponent, batches
    added with ``_add_stripped``).

    ``constants`` ({position: tensor on ``device``}) are closed over:
    ``fn`` then takes only the other (variable) inputs, in order. The
    steps that only constants reach and that no non-projected sliced
    index reaches are folded: they run at the first call, and their
    results stay on the device for every later call (stripped: their
    exponent is added to every slice's). It runs on the batched core,
    one slice per batch unless ``slice_batch`` says otherwise. A batched
    ``fn`` has the core's step split as ``fn.batch``
    (``slices.SliceBatch``).

    ``autojit=True`` captures the whole call, every slice and the sums,
    as one CUDA graph on the card (``capture.capture_call``; the folded
    steps run eagerly first): later calls copy their inputs into its
    static buffers and replay it. On the CPU it runs eagerly.
    """
    dev = resolve_device(device)
    pdt = resolve_plane_dtype(plane_dtype)
    ir = extract_contractions(tree)
    n_inner, n_chunks, _ = _chunk_structure(tree)
    if constants is not None:
        slice_batch = min(slice_batch or 1, n_inner)
    elif not tree.sliced_inds:
        slice_batch = None
    elif slice_batch:
        slice_batch = min(slice_batch, n_inner)
    core, plane_io = _build_best_core(
        tree, ir, dev, strip_exponent, implementation, pdt, slice_batch,
        None if constants is None else set(constants),
    )
    if constants is not None:
        const_complex = any(a.is_complex() for a in constants.values())
        if plane_io:
            constants = {
                i: _to_planes(a, pdt) for i, a in constants.items()
            }
    folded = None  # the folded steps' results, made at the first call
    # the grouped core's digits of each batch, on the device from the
    # first call on (before a capture: a graph reads them at replay)
    digits = {}

    def fn(*arrays):
        nonlocal folded
        any_complex = any(a.is_complex() for a in arrays)
        inputs = [_to_planes(a, pdt) for a in arrays] if plane_io else arrays
        if constants is not None:
            any_complex = any_complex or const_complex
            inputs = _splice(constants, inputs, tree.N)
            if folded is None:
                folded = core.fold(inputs)

        def finish(res):
            return _user_result(res, any_complex) if plane_io else res

        if slice_batch is None and not tree.sliced_inds:
            return finish(core(*inputs))
        if slice_batch:
            def batch(ids):
                if not plane_io:
                    return core(inputs, ids, folded)
                if ids.start not in digits:
                    digits[ids.start] = core.digits(ids)
                return core(inputs, ids, folded, digits[ids.start])

            def chunk(c):
                ids = range(c * n_inner, (c + 1) * n_inner)
                return _sum_slices(
                    lambda k: _sum_batch(batch(ids[k:k + slice_batch])),
                    range(0, n_inner, slice_batch),
                )
        else:
            offset = 1 if plane_io else 0

            def chunk(c):
                return _sum_slices(
                    lambda sid: core(
                        *slice_arrays(tree, inputs, sid, offset)
                    ),
                    range(c * n_inner, (c + 1) * n_inner),
                )

        results = [finish(chunk(c)) for c in range(n_chunks)]
        if n_chunks == 1:
            return results[0]
        return _stack_chunks(tree, results, ir.output_legs)

    full = tracing.entry("full", tree.multiplicity)(
        _autojit(fn, dev) if autojit else fn
    )
    if slice_batch:
        full.batch = core.batch
    return full


def _splice(constants, variables, n):
    """The full input list: ``constants`` ({position: tensor}) between
    the ``variables``, in order."""
    if len(variables) != n - len(constants):
        raise ValueError(
            f"{len(constants)} constants close over {n} inputs: expected "
            f"{n - len(constants)} variable inputs, got {len(variables)}"
        )
    vit = iter(variables)
    return [constants[i] if i in constants else next(vit) for i in range(n)]


# -- public tree-execution entry points ---------------------------------------


def _cached(tree, key, build):
    """The contractor cached on ``tree`` under ``key``, built on a
    miss. The key holds the resolved device, so that a contractor built
    for one device is never handed to a call on another."""
    try:
        return tree.contraction_cores[key]
    except KeyError:
        fn = tree.contraction_cores[key] = build()
        return fn


def _cached_core(tree, device="cuda", strip_exponent=False,
                 implementation=None, plane_dtype=torch.float32):
    """``make_contractor``, cached on the tree."""
    dev = resolve_device(device)
    key = ("torch", "core", dev, plane_dtype, strip_exponent, implementation)
    return _cached(tree, key, lambda: make_contractor(
        tree, dev, strip_exponent=strip_exponent,
        implementation=implementation, plane_dtype=plane_dtype,
    ))


def _cached_full(tree, device="cuda", strip_exponent=False,
                 slice_batch=None, implementation=None,
                 plane_dtype=torch.float32, autojit=False):
    """``make_full_contractor``, cached on the tree (the reference's
    ``_cached_full``)."""
    dev = resolve_device(device)
    key = ("torch", "full", dev, plane_dtype, strip_exponent,
           implementation, slice_batch, autojit)
    return _cached(tree, key, lambda: make_full_contractor(
        tree, dev, strip_exponent=strip_exponent, slice_batch=slice_batch,
        implementation=implementation, plane_dtype=plane_dtype,
        autojit=autojit,
    ))


@tracing.entry("core", 1)
def contract_core(tree, arrays, device="cuda", plane_dtype=torch.float32,
                  **kwargs):
    """Contract ``arrays`` (one slice, already sliced if applicable) on
    ``device`` with the tree's cached contractor. ``arrays`` are numpy
    arrays or tensors; real ones run as ``plane_dtype``, complex ones at
    its precision."""
    dev = resolve_device(device)
    fn = _cached_core(tree, dev, plane_dtype=plane_dtype, **kwargs)
    return fn(*to_tensors(arrays, dev, plane_dtype))


@tracing.entry("slice", 1)
def contract_slice(tree, arrays, i, device="cuda", **kwargs):
    """Slice the full input arrays for slice ``i`` and contract."""
    return contract_core(
        tree, slice_arrays(tree, arrays, i), device, **kwargs
    )


def _defaults(implementation, slice_batch):
    """Unset options take ``cotengra_tpu_torch.config``'s defaults, as
    the reference's ``contract_tree`` takes its own config's."""
    if implementation is None:
        implementation = get_default("implementation")
    if slice_batch is None:
        slice_batch = get_default("slice_batch")
    return implementation, slice_batch


@tracing.entry("tree", lambda tree, *args, **kwargs: tree.multiplicity)
def contract_tree(
    tree, arrays, device="cuda", plane_dtype=torch.float32,
    strip_exponent=False, implementation=None, slice_batch=None,
    autojit=False,
):
    """Contract ``tree`` over all its slices on ``device``.

    ``arrays`` are the raw inputs, numpy arrays (the arrays the reference
    package consumes) or tensors. Real inputs run as real tensors of
    ``plane_dtype``; complex ones at its precision, as complex tensors
    on the direct route and as split-complex planes on the grouped
    route. Returns the result on ``device``, or ``(mantissa, log10
    exponent)`` with ``strip_exponent``. Unset ``implementation`` and
    ``slice_batch`` take ``cotengra_tpu_torch.config``'s defaults. The
    contractor is planned once per tree and options (``_cached_full``);
    ``autojit=True`` captures it as one CUDA graph on the card
    (``make_full_contractor``).
    """
    implementation, slice_batch = _defaults(implementation, slice_batch)
    dev = resolve_device(device)
    fn = _cached_full(
        tree, dev, strip_exponent=strip_exponent, slice_batch=slice_batch,
        implementation=implementation, plane_dtype=plane_dtype,
        autojit=autojit,
    )
    return fn(*to_tensors(arrays, dev, plane_dtype))


def gen_output_chunks(
    tree, arrays, device="cuda", strip_exponent=False,
    plane_dtype=torch.float32, **kwargs,
):
    """Generate the output chunks of an output-sliced contraction one at
    a time, without materializing the full output. Yields
    ``(chunk_key, chunk)`` where ``chunk_key`` maps each output-sliced
    index to its value. With ``strip_exponent=True`` each chunk is a
    ``(mantissa, exponent)`` pair, its inner slices summed with
    ``_add_stripped``.
    """
    n_inner, n_chunks, _ = _chunk_structure(tree)
    dev = resolve_device(device)
    core = _cached_core(
        tree, dev, strip_exponent=strip_exponent, plane_dtype=plane_dtype,
        **kwargs,
    )
    tensors = to_tensors(arrays, dev, plane_dtype)
    for c in range(n_chunks):
        acc = _sum_slices(
            lambda sid: core(*slice_arrays(tree, tensors, sid)),
            range(c * n_inner, (c + 1) * n_inner),
        )
        key = {
            ix: v
            for ix, v in tree.slice_key(c * n_inner).items()
            if not tree.sliced_inds[ix].inner
        }
        yield key, acc


def gather_slices(tree, slices, strip_exponent=False):
    """Gather an iterable of per-slice results (in flat slice id order):
    sum inner slices, stack output chunks, reassemble. With
    ``strip_exponent`` each result is a ``(mantissa, exponent)`` pair.
    """
    n_inner, n_chunks, _ = _chunk_structure(tree)
    slices = list(slices)
    if strip_exponent and not all(isinstance(s, tuple) for s in slices):
        raise ValueError("strip_exponent needs (mantissa, exponent) pairs")
    chunk_vals = [
        _sum_slices(slices.__getitem__, range(c * n_inner, (c + 1) * n_inner))
        for c in range(n_chunks)
    ]
    if n_chunks == 1:
        return chunk_vals[0]
    ir_out = tuple(ix for ix in tree.output if ix not in tree.sliced_inds)
    return _stack_chunks(tree, chunk_vals, ir_out)


def _pull(res):
    """Copy a result (or (mantissa, exponent)) to the host: the end of a
    timed pass."""
    if isinstance(res, tuple):
        return tuple(r.cpu() for r in res)
    return res.cpu()


def benchmark_tree(
    tree, device="cuda", arrays=None, dtype="float32", repeats=3, **kwargs
):
    """Wall-clock benchmark of the full contraction on ``device``:
    seconds per run (best of ``repeats`` after a warm-up, each ending in
    a host pull), and the flops rate it implies."""
    dev = resolve_device(device)
    if arrays is None:
        rng = np.random.default_rng(42)
        arrays = [
            rng.normal(size=shape).astype(dtype)
            for shape in tree.get_shapes()
        ]
    real = np.finfo(np.dtype(dtype)).dtype
    pdt = torch.float64 if real == np.float64 else torch.float32
    fn = make_full_contractor(tree, dev, plane_dtype=pdt, **kwargs)
    tensors = to_tensors(arrays, dev, pdt)

    def run():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        _pull(fn(*tensors))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    run()  # warm-up
    t = min(run() for _ in range(repeats))
    flops = tree.total_flops(dtype=dtype)
    return {
        "time": t,
        "flops": flops,
        "gflops_per_sec": flops / t / 1e9,
        "tflops_per_sec": flops / t / 1e12,
    }
