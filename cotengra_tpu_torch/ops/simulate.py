"""The grouped executor's time on the card, modelled from its own plan
(counterpart of ``cotengra_tpu/ops/simulate.py``).

Tree-level quantities (flops, write) do not rank trees by the card's
time: the circuit plans spend theirs in chain passes, block transposes,
true-fp32 GEMMs and, above all on the m=10 plans, in the host's step
calls while the card waits. So, as the reference does for the TPU, this
module runs the port's own host planner (:func:`.grouped_plan.plan_grouped`,
the code path of :func:`.grouped.make_grouped_contractor`) and prices
each planned step as the port executes it:

- an in-place chain per pass of :func:`.gate_chains.chain_tile_plan`
  (one kernel launch each): one read of x's planes and one write of
  out's at ``chain_gbps``, or its complex multiply-adds at
  ``chain_gflops`` for a gate-dense pass, the larger;
- a block transpose (``_apply_block_plan_split``) as one read and one
  write of both planes at ``copy_gbps``. This replaces the reference's
  ``_copy_traffic``, which priced the TPU's tile padding and multipass
  synthesis (``transpose_synth``, which the port leaves out); its
  scatter-padding term goes with it;
- a pair product or scattered dot as its ``8 B M K N`` flops at the
  true-fp32 GEMM rate ``gemm_tflops`` (TF32 off), or as streaming its
  operands and output at ``dot_gbps`` where that is slower;
- a fallback einsum as a read of both operands and a write of its
  output, complex, at ``einsum_gbps``, and a single step as a read and
  write of its output at ``copy_gbps``;
- a window step (``gate_mode="window"``) as its rotation copy (none
  for a prefix window) at ``copy_gbps`` and one true-fp32 GEMM of
  ``8 S_in S_out M`` flops (``W2 (2 S_out, 2 S_in) @ X (2 S_in, M)``)
  priced as a pair product; its operator build (a ``"w2build"`` step of
  the executor plan) as the writes and reads of its mask, one-hot
  products and ``W2`` (16 plane elements per ``S_in S_out``) at
  ``copy_gbps``, slice-invariant where no sliced index reaches the
  gates, as the executor runs it;
- a fused kron chain (``fuse_gates``) as its copy plus its small-y
  product, as a pair step;
- the host: ``step_s`` per step call and ``launch_s`` per kernel
  launch the step makes (``_step_launches`` reckons them from the
  branch the executor takes), counted as the executor runs: slice by
  slice (no ``slice_batch``) every step once per slice; under
  ``"scan"`` the slice-invariant steps once per call and the others
  once per slice; under ``"vmap"`` the others once per call too;
- ``kernel_s`` of device time per launch beyond its work (a small
  kernel's floor), and ``slice_overhead_s`` of host time per slice
  (selection, the final rearrangement, sums).

The device's work is the same in both batch modes; the slice-invariant
steps run once per call in both. The reference's ``dispatch_s`` per
compiled stage has no counterpart: the port compiles no stages, so
``stage_size`` has none either.

``H100_CONSTANTS`` were fitted by ``scratch/sim_calibrate_gpu.py`` to
the warm times in ``H100_MEASURED``, which ``chip_smoke.py`` (its
calibration phase) measured on the card named there.
"""

import math

from ..utils.misc import prod
from .gate_chains import chain_tile_plan
from .grouped import (
    _step_io,
    auto_slice_batch_mode,
    hoist_window_operators,
    slice_peak_bytes,
)
from .grouped_plan import plan_grouped
from .lowering import extract_contractions, sliced_input_legs
from .slices import varying_ids

# Fitted by scratch/sim_calibrate_gpu.py to H100_MEASURED (least squares
# on log(model / measured), the chain kernel's byte rate measured apart).
H100_CONSTANTS = {
    # the chain kernel: bytes of one pass (x in, out written); chip_smoke
    # phase 31, the 13 t27 chains at 4 slices (bytes over kernel ms)
    "chain_gbps": 1319.0,
    # its complex multiply-adds (8 flops each), for gate-dense passes
    "chain_gflops": 10260.0,
    # permuted copies: block transposes, single steps
    "copy_gbps": 1236.0,
    # GEMM operand and output streaming
    "dot_gbps": 1778.0,
    # true-fp32 GEMMs (TF32 off)
    "gemm_tflops": 49.56,
    # complex einsums of the fallback steps (the fit's bound: their
    # tensors are small, their cost the launches)
    "einsum_gbps": 3350.0,
    # host seconds per step call, and per kernel launch of a step (the
    # fit's lower bound: the call's cost does not grow with launches)
    "step_s": 0.0001971,
    "launch_s": 1e-07,
    # device seconds per kernel launch beyond its work (the floor of a
    # small kernel)
    "kernel_s": 6.061e-06,
    # host seconds per slice (no run of the calibration set resolves it:
    # the starting value)
    "slice_overhead_s": 0.0001,
    # bytes per stored plane element (split-complex float32)
    "plane_bytes": 4,
    # device memory, for "auto"'s choice of batch mode: 79.18 GiB, as
    # torch reports the card's
    "device_bytes": 79.18 * 2**30,
}

# Warm seconds (best of 3 or 5 passes) measured by chip_smoke.py's
# phases 32, 33 and 35 on the card named here (PERF.md section 6): the
# calibration set, one entry per plan, slices a call (None: slice by
# slice), mode and slices contracted.
H100_MEASURED = {
    "card": "NVIDIA H100 80GB HBM3, 700.00 W",
    "runs": [
        {"plan": "sycamore53_m10_t29", "slice_batch": None, "mode": None,
         "nslices": 1, "seconds": 0.17316119600002366},
        {"plan": "sycamore53_m10_t27_combo", "slice_batch": 16,
         "mode": "scan", "nslices": 16, "seconds": 0.20043150099996865},
        {"plan": "sycamore53_m10_t27_combo-256", "slice_batch": 4,
         "mode": "scan", "nslices": 4, "seconds": 0.2966002910000043},
        {"plan": "sycamore53_m10_t27_tpu", "slice_batch": None, "mode": None,
         "nslices": 1, "seconds": 0.17993120099998805},
        {"plan": "r5b_m10_tpu", "slice_batch": None, "mode": None,
         "nslices": 1, "seconds": 0.1664641690000508},
        {"plan": "sycamore53_m10_t27", "slice_batch": 4, "mode": "scan",
         "nslices": 4, "seconds": 0.10852603099999669},
        {"plan": "sycamore53_m10_t27", "slice_batch": 4, "mode": "vmap",
         "nslices": 4, "seconds": 0.10121988799994597},
        {"plan": "sycamore53_m20_t28", "slice_batch": 16, "mode": "scan",
         "nslices": 16, "seconds": 0.919259894999982},
        {"plan": "sycamore53_m20_t28", "slice_batch": 11, "mode": "vmap",
         "nslices": 16, "seconds": 0.7329790860000003},
    ],
}


def _step_launches(kind, info, strip):
    """Kernel launches one call of a plan step makes, as the branch of
    ``grouped._exec_steps_split`` that runs it issues them (views are
    free; a strip adds the |max|, the guard, the log, the division and
    the exponent's sum)."""
    strips = 5 if strip else 0
    if kind == "single":
        return 1
    if kind == "fallback":
        # two complex views, the einsum, the planes' concatenation
        return 4 + strips
    if kind == "inplace":
        passes = len(chain_tile_plan(info.spec))
        return passes + sum(y[1] is not None for y in info.ys)
    if kind == "window":
        # the rotation copy (not for a prefix window) and the GEMM
        return 1 + (info.rec.form != "prefix")
    if kind == "w2build":
        # per gate its realignment and four einsums with their sum and
        # difference after the first; the index tensors, mask, one-hots,
        # two products each side, the block embedding
        gates = info.rec.gates
        return (sum(y[1] is not None for y in gates)
                + 6 * max(len(gates) - 1, 0) + 20)
    p = info
    if kind == "fusedchain":
        # per gate a complex view, its permutation and the kron; then
        # the small-y product of the branch its K and N take
        pre = 3 * len(p.gates) + (p.x_plan is not None)
        if p.K < 8:
            return pre + 8 * p.K * p.N + 1 + strips
        if p.N < 8:
            return pre + 5 * p.N + 1 + strips
        return pre + 5 + strips
    copies = (getattr(p, "x_plan", None) is not None) + (
        p.y_plan is not None
    )
    if p.scatter is not None:
        # lhs: a negation, two concatenations, a stack; the dot
        return copies + 5 + strips
    if p.mode == "bmm":
        return copies + 7 + strips
    if p.mode == "mac":
        return copies + 8 * p.K * p.N + 1 + strips
    if p.mode == "matvec":
        return copies + 5 * p.N + 1 + strips
    # mm: the gate's block embedding (or two products) and the GEMM
    return copies + 5 + strips


def step_records(tree, gate_mode="inplace", strip_exponent=False,
                 fuse_gates=False):
    """Per step of ``tree``'s executor plan: ``(kind, bucket, device
    seconds by rate, launches, slice-invariant)``, where the device
    seconds are held as tallies to price later (``_price_step``). Also
    returns the plan's per-slice live peak in bytes. The plan is the
    port's own (``plan_grouped``, with the window operators hoisted as
    the executor hoists them); this is the slow, chip-independent half
    of :func:`simulate_grouped`."""
    ir = extract_contractions(tree)
    input_orders = [sliced_input_legs(tree, i) for i in range(tree.N)]
    plans, _, out_plan, out_shape, _ = plan_grouped(
        ir, tree.size_dict, input_orders, gate_mode=gate_mode,
        fuse_gates=fuse_gates,
    )
    plans, last_use = hoist_window_operators(
        plans, ir.final_id, ir.num_inputs
    )
    sizes = tree.size_dict
    step_io = list(_step_io(plans))
    varying = varying_ids(tree, step_io) if tree.sliced_inds else set()
    recs = []
    for (kind, info), (_, out) in zip(plans, step_io):
        t = {"copy": 0.0, "chain": [], "dot": None, "einsum": 0.0,
             "single": 0.0}
        if kind == "inplace":
            gs = info.spec.gate_strides
            for ps in chain_tile_plan(info.spec):
                first, stop = ps.gates
                flops = sum(
                    8 * g.numel_in * prod(d[0] for d in g.ndims)
                    for g in gs[first:stop]
                )
                t["chain"].append(
                    (2 * (ps.io.numel_in + ps.io.numel_out), flops)
                )
            t["copy"] = sum(
                4 * K * N for _, plan, K, N in info.ys if plan is not None
            )
            bucket = "chain"
        elif kind == "single":
            t["single"] = 4 * prod(sizes[ix] for ix in info.out_legs)
            bucket = "other"
        elif kind == "window":
            rec = info.rec
            M = prod(rec.out_shape) // rec.S_out
            x_elems = rec.S_in * M
            t["copy"] = 4 * x_elems * (rec.form != "prefix")
            t["dot"] = (8.0 * rec.S_in * rec.S_out * M,
                        2 * (x_elems + rec.S_out * M)
                        + 4 * rec.S_in * rec.S_out)
            bucket = "window"
        elif kind == "w2build":
            t["single"] = 16 * info.rec.S_in * info.rec.S_out
            bucket = "window"
        elif kind == "fallback":
            step = info[0]
            so = prod(sizes[ix] for ix in step.out_legs)
            t["einsum"] = 2 * (prod(info[5]) + prod(info[6]) + so)
            bucket = "other"
        else:  # a pair or a fused chain (B = 1, its gates' kron as y)
            B = getattr(info, "B", 1)
            M, K, N = info.M, info.K, info.N
            x_elems, y_elems = B * M * K, B * K * N
            t["copy"] = 4 * (
                x_elems * (info.x_plan is not None)
                + y_elems * (getattr(info, "y_plan", None) is not None)
            )
            t["dot"] = (8.0 * B * M * K * N,
                        2 * (x_elems + y_elems + B * M * N))
            bucket = "dot"
        recs.append((
            kind, bucket, t, _step_launches(kind, info, strip_exponent),
            out not in varying,
        ))
    out_copy = 4 * prod(out_shape) if out_plan is not None else 0
    in_shapes = [tuple(sizes[ix] for ix in o) for o in input_orders]
    peak = slice_peak_bytes(plans, in_shapes, last_use, sizes)
    raw = 8 * sum(prod(s) for s in tree.get_shapes())
    return {
        "steps": recs, "out_copy": out_copy, "slice_bytes": peak,
        "raw_bytes": raw, "nslices": tree.multiplicity,
        "sliced": bool(tree.sliced_inds),
    }


def _price_step(t, c):
    """Device seconds of one step's tallies (plane elements x planes)
    under constants ``c``: (chain, copy, dot, other) seconds and the
    chain, copy element counts and flops it moves."""
    pb = c["plane_bytes"]
    chain = sum(
        max(elems * pb / (c["chain_gbps"] * 1e9),
            flops / (c["chain_gflops"] * 1e9))
        for elems, flops in t["chain"]
    )
    copy = t["copy"] * pb / (c["copy_gbps"] * 1e9)
    dot = 0.0
    if t["dot"] is not None:
        flops, elems = t["dot"]
        dot = max(flops / (c["gemm_tflops"] * 1e12),
                  elems * pb / (c["dot_gbps"] * 1e9))
    other = (
        t["einsum"] * pb / (c["einsum_gbps"] * 1e9)
        + t["single"] * pb / (c["copy_gbps"] * 1e9)
    )
    return chain, copy, dot, other


def price(records, constants=None, slice_batch=None,
          slice_batch_mode="auto", nslices=None, detail=False):
    """Model seconds from :func:`step_records`' result (see
    :func:`simulate_grouped`).

    The host issues each step call in the executor's order (slice by
    slice; or per call the slice-invariant steps, then the others per
    slice under ``"scan"`` or once for the batch under ``"vmap"``) and
    the card runs a step's kernels once they are issued and the card is
    free: two timelines, host and device, and the wall is where the
    later one ends. So a host-bound pass costs its step calls and a
    device-bound one its kernels, as eager PyTorch's asynchronous
    launches make them."""
    c = dict(H100_CONSTANTS)
    if constants:
        c.update(constants)
    pb = c["plane_bytes"]
    nsl = records["nslices"] if nslices is None else nslices
    mode = None
    if slice_batch and records["sliced"]:
        mode = slice_batch_mode
        if mode == "auto":
            mode = auto_slice_batch_mode(
                "cuda", slice_batch, records["slice_bytes"],
                records["raw_bytes"], c["device_bytes"],
            )
        batches = [min(slice_batch, nsl - k)
                   for k in range(0, nsl, slice_batch)]
    else:
        batches = [1] * nsl

    b = dict.fromkeys(("chain", "copy", "dot", "other"), 0.0)
    tallies = {"chain": 0.0, "copy": 0.0, "dot_flops": 0.0}
    once, each = [], []
    for kind, _, t, n_launch, invariant in records["steps"]:
        parts = _price_step(t, c)
        for k, v in zip(("chain", "copy", "dot", "other"), parts):
            b[k] += v
        tallies["chain"] += sum(e for e, _ in t["chain"])
        tallies["copy"] += t["copy"]
        if t["dot"] is not None:
            tallies["dot_flops"] += t["dot"][0]
        step = (c["step_s"] + n_launch * c["launch_s"], sum(parts),
                n_launch * c["kernel_s"], n_launch)
        (once if mode is not None and invariant else each).append(step)
    out_copy = records["out_copy"] * pb / (c["copy_gbps"] * 1e9)
    b["copy"] += out_copy
    tallies["copy"] += records["out_copy"]

    host = dev = busy = 0.0
    step_calls = launches = 0

    def issue(steps, slices=1):
        # a batched step does ``slices`` times the work in the same
        # launches
        nonlocal host, dev, busy, step_calls, launches
        for host_s, work_s, kernel_s, _ in steps:
            host += host_s
            dev_s = slices * work_s + kernel_s
            dev = max(dev, host) + dev_s
            busy += dev_s
        step_calls += len(steps)
        launches += sum(s[3] for s in steps)

    for n in batches:
        issue(once)
        if mode == "vmap":
            issue(each, n)
        else:
            for _ in range(n):
                issue(each)
        # per slice: selection, the final rearrangement, the sums
        host += n * c["slice_overhead_s"]
        dev = max(dev, host) + n * out_copy
        busy += n * out_copy
    seconds = max(host, dev)
    if not detail:
        return seconds
    return {
        "seconds": seconds,
        "per_slice_s": sum(b.values()),
        "nslices": nsl,
        # plan_grouped's steps (the reference's count): the operator
        # builds are the executor's own
        "n_plans": sum(r[0] != "w2build" for r in records["steps"]),
        "n_calls": len(batches),
        "mode": mode,
        "chain_s": b["chain"],
        "copy_s": b["copy"],
        "dot_s": b["dot"],
        "other_s": b["other"],
        "once_s": sum(s[1] + s[2] for s in once),
        "device_s": busy,
        "host_s": host,
        "idle_share": 1 - busy / seconds,
        "step_calls": step_calls,
        "launches": launches,
        "chain_gb": tallies["chain"] * pb / 1e9,
        "copy_gb": tallies["copy"] * pb / 1e9,
        "dot_tflop": tallies["dot_flops"] / 1e12,
    }


def simulate_grouped(tree, constants=None, gate_mode="inplace",
                     slice_batch=None, slice_batch_mode="auto",
                     detail=False, nslices=None, fuse_gates=False):
    """Modelled wall-clock seconds of contracting ``tree`` on the card
    through the grouped executor: all its slices (or the first
    ``nslices``), slice by slice, or in batches of ``slice_batch`` in
    ``slice_batch_mode`` (``"auto"`` resolved as the executor resolves
    it on a card of ``constants["device_bytes"]``), warm: the plan made
    and the inputs on the card.

    Returns the modelled seconds; with ``detail=True`` a dict of the
    reference's breakdown (per-slice seconds by bucket, the slices, the
    planned steps, chain / copy gigabytes and dot teraflops) with the
    host's bucket (``host_s``: step calls and launches), the device's
    (``device_s``), the step calls, launches, calls and the mode taken.
    There is no ``n_stages``: the port compiles no stages.
    ``gate_mode`` and ``fuse_gates`` are the executor's
    (``make_grouped_contractor``).
    """
    return price(
        step_records(tree, gate_mode, fuse_gates=fuse_gates), constants,
        slice_batch, slice_batch_mode, nslices, detail,
    )
