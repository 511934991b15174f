#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``cotengra_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py              # the smoke run below
    python3 chip_smoke.py --profile    # phases 1-2, then where the time goes

Run from the root of a checkout. Phases:

1. the card's name and power limit, torch and CUDA versions;
2. build the CUDA kernels from ``cotengra_tpu_torch/csrc`` (one nvcc
   per source, sm_90a, started together) and, in parallel, the host
   planning library from ``cotengra_tpu_torch/ops/native/kernels.cpp``
   (g++), and print the build seconds and the library's path; the run
   fails where the host library does not build (no silent pure-Python
   planning);
3. the gate-chain kernel against its plain PyTorch version on every
   chain of the Sycamore-53 m=10 t27 plan at full size, float32 inputs
   from a fixed numpy seed: max|kernel - plain| <= 1e-5 * max|plain|,
   each chain one pass (one launch) of ``chain_tile_plan``; per chain
   its tile, passes, kernel, plain and library times from CUDA events
   (the library call is one ``torch.einsum`` over complex64 x and all
   of the chain's gates, held to the plain version too; the port never
   makes it) and the chain's bound (one read of its input planes and
   one write of its output planes at the HBM rate); then a synthetic
   2^24-element chain whose tile outgrows shared memory, run as two
   passes, held to the plain version at the same limit;
4. the Sycamore-53 m=10 amplitude over all 4 slices of
   ``plans/sycamore53_m10_t27.json`` in float32 planes, held to the
   complex128 reference amplitude at relerr <= 1e-5, with the chain
   kernel's launch count (one per pass: 13 per slice) and the warm
   time-to-amplitude;
5. the same for the unsliced ``plans/sycamore53_m10_t29.json`` (no
   chains: the pair and fallback steps only);
6. the matmul+|max| kernel against its plain version on every distinct
   (B, M, K, N) of the kernel steps of the 7x7 bond-16 lattice plan
   (``plans/lattice7x7_d16_s16.json``), at full size, float32 uniform
   inputs from a fixed numpy seed, y handed over as the executor does
   (the transpose of a contiguous (B, N, K)): max|out - plain| <= 1e-5
   max|plain|, |absmax - plain| <= 1e-5 plain, absmax == max|out|
   exactly; kernel and plain times from CUDA events in turns (the plain
   version, ``torch.bmm`` then ``abs().amax()``, is also the library
   call the kernel is held against; the port never makes it on a CUDA
   tensor), TFLOP/s, the bound at the 3xTF32 ceiling and at the
   float32 FMA rate, and what a contiguous (B, K, N) y costs (the
   wrapper's transposing copy);
7. the lattice main path: its value over all 16 slices in float32 with
   ``strip_exponent=True, implementation="pallas"``, held to the float64
   reference stored in the plan file at |delta log10| <= 1e-4, with the
   kernel's launch count (the qualifying steps x 16), the unstripped
   float32 overflow, the
   warm time-to-value and the peak device memory;
8. the m10-t27 amplitude once more with ``strip_exponent=True`` (the
   grouped split-complex strip), mantissa x 10^exponent held to the
   same reference at relerr <= 1e-5;
9. the m10-t27 amplitude through the slice-batched call
   (``contract_tree(..., slice_batch=4)``), plain and stripped, held to
   the same reference at relerr <= 1e-5 with the chain kernel's launch
   count, and the warm times of the batched call
   (``make_grouped_contractor(..., slice_batch=4)``) and of phase 4's
   slice loop in turns;
10. the gate-chain kernel against its plain version on every chain of
   the Sycamore-53 m=20 t28 plan (``plans/sycamore53_m20_t28.json``) at
   full size, float32 inputs made on the card from a seeded
   ``torch.Generator``, at phase 3's limit; each chain's launches equal
   its passes of ``chain_tile_plan`` (40 passes in all, two chains of
   two); kernel, plain and library times and the bound per chain, as in
   phase 3;
11. the m=20 main path: one batched call of slice ids 0..15
   (``make_grouped_contractor(..., slice_batch=16)``, float32 planes),
   its partial sums over the first 4, 8 and 16 slices held to the
   complex128 sidecar at relerr <= 1e-5, the chain kernel's launches
   (the slice-invariant chains once, the others 16 times, derived from
   the plan), the warm 16-slice time (best of 3, each pass ending in a
   host pull checked finite and stable), ms per slice and the peak
   device memory;
12. the front end on the lattice: ``cotengra_tpu_torch.einsum`` on the
   7x7 lattice's equation (``inputs_output_to_eq``) with
   ``optimize=<the loaded tree>, strip_exponent=True,
   implementation="pallas"``, no ``device=`` (the card is the
   default): 464 ``bmm_absmax`` launches and |delta log10| <= 1e-4
   against the plan's float64 reference, as phase 7;
13. the front end on m10-t27: ``cotengra_tpu_torch.array_contract(arrays,
   inputs, (), optimize=<the loaded tree>, slice_batch=4)``: 52 chain
   launches and relerr <= 1e-5 against the sidecar's 4-slice
   amplitude;
14. for both, the warm time of the front-end call next to that of
   ``make_full_contractor`` with the same options on the same device
   tensors, measured in turns (best of 5 for the lattice, of 21 for
   t27's 0.1 s pass, each after a ``gc.collect()`` and ending in a host
   pull checked finite and stable): the front end may cost at most
   1.1x, its host canonicalisation, since its expression reuses the
   contractor that the tree caches;
15. the front end planning its own path: ``einsum`` on the 6x6 bond-16
   lattice (uniform [0, 1) float32 from ``default_rng(7)``) with the
   default ``optimize="auto"`` (the hyper-optimizer at this hardness,
   with its default methods ``["greedy", "ctgpart"]``: its planning
   seconds, trials and accel, unsliced), the planned tree's log2
   max size (<= 28) and log10 flops printed before it runs,
   ``bmm_absmax`` launches > 0 and |delta log10| <= 1e-4 against
   ``LATTICE6_LOG10``;
16. compressed contraction of the 16x16 bond-4 lattice at chi=32
   (``1 + 0.05 * normal`` float64 entries from ``default_rng(0)``): the
   port plans it (``greedy_compressed_ssa(..., chi=32)``; planning
   seconds, the SSA path's hash held to ``COMPRESSED_PATH_HASH``, the
   compressed log2 max, log2 peak and log10 flops), then
   ``ContractionTreeCompressed.contract_compressed(arrays, chi=32,
   strip_exponent=True)`` runs on the card in float64 and with the
   inputs cast to float32, each held to ``COMPRESSED_LOG10`` (from
   ``scratch/make_compressed_ref.py``) at |delta log10| <= 1e-4 and
   1e-3; per dtype the QR and SVD calls and the host syncs of one pass
   (``torch.cuda.set_sync_debug_mode("warn")``), the warm time-to-value
   (best of 3, each pass ending in a host pull checked finite and
   stable) and the peak device memory; the host seconds of the
   neighbour bookkeeping (``compress_with_neighbors``, under cProfile);
   one SVD of a 128x128 core and one QR of the largest tall-skinny
   operand, timed; no kernel of the port is launched;
17. Sycamore-53 m=10 planned by the port: ``HyperOptimizer(methods=
   ["greedy", "labels"], max_repeats=16, seed=8, slicing_reconf_opts=
   {"target_size": 2**27, "temperature": 0}, parallel=False)`` on the
   host, on the native library (``accel="auto"``), made repeatable: the
   methods are seeded counterparts that this script registers (the same
   finders and spaces, each trial's finder given the next seed of one
   stream per search; the package's own search is unseeded, as the
   reference's) and the slice finder runs at temperature 0 (planning
   seconds, seconds per trial, the methods and accel, the tree's hash,
   slices, log2 max and peak, log10 flops, beside the committed t27
   plan's), max size <= 2^27 and log10 flops <= the t27 plan's + 1;
   all its slices contracted through
   ``contract_tree`` and held to the sidecar's full amplitude (key
   ``"4"``, the sum over all slices of any plan) at relerr <= 1e-5,
   with the chain kernel's launches (the plan's passes x slices, > 0),
   the warm time-to-amplitude and peak memory beside the t27 plan's,
   measured in turns;
18. the 7x7 bond-16 lattice planned by the port the same way (target
   2^28), contracted stripped through ``bmm_absmax`` (launches = the
   plan's kernel steps x slices, > 0) and held to the plan file's
   float64 ``"reference"`` at |delta log10| <= 1e-4, its plan stats,
   warm time-to-value and launches beside the committed plan's;
19. phase 17 again with the hyper-optimizer's default methods
   (``HyperOptimizer()``'s: ``["greedy", "ctgpart"]``, asserted, then
   seeded as above), the same checks and limits;
20. phase 18 again with the default methods;
21. planning alone, pure Python (every finder as with ``accel=False``)
   against native, in turns (Python, native, native, Python): one
   seeded m10 greedy path and the committed unsliced t29 tree sliced
   and reconfigured to 2^25 at temperature 0; the seconds of each and
   their ratio;
22. the slice sum sharded over ranks (``parallel/mesh.py``), each
   multi-rank phase spawning its ranks from this script (``spawn``
   start method, after phase 2 built the kernels; the ranks import only
   ``cotengra_tpu_torch``), every rank killed at the first failure or
   after ``RANK_LIMIT_S``: m10-t27 (full width, 4 slices) through
   ``contract_sharded`` over two gloo ranks on the one card (NCCL
   refuses two ranks on a card): each rank's chain launches (its 2
   slices x 13 passes, 52 in all, phase 4's count), peak memory and
   warm seconds (best of 3), the amplitude identical on both ranks and
   within relerr 1e-5 of the sidecar's key ``"4"``; then, on the same
   ranks, an output-sliced ``rand_equation(12, 3, n_out=3)`` (rank 0's
   tree, ``broadcast_tree``) chunk-sharded, the whole output
   (``reassemble=True``) and each rank's own rows (``reassemble=False``)
   held to the unsharded result at 1e-5;
23. the stripped 7x7 lattice through ``contract_sharded(...,
   implementation="pallas")`` over three gloo ranks: 16 slices as 6, 5
   and 5, ``bmm_absmax`` launches 174, 145 and 145 (464 in all),
   |delta log10| <= 1e-4 on every rank, peak memory and warm seconds;
24. one rank on NCCL with the default mesh: t27 (52 chain launches,
   relerr <= 1e-5) and the lattice (464 ``bmm_absmax`` launches,
   |delta log10| <= 1e-4); the number of cards, and with two or more,
   both again with one NCCL rank per card;
25. a stripped sum of ~10^-55.6 (``rand_equation(10, 3)``, entries near
   1e-6, float32, 9 slices) over four gloo ranks: every rank's value
   within |delta log10| <= 1e-5 of the unsharded one (the JAX
   package's padded slots flush it to 0);
26. folded constants: the 7x7 lattice as an ``einsum_expression`` whose
   constants are every tensor but row ``FOLD_ROW``'s 7 (row 0: the
   row whose fold is largest; the sliced bond touches row 1), stripped
   through ``bmm_absmax``: the folded steps, the steps run and the
   kernel launches of the first and of a later call (the first runs the
   folded steps, later ones not), both values held to the plan's
   reference at 1e-4, and the later call's warm time against the
   unfolded expression's, in turns;
27. one JSON line of kernel results (launches on the main path, error,
   ms, plain ms, bound, library ms; the gate chain's m=20 figures
   under ``m20_*`` keys, the launches of phases 17 and 18 under
   ``hyper_*`` keys, of phases 19 and 20 under ``default_*`` keys, of
   phases 22-24 under ``sharded_*`` (per rank) and ``nccl_*`` keys and
   of phase 26 under ``folded_*`` keys), one JSON line
   ``{"host_native": {...}}`` of the host library's build seconds and
   the planning seconds of phases 15, 17-21, then the last line
   ``{"ok": true, "device": {...}}``.

Every instance is built and every plan loaded through the port
(``cotengra_tpu_torch.rand_circuit_tn``, ``lattice_equation``,
``load_tree``): the script imports neither JAX nor the JAX package.

Each main path (4, 5, 7, 8, 9, 11, 12, 13, 15-20, 22-24, 26) is
driven with every kernel's launch count set to 0 just before it and
read just after (in each rank, by the rank). Any failed
phase raises, and the script exits non-zero without the last line. It
needs a CUDA device and never falls back to the CPU.

``--profile`` instead runs ``torch.profiler`` over one warm pass of each
main path (m10-t27 slice by slice and through the batched call,
m10-t29, the lattice, 16 slices of m20-t28, the compressed 16x16 lattice
in float64) and prints the median wall time of 5 unprofiled passes, the
device's busy time and idle share, and every device kernel's time
grouped by class (the breakdown in ``PERF.md`` section 5).
"""

import contextlib
import cProfile
import gc
import hashlib
import json
import math
import pstats
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CHAIN_RTOL = 1e-5   # float32 sums in another order: a few ulps per gate
AMP_RTOL = 1e-5     # float32 planes at full fp32 matmul precision
BMM_RTOL = 1e-5     # float32 sums over K in another order
# float32 exponents summed over 48 steps x 16 slices: a wrong kernel or
# layout misses this by orders of magnitude
LOG10_ATOL = 1e-4
LATTICE = "lattice7x7_d16_s16"
T27 = "sycamore53_m10_t27"
M20 = "sycamore53_m20_t28"
M20_SLICES = 16     # the sidecar's largest partial sum
M20_PASSES = 40     # chain_tile_plan's passes over the 38 chains of M20
SEED = 1234
PROFILE_WALL_PASSES = 5
T27_BATCHED_LAUNCHES = 52   # 4 slices in one batched call (phase 9)
FRONT_END_OVERHEAD = 1.1    # front-end warm time / make_full_contractor's
# best of 5 in turns: best-of-3 t27 passes spread by 10% on the host side
FRONT_END_PASSES = 5
# t27's ~0.1 s pass carries ~10 ms of host jitter: best of 5 in turns put
# the ratio over 1.1 in 1 of 16 repeats; best of 21 keeps its spread
# well inside the limit (PERF.md section 6)
T27_FRONT_END_PASSES = 21
# log10 of the 6x6 bond-16 lattice's value in float64, from
# ``python scratch/make_lattice6_ref.py`` (the JAX package on the CPU:
# random-greedy path, strip_exponent=True, uniform [0, 1) float64 draws
# from default_rng(7), which phase 15 casts to float32)
LATTICE6_LOG10 = 61.38831832090792
LATTICE6_MAX_LOG2 = 28
# the compressed 16x16 bond-4 lattice at chi=32, from
# ``python scratch/make_compressed_ref.py`` (the JAX package on the CPU
# with x64: the same planner, path and float64 inputs; its stripped
# exponent is a float32 sum, whose ulp at 289 is 3.05e-5)
COMPRESSED = "lattice16x16_d4_chi32"
COMPRESSED_DIMS = (16, 16)
COMPRESSED_BOND = 4
COMPRESSED_CHI = 32
COMPRESSED_PATH_HASH = (
    "849afce1fe0f9957606833839d80c6439a64fc5500173c2588466ff6fb148c08"
)
COMPRESSED_LOG10 = 288.9674377441406
# float64 on the card: the exponent's float32 rounding and cuSOLVER's QR
# rounding otherwise than LAPACK's; float32: QR and SVD in float32 over
# 255 steps on top of that
COMPRESSED_ATOL = {torch.float64: 1e-4, torch.float32: 1e-3}
# phases 17-20: the port's own hyper-optimizer, as a user would call it:
# with the methods named (17-18), then with its default methods (19-20)
HYPER_TRIALS = 16
HYPER_SEED = 8
HYPER_M10_TARGET = 2**27
HYPER_LATTICE_TARGET = 2**28
HYPER_LABELS = ["greedy", "labels"]
DEFAULT_METHODS = ["greedy", "ctgpart"]   # where the native library builds
# phase 21: one refinement of a planning trial, timed pure Python against
# native: the committed unsliced t29 tree sliced and reconfigured to 2^25
# (temperature 0: no noise), after one seeded greedy path
TIMING_TARGET = 2**25
TIMING_GREEDY = {"costmod": 2.0, "temperature": 0.03, "seed": HYPER_SEED}
# log10 flops above the committed t27 plan's that a port-planned m10
# tree may reach
HYPER_FLOPS_SLACK = 1.0
# phases 17-20 plan with seeded counterparts of the hyper methods,
# registered under this prefix (the package's own searches are unseeded,
# as the reference's), so that each search gives the same tree each run
SEEDED_PREFIX = "smoke-seeded-"
# published H100 SXM peaks at a 700 W power limit (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12        # float32 FMA outside the tensor cores
TF32_FLOPS = 495e12       # dense TF32 on the tensor cores


def _load_instance(plan_name):
    """The Sycamore-53 network of the plan's depth (``..._m<depth>_...``;
    seed 42, absorbed as the benchmark does), the plan's tree, and its
    reference amplitudes."""
    from cotengra_tpu_torch import (
        absorb_simple_tensors,
        load_tree,
        rand_circuit_tn,
    )

    depth = int(plan_name.split("_m")[1].split("_")[0])
    inputs, output, _, _, arrays = rand_circuit_tn(53, depth, seed=42)
    inputs, arrays = absorb_simple_tensors(
        inputs, arrays, output, max_rank=2, max_absorb_size=2**12
    )
    size_dict = {
        ix: int(d)
        for term, arr in zip(inputs, arrays)
        for ix, d in zip(term, arr.shape)
    }
    plan = ROOT / "plans" / f"{plan_name}.json"
    tree = load_tree(str(plan), inputs, output, size_dict)
    with open(ROOT / "plans" / f"{plan_name}.refamp.json") as f:
        refs = {int(k): complex(*v) for k, v in json.load(f)["amps"].items()}
    return tree, arrays, refs


def _kernel_counters():
    """Every kernel wrapper of the port, by the name the JSON line uses."""
    from cotengra_tpu_torch.ops.bmm_absmax import bmm_absmax_cuda
    from cotengra_tpu_torch.ops.gate_chains import run_chain_cuda

    return {"gate_chain": run_chain_cuda, "bmm_absmax": bmm_absmax_cuda}


def _reset_launches():
    for wrapper in _kernel_counters().values():
        wrapper.launches = 0


def _read_launches():
    return {k: w.launches for k, w in _kernel_counters().items()}


def _load_lattice():
    """The 7x7 bond-16 lattice, its plan, float32 arrays rebuilt from the
    recipe stored with the plan, and the plan's float64 reference."""
    from cotengra_tpu_torch import lattice_equation, load_tree

    plan = ROOT / "plans" / f"{LATTICE}.json"
    with open(plan) as f:
        ref = json.load(f)["reference"]
    inst = ref["instance"]
    inputs, output, shapes, size_dict = lattice_equation(
        inst["dims"], d_min=inst["d_min"]
    )
    tree = load_tree(str(plan), inputs, output, size_dict)
    rng = np.random.default_rng(inst["seed"])
    arrays = [rng.uniform(size=s).astype(np.float32) for s in shapes]
    return tree, arrays, ref


def _operand_layout(legs, order, groups, sizes):
    """How a row-major tensor with ``legs`` reaches the 3-D (B, M, K)
    of ``order``, whose first ``groups[0]`` and next ``groups[1]`` legs
    merge into B and M: "contiguous" (no copy), "3-stride view" (each
    group merges, a strided view) or "general permutation" (a copy)."""
    from cotengra_tpu_torch.utils.misc import prod

    legs, order = list(legs), list(order)
    if legs == order:
        return "contiguous"
    shape = [sizes[ix] for ix in legs]
    stride = {ix: prod(shape[i + 1:]) for i, ix in enumerate(legs)}
    cut = [0, groups[0], groups[0] + groups[1], len(order)]
    for a, b in zip(cut, cut[1:]):
        for u, v in zip(order[a:b], order[a + 1:b]):
            if stride[u] != stride[v] * sizes[v]:
                return "general permutation"
    return "3-stride view"


def _lattice_kernel_shapes(tree, layouts=None):
    """{(B, M, K, N): steps per slice} of the plan's kernel steps, by the
    executor's routing rule on float32 tensors of the steps' shapes.
    ``layouts``, a dict, gets per-slice counts of the kernel operands by
    how they reach the kernel's layout (x as (batch, l_free, contract),
    y as (batch, r_free, contract); see ``_operand_layout``), and of the
    outputs that need a permute."""
    from cotengra_tpu_torch.ops.bmm_absmax import _bmm_layout
    from cotengra_tpu_torch.ops.executor import _pallas_step_ok
    from cotengra_tpu_torch.ops.lowering import (
        PairStep,
        extract_contractions,
    )
    from cotengra_tpu_torch.utils.misc import prod

    sizes = tree.size_dict
    shapes = {}
    for step in extract_contractions(tree).steps:
        if not isinstance(step, PairStep):
            continue
        x = torch.empty([sizes[ix] for ix in step.l_legs], device="meta")
        y = torch.empty([sizes[ix] for ix in step.r_legs], device="meta")
        if not _pallas_step_ok(x, y, step):
            continue
        batch, contract, l_free, r_free = _bmm_layout(
            step.l_legs, step.r_legs, step.out_legs
        )
        key = tuple(
            prod(sizes[ix] for ix in legs)
            for legs in (batch, l_free, contract, r_free)
        )
        shapes[key] = shapes.get(key, 0) + 1
        if layouts is not None:
            kinds = [
                _operand_layout(step.l_legs, batch + l_free + contract,
                                [len(batch), len(l_free)], sizes),
                _operand_layout(step.r_legs, batch + r_free + contract,
                                [len(batch), len(r_free)], sizes),
            ]
            if tuple(batch + l_free + r_free) != tuple(step.out_legs):
                kinds.append("output permuted")
            for kind in kinds:
                layouts[kind] = layouts.get(kind, 0) + 1
    return shapes


def _chain_recs(tree):
    from cotengra_tpu_torch.ops.grouped_plan import plan_grouped
    from cotengra_tpu_torch.ops.lowering import (
        extract_contractions,
        sliced_input_legs,
    )

    ir = extract_contractions(tree)
    orders = [sliced_input_legs(tree, i) for i in range(tree.N)]
    plans, *_ = plan_grouped(ir, tree.size_dict, orders, gate_mode="inplace")
    return [rec for kind, rec in plans if kind == "inplace"]


def _chain_passes(tree):
    """Chain-kernel launches per slice: the passes of every chain."""
    from cotengra_tpu_torch.ops.gate_chains import chain_tile_plan

    return sum(len(chain_tile_plan(rec.spec)) for rec in _chain_recs(tree))


def _cuda_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(
        f"# torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}",
        flush=True,
    )


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def phase_build():
    """The CUDA kernels (nvcc) and, beside them in a thread, the host
    planning library (g++). Returns the host library's build seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from cotengra_tpu_torch.ops import native
    from cotengra_tpu_torch.ops._build import library_path, load_library

    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(_timed, native.is_available)
        _, cuda_s = _timed(load_library)
        ok, host_s = host.result()
    print(f"# build: {library_path().name} in {cuda_s:.2f}s", flush=True)
    if not ok:
        raise RuntimeError(
            f"the native planning library did not build: "
            f"{native.build_error()}"
        )
    print(
        f"# build: host planning library {native.library()._name} in "
        f"{host_s:.2f}s (g++, in parallel with nvcc)",
        flush=True,
    )
    return host_s


def _accel_note():
    """Which path finders ``accel="auto"`` (every finder's default)
    takes in this process."""
    from cotengra_tpu_torch.pathfinders.basic import _get_native

    return (
        "accel auto: native library" if _get_native("auto") is not None
        else "accel auto: pure Python"
    )


def _chain_einsum(spec, x, ys):
    """(equation, operands) of one ``torch.einsum`` that computes the
    chain: complex64 x in the chain's input leg order and every gate
    (K legs, then N legs), the result in the chain's output order."""
    import string

    sizes = spec.leg_sizes
    orders = spec.gate_orders
    legs = list(dict.fromkeys(
        ix for o_in, o_out, _, _ in orders for ix in o_in + o_out
    ))
    if len(legs) > len(string.ascii_letters):
        raise ValueError(f"{len(legs)} legs: more than einsum's letters")
    sym = dict(zip(legs, string.ascii_letters))
    n = x.numel() // 2
    terms = ["".join(sym[ix] for ix in orders[0][0])]
    ops = [torch.complex(x[:n], x[n:]).view(
        [sizes[ix] for ix in orders[0][0]])]
    for (_, _, c, ny), y in zip(orders, ys):
        terms.append("".join(sym[ix] for ix in c + ny))
        ops.append(torch.complex(y[0], y[1]).view(
            [sizes[ix] for ix in c + ny]))
    eq = ",".join(terms) + "->" + "".join(sym[ix] for ix in orders[-1][1])
    return eq, ops


def _synthetic_chain():
    """A 2^24-element chain of seven 2-leg gates (two on leading legs,
    five on the trailing ten) whose tile, 8192 complex per batch element
    at the widest, outgrows one block's shared memory with its last
    gate: ``chain_tile_plan`` cuts it into two passes."""
    from cotengra_tpu_torch.ops.gate_chains import build_chain_spec

    n = 24
    order0 = tuple(f"a{k}" for k in range(n))
    sizes = {ix: 2 for ix in order0}
    cur, gates = list(order0), []
    for g, pos in enumerate([(0, 1), (2, 3), (14, 15), (16, 17), (18, 19),
                             (20, 21), (22, 23)]):
        c = tuple(cur[p] for p in pos)
        ny = (f"b{g}_0", f"b{g}_1")
        sizes.update(dict.fromkeys(ny, 2))
        rest = [ix for ix in cur if ix not in c]
        cur = rest[:pos[0]] + list(ny) + rest[pos[0]:]
        gates.append((c, ny))
    spec, out_order, c_orders = build_chain_spec(order0, sizes, gates)
    if spec is None:
        raise AssertionError(f"synthetic chain rejected: {out_order}")
    return spec, [(4, 4)] * len(gates)


def _check_chain(name, spec, x, ys):
    """Kernel vs plain on one chain: (max_abs_err, max|plain|), raising
    beyond CHAIN_RTOL."""
    from cotengra_tpu_torch.ops.gate_chains import (
        run_chain_cuda,
        run_chain_plain,
    )

    plain = run_chain_plain(spec, x, ys)
    kern = run_chain_cuda(spec, x, ys)
    torch.cuda.synchronize()
    err = (kern - plain).abs().max().item()
    scale = plain.abs().max().item()
    if not (np.isfinite(err) and err <= CHAIN_RTOL * scale):
        raise AssertionError(
            f"{name}: max|kernel-plain| = {err:.3e} > "
            f"{CHAIN_RTOL} * {scale:.3e}"
        )
    return err, scale, plain


def _chain_inputs(rng, spec, kn, dev):
    n_in = spec.gate_strides[0].numel_in
    x = torch.from_numpy(rng.standard_normal(2 * n_in, dtype=np.float32))
    ys = [
        torch.from_numpy(rng.standard_normal((2, K, N), dtype=np.float32))
        for K, N in kn
    ]
    return x.to(dev), [y.to(dev) for y in ys]


def _chain_inputs_on_card(gen, spec, kn, dev):
    """As ``_chain_inputs``, drawn on the card (2^28-element inputs
    take seconds to make with numpy on the host)."""
    n_in = spec.gate_strides[0].numel_in
    x = torch.randn(2 * n_in, generator=gen, device=dev)
    ys = [torch.randn((2, K, N), generator=gen, device=dev) for K, N in kn]
    return x, ys


def _pass_tile(ps):
    """The widest tile of a pass, in complex elements per batch element."""
    return max(max(g.numel_in, g.numel_out) for g in ps.tile)


def _measure_chains(label, recs, make_inputs):
    """Every chain of ``recs``, kernel vs plain at full size (one launch
    per pass of ``chain_tile_plan``), with the library call's time and
    the bound. Rows of (max_abs_err, kernel ms, plain ms, (bound ms,
    bound_by), library ms, passes)."""
    from cotengra_tpu_torch.ops.gate_chains import (
        chain_tile_plan,
        run_chain_cuda,
        run_chain_plain,
    )

    rows = []
    for ci, rec in enumerate(recs):
        spec = rec.spec
        kn = [(K, N) for _, _, K, N in rec.ys]
        plan = chain_tile_plan(spec)
        x, ys = make_inputs(spec, kn)
        n_in = x.numel() // 2
        before = run_chain_cuda.launches
        err, scale, plain = _check_chain(f"{label} chain {ci}", spec, x, ys)
        if run_chain_cuda.launches - before != len(plan):
            raise AssertionError(
                f"{label} chain {ci}: {run_chain_cuda.launches - before} "
                f"launches, the plan has {len(plan)} passes"
            )
        # the library call: one torch.einsum on complex64 inputs made
        # outside the timed region, held to the plain version
        eq, ops = _chain_einsum(spec, x, ys)
        lib = torch.view_as_real(torch.einsum(eq, *ops)).reshape(-1, 2)
        lib_err = (torch.cat([lib[:, 0], lib[:, 1]]) - plain).abs().max()
        if not lib_err.item() <= CHAIN_RTOL * scale:
            raise AssertionError(
                f"{label} chain {ci}: einsum {eq} off the plain version by "
                f"{lib_err.item():.3e}"
            )
        del plain, lib
        reps = 3 if n_in >= 2**26 else 10
        # in turns: plain, kernel, library, library, kernel, plain
        plain_ms = _cuda_ms(lambda: run_chain_plain(spec, x, ys), reps)
        ms = _cuda_ms(lambda: run_chain_cuda(spec, x, ys), reps)
        lib_ms = _cuda_ms(lambda: torch.einsum(eq, *ops), reps)
        lib_ms = (lib_ms + _cuda_ms(lambda: torch.einsum(eq, *ops), reps)) / 2
        ms = (ms + _cuda_ms(lambda: run_chain_cuda(spec, x, ys), reps)) / 2
        plain_ms = (plain_ms + _cuda_ms(
            lambda: run_chain_plain(spec, x, ys), reps)) / 2
        bound = _chain_bound(spec, kn)
        n_out = plan[-1].io.numel_out
        print(
            f"# {label} chain {ci:2d}: numel 2^{int(np.log2(n_in))} -> "
            f"2^{int(np.log2(n_out))} gates (K,N) {kn} tile "
            f"{[_pass_tile(ps) for ps in plan]} x batch tile "
            f"{[ps.batch_tile for ps in plan]} smem "
            f"{[ps.smem_bytes for ps in plan]} passes {len(plan)} "
            f"{[ps.gates for ps in plan]} max_abs_err {err:.3e} (max|plain| "
            f"{scale:.3e}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
            f"library {lib_ms:.3f} ms bound {bound[0]:.3f} ms ({bound[1]}; "
            f"{100 * bound[0] / ms:.0f}% of it)",
            flush=True,
        )
        rows.append((err, ms, plain_ms, bound, lib_ms, len(plan)))
        del x, ys, ops
    torch.cuda.empty_cache()
    print(
        f"# {label} chains per slice: kernel {sum(r[1] for r in rows):.3f} "
        f"ms plain {sum(r[2] for r in rows):.3f} ms library "
        f"{sum(r[4] for r in rows):.3f} ms bound "
        f"{sum(r[3][0] for r in rows):.3f} ms passes "
        f"{sum(r[5] for r in rows)}",
        flush=True,
    )
    return rows


def phase_chains(dev):
    """Every chain of the t27 plan, each one pass, kernel vs plain at
    full size, with the library call's time and the bound; then the
    two-pass synthetic chain."""
    from cotengra_tpu_torch.ops.gate_chains import (
        chain_tile_plan,
        run_chain_cuda,
    )

    tree, _, _ = _load_instance(T27)
    recs = _chain_recs(tree)
    for ci, rec in enumerate(recs):
        if len(chain_tile_plan(rec.spec)) != 1:
            raise AssertionError(f"t27 chain {ci}: more than one pass")
    rng = np.random.default_rng(SEED)
    rows = _measure_chains(
        "t27", recs, lambda spec, kn: _chain_inputs(rng, spec, kn, dev)
    )

    spec, kn = _synthetic_chain()
    plan = chain_tile_plan(spec)
    if len(plan) < 2:
        raise AssertionError(f"synthetic chain: {len(plan)} pass, not >= 2")
    x, ys = _chain_inputs(rng, spec, kn, dev)
    before = run_chain_cuda.launches
    err, scale, _ = _check_chain("synthetic chain", spec, x, ys)
    if run_chain_cuda.launches - before != len(plan):
        raise AssertionError("synthetic chain: launches != passes")
    ms = _cuda_ms(lambda: run_chain_cuda(spec, x, ys), 10)
    print(
        f"# synthetic chain: numel 2^24, {len(kn)} gates (4,4), passes "
        f"{[p.gates for p in plan]} tiles "
        f"{[max(g.numel_in for g in p.tile) for p in plan]} max_abs_err "
        f"{err:.3e} (max|plain| {scale:.3e}) kernel {ms:.3f} ms bound "
        f"{_chain_bound(spec, kn)[0]:.3f} ms (one pass)",
        flush=True,
    )
    del x, ys
    torch.cuda.empty_cache()
    return rows


def phase_chains_m20(dev):
    """Every chain of the m20-t28 plan, kernel vs plain at full size,
    with the library call's time and the bound; the plan's passes
    checked (40 in all, two chains of two)."""
    tree, _, _ = _load_instance(M20)
    recs = _chain_recs(tree)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rows = _measure_chains(
        "m20", recs,
        lambda spec, kn: _chain_inputs_on_card(gen, spec, kn, dev),
    )
    passes = [r[5] for r in rows]
    if sum(passes) != M20_PASSES or sorted(passes)[-3:] != [1, 2, 2]:
        raise AssertionError(
            f"m20 chains: passes {passes}, expected {M20_PASSES} in all "
            "with two chains of two"
        )
    return rows


def _chain_bound(spec, kn):
    """(ms, "bytes" or "operations"): the least time for one chain, as the
    TPU kernel does it - one read of the input planes, one write of the
    output planes and one read of each gate, at the HBM rate - or its
    complex multiply-adds (8 flops each) at the float32 rate, the
    larger."""
    g0, g1 = spec.gate_strides[0], spec.gate_strides[-1]
    nbytes = 8 * (g0.numel_in + g1.numel_out) + sum(8 * k * n for k, n in kn)
    flops = sum(
        8 * g.numel_in * n for g, (_, n) in zip(spec.gate_strides, kn)
    )
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def _bmm_bound(B, M, K, N):
    """(ms, "bytes" or "operations"): the least time for one (B, M, K, N)
    product at float32 accuracy - x, y read once and out written once at
    the HBM rate, or its 2 B M K N flops as three TF32 products on the
    tensor cores (the 3xTF32 ceiling, ~165 TFLOP/s), the larger."""
    t_bytes = 4 * B * (M * K + K * N + M * N) / HBM_BYTES_PER_S
    t_ops = 3 * 2 * B * M * K * N / TF32_FLOPS
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def phase_main_path(plan_name, n_ref, dev, passes=3):
    """contract_tree over all slices, checked against the sidecar."""
    import cotengra_tpu_torch as ctt

    tree, arrays, refs = _load_instance(plan_name)
    if tree.multiplicity != n_ref or n_ref not in refs:
        raise AssertionError(
            f"{plan_name}: {tree.multiplicity} slices, sidecar has "
            f"{sorted(refs)}"
        )
    expect = _chain_passes(tree) * n_ref
    torch.cuda.reset_peak_memory_stats()

    _reset_launches()
    amp = ctt.contract_tree(tree, arrays, device=dev)
    torch.cuda.synchronize()
    counts = _read_launches()
    launches = counts["gate_chain"]

    amp0 = complex(amp.cpu().item())
    ref = refs[n_ref]
    relerr = abs(amp0 - ref) / abs(ref)
    if counts != {"gate_chain": expect, "bmm_absmax": 0}:
        raise AssertionError(
            f"{plan_name}: launches {counts}, plan has {expect} passes"
        )
    if not relerr <= AMP_RTOL:
        raise AssertionError(
            f"{plan_name}: amplitude {amp0} vs reference {ref}: relerr "
            f"{relerr:.3e} > {AMP_RTOL}"
        )

    # warm time-to-amplitude: planned contractor and device inputs made
    # once; each pass ends in a host pull checked finite and stable
    core = ctt.make_grouped_contractor(tree, dev, torch.float32)
    planes = ctt.to_plane_tensors(arrays, dev, torch.float32)
    times = []
    for _ in range(passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ctt.contract_slices(tree, core, planes)
        val = complex(out[0].item(), out[1].item())
        times.append(time.perf_counter() - t0)
        if not (np.isfinite(val.real) and np.isfinite(val.imag)):
            raise AssertionError(f"{plan_name}: non-finite amplitude")
        if abs(val - amp0) > 1e-4 * abs(amp0):
            raise AssertionError(
                f"{plan_name}: unstable amplitude {val} vs {amp0}"
            )
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(
        f"# main path {plan_name}: slices {n_ref} amplitude "
        f"{amp0.real:.12e}{amp0.imag:+.12e}j relerr {relerr:.3e} "
        f"chain launches {launches} time_to_amplitude_s "
        f"{' '.join(f'{t:.4f}' for t in times)} (best {min(times):.4f}) "
        f"peak_mem_gib {peak:.2f}",
        flush=True,
    )
    return launches


def phase_bmm(dev):
    """Every distinct kernel shape of the lattice plan, kernel vs plain,
    at full size, with the library call's time and the bound."""
    from cotengra_tpu_torch.ops.bmm_absmax import (
        bmm_absmax_cuda,
        bmm_absmax_plain,
    )

    tree, _, _ = _load_lattice()
    rng = np.random.default_rng(SEED)
    layouts = {}
    shapes = _lattice_kernel_shapes(tree, layouts)
    print(
        f"# lattice kernel steps: {sum(shapes.values())} per slice; "
        f"operands and outputs by layout: {layouts}",
        flush=True,
    )
    rows = []
    for (B, M, K, N), n_steps in sorted(shapes.items()):
        x = torch.from_numpy(rng.random((B, M, K), dtype=np.float32)).to(dev)
        # y as the executor hands it over: the (B, K, N) transpose of a
        # contiguous (B, N, K)
        yt = torch.from_numpy(rng.random((B, N, K), dtype=np.float32)).to(dev)
        y = yt.transpose(1, 2)
        plain, plain_amax = bmm_absmax_plain(x, y)
        kern, amax = bmm_absmax_cuda(x, y)
        torch.cuda.synchronize()
        err = (kern - plain).abs().max().item()
        scale = plain_amax.item()
        amax_err = abs(amax.item() - scale)
        exact = amax.item() == kern.abs().max().item()
        if not (
            np.isfinite(err) and err <= BMM_RTOL * scale
            and amax_err <= BMM_RTOL * scale and exact
        ):
            raise AssertionError(
                f"bmm_absmax {(B, M, K, N)}: max|kernel-plain| {err:.3e}, "
                f"|absmax-plain| {amax_err:.3e} (max|plain| {scale:.3e}), "
                f"absmax == max|out|: {exact}"
            )
        del plain, kern
        flops = 2 * B * M * K * N
        reps = max(2, min(50, int(2e11 / (flops + 1))))
        # in turns: plain, kernel, kernel, plain. The plain version is
        # the library call itself (torch.bmm, then abs().amax()), which
        # the port never makes on a CUDA tensor: it is timed once and
        # reported as both
        plain_ms = _cuda_ms(lambda: bmm_absmax_plain(x, y), reps)
        ms = _cuda_ms(lambda: bmm_absmax_cuda(x, y), reps)
        ms = (ms + _cuda_ms(lambda: bmm_absmax_cuda(x, y), reps)) / 2
        plain_ms = (plain_ms + _cuda_ms(lambda: bmm_absmax_plain(x, y),
                                        reps)) / 2
        # what a contiguous (B, K, N) y costs: the wrapper's transposing copy
        yc = y.contiguous()
        copy_ms = _cuda_ms(lambda: yc.transpose(1, 2).contiguous(), reps)
        bound_ms, bound_by = _bmm_bound(B, M, K, N)
        fp32_ms = flops / FP32_FLOPS * 1e3
        print(
            f"# bmm_absmax (B,M,K,N) {(B, M, K, N)} x{n_steps}/slice: "
            f"max_abs_err {err:.3e} (max|plain| {scale:.3e}) absmax_err "
            f"{amax_err:.3e} absmax==max|out| {exact} kernel {ms:.3f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s) plain = library "
            f"{plain_ms:.3f} ms ({flops / plain_ms / 1e9:.1f} TFLOP/s) "
            f"bound {bound_ms:.3f} ms ({bound_by}; 3xTF32 ceiling) fp32-FMA "
            f"bound {fp32_ms:.3f} ms y-transpose copy {copy_ms:.3f} ms",
            flush=True,
        )
        rows.append((err, ms * n_steps, plain_ms * n_steps,
                     bound_ms * n_steps, bound_by, fp32_ms * n_steps))
        del x, y, yt, yc
    torch.cuda.empty_cache()
    print(
        f"# bmm_absmax per slice: kernel {sum(r[1] for r in rows):.3f} ms "
        f"plain = library {sum(r[2] for r in rows):.3f} ms bound "
        f"{sum(r[3] for r in rows):.3f} ms (3xTF32) fp32-FMA bound "
        f"{sum(r[5] for r in rows):.3f} ms",
        flush=True,
    )
    return rows


def phase_lattice(dev, passes=3):
    """The lattice main path over all 16 slices, checked against the
    plan's float64 reference."""
    import cotengra_tpu_torch as ctt

    tree, arrays, ref = _load_lattice()
    n_slices = tree.multiplicity
    if n_slices != ref["slices"]:
        raise AssertionError(
            f"{LATTICE}: {n_slices} slices, reference has {ref['slices']}"
        )
    expect = sum(_lattice_kernel_shapes(tree).values()) * n_slices
    torch.cuda.reset_peak_memory_stats()

    _reset_launches()
    m, e = ctt.contract_tree(
        tree, arrays, device=dev, strip_exponent=True,
        implementation="pallas",
    )
    torch.cuda.synchronize()
    counts = _read_launches()

    log10 = float(np.log10(abs(m.item())) + e.item())
    d_log10 = abs(log10 - ref["log10"])
    if counts != {"gate_chain": 0, "bmm_absmax": expect}:
        raise AssertionError(
            f"{LATTICE}: launches {counts}, plan has {expect} kernel steps"
        )
    if not (np.isfinite(log10) and d_log10 <= LOG10_ATOL):
        raise AssertionError(
            f"{LATTICE}: log10 {log10!r} vs reference {ref['log10']!r}: "
            f"|delta| {d_log10:.3e} > {LOG10_ATOL}"
        )

    # unstripped, float32 cannot hold the value
    plain = ctt.contract_tree(
        tree, arrays, device=dev, implementation="pallas"
    ).item()
    if np.isfinite(plain) and abs(plain) <= np.finfo(np.float32).max:
        raise AssertionError(f"{LATTICE}: unstripped float32 gave {plain}")

    # warm time-to-value: contractor and device inputs made once; each
    # pass ends in a host pull checked finite and stable
    one_pass = _warm_pass(LATTICE, dev)
    times = []
    for _ in range(passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pm, pe = one_pass()
        times.append(time.perf_counter() - t0)
        val = float(np.log10(abs(pm)) + pe)
        if not (np.isfinite(val) and abs(val - log10) <= 1e-5):
            raise AssertionError(
                f"{LATTICE}: unstable value log10 {val!r} vs {log10!r}"
            )
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(
        f"# main path {LATTICE}: slices {n_slices} value "
        f"{m.item():.9e} x 10^{e.item():.6f} log10 {log10:.7f} (reference "
        f"{ref['log10']:.7f}) |delta log10| {d_log10:.3e} bmm_absmax "
        f"launches {counts['bmm_absmax']} unstripped float32 {plain} "
        f"time_to_value_s {' '.join(f'{t:.4f}' for t in times)} (best "
        f"{min(times):.4f}) peak_mem_gib {peak:.2f}",
        flush=True,
    )
    return counts["bmm_absmax"]


def phase_t27_stripped(dev):
    """The m10-t27 amplitude with the grouped split-complex strip."""
    import cotengra_tpu_torch as ctt

    tree, arrays, refs = _load_instance(T27)
    n_ref = tree.multiplicity
    expect = _chain_passes(tree) * n_ref
    _reset_launches()
    m, e = ctt.contract_tree(tree, arrays, device=dev, strip_exponent=True)
    torch.cuda.synchronize()
    counts = _read_launches()
    amp = complex(m.cpu().item()) * 10.0 ** e.item()
    ref = refs[n_ref]
    relerr = abs(amp - ref) / abs(ref)
    if counts != {"gate_chain": expect, "bmm_absmax": 0}:
        raise AssertionError(
            f"stripped t27: launches {counts}, plan has {expect} passes"
        )
    if not relerr <= AMP_RTOL:
        raise AssertionError(
            f"stripped t27: amplitude {amp} vs reference {ref}: relerr "
            f"{relerr:.3e} > {AMP_RTOL}"
        )
    print(
        f"# stripped sycamore53_m10_t27: mantissa {complex(m.cpu().item())} "
        f"exponent {e.item():.6f} amplitude {amp.real:.12e}"
        f"{amp.imag:+.12e}j relerr {relerr:.3e} launches {counts}",
        flush=True,
    )


def _batched_chain_passes(fn, n_slices):
    """Chain-kernel launches of one batched call over ``n_slices``: the
    passes of the slice-invariant chains once, the others per slice."""
    from cotengra_tpu_torch.ops.gate_chains import chain_tile_plan

    def passes(steps):
        return sum(
            len(chain_tile_plan(fn.plans[si][1].spec))
            for si in steps if fn.plans[si][0] == "inplace"
        )

    return passes(fn.batch.steps_once) + n_slices * passes(
        fn.batch.steps_each
    )


def _batched_amp(fn, planes, n_slices):
    """One batched call over slices 0..n_slices-1, summed and pulled."""
    out = fn(planes, range(n_slices)).sum(0)
    return complex(out[0].item(), out[1].item())


def phase_t27_batched(dev, passes=3):
    """m10-t27 through the slice-batched call, plain and stripped, then
    the warm times of the batched call and of phase 4's slice loop in
    turns."""
    import cotengra_tpu_torch as ctt

    tree, arrays, refs = _load_instance(T27)
    n = tree.multiplicity
    fn = ctt.make_grouped_contractor(tree, dev, torch.float32, slice_batch=n)
    expect = _batched_chain_passes(fn, n)
    ref = refs[n]
    for strip in (False, True):
        _reset_launches()
        res = ctt.contract_tree(
            tree, arrays, device=dev, slice_batch=n, strip_exponent=strip
        )
        torch.cuda.synchronize()
        counts = _read_launches()
        if strip:
            amp = complex(res[0].cpu().item()) * 10.0 ** res[1].item()
        else:
            amp = complex(res.cpu().item())
        relerr = abs(amp - ref) / abs(ref)
        if counts != {"gate_chain": expect, "bmm_absmax": 0}:
            raise AssertionError(
                f"batched t27 (strip {strip}): launches {counts}, the plan "
                f"gives {expect}"
            )
        if not relerr <= AMP_RTOL:
            raise AssertionError(
                f"batched t27 (strip {strip}): amplitude {amp} vs "
                f"reference {ref}: relerr {relerr:.3e} > {AMP_RTOL}"
            )
        print(
            f"# batched {T27} (slice_batch {n}, strip {strip}): amplitude "
            f"{amp.real:.12e}{amp.imag:+.12e}j relerr {relerr:.3e} chain "
            f"launches {counts['gate_chain']} (steps once "
            f"{len(fn.batch.steps_once)}, per slice "
            f"{len(fn.batch.steps_each)})",
            flush=True,
        )

    # warm time-to-amplitude of both slice loops, in turns
    core = ctt.make_grouped_contractor(tree, dev, torch.float32)
    planes = ctt.to_plane_tensors(arrays, dev, torch.float32)
    loops = {
        "slice loop": lambda: ctt.contract_slices(tree, core, planes),
        "batched call": lambda: fn(planes, range(n)).sum(0),
    }
    times = {k: [] for k in loops}
    for k in [*loops, *reversed(loops)] * ((passes + 1) // 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = loops[k]()
        val = complex(out[0].item(), out[1].item())
        times[k].append(time.perf_counter() - t0)
        if not abs(val - ref) <= AMP_RTOL * abs(ref):
            raise AssertionError(f"{T27} {k}: unstable amplitude {val}")
    print(
        "# warm time_to_amplitude_s " + "; ".join(
            f"{k} {' '.join(f'{t:.4f}' for t in ts)} (best {min(ts):.4f})"
            for k, ts in times.items()
        ),
        flush=True,
    )


def phase_m20(dev, passes=3):
    """The m20-t28 main path: one batched call of slices 0..15, partial
    sums held to the sidecar, launches, warm time and peak memory."""
    import cotengra_tpu_torch as ctt

    t0 = time.perf_counter()
    tree, arrays, refs = _load_instance(M20)
    fn = ctt.make_grouped_contractor(
        tree, dev, torch.float32, slice_batch=M20_SLICES
    )
    planes = ctt.to_plane_tensors(arrays, dev, torch.float32)
    expect = _batched_chain_passes(fn, M20_SLICES)
    setup = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _reset_launches()
    t0 = time.perf_counter()
    res = fn(planes, range(M20_SLICES))
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = _read_launches()

    if counts != {"gate_chain": expect, "bmm_absmax": 0}:
        raise AssertionError(
            f"{M20}: launches {counts}, the plan gives {expect}"
        )
    per_slice = res.cpu().double()
    if tuple(per_slice.shape) != (M20_SLICES, 2) or not bool(
        torch.isfinite(per_slice).all()
    ):
        raise AssertionError(f"{M20}: per-slice planes {per_slice}")
    partial = per_slice.cumsum(0)
    errs = {}
    for n, ref in sorted(refs.items()):
        amp = complex(partial[n - 1, 0].item(), partial[n - 1, 1].item())
        errs[n] = abs(amp - ref) / abs(ref)
        if not errs[n] <= AMP_RTOL:
            raise AssertionError(
                f"{M20}: first {n} slices {amp} vs reference {ref}: "
                f"relerr {errs[n]:.3e} > {AMP_RTOL}"
            )
    if sorted(refs) != [4, 8, M20_SLICES]:
        raise AssertionError(f"{M20}: sidecar keys {sorted(refs)}")
    amp16 = complex(partial[-1, 0].item(), partial[-1, 1].item())

    times = []
    for _ in range(passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val = _batched_amp(fn, planes, M20_SLICES)
        times.append(time.perf_counter() - t0)
        if not (np.isfinite(val.real) and np.isfinite(val.imag)):
            raise AssertionError(f"{M20}: non-finite amplitude")
        if abs(val - amp16) > 1e-4 * abs(amp16):
            raise AssertionError(f"{M20}: unstable amplitude {val} vs {amp16}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    best = min(times)
    print(
        f"# main path {M20}: slices 0..{M20_SLICES - 1} in one batched call "
        f"(steps once {len(fn.batch.steps_once)}, per slice "
        f"{len(fn.batch.steps_each)}); partial amplitudes "
        + " ".join(
            f"[{n}] relerr {e:.3e}" for n, e in sorted(errs.items())
        )
        + f"; amplitude(16) {amp16.real:.12e}{amp16.imag:+.12e}j chain "
        f"launches {counts['gate_chain']} setup_s {setup:.2f} first_call_s "
        f"{first:.3f} warm_s {' '.join(f'{t:.4f}' for t in times)} (best "
        f"{best:.4f}, {1e3 * best / M20_SLICES:.2f} ms per slice) "
        f"peak_mem_gib {peak:.2f}",
        flush=True,
    )
    return counts["gate_chain"]


def _in_turns(label, calls, pull, passes=3):
    """Warm times of ``calls`` (name -> fn) measured in turns, each pass
    ending in ``pull(result)``, a host pull that must be finite and
    agree with the first pass's to 1e-6 relative. Returns name -> list
    of seconds."""
    names = list(calls)
    order = ([*names, *reversed(names)] * passes)[:passes * len(names)]
    times = {k: [] for k in names}
    first = None
    for k in order:
        gc.collect()  # earlier passes' garbage is not this pass's cost
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        val = pull(calls[k]())
        times[k].append(time.perf_counter() - t0)
        first = val if first is None else first
        if not (np.isfinite(val) and abs(val - first) <= 1e-6 * abs(first)):
            raise AssertionError(f"{label} {k}: unstable value {val} vs {first}")
    return times


def _check_front_end_time(label, times):
    best = {k: min(ts) for k, ts in times.items()}
    front, direct = best["front end"], best["make_full_contractor"]
    print(
        f"# front end {label} warm_s "
        + "; ".join(
            f"{k} {' '.join(f'{t:.4f}' for t in ts)} (best {best[k]:.4f})"
            for k, ts in times.items()
        )
        + f"; front end / direct {front / direct:.3f}",
        flush=True,
    )
    if not front <= FRONT_END_OVERHEAD * direct:
        raise AssertionError(
            f"front end {label}: warm {front:.4f}s > {FRONT_END_OVERHEAD} x "
            f"make_full_contractor's {direct:.4f}s: it re-plans"
        )


def _stripped_log10(res):
    m, e = res
    return float(np.log10(abs(m.item())) + e.item())


def phase_front_lattice(dev):
    """``einsum`` with the loaded 7x7 tree, stripped through the kernel,
    on the default device; then its warm time against the direct
    contractor's, in turns."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.utils.eqs import inputs_output_to_eq

    t_phase = time.perf_counter()
    tree, arrays, ref = _load_lattice()
    eq = inputs_output_to_eq(tree.inputs, tree.output)
    expect = sum(_lattice_kernel_shapes(tree).values()) * tree.multiplicity
    opts = dict(strip_exponent=True, implementation="pallas")

    _reset_launches()
    res = ctt.einsum(eq, *arrays, optimize=tree, **opts)
    torch.cuda.synchronize()
    counts = _read_launches()
    log10 = _stripped_log10(res)
    d_log10 = abs(log10 - ref["log10"])
    if res[0].device != dev:
        raise AssertionError(f"front end lattice: result on {res[0].device}")
    if counts != {"gate_chain": 0, "bmm_absmax": expect}:
        raise AssertionError(
            f"front end lattice: launches {counts}, plan has {expect}"
        )
    if not (np.isfinite(log10) and d_log10 <= LOG10_ATOL):
        raise AssertionError(
            f"front end lattice: log10 {log10!r} vs {ref['log10']!r}: "
            f"|delta| {d_log10:.3e} > {LOG10_ATOL}"
        )
    print(
        f"# front end {LATTICE}: einsum(optimize=tree, strip_exponent=True, "
        f'implementation="pallas") log10 {log10:.7f} |delta log10| '
        f"{d_log10:.3e} bmm_absmax launches {counts['bmm_absmax']}",
        flush=True,
    )

    tensors = ctt.to_tensors(arrays, dev, torch.float32)
    direct = ctt.make_full_contractor(tree, dev, **opts)
    times = _in_turns(
        "front end lattice",
        {
            "front end": lambda: ctt.einsum(
                eq, *tensors, optimize=tree, **opts
            ),
            "make_full_contractor": lambda: direct(*tensors),
        },
        _stripped_log10, FRONT_END_PASSES,
    )
    _check_front_end_time(LATTICE, times)
    print(f"# front end {LATTICE} phase_s {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return counts["bmm_absmax"]


def phase_front_t27(dev):
    """``array_contract`` with the loaded t27 tree through the batched
    call; then its warm time against the direct contractor's, in
    turns."""
    import cotengra_tpu_torch as ctt

    t_phase = time.perf_counter()
    tree, arrays, refs = _load_instance(T27)
    n = tree.multiplicity
    if tree.output != ():
        raise AssertionError(f"{T27}: output {tree.output}, not ()")
    expect = _batched_chain_passes(
        ctt.make_grouped_contractor(tree, dev, slice_batch=n), n
    )
    if expect != T27_BATCHED_LAUNCHES:
        raise AssertionError(f"{T27}: the plan gives {expect} launches")
    ref = refs[n]

    _reset_launches()
    res = ctt.array_contract(arrays, tree.inputs, (), optimize=tree,
                             slice_batch=n)
    torch.cuda.synchronize()
    counts = _read_launches()
    amp = complex(res.cpu().item())
    relerr = abs(amp - ref) / abs(ref)
    if res.device != dev or res.dtype != torch.complex64:
        raise AssertionError(
            f"front end t27: {res.dtype} result on {res.device}"
        )
    if counts != {"gate_chain": expect, "bmm_absmax": 0}:
        raise AssertionError(
            f"front end t27: launches {counts}, the plan gives {expect}"
        )
    if not relerr <= AMP_RTOL:
        raise AssertionError(
            f"front end t27: amplitude {amp} vs {ref}: relerr "
            f"{relerr:.3e} > {AMP_RTOL}"
        )
    print(
        f"# front end {T27}: array_contract(optimize=tree, slice_batch={n}) "
        f"amplitude {amp.real:.12e}{amp.imag:+.12e}j relerr {relerr:.3e} "
        f"chain launches {counts['gate_chain']}",
        flush=True,
    )

    tensors = ctt.to_tensors(arrays, dev, torch.float32)
    direct = ctt.make_full_contractor(tree, dev, slice_batch=n)
    times = _in_turns(
        "front end t27",
        {
            "front end": lambda: ctt.array_contract(
                tensors, tree.inputs, (), optimize=tree, slice_batch=n
            ),
            "make_full_contractor": lambda: direct(*tensors),
        },
        lambda r: complex(r.item()), T27_FRONT_END_PASSES,
    )
    _check_front_end_time(T27, times)
    print(f"# front end {T27} phase_s {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return counts["gate_chain"]


def phase_front_auto(dev):
    """``einsum`` on the 6x6 bond-16 lattice with ``optimize="auto"``:
    the port plans the path (the hyper-optimizer at this hardness)."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.utils.eqs import inputs_output_to_eq

    t_phase = time.perf_counter()
    inputs, output, shapes, _ = ctt.lattice_equation([6, 6], d_min=16)
    rng = np.random.default_rng(7)
    arrays = [rng.uniform(size=s).astype(np.float32) for s in shapes]
    eq = inputs_output_to_eq(inputs, output)
    opts = dict(strip_exponent=True, implementation="pallas")
    hardness = ctt.estimate_optimal_hardness(inputs)

    # the expression einsum finds in the cache: planned here, so that its
    # tree is printed before it runs
    t0 = time.perf_counter()
    expr = ctt.einsum_expression(eq, *shapes, **opts)
    plan_s = time.perf_counter() - t0
    tree = expr.tree
    max_log2 = tree.max_size(log=2)
    hyper = ctt.auto_optimize._get_hyperoptimizer()
    trials = len(hyper.trials)
    if hyper._methods != DEFAULT_METHODS:
        raise AssertionError(f"auto 6x6: methods {hyper._methods}")
    print(
        f"# front end lattice6x6_d16 auto: hardness {hardness:.0f}, the "
        f"hyper-optimizer's {trials} trials (methods {hyper._methods}, "
        f"{_accel_note()}) planned in {plan_s:.2f}s: "
        f"slices {tree.multiplicity} log2 max size "
        f"{max_log2:.2f} log2 peak {tree.peak_size(log=2):.2f} log10 flops "
        f"{tree.total_flops(log=10):.3f}",
        flush=True,
    )
    if max_log2 > LATTICE6_MAX_LOG2 or tree.multiplicity != 1:
        raise AssertionError(
            f"auto 6x6: 2^{max_log2:.2f} max size, {tree.multiplicity} "
            f"slices"
        )

    _reset_launches()
    t0 = time.perf_counter()
    res = ctt.einsum(eq, *arrays, **opts)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = _read_launches()
    if ctt.einsum_expression(eq, *shapes, **opts) is not expr:
        raise AssertionError("auto 6x6: einsum planned another expression")
    log10 = _stripped_log10(res)
    d_log10 = abs(log10 - LATTICE6_LOG10)
    if counts["gate_chain"] != 0 or counts["bmm_absmax"] <= 0:
        raise AssertionError(f"auto 6x6: launches {counts}")
    if not (np.isfinite(log10) and d_log10 <= LOG10_ATOL):
        raise AssertionError(
            f"auto 6x6: log10 {log10!r} vs {LATTICE6_LOG10!r}: |delta| "
            f"{d_log10:.3e} > {LOG10_ATOL}"
        )
    print(
        f"# front end lattice6x6_d16 auto: log10 {log10:.7f} (reference "
        f"{LATTICE6_LOG10:.7f}) |delta log10| {d_log10:.3e} bmm_absmax "
        f"launches {counts['bmm_absmax']} call_s {first_s:.3f} phase_s "
        f"{time.perf_counter() - t_phase:.1f}",
        flush=True,
    )
    return plan_s


def _compressed_inputs():
    """The 16x16 bond-4 lattice and its float64 inputs, as
    ``scratch/make_compressed_ref.py`` makes them."""
    from cotengra_tpu_torch import lattice_equation

    inputs, output, shapes, size_dict = lattice_equation(
        list(COMPRESSED_DIMS), d_min=COMPRESSED_BOND
    )
    rng = np.random.default_rng(0)
    arrays = [np.ones(s) + 0.05 * rng.normal(size=s) for s in shapes]
    return inputs, output, size_dict, arrays


def _path_hash(ssa_path):
    text = repr(tuple(tuple(int(i) for i in step) for step in ssa_path))
    return hashlib.sha256(text.encode()).hexdigest()


@contextlib.contextmanager
def _count_linalg():
    """Count ``torch.linalg.qr`` and ``torch.linalg.svd`` calls (looked up
    at call time by ``ops/compressed.py``) and the host syncs that
    ``set_sync_debug_mode("warn")`` reports, inside the block."""
    counts = {"qr": 0, "svd": 0, "syncs": 0}
    real = {k: getattr(torch.linalg, k) for k in ("qr", "svd")}

    def counted(k):
        def fn(*args, **kwargs):
            counts[k] += 1
            return real[k](*args, **kwargs)

        return fn

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for k in real:
            setattr(torch.linalg, k, counted(k))
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield counts
        finally:
            torch.cuda.set_sync_debug_mode("default")
            for k, fn in real.items():
                setattr(torch.linalg, k, fn)
    counts["syncs"] = sum(
        "synchroniz" in str(w.message) for w in caught
    )


def _stripped_pass(tree, tensors):
    """One compressed contraction at chi=32, pulled to the host."""
    m, e = tree.contract_compressed(
        tensors, chi=COMPRESSED_CHI, strip_exponent=True,
        device=tensors[0].device,
    )
    if m.shape != () or e.dtype != torch.float32:
        raise AssertionError(f"{COMPRESSED}: mantissa {m.shape}, {e.dtype}")
    return m.item(), e.item()


def phase_compressed(dev, passes=3):
    """The compressed 16x16 lattice: planned by the port, contracted on
    the card in float64 and float32, held to the JAX package's value."""
    from cotengra_tpu_torch.pathfinders.compressed import (
        greedy_compressed_ssa,
    )
    from cotengra_tpu_torch.tree_compressed import ContractionTreeCompressed

    t_phase = time.perf_counter()
    inputs, output, size_dict, arrays = _compressed_inputs()
    t0 = time.perf_counter()
    ssa_path = greedy_compressed_ssa(
        inputs, output, size_dict, chi=COMPRESSED_CHI
    )
    tree = ContractionTreeCompressed.from_path(
        inputs, output, size_dict, ssa_path=ssa_path
    )
    plan_s = time.perf_counter() - t0
    phash = _path_hash(ssa_path)
    print(
        f"# {COMPRESSED}: planned in {plan_s:.3f}s, ssa path hash {phash}",
        flush=True,
    )
    if phash != COMPRESSED_PATH_HASH:
        raise AssertionError(
            f"{COMPRESSED}: path hash {phash} != {COMPRESSED_PATH_HASH}"
        )
    stats = tree.compressed_contract_stats(chi=COMPRESSED_CHI)
    print(
        f"# {COMPRESSED}: compressed log2 max {np.log2(stats.max_size):.3f} "
        f"log2 peak {np.log2(stats.peak_size):.3f} log10 flops "
        f"{np.log10(stats.flops):.3f}",
        flush=True,
    )

    for dtype in (torch.float64, torch.float32):
        tensors = [torch.as_tensor(a, dtype=dtype, device=dev) for a in arrays]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        with _count_linalg() as counts:
            m, e = tree.contract_compressed(
                tensors, chi=COMPRESSED_CHI, strip_exponent=True, device=dev
            )
        mant, expo = m.item(), e.item()
        first_s = time.perf_counter() - t0
        launches = _read_launches()
        log10 = float(np.log10(abs(mant)) + expo)
        d_log10 = abs(log10 - COMPRESSED_LOG10)
        if launches != {"gate_chain": 0, "bmm_absmax": 0}:
            raise AssertionError(f"{COMPRESSED}: launches {launches}")
        if m.dtype != dtype or m.device != dev:
            raise AssertionError(f"{COMPRESSED}: {m.dtype} on {m.device}")
        if not (np.isfinite(log10) and d_log10 <= COMPRESSED_ATOL[dtype]):
            raise AssertionError(
                f"{COMPRESSED} {dtype}: log10 {log10!r} vs "
                f"{COMPRESSED_LOG10!r}: |delta| {d_log10:.3e} > "
                f"{COMPRESSED_ATOL[dtype]}"
            )
        times = []
        for _ in range(passes):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pm, pe = _stripped_pass(tree, tensors)
            times.append(time.perf_counter() - t0)
            val = float(np.log10(abs(pm)) + pe)
            if not (np.isfinite(val) and abs(val - log10) <= 1e-6):
                raise AssertionError(
                    f"{COMPRESSED} {dtype}: unstable log10 {val!r} vs "
                    f"{log10!r}"
                )
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(
            f"# main path {COMPRESSED} {str(dtype).removeprefix('torch.')}: "
            f"value {mant!r} x 10^{expo!r} log10 {log10!r} (reference "
            f"{COMPRESSED_LOG10!r}) |delta log10| {d_log10:.3e} qr "
            f"{counts['qr']} svd {counts['svd']} host syncs "
            f"{counts['syncs']} first_call_s {first_s:.3f} time_to_value_s "
            f"{' '.join(f'{t:.4f}' for t in times)} (best {min(times):.4f}) "
            f"peak_mem_gib {peak:.2f} launches {launches}",
            flush=True,
        )
        if dtype == torch.float64:
            _compressed_host_share(tree, tensors)
        _time_compressed_linalg(dtype, dev, int(stats.max_size))
        del tensors, m, e
        torch.cuda.empty_cache()
    print(f"# {COMPRESSED} phase_s {time.perf_counter() - t_phase:.1f}",
          flush=True)


def _compressed_host_share(tree, tensors):
    """Host seconds of the neighbour bookkeeping in one pass under
    cProfile: the own time of ``compress_with_neighbors`` (its index-holder
    count over every live tensor, per neighbour) and ``neighbors_of``."""
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.enable()
    _stripped_pass(tree, tensors)
    prof.disable()
    wall = time.perf_counter() - t0
    own = {}
    for (path, _, name), row in pstats.Stats(prof).stats.items():
        if path.endswith("compressed.py") and name in (
            "compress_with_neighbors", "neighbors_of"
        ):
            own[name] = own.get(name, 0.0) + row[2]
    print(
        f"# {COMPRESSED} host bookkeeping under cProfile: "
        + " ".join(f"{k} {v:.4f}s" for k, v in sorted(own.items()))
        + f" of a {wall:.3f}s profiled pass ({tree.N} tensors)",
        flush=True,
    )


def _time_compressed_linalg(dtype, dev, max_size):
    """One SVD of the largest core (D x D, D = 4 * chi = 128 here) and
    one QR of the largest operand as a tall-skinny (max_size / D, D)
    matrix, by CUDA events."""
    D = COMPRESSED_BOND * COMPRESSED_CHI
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    core = torch.randn(D, D, generator=gen, device=dev, dtype=dtype)
    tall = torch.randn(max_size // D, D, generator=gen, device=dev, dtype=dtype)
    for _ in range(2):
        torch.linalg.svd(core, full_matrices=False)
        torch.linalg.qr(tall)
    svd_ms = _cuda_ms(lambda: torch.linalg.svd(core, full_matrices=False), 20)
    qr_ms = _cuda_ms(lambda: torch.linalg.qr(tall), 5)
    print(
        f"# {COMPRESSED} {str(dtype).removeprefix('torch.')}: one svd "
        f"({D}, {D}) {svd_ms:.3f} ms; one qr ({max_size // D}, {D}) "
        f"{qr_ms:.3f} ms",
        flush=True,
    )
    del core, tall


def _seeded_methods(methods, rng):
    """Register a seeded counterpart of each hyper method in ``methods``
    (``SEEDED_PREFIX`` + its name): the same path finder and search
    space, each trial's finder given the next seed drawn from ``rng``.
    Returns their names."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.pathfinders.labels import optimize_labels
    from cotengra_tpu_torch.pathfinders.partition import optimize_ctgpart

    finders = {"greedy": ctt.optimize_greedy, "labels": optimize_labels,
               "ctgpart": optimize_ctgpart}
    spaces = ctt.get_hyper_space()
    names = []
    for method in methods:
        def trial(inputs, output, size_dict, _finder=finders[method],
                  **params):
            return _finder(inputs, output, size_dict, use_ssa=True,
                           seed=rng.randrange(2**31), **params)

        names.append(SEEDED_PREFIX + method)
        ctt.register_hyper_function(names[-1], trial, space=spaces[method])
    return names


def _hyper_plan(tree, target, methods):
    """The port's hyper-optimizer on the instance of a committed ``tree``,
    sliced to ``target`` (planned on the host, serially: the process has
    initialised CUDA), with ``methods`` (``None``: its defaults, which
    must be ``DEFAULT_METHODS``). The search is made repeatable: the
    methods' seeded counterparts (``_seeded_methods``, one seed stream
    per search) and the refinement's slice finder at temperature 0.
    Returns the planned tree, the planning seconds, the trials and a
    note of the methods and accel."""
    import random

    import cotengra_tpu_torch as ctt

    if methods is None:
        methods = ctt.HyperOptimizer(parallel=False)._methods
        if methods != DEFAULT_METHODS:
            raise AssertionError(f"hyper plan: default methods {methods}")
        defaults = True
    else:
        defaults = False
    opt = ctt.HyperOptimizer(
        methods=_seeded_methods(methods, random.Random(HYPER_SEED)),
        max_repeats=HYPER_TRIALS, seed=HYPER_SEED,
        slicing_reconf_opts={"target_size": target, "temperature": 0},
        parallel=False,
    )
    t0 = time.perf_counter()
    planned = opt.search(tree.inputs, tree.output, tree.size_dict)
    plan_s = time.perf_counter() - t0
    if planned.max_size() > target:
        raise AssertionError(
            f"hyper plan: 2^{planned.max_size(log=2):.2f} > target "
            f"2^{math.log2(target):.0f}"
        )
    note = (
        f"methods {methods}{' (defaults)' if defaults else ''}, seeded, "
        f"{_accel_note()}; tree {_tree_hash(planned)}"
    )
    return planned, plan_s, len(opt.trials), note


def _tree_hash(tree):
    """A short hash of a tree's contractions and sliced indices: equal
    hashes, equal trees (the seeded search gives one tree every run)."""
    text = repr((sorted(tree.children.items()), list(tree.sliced_inds)))
    return hashlib.sha256(text.encode()).hexdigest()[:12]


def _plan_stats(tree):
    return (
        f"slices {tree.multiplicity} log2 max {tree.max_size(log=2):.2f} "
        f"log2 peak {tree.peak_size(log=2):.2f} log10 flops "
        f"{tree.total_flops(log=10):.3f}"
    )


def _warm_in_turns(label, passes_of, passes=3):
    """Warm seconds of each one-pass function in ``passes_of`` (name ->
    fn returning a host value), taken in turns; each pass's value is
    finite and within 1e-4 relative of that function's first."""
    times = {k: [] for k in passes_of}
    first = {}
    for _ in range(passes):
        for k, fn in passes_of.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            val = fn()
            times[k].append(time.perf_counter() - t0)
            first.setdefault(k, val)
            if not (np.isfinite(val) and abs(val - first[k])
                    <= 1e-4 * abs(first[k])):
                raise AssertionError(
                    f"{label} {k}: unstable value {val} vs {first[k]}"
                )
    return times


def _amp_pass(tree, dev, planes):
    """One warm slice-by-slice pass of a circuit tree, as phase 4's."""
    import cotengra_tpu_torch as ctt

    core = ctt.make_grouped_contractor(tree, dev, torch.float32)

    def one_pass():
        out = ctt.contract_slices(tree, core, planes)
        return abs(complex(out[0].item(), out[1].item()))

    return one_pass


def phase_hyper_m10(dev, methods, label):
    """Sycamore-53 m=10 planned by the port's hyper-optimizer with
    ``methods`` (``None``: its defaults), all its slices contracted
    through the chain kernel, held to the sidecar's full amplitude.
    Returns the chain launches and the planning seconds."""
    import cotengra_tpu_torch as ctt

    t_phase = time.perf_counter()
    committed, arrays, refs = _load_instance(T27)
    ref = refs[committed.multiplicity]
    tree, plan_s, trials, note = _hyper_plan(
        committed, HYPER_M10_TARGET, methods
    )
    print(
        f"# {label}: planned in {plan_s:.1f}s ({plan_s / trials:.2f}s per "
        f"trial, {trials} trials; {note}): {_plan_stats(tree)}; committed "
        f"{T27}: {_plan_stats(committed)}",
        flush=True,
    )
    slack = committed.total_flops(log=10) + HYPER_FLOPS_SLACK
    if tree.total_flops(log=10) > slack:
        raise AssertionError(
            f"{label}: log10 flops {tree.total_flops(log=10):.3f} > "
            f"{slack:.3f}"
        )
    expect = _chain_passes(tree) * tree.multiplicity
    torch.cuda.reset_peak_memory_stats()

    _reset_launches()
    amp = ctt.contract_tree(tree, arrays, device=dev)
    torch.cuda.synchronize()
    counts = _read_launches()

    amp0 = complex(amp.cpu().item())
    relerr = abs(amp0 - ref) / abs(ref)
    if counts != {"gate_chain": expect, "bmm_absmax": 0} or expect <= 0:
        raise AssertionError(
            f"{label}: launches {counts}, the plan has {expect} passes"
        )
    if not relerr <= AMP_RTOL:
        raise AssertionError(
            f"{label}: amplitude {amp0} vs reference {ref}: relerr "
            f"{relerr:.3e} > {AMP_RTOL}"
        )
    peak = torch.cuda.max_memory_allocated() / 2**30
    planes = ctt.to_plane_tensors(arrays, dev, torch.float32)
    times = _warm_in_turns(label, {
        "port-planned": _amp_pass(tree, dev, planes),
        T27: _amp_pass(committed, dev, planes),
    })
    print(
        f"# main path {label}: slices {tree.multiplicity} amplitude "
        f"{amp0.real:.12e}{amp0.imag:+.12e}j relerr {relerr:.3e} chain "
        f"launches {counts['gate_chain']} ({_chain_passes(tree)} per slice) "
        f"peak_mem_gib {peak:.2f} time_to_amplitude_s "
        + "; ".join(
            f"{k} {' '.join(f'{t:.4f}' for t in ts)} (best {min(ts):.4f})"
            for k, ts in times.items()
        )
        + f" phase_s {time.perf_counter() - t_phase:.1f}",
        flush=True,
    )
    return counts["gate_chain"], plan_s


def phase_hyper_lattice(dev, methods, label):
    """The 7x7 bond-16 lattice planned by the port's hyper-optimizer with
    ``methods`` (``None``: its defaults), contracted stripped through
    ``bmm_absmax``, held to the plan file's float64 reference. Returns
    the kernel launches and the planning seconds."""
    import cotengra_tpu_torch as ctt

    t_phase = time.perf_counter()
    committed, arrays, ref = _load_lattice()
    tree, plan_s, trials, note = _hyper_plan(
        committed, HYPER_LATTICE_TARGET, methods
    )
    print(
        f"# {label}: planned in {plan_s:.1f}s "
        f"({plan_s / trials:.2f}s per trial, {trials} trials; {note}): "
        f"{_plan_stats(tree)}; committed {LATTICE}: "
        f"{_plan_stats(committed)}",
        flush=True,
    )
    expect = sum(_lattice_kernel_shapes(tree).values()) * tree.multiplicity
    opts = dict(strip_exponent=True, implementation="pallas")
    torch.cuda.reset_peak_memory_stats()

    _reset_launches()
    res = ctt.contract_tree(tree, arrays, device=dev, **opts)
    torch.cuda.synchronize()
    counts = _read_launches()
    log10 = _stripped_log10(res)
    d_log10 = abs(log10 - ref["log10"])
    if counts != {"gate_chain": 0, "bmm_absmax": expect} or expect <= 0:
        raise AssertionError(
            f"{label}: launches {counts}, the plan has {expect} "
            f"kernel steps"
        )
    if not (np.isfinite(log10) and d_log10 <= LOG10_ATOL):
        raise AssertionError(
            f"{label}: log10 {log10!r} vs {ref['log10']!r}: |delta| "
            f"{d_log10:.3e} > {LOG10_ATOL}"
        )
    peak = torch.cuda.max_memory_allocated() / 2**30
    tensors = ctt.to_tensors(arrays, dev, torch.float32)
    fn = ctt.make_full_contractor(tree, dev, **opts)
    committed_pass = _warm_pass(LATTICE, dev)

    def committed_log10():
        m, e = committed_pass()
        return float(np.log10(abs(m)) + e)

    times = _warm_in_turns(label, {
        "port-planned": lambda: _stripped_log10(fn(*tensors)),
        LATTICE: committed_log10,
    })
    print(
        f"# main path {label}: slices {tree.multiplicity} log10 "
        f"{log10:.7f} (reference {ref['log10']:.7f}) |delta log10| "
        f"{d_log10:.3e} bmm_absmax launches {counts['bmm_absmax']} (committed "
        f"plan: {sum(_lattice_kernel_shapes(committed).values())} per slice "
        f"x {committed.multiplicity}) peak_mem_gib {peak:.2f} "
        "time_to_value_s "
        + "; ".join(
            f"{k} {' '.join(f'{t:.4f}' for t in ts)} (best {min(ts):.4f})"
            for k, ts in times.items()
        )
        + f" phase_s {time.perf_counter() - t_phase:.1f}",
        flush=True,
    )
    return counts["bmm_absmax"], plan_s


@contextlib.contextmanager
def _pure_python_planning():
    """Every path finder and the compressed replay as with
    ``accel=False``: the port's native hooks answer ``None``."""
    import cotengra_tpu_torch.pathfinders.basic as basic
    import cotengra_tpu_torch.tree as tree_mod

    saved = basic._get_native, tree_mod._get_native_replay
    basic._get_native = lambda accel: None
    tree_mod._get_native_replay = lambda accel: None
    try:
        yield
    finally:
        basic._get_native, tree_mod._get_native_replay = saved


def phase_plan_timing():
    """Planning alone, pure Python (``accel=False``) against native, in
    turns on the host: one seeded m10 greedy path, and the committed
    unsliced t29 tree sliced and reconfigured to ``TIMING_TARGET`` (the
    refinement that takes most of a trial; the DP answers are not kept
    between runs). Returns the best seconds of each."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.pathfinders.basic import _optimal_ssa_path

    t29, _, _ = _load_instance("sycamore53_m10_t29")
    modes = {"pure Python": _pure_python_planning,
             "native": contextlib.nullcontext}
    best = {}
    for mode in ("pure Python", "native", "native", "pure Python"):
        _optimal_ssa_path.cache_clear()
        with modes[mode]():
            path, greedy_s = _timed(lambda: ctt.optimize_greedy(
                t29.inputs, t29.output, t29.size_dict, **TIMING_GREEDY
            ))
            tree, refine_s = _timed(lambda: t29.slice_and_reconfigure(
                TIMING_TARGET, temperature=0
            ))
        greedy = ctt.ContractionTree.from_path(
            t29.inputs, t29.output, t29.size_dict, path=path
        )
        total = greedy_s + refine_s
        best[mode] = min(best.get(mode, total), total)
        print(
            f"# planning timing m10, {mode}: greedy {greedy_s:.3f}s (log2 "
            f"max {greedy.max_size(log=2):.2f}, log10 flops "
            f"{greedy.total_flops(log=10):.3f}); t29 sliced and "
            f"reconfigured to 2^{math.log2(TIMING_TARGET):.0f} in "
            f"{refine_s:.3f}s ({_plan_stats(tree)})",
            flush=True,
        )
    print(
        f"# planning timing m10: pure Python {best['pure Python']:.3f}s, "
        f"native {best['native']:.3f}s (best of 2 in turns): "
        f"{best['pure Python'] / best['native']:.2f}x",
        flush=True,
    )
    return best


# phases 22-26: the slice sum sharded over ranks
# (``cotengra_tpu_torch/parallel/mesh.py``). The card machine has one
# card: several ranks share it on gloo (NCCL refuses two ranks on one
# card) and NCCL runs one rank per card
RANK_LIMIT_S = 300        # wall-clock limit of one multi-rank phase
RANK_COLLECTIVE_S = 240   # timeout of every collective in a rank
T27_RANKS = 2
LATTICE_RANKS = 3
TINY_RANKS = 4
TINY = 1e-6               # entries of the stripped case of phase 25
TINY_LOG10_ATOL = 1e-5
CHUNK_RTOL = 1e-5         # float32 sums of the same slices in one order
FOLD_ROW = 0              # phase 26: the lattice row that stays variable


def _rank_main(rank, world, store, backend, device, results, job):
    """One spawned rank: join the process group, run ``job()`` and put
    ``(rank, "ok", its result)`` on ``results``, or ``(rank, "error",
    the traceback)``."""
    import traceback

    try:
        sys.path.insert(0, str(ROOT))
        from cotengra_tpu_torch.parallel import mesh as pmesh

        pmesh.maybe_init_distributed(
            init_method=store, world_size=world, rank=rank, backend=backend,
            device=device, timeout=RANK_COLLECTIVE_S,
        )
        results.put((rank, "ok", job()))
        torch.distributed.destroy_process_group()
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise


def _run_ranks(label, world, backend, device, job):
    """Spawn ``world`` ranks on ``backend`` (``device``: each rank's,
    None for ``cuda:{rank % device_count}``) that each run ``job``;
    return their results in rank order and the phase's wall seconds.
    Every rank is killed at the first failure or after
    ``RANK_LIMIT_S``."""
    import multiprocessing as mp
    import queue
    import tempfile

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        store = f"file://{tmp}/store"
        procs = [
            ctx.Process(target=_rank_main, daemon=True, args=(
                rank, world, store, backend, device, results, job,
            ))
            for rank in range(world)
        ]
        for proc in procs:
            proc.start()
        try:
            while len(got) < world:
                left = RANK_LIMIT_S - (time.perf_counter() - t0)
                if left <= 0:
                    raise AssertionError(
                        f"{label}: no result from ranks "
                        f"{sorted(set(range(world)) - set(got))} in "
                        f"{RANK_LIMIT_S} s"
                    )
                try:
                    rank, status, payload = results.get(
                        timeout=min(left, 5.0)
                    )
                except queue.Empty:
                    dead = [r for r, proc in enumerate(procs)
                            if proc.exitcode is not None and r not in got]
                    if dead:
                        raise AssertionError(
                            f"{label}: ranks {dead} exited without a result"
                        ) from None
                    continue
                if status != "ok":
                    raise AssertionError(
                        f"{label}: rank {rank} failed:\n{payload}"
                    )
                got[rank] = payload
            for proc in procs:
                proc.join(timeout=60)
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
    return [got[r] for r in range(world)], time.perf_counter() - t0


def _rank_warm(mesh, label, passes_of):
    """A rank's warm seconds of the sharded contractor (best of 3); on a
    mesh of one rank, 5 passes in turns with ``make_full_contractor``'s
    on the same tensors, which isolates the mesh layer's cost.
    ``passes_of`` maps both names to one-pass functions."""
    if mesh.size == 1:
        return _warm_in_turns(label, passes_of, passes=5)
    return _warm_in_turns(label, {"sharded": passes_of["sharded"]})


def _rank_t27():
    """A rank's share of the t27 amplitude through ``contract_sharded``
    on the default mesh: its launches, the amplitude, its peak memory
    and warm seconds."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch import parallel

    mesh = parallel.get_default_mesh()
    tree, arrays, refs = _load_instance(T27)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    amp = parallel.contract_sharded(tree, arrays, mesh=mesh)
    torch.cuda.synchronize()
    counts = _read_launches()
    amp = complex(amp.cpu().item())
    tensors = ctt.to_tensors(arrays, mesh.device, torch.float32)
    sharded = parallel.make_sharded_contractor(tree, mesh)
    full = ctt.make_full_contractor(tree, mesh.device)
    times = _rank_warm(mesh, "sharded t27", {
        "sharded": lambda: abs(complex(sharded(*tensors).item())),
        "make_full_contractor": lambda: abs(complex(full(*tensors).item())),
    })
    ref = refs[tree.multiplicity]
    return {
        "rank": mesh.rank, "size": mesh.size, "device": str(mesh.device),
        "slices": len(range(mesh.rank, tree.multiplicity, mesh.size)),
        "passes": _chain_passes(tree), "counts": counts,
        "amp": (amp.real, amp.imag), "relerr": abs(amp - ref) / abs(ref),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "warm_s": times,
    }


def _rank_chunks():
    """A rank's output-sliced contraction (as ``__graft_entry__.py``'s
    chunk-sharded check): rank 0's tree (``broadcast_tree``), held to
    the unsharded result, with the whole output (``reassemble=True``)
    and with the rank's own rows (``reassemble=False``)."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch import parallel
    from cotengra_tpu_torch.parallel.mesh import broadcast_tree

    mesh = parallel.get_default_mesh()
    inputs, output, shapes, size_dict = ctt.rand_equation(
        12, 3, n_out=3, seed=11, d_min=2, d_max=3
    )
    rng = np.random.default_rng(11)
    arrays = [rng.normal(size=s).astype(np.float32) for s in shapes]
    tree = ctt.array_contract_tree(inputs, output, size_dict=size_dict,
                                   optimize="greedy")
    tree.slice_(target_slices=mesh.size, allow_outer="only")
    tree.slice_(target_slices=2 * tree.multiplicity)
    tree = broadcast_tree(tree)
    whole = ctt.contract_tree(tree, arrays, device=mesh.device)
    chunks = [c for _, c in ctt.gen_output_chunks(tree, arrays,
                                                  device=mesh.device)]
    scale = whole.abs().max().item()
    got = parallel.contract_sharded(tree, arrays, mesh=mesh, shard_chunks=True)
    mine = parallel.make_sharded_contractor(
        tree, mesh, shard_chunks=True, reassemble=False
    )(*ctt.to_tensors(arrays, mesh.device))
    n_per = mine.shape[0]
    rows = [
        (mine[k] - chunks[mesh.rank * n_per + k]).abs().max().item()
        if mesh.rank * n_per + k < len(chunks) else mine[k].abs().max().item()
        for k in range(n_per)
    ]
    return {
        "rank": mesh.rank, "chunks": len(chunks), "n_per": n_per,
        "inner": tree.multiplicity // len(chunks),
        "err_whole": (got - whole).abs().max().item() / scale,
        "err_rows": max(rows) / scale,
    }


def _rank_t27_and_chunks():
    return {"t27": _rank_t27(), "chunks": _rank_chunks()}


def _rank_lattice():
    """A rank's share of the stripped 7x7 lattice through
    ``contract_sharded`` and ``bmm_absmax``: launches, value, peak
    memory, warm seconds."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch import parallel

    mesh = parallel.get_default_mesh()
    tree, arrays, ref = _load_lattice()
    opts = dict(strip_exponent=True, implementation="pallas")
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    res = parallel.contract_sharded(tree, arrays, mesh=mesh, **opts)
    torch.cuda.synchronize()
    counts = _read_launches()
    log10 = _stripped_log10(res)
    tensors = ctt.to_tensors(arrays, mesh.device, torch.float32)
    sharded = parallel.make_sharded_contractor(tree, mesh, **opts)
    full = ctt.make_full_contractor(tree, mesh.device, **opts)
    times = _rank_warm(mesh, "sharded lattice", {
        "sharded": lambda: _stripped_log10(sharded(*tensors)),
        "make_full_contractor": lambda: _stripped_log10(full(*tensors)),
    })
    return {
        "rank": mesh.rank, "size": mesh.size, "device": str(mesh.device),
        "slices": len(range(mesh.rank, tree.multiplicity, mesh.size)),
        "steps": sum(_lattice_kernel_shapes(tree).values()),
        "counts": counts, "log10": log10,
        "d_log10": abs(log10 - ref["log10"]),
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "warm_s": times,
    }


def _rank_both():
    return {"t27": _rank_t27(), "lattice": _rank_lattice()}


def _tiny_case(ctt, mesh):
    """10 tensors of entries near ``TINY``, 9 slices (two inner indices
    of size 3), rank 0's greedy tree: ~10^-55.6, below float32's range
    unless stripped."""
    from cotengra_tpu_torch.parallel.mesh import broadcast_tree

    inputs, output, shapes, size_dict = ctt.rand_equation(10, 3, seed=0)
    tree = broadcast_tree(ctt.array_contract_tree(
        inputs, output, size_dict=size_dict, optimize="greedy"
    ))
    threes = sorted(ix for ix, d in tree.size_dict.items() if d == 3)
    for ix in threes[:2]:
        tree.remove_ind_(ix)
    rng = np.random.default_rng(0)
    arrays = [(TINY * rng.uniform(0.5, 1.5, size=s)).astype(np.float32)
              for s in shapes]
    return tree, arrays


def _rank_tiny():
    """A rank's stripped sum of the tiny case against the unsharded one
    on the same card."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch import parallel

    mesh = parallel.get_default_mesh()
    tree, arrays = _tiny_case(ctt, mesh)
    want = _stripped_log10(ctt.contract_tree(
        tree, arrays, device=mesh.device, strip_exponent=True
    ))
    got = _stripped_log10(parallel.contract_sharded(
        tree, arrays, mesh=mesh, strip_exponent=True
    ))
    return {"rank": mesh.rank, "slices": tree.multiplicity,
            "log10": got, "unsharded_log10": want}


def _rank_line(label, r, extra):
    return (
        f"# {label} rank {r['rank']}/{r['size']} on {r['device']}: slices "
        f"{r['slices']} launches {r['counts']} {extra} peak_mem_gib "
        f"{r['peak_gib']:.2f} warm_s "
        + "; ".join(
            f"{k} {' '.join(f'{t:.4f}' for t in ts)} (best {min(ts):.4f})"
            for k, ts in r["warm_s"].items()
        )
    )


def _check_t27_ranks(label, ranks):
    """Each rank launched the chain kernel for its own slices only, all
    of them together phase 4's count, and holds one amplitude within
    ``AMP_RTOL`` of the sidecar. Returns the launches per rank."""
    launches = []
    for r in ranks:
        expect = r["passes"] * r["slices"]
        if r["counts"] != {"gate_chain": expect, "bmm_absmax": 0}:
            raise AssertionError(
                f"{label} rank {r['rank']}: launches {r['counts']}, its "
                f"{r['slices']} slices give {expect}"
            )
        if not r["relerr"] <= AMP_RTOL:
            raise AssertionError(
                f"{label} rank {r['rank']}: relerr {r['relerr']:.3e} > "
                f"{AMP_RTOL}"
            )
        launches.append(r["counts"]["gate_chain"])
        print(_rank_line(label, r, f"relerr {r['relerr']:.3e}"), flush=True)
    if sum(r["slices"] for r in ranks) != 4 or sum(launches) != (
        ranks[0]["passes"] * 4
    ):
        raise AssertionError(f"{label}: launches {launches} in all")
    if len({r["amp"] for r in ranks}) != 1:
        raise AssertionError(
            f"{label}: ranks disagree: {[r['amp'] for r in ranks]}"
        )
    amp = complex(*ranks[0]["amp"])
    print(
        f"# {label}: amplitude {amp.real:.12e}{amp.imag:+.12e}j on every "
        f"rank, relerr {ranks[0]['relerr']:.3e}, chain launches {launches} "
        f"({sum(launches)} in all)",
        flush=True,
    )
    return launches


def _check_lattice_ranks(label, ranks):
    """The lattice's kernel steps per rank (its slices x 29) and the
    value on every rank within ``LOG10_ATOL``. Returns the launches."""
    launches = []
    for r in ranks:
        expect = r["steps"] * r["slices"]
        if r["counts"] != {"gate_chain": 0, "bmm_absmax": expect}:
            raise AssertionError(
                f"{label} rank {r['rank']}: launches {r['counts']}, its "
                f"{r['slices']} slices give {expect}"
            )
        if not (np.isfinite(r["log10"]) and r["d_log10"] <= LOG10_ATOL):
            raise AssertionError(
                f"{label} rank {r['rank']}: |delta log10| "
                f"{r['d_log10']:.3e} > {LOG10_ATOL}"
            )
        launches.append(r["counts"]["bmm_absmax"])
        print(_rank_line(label, r, f"|delta log10| {r['d_log10']:.3e}"),
              flush=True)
    if sum(r["slices"] for r in ranks) != 16:
        raise AssertionError(f"{label}: slices {[r['slices'] for r in ranks]}")
    print(f"# {label}: bmm_absmax launches {launches} ({sum(launches)} in "
          "all)", flush=True)
    return launches


def phase_sharded_gloo():
    """Phases 22-23: t27 over two gloo ranks on one card (and an
    output-sliced contraction, chunk-sharded), then the stripped 7x7
    lattice over three. Returns the launches per rank."""
    # the blocks this process's allocator keeps are not the ranks' to use
    torch.cuda.empty_cache()
    ranks, wall = _run_ranks("sharded t27", T27_RANKS, "gloo", "cuda:0",
                             _rank_t27_and_chunks)
    t27 = _check_t27_ranks(f"sharded {T27} gloo",
                           [r["t27"] for r in ranks])
    for r in (r["chunks"] for r in ranks):
        if not (r["err_whole"] <= CHUNK_RTOL and r["err_rows"] <= CHUNK_RTOL):
            raise AssertionError(f"chunk-sharded rank {r['rank']}: {r}")
        print(
            f"# chunk-sharded rand_equation(12, 3, n_out=3) rank "
            f"{r['rank']}: {r['chunks']} chunks of {r['inner']} inner "
            f"slices, {r['n_per']} per rank; max|whole - unsharded| / max "
            f"{r['err_whole']:.3e}; own rows {r['err_rows']:.3e}",
            flush=True,
        )
    print(f"# sharded {T27} gloo phase_s {wall:.1f}", flush=True)
    ranks, wall = _run_ranks("sharded lattice", LATTICE_RANKS, "gloo",
                             "cuda:0", _rank_lattice)
    lattice = _check_lattice_ranks(f"sharded {LATTICE} gloo", ranks)
    print(f"# sharded {LATTICE} gloo phase_s {wall:.1f}", flush=True)
    return t27, lattice


def phase_sharded_nccl():
    """Phase 24: one rank on NCCL, both paths on the default mesh; with
    two or more cards, one rank per card as well. Returns the launches
    of the one-rank run."""
    count = torch.cuda.device_count()
    print(f"# nccl: {count} card(s) visible", flush=True)
    ranks, wall = _run_ranks("nccl", 1, "nccl", None, _rank_both)
    t27 = _check_t27_ranks(f"sharded {T27} nccl",
                           [r["t27"] for r in ranks])
    lattice = _check_lattice_ranks(f"sharded {LATTICE} nccl",
                                   [r["lattice"] for r in ranks])
    print(f"# nccl world size 1 phase_s {wall:.1f}", flush=True)
    if count >= 2:
        ranks, wall = _run_ranks("nccl multi-card", count, "nccl", None,
                                 _rank_both)
        _check_t27_ranks(f"sharded {T27} nccl x{count}",
                         [r["t27"] for r in ranks])
        _check_lattice_ranks(f"sharded {LATTICE} nccl x{count}",
                             [r["lattice"] for r in ranks])
        print(f"# nccl world size {count} phase_s {wall:.1f}", flush=True)
    return t27[0], lattice[0]


def phase_sharded_tiny():
    """Phase 25: the stripped sum of ~10^-55.6 over 4 gloo ranks and 9
    slices (the JAX package's padded slot flushes it to 0): every rank
    equals the unsharded value."""
    ranks, wall = _run_ranks("tiny", TINY_RANKS, "gloo", "cuda:0",
                             _rank_tiny)
    for r in ranks:
        d = abs(r["log10"] - r["unsharded_log10"])
        if not (np.isfinite(r["log10"]) and r["unsharded_log10"] < -38
                and d <= TINY_LOG10_ATOL):
            raise AssertionError(f"tiny stripped sum rank {r['rank']}: {r}")
        print(
            f"# tiny stripped sum rank {r['rank']}/{TINY_RANKS}: "
            f"{r['slices']} slices, log10 {r['log10']:.7f} unsharded "
            f"{r['unsharded_log10']:.7f} |delta| {d:.3e}",
            flush=True,
        )
    print(f"# tiny stripped sum phase_s {wall:.1f}", flush=True)


def _kernel_step_ids(tree):
    """The IR steps of ``tree`` that go through ``bmm_absmax`` (float32,
    stripped), by the executor's rule."""
    from cotengra_tpu_torch.ops.executor import _pallas_step_ok
    from cotengra_tpu_torch.ops.lowering import (
        PairStep,
        extract_contractions,
    )

    sizes = tree.size_dict
    ids = set()
    for si, step in enumerate(extract_contractions(tree).steps):
        if isinstance(step, PairStep):
            x = torch.empty([sizes[ix] for ix in step.l_legs], device="meta")
            y = torch.empty([sizes[ix] for ix in step.r_legs], device="meta")
            if _pallas_step_ok(x, y, step):
                ids.add(si)
    return ids


@contextlib.contextmanager
def _counted_steps():
    """Count the direct executor's steps as they run."""
    from cotengra_tpu_torch.ops import executor

    real = executor._run_ir_steps
    count = [0]

    def counting(ir, steps, *args, **kwargs):
        steps = list(steps)
        count[0] += len(steps)
        return real(ir, steps, *args, **kwargs)

    executor._run_ir_steps = counting
    try:
        yield count
    finally:
        executor._run_ir_steps = real


def phase_folded(dev):
    """Phase 26: the 7x7 lattice as an ``einsum_expression`` whose
    constants are every tensor but row ``FOLD_ROW``'s 7: the folded
    steps run in the first call only; the value of both calls held to
    the plan's reference; the later call's warm time against the
    unfolded expression's, in turns. Returns the ``bmm_absmax`` launches
    of the first and a later call."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.utils.eqs import inputs_output_to_eq

    tree, arrays, ref = _load_lattice()
    eq = inputs_output_to_eq(tree.inputs, tree.output)
    side = ref["instance"]["dims"][1]
    row = range(FOLD_ROW * side, (FOLD_ROW + 1) * side)
    opts = dict(device=dev, strip_exponent=True, implementation="pallas")
    expr = ctt.einsum_expression(
        eq, *(a.shape for a in arrays), optimize=tree,
        constants={i: a for i, a in enumerate(arrays) if i not in row},
        **opts,
    )
    variables = ctt.to_tensors([arrays[i] for i in row], dev)
    calls = []
    for call in ("first", "later"):
        with _counted_steps() as steps:
            _reset_launches()
            res = expr(*variables)
            torch.cuda.synchronize()
            counts = _read_launches()
        log10 = _stripped_log10(res)
        calls.append((steps[0], counts, log10))
        if not abs(log10 - ref["log10"]) <= LOG10_ATOL:
            raise AssertionError(
                f"folded lattice, {call} call: log10 {log10!r} vs "
                f"{ref['log10']!r}"
            )
    batch = next(iter(expr._folded.values())).batch
    kernel = _kernel_step_ids(tree)
    n = tree.multiplicity
    k_fold = len(kernel & set(batch.steps_fold))
    k_rest = n * len(kernel - set(batch.steps_fold))
    (s1, c1, v1), (s2, c2, v2) = calls
    if not (batch.steps_fold and s1 - s2 == len(batch.steps_fold)
            and c1 == {"gate_chain": 0, "bmm_absmax": k_fold + k_rest}
            and c2 == {"gate_chain": 0, "bmm_absmax": k_rest}):
        raise AssertionError(
            f"folded lattice: {len(batch.steps_fold)} folded steps, steps "
            f"run {s1} then {s2}, launches {c1} then {c2}, expected "
            f"{k_fold + k_rest} then {k_rest}"
        )
    tensors = ctt.to_tensors(arrays, dev)
    unfolded = ctt.einsum_expression(
        eq, *(a.shape for a in arrays), optimize=tree, **opts
    )
    times = _in_turns("folded lattice", {
        "folded": lambda: expr(*variables),
        "unfolded": lambda: unfolded(*tensors),
    }, _stripped_log10)
    best = {k: min(ts) for k, ts in times.items()}
    print(
        f"# folded {LATTICE}, row {FOLD_ROW} ({len(row)} tensors) "
        f"variable, {tree.N - len(row)} constant: folded steps "
        f"{len(batch.steps_fold)} of {len(batch.steps_fold) + len(batch.steps_once) + len(batch.steps_each)} "
        f"({k_fold} through bmm_absmax), per slice {len(batch.steps_once)} + "
        f"{len(batch.steps_each)}; steps run first call {s1}, later {s2}; "
        f"bmm_absmax launches first {c1['bmm_absmax']}, later "
        f"{c2['bmm_absmax']}; log10 {v1:.7f} then {v2:.7f} (reference "
        f"{ref['log10']:.7f}, |delta| {abs(v2 - ref['log10']):.3e}); warm_s "
        + "; ".join(
            f"{k} {' '.join(f'{t:.4f}' for t in ts)} (best {best[k]:.4f})"
            for k, ts in times.items()
        )
        + f"; folded / unfolded {best['folded'] / best['unfolded']:.3f}",
        flush=True,
    )
    return c1["bmm_absmax"], c2["bmm_absmax"]


def _kernel_class(name):
    if "gate_chain_kernel" in name:
        return "gate-chain kernel"
    if any(k in name for k in ("bmm_absmax_kernel", "splitk_reduce_absmax",
                               "presplit_kernel")):
        return "bmm_absmax kernel"
    if "gemv" in name:
        return "gemv"
    if "gemm" in name:
        return "GEMM"
    if "copy" in name.lower():
        return "copies"
    return "other"


def _compressed_class(name):
    """Device kernels of the compressed path by class."""
    low = name.lower()
    if "qr" in low or "larf" in low:
        return "QR"
    if any(k in low for k in ("svd", "gebrd", "bdsqr", "jacobi")):
        return "SVD"
    if "gemm" in low or "gemv" in low or "xmma" in low or "cutlass" in low:
        return "GEMM"
    if "copy" in low or "memcpy" in low or "memset" in low:
        return "copies"
    if "elementwise" in low or "reduce" in low:
        return "elementwise"
    return "other"


def _warm_pass(plan_name, dev, slice_batch=None):
    """One warm pass of a main path as a function (contractor and device
    inputs made once), ending in a host pull; with ``slice_batch``, one
    batched call over the first ``slice_batch`` slices."""
    import cotengra_tpu_torch as ctt

    if plan_name == COMPRESSED:
        from cotengra_tpu_torch.pathfinders.compressed import (
            greedy_compressed_ssa,
        )
        from cotengra_tpu_torch.tree_compressed import (
            ContractionTreeCompressed,
        )

        inputs, output, size_dict, arrays = _compressed_inputs()
        tree = ContractionTreeCompressed.from_path(
            inputs, output, size_dict, ssa_path=greedy_compressed_ssa(
                inputs, output, size_dict, chi=COMPRESSED_CHI
            ),
        )
        tensors = [torch.as_tensor(a, device=dev) for a in arrays]
        return lambda: _stripped_pass(tree, tensors)

    if plan_name == LATTICE:
        tree, arrays, _ = _load_lattice()
        fn = ctt.make_full_contractor(
            tree, dev, strip_exponent=True, implementation="pallas"
        )
        tensors = ctt.to_tensors(arrays, dev, torch.float32)

        def one_pass():
            m, e = fn(*tensors)
            return m.item(), e.item()

        return one_pass

    tree, arrays, _ = _load_instance(plan_name)
    planes = ctt.to_plane_tensors(arrays, dev, torch.float32)
    if slice_batch:
        fn = ctt.make_grouped_contractor(
            tree, dev, torch.float32, slice_batch=slice_batch
        )
        return lambda: _batched_amp(fn, planes, slice_batch)
    core = ctt.make_grouped_contractor(tree, dev, torch.float32)

    def one_pass():
        out = ctt.contract_slices(tree, core, planes)
        return complex(out[0].item(), out[1].item())

    return one_pass


def phase_profile(plan_name, dev, slice_batch=None, classify=None):
    """Device time by kernel over one warm pass of the main path,
    grouped by ``classify`` (default ``_kernel_class``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    one_pass = _warm_pass(plan_name, dev, slice_batch)
    if slice_batch:
        plan_name = f"{plan_name} batched x{slice_batch}"
    one_pass()
    # the wall of one pass moves by tens of percent between passes (host
    # side): the idle share reads the median of several
    walls = []
    for _ in range(PROFILE_WALL_PASSES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_pass()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        t0 = time.perf_counter()
        one_pass()
        prof_wall = time.perf_counter() - t0

    per_kernel = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        ms, n = per_kernel.get(e.name, (0.0, 0))
        per_kernel[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    if not per_kernel:
        raise AssertionError(f"{plan_name}: the profiler saw no device time")
    busy = sum(ms for ms, _ in per_kernel.values())
    print(
        f"# profile {plan_name}: wall {wall * 1e3:.1f} ms (median of "
        f"unprofiled passes {' '.join(f'{w * 1e3:.1f}' for w in walls)}), "
        f"profiled wall {prof_wall * 1e3:.1f} ms, device busy {busy:.1f} ms, "
        f"idle share {1 - busy / (wall * 1e3):.3f}",
        flush=True,
    )
    classify = classify or _kernel_class
    by_class = {}
    for name, (ms, n) in per_kernel.items():
        cls = classify(name)
        c_ms, c_n = by_class.get(cls, (0.0, 0))
        by_class[cls] = (c_ms + ms, c_n + n)
    for cls, (ms, n) in sorted(by_class.items(), key=lambda kv: -kv[1][0]):
        print(f"#   {cls}: {ms:.3f} ms x {n}", flush=True)
        for name, (k_ms, k_n) in sorted(
            per_kernel.items(), key=lambda kv: -kv[1][0]
        ):
            if classify(name) == cls:
                print(f"#     {k_ms:9.3f} ms x {k_n:5d}  {name[:110]}",
                      flush=True)


def _dominant(bounds):
    """The ``bound_by`` of a sum of (ms, bound_by) bounds: the kind that
    carries the larger share of the time."""
    share = {}
    for ms, by in bounds:
        share[by] = share.get(by, 0.0) + ms
    return max(share, key=share.get)


def main():
    args = sys.argv[1:]
    if args not in ([], ["--profile"]):
        print(f"FAIL: unknown arguments {args}", flush=True)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", flush=True)
        return 1
    if not (ROOT / "cotengra_tpu_torch").is_dir():
        print("FAIL: run chip_smoke.py from a checkout of the repository",
              flush=True)
        return 1
    sys.path.insert(0, str(ROOT))
    from cotengra_tpu_torch import resolve_device

    dev = resolve_device("cuda")
    phase_device()
    host_build_s = phase_build()
    if args == ["--profile"]:
        phase_profile(T27, dev)
        phase_profile(T27, dev, slice_batch=4)
        phase_profile("sycamore53_m10_t29", dev)
        phase_profile(LATTICE, dev)
        phase_profile(M20, dev, slice_batch=M20_SLICES)
        phase_profile(COMPRESSED, dev, classify=_compressed_class)
        return 0
    chain_rows = phase_chains(dev)
    chain_launches = phase_main_path(T27, 4, dev)
    phase_main_path("sycamore53_m10_t29", 1, dev)
    bmm_rows = phase_bmm(dev)
    bmm_launches = phase_lattice(dev)
    phase_t27_stripped(dev)
    phase_t27_batched(dev)
    m20_rows = phase_chains_m20(dev)
    m20_launches = phase_m20(dev)
    phase_front_lattice(dev)
    phase_front_t27(dev)
    auto_plan_s = phase_front_auto(dev)
    phase_compressed(dev)
    hyper_m10_launches, labels_m10_s = phase_hyper_m10(
        dev, HYPER_LABELS, "hyper m10"
    )
    hyper_lattice_launches, labels_lattice_s = phase_hyper_lattice(
        dev, HYPER_LABELS, "hyper lattice7x7_d16"
    )
    default_m10_launches, default_m10_s = phase_hyper_m10(
        dev, None, "default m10"
    )
    default_lattice_launches, default_lattice_s = phase_hyper_lattice(
        dev, None, "default lattice7x7_d16"
    )
    timing = phase_plan_timing()
    sharded_t27, sharded_lattice = phase_sharded_gloo()
    nccl_t27, nccl_lattice = phase_sharded_nccl()
    phase_sharded_tiny()
    folded_first, folded_later = phase_folded(dev)
    kernels = [
        {
            # per slice: the 13 chains of one m10-t27 slice
            "name": "gate_chain",
            "route": "cuda",
            "source": "cotengra_tpu_torch/csrc/gate_chain.cu",
            "replaces": "cotengra_tpu/ops/pallas_gates.py:557",
            "launches": chain_launches,
            "max_abs_err": max(r[0] for r in chain_rows),
            "ms": sum(r[1] for r in chain_rows),
            "plain_ms": sum(r[2] for r in chain_rows),
            "bound_ms": sum(r[3][0] for r in chain_rows),
            "bound_by": _dominant(r[3] for r in chain_rows),
            # one torch.einsum per chain over complex64 x and its gates
            "library_ms": sum(r[4] for r in chain_rows),
            # m20-t28: launches of the 16-slice batched call; the rest
            # per slice, all 38 chains once each
            "m20_launches": m20_launches,
            "m20_max_abs_err": max(r[0] for r in m20_rows),
            "m20_ms": sum(r[1] for r in m20_rows),
            "m20_plain_ms": sum(r[2] for r in m20_rows),
            "m20_bound_ms": sum(r[3][0] for r in m20_rows),
            "m20_bound_by": _dominant(r[3] for r in m20_rows),
            "m20_library_ms": sum(r[4] for r in m20_rows),
            # all slices of the m10 tree the port's hyper-optimizer plans
            # with greedy + labels, and with its default methods
            "hyper_m10_launches": hyper_m10_launches,
            "default_m10_launches": default_m10_launches,
            # t27 sharded: per rank of two gloo ranks on the card, and
            # one NCCL rank
            "sharded_t27_launches": sharded_t27,
            "nccl_t27_launches": nccl_t27,
        },
        {
            # per slice: one slice's kernel steps, summed over the plan's
            # distinct shapes times their steps per slice
            "name": "bmm_absmax",
            "route": "cuda",
            "source": "cotengra_tpu_torch/csrc/bmm_absmax.cu",
            "replaces": "cotengra_tpu/ops/pallas_bmm.py:56",
            "launches": bmm_launches,
            "max_abs_err": max(r[0] for r in bmm_rows),
            "ms": sum(r[1] for r in bmm_rows),
            "plain_ms": sum(r[2] for r in bmm_rows),
            "bound_ms": sum(r[3] for r in bmm_rows),
            "bound_by": _dominant((r[3], r[4]) for r in bmm_rows),
            # torch.bmm + abs().amax(): the plain version's own calls
            "library_ms": sum(r[2] for r in bmm_rows),
            # all slices of the 7x7 tree the port's hyper-optimizer plans
            # with greedy + labels, and with its default methods
            "hyper_lattice_launches": hyper_lattice_launches,
            "default_lattice_launches": default_lattice_launches,
            # the lattice sharded: per rank of three gloo ranks, and one
            # NCCL rank; its folded expression's first and later call
            "sharded_lattice_launches": sharded_lattice,
            "nccl_lattice_launches": nccl_lattice,
            "folded_first_launches": folded_first,
            "folded_later_launches": folded_later,
        },
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"host_native": {
        "build_s": host_build_s,
        "m10_plan_s": default_m10_s,
        "m10_labels_plan_s": labels_m10_s,
        "lattice_plan_s": default_lattice_s,
        "lattice_labels_plan_s": labels_lattice_s,
        "auto6x6_plan_s": auto_plan_s,
        "m10_trial_s": timing["native"],
        "m10_trial_s_py": timing["pure Python"],
    }}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
