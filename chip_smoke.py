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
   count (reckoned for the mode that ``"auto"`` takes there), and the
   warm times of the batched call (``make_grouped_contractor(...,
   slice_batch=4, slice_batch_mode="scan")``) and of phase 4's slice
   loop in turns;
10. the gate-chain kernel against its plain version on every chain of
   the Sycamore-53 m=20 t28 plan (``plans/sycamore53_m20_t28.json``) at
   full size, float32 inputs made on the card from a seeded
   ``torch.Generator``, at phase 3's limit; each chain's launches equal
   its passes of ``chain_tile_plan`` (39 passes in all, one chain of
   two); kernel, plain and library times and the bound per chain, as in
   phase 3;
11. the m=20 main path: one batched call of slice ids 0..15
   (``make_grouped_contractor(..., slice_batch=16,
   slice_batch_mode="scan")``, float32 planes),
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
   inputs, (), optimize=<the loaded tree>, slice_batch=4)``: 13 chain
   launches (its ``"auto"`` takes ``"vmap"`` on the card: one launch a
   pass for the 4 slices; 52 under ``"scan"``) and relerr
   <= 1e-5 against the sidecar's 4-slice amplitude;
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
   inputs cast to float32 (the exponent a float64 tensor in both), each
   held to ``COMPRESSED_LOG10`` (from
   ``scratch/make_compressed_ref.py``) at |delta log10| <= 1e-4 and
   1e-3; per dtype of one pass the library QR calls (0) and the
   operands the QR kernel factors (``csrc/qr_core.cu``,
   ``COUNTS["qr_kernel"]``: two a truncation, 144; one factor and one
   apply launch a truncation), the library SVD calls (0), the
   truncation-core kernel's launches
   (``csrc/svd_core.cu``, one a truncation: 72), none of them at its
   sweep cap unconverged (``svd_core.unconverged``), and the host syncs
   (0; ``torch.cuda.set_sync_debug_mode("warn")``), the warm
   time-to-value (best of 3, each pass ending in a host pull checked
   finite and stable) and the peak device memory; the host seconds of
   the neighbour bookkeeping (``compress_with_neighbors``, under
   cProfile); the kernel on every core of the pass held to the plain
   version on the CPU in float64 (singular values, the rank-k truncation
   and its error above the optimum, within ``SVD_CORE_ATOL``), timed on one core of
   each size (1x1 to 1024x1024) and on a value's cores in turn beside
   the library's SVD and the bound; the QR kernel on every truncation's
   two sides, with the truncation's own ``U s V`` from its core, held to
   the plain version on the card in float64 (R's Gram, Q's
   orthonormality, ``A^T Q C = R^T C`` and the truncation's error above
   the optimum, within ``QR_CORE_ATOL``), timed on one truncation of
   each shape pair and on a value's truncations in turn beside the plain
   version (``torch.linalg.qr`` and the products with Q), the library's
   QR alone and the bound; and behind a 200 ms spin on the card the
   host's time in the kernel's two launches for the largest truncation
   (under 1 ms) against ``torch.linalg.qr`` of its (131072, 1024) side;
   neither the chain nor the matmul kernel is launched;
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
27. mixed real and complex inputs on the kernel route: the 7x7 lattice
   with input 0 times exp(i pi/3) as complex64 and every other input
   real float32, stripped with ``implementation="pallas"``: each pair
   step promotes its operands, and only the steps whose operands both
   stay real launch ``bmm_absmax`` (their number reckoned from the plan,
   ``_kernel_step_ids``: 23 per slice, 368 in all, against 464 with
   every input real); |delta log10| of the modulus and the phase error
   in radians against the plan's reference times the phase, both
   <= 1e-4;
28. the compressed 16x16 lattice of phase 16 in float64 with input 0
   times the same phase (complex128): the truncations depend on
   singular values only, so the value is ``COMPRESSED_LOG10`` times the
   phase; |delta log10| and the phase error <= 1e-4; each truncation
   either the library's QRs and SVD (a complex side, > 0) or the QR
   kernel (both real sides) and the SVD kernel;
29. the JAX package's example (``examples/ex_plan_slice_contract.py``)
   through the port at full width, on phase 4's m10 instance:
   ``optimize_random_greedy_track_flops(ntrials=128, seed=0)``,
   ``subtree_reconfigure_(subtree_size=10)``,
   ``slice_and_reconfigure_(2**27, temperature=0)``; its
   ``describe("full")`` equal to the CPU's (``EXAMPLE_DESCRIBE``,
   ``scratch/example_multi_plans.py``); ``tree.contract`` on the card
   (the grouped route) over its 16 slices: chain launches = the plan's
   passes x slices (> 0), relerr <= 1e-5 against the sidecar's full
   amplitude (key ``"4"``), and ``tree.benchmark``'s best of 3;
30. ``HyperMultiOptimizer`` on the same m10 network over 4
   configurations of t27's two sliced indices (``varmults``), with the
   seeded greedy and labels methods of phases 17-20, 16 trials and
   subtree reconfiguration, on the host: planning seconds, the tree's
   ``total_flops`` and ``exact_multi_stats`` over the 4 configurations;
   the phase fails if its largest intermediate exceeds 2^30; its path
   contracted with those two indices sliced (one slice per
   configuration) through the grouped route, the sum held to the
   sidecar's full amplitude at relerr <= 1e-5, with its chain launches;
31. the gate-chain kernel's slice leg (the ``"vmap"`` mode's batch):
   every chain of the t27 plan with x ``(4, 2 * numel)`` and its gates
   batched as the plan batches them (a gate that reads a sliced index
   is ``(4, 2, K, N)``), against the plain version on the same batch,
   and the largest m20 chain at 16 slices (2^33 floats in x, over
   2^31), against the plain version slice by slice; the limit of phase
   3, one launch a pass for the whole batch; ms per batched pass
   against the batch size x one slice's kernel ms, and the bound: the
   batch size x one HBM read and write of the planes (``_chain_bound``);
32. m10-t27 through ``make_grouped_contractor(..., slice_batch=4,
   slice_batch_mode="vmap")``, plain and stripped, held to key ``"4"``
   at relerr <= 1e-5, the chain launches against the plan's count (13:
   one a pass for the batch) and the step calls against scan's; the
   warm time in turns with ``"scan"``, and each mode's peak memory;
33. m20-t28 slices 0..15 under ``"vmap"`` in calls of the largest
   batch that fits the card (``ops/grouped.py::vmap_max_batch`` from
   the plan's per-slice live peak, printed): the partial sums over 4, 8
   and 16 slices held to the sidecar at relerr <= 1e-5, the launches
   against the plan's count, the warm time in turns with ``"scan"`` (16
   a call) and peak memory;
34. many small slices: the example's m10 tree of phase 29 sliced to
   2^22 at temperature 0 (512 slices), all of them in calls of 16 under
   ``"scan"`` and ``"vmap"``, each held to key ``"4"`` at relerr <=
   1e-5 with its launches against the plan's count; the slice count,
   step calls and warm times in turns;
35. the cost model's calibration: the warm time of each plan of
   ``CALIBRATION`` (slice by slice, or in batched calls), each held to
   its sidecar at relerr <= 1e-5, and the runs of phases 32-34, each
   beside ``ops/simulate.py::simulate_grouped``'s seconds and its
   error; one JSON line ``{"calibration": ...}`` of the runs, which
   ``scratch/sim_calibrate_gpu.py`` fits ``H100_CONSTANTS`` to (the
   calibration set: t27 under both modes, t29, combo, combo-256,
   t27_tpu, r5b_m10_tpu and m20 under both modes; t27 slice by slice
   and the small slices are held out, as checks of the model);
36. m10 planned for the card: the port's hyper-optimizer with
   ``minimize="gpu"`` (phase 17's seeded greedy and labels methods,
   ``GPU_PLAN_TRIALS`` trials, 2^27), its slices contracted and held to
   key ``"4"`` at relerr <= 1e-5 with its chain launches; its modelled
   and measured warm seconds beside t27's, slice by slice, in turns;
37. the window engine on m10-t27 at full width
   (``gate_mode="window"``): slice by slice and under ``"vmap"`` (4
   slices a call), each held to key ``"4"`` at relerr <= 1e-5 with no
   chain launch; 15 window steps a slice; the operator builds that the
   hoist runs once a call and per slice (``"w2build"`` steps of the
   executor plan), the largest ``W2`` in bytes, the window steps' and
   operator builds' device ms (CUDA events around each step); warm
   seconds in turns with ``"inplace"`` slice by slice and under vmap;
38. fused kron chains on m10-t27 (``fuse_gates=True``) under
   ``"inplace"`` and under None, one scan call of 4 slices each: relerr
   <= 1e-5, 1 and 11 fused steps a slice, chain launches (52 and 0),
   the fused steps' device ms; warm seconds in turns with the same
   engine unfused;
39. the one-step layout lookahead on m10-t27 under ``"inplace"``
   (``grouped_plan._LAYOUT_LOOKAHEAD`` set for the phase, restored
   after), slice by slice: relerr <= 1e-5, chain launches, the stored
   orders that changed, block transposes of a pass and their device ms
   against the default;
40. the window engine on m20-t28 slices 0..3 in one scan call and under
   ``"vmap"`` in calls of the batch that fits (from the window plan's
   per-slice peak): relerr <= 1e-5 against key ``"4"``, 44 window steps
   a slice, no chain launch, the operators stacked per slice (those
   whose gates read a sliced index), the first and a warm call's
   seconds;
41. the cost model on phases 37-38's runs: ``simulate_grouped`` with
   ``gate_mode="window"`` and with ``fuse_gates``, modelled over
   measured (no limit: no constant was fitted to them);
42. the plots, on the host: ``cotengra_tpu_torch.plot`` and
   ``.schematic`` import and the 19 plot methods are bound onto
   ``ContractionTree``, ``HyperOptimizer``, ``SliceFinder`` and
   ``HyperGraph``; the ring and tent layouts of the trees that phases 4
   (t27, 182 leaves) and 11 (m20, 413 leaves) contracted: a position
   for each of the 2N-1 nodes, the ring's internal nodes strictly inside
   the unit disc, tent heights extent / N, the convex hull of the ring
   positions of the last step's leaves (every one a vertex: they lie on
   the unit circle); no kernel launched; which of matplotlib,
   networkx, pandas and altair are installed, and the host
   milliseconds, beside the card's name and power limit; where
   matplotlib cannot be imported,
   ``plot_ring()`` raises the ``ImportError`` naming it, and where it
   can, the t27 ring drawn to Agg has 2(N-1) edge lines;
43. the staged contractor (``ops/grouped.py::make_grouped_staged_contractor``,
   stages of ``STAGE_SIZE`` plan steps, each a CUDA graph, replayed
   after ``fn.precompile``) on m10-t27, 4 slices a call under
   ``"vmap"`` and ``"scan"``, each against the eager contractor in the
   same mode: relerr <= 1e-5 against key ``"4"``; replays a call equal
   to the graphs, no Python step call (``tracing.STEP_CALLS``) in a
   replayed call; ``gate_chain_kernel`` launches equal to the plan's
   (13 vmap, 52 scan), exactly, by the wrapper's counter: in an eager
   call, and recorded into the graphs at capture (a replay runs each
   recorded kernel once and ticks no counter), and seen by the profiler
   inside a replayed call (which now and then loses a block of records,
   so its count is printed, not held to the plan); capture seconds;
   warm seconds in turns (best of 5, each pass ending in a host pull
   checked finite and stable); device busy ms, wall ms and idle share
   (1 - busy / wall) of one profiled call on each side, both read from
   that call; eager GiB allocated against the GiB the graphs' pool and
   buffers reserve;
44. m20-t28 slices 0..15 staged under ``"scan"``, 4 slices a call: the
   same graphs replayed on ids 0..3, 4..7, 8..11 and 12..15, the
   partial sums at 4, 8 and 16 slices held to the sidecar at relerr
   <= 1e-5 (a slice baked into a graph would repeat), with phase 43's
   checks and measures against the eager contractor on the same ids;
45. the stripped 7x7 lattice through ``make_full_contractor(...,
   autojit=True, implementation="pallas")``: the 16 slices and their sum
   as one CUDA graph, |delta log10| <= 1e-4, 464 ``bmm_absmax_kernel``
   launches recorded into the graph and seen running in a profiled
   replay, no Python step call, phase 43's measures against eager;
46. m10-t27 under ``"vmap"``: stages of 12 steps against the whole plan
   as one graph, warm seconds in turns;
47. one JSON line of kernel results (launches on the main path, error,
   ms, plain ms, bound, library ms; the gate chain's m=20 figures
   under ``m20_*`` keys, the launches of phases 17 and 18 under
   ``hyper_*`` keys, of phases 19 and 20 under ``default_*`` keys, of
   phases 22-24 under ``sharded_*`` (per rank) and ``nccl_*`` keys, of
   phase 26 under ``folded_*`` keys, of phase 27 under
   ``mixed_lattice_launches``, of phases 29 and 30 under
   ``example_m10_launches`` and ``multi_m10_launches``, of phases
   31-34 and 36 under ``vmap_*``, ``small_slices_vmap_launches`` and
   ``gpu_m10_launches``, and of phases 37 and 38 under
   ``window_t27_chain_launches`` and ``fused_t27_launches``, of phases
   43-45 under ``captured_*``: counted by the profiler in replayed
   graphs; the truncation-core kernel's from phase 16, a value's cores
   in float64, with ``max_err_over_s0``, ``max_cut_err``, ``max_excess``,
   ``max_sweeps``
   and ``f32_*`` keys), one JSON
   line ``{"host_native": {...}}`` of the host library's build seconds
   and the planning seconds of phases 15, 17-21 and 30, then the last
   line ``{"ok": true, "device": {...}}``.

Every instance is built and every plan loaded through the port
(``cotengra_tpu_torch.rand_circuit_tn``, ``lattice_equation``,
``load_tree``): the script imports neither JAX nor the JAX package.

Each main path (4, 5, 7, 8, 9, 11, 12, 13, 15-20, 22-24, 26-30, 32-34,
36-40) is
driven with every kernel's launch count set to 0 just before it and
read just after (in each rank, by the rank); the captured paths (43-45)
count the launches of a replayed call with the profiler. Any failed
phase raises, and the script exits non-zero without the last line. It
needs a CUDA device and never falls back to the CPU.

``--profile`` instead runs ``torch.profiler`` over one warm pass of each
main path (m10-t27 slice by slice and through the batched call,
m10-t29, the lattice, 16 slices of m20-t28, the compressed 16x16 lattice
in float64, then t27 and m20's 16 slices under ``"vmap"``, and t27
under ``"vmap"`` with ``gate_mode="window"``, whose window steps and
operator builds are profiler ranges of their own) and prints
the median wall time of 5 unprofiled passes, the
device's busy time and idle share, and every device kernel's time
grouped by class (the breakdown in ``PERF.md`` section 5).
"""

import contextlib
import cProfile
import gc
import hashlib
import itertools
import json
import math
import os
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
M20_PASSES = 39     # chain_tile_plan's passes over the 38 chains of M20
SEED = 1234
PROFILE_WALL_PASSES = 5
# 4 slices in one batched call through the front end (phase 13), whose
# "auto" takes "vmap" on the card: one launch a pass for the batch (52
# under "scan")
T27_BATCHED_LAUNCHES = 13
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
# exponent is a float32 sum, whose ulp at 289 is 3.05e-5, the port's a
# float64 one)
COMPRESSED = "lattice16x16_d4_chi32"
COMPRESSED_DIMS = (16, 16)
COMPRESSED_BOND = 4
COMPRESSED_CHI = 32
COMPRESSED_PATH_HASH = (
    "849afce1fe0f9957606833839d80c6439a64fc5500173c2588466ff6fb148c08"
)
COMPRESSED_LOG10 = 288.9674377441406
# float64 on the card: the reference exponent's float32 rounding and
# cuSOLVER's QR rounding otherwise than LAPACK's; float32: QR and SVD in
# float32 over 255 steps on top of that
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
# phases 27-28: one input multiplied by this phase, the rest real; the
# exact value is the real network's times it
MIXED_PHASE = np.pi / 3
MIXED_INPUT = 0
# phase 29: the JAX package's example (``examples/ex_plan_slice_contract.py``)
# through the port on m10, its slicing target raised to the main path's;
# its describe("full") on the CPU (``python scratch/example_multi_plans.py``)
EXAMPLE_TARGET = 2**27
EXAMPLE_DESCRIBE = (
    "log10[FLOPS]=11.31 log10[COMBO]=12.43 log2[SIZE]=27.00 "
    "log2[PEAK]=28.00 NSLICES=16.00"
)
# phase 30: HyperMultiOptimizer on m10 over t27's two sliced indices
MULTI_VARMULTS = ("ƌ", "Ɨ")
MULTI_CONFIGS = 4
MULTI_TRIALS = 16
MULTI_MAX_SIZE = 2**30
# phases 31-36: the "vmap" slice-batch mode and the cost model
VMAP_T27_BATCH = 4
SMALL_SLICE_TARGET = 2**22   # phase 34: the example's tree sliced small
SMALL_SLICE_BATCH = 16
GPU_PLAN_TRIALS = 4          # phase 36: minimize="gpu" trials
CALIBRATION_PASSES = 5       # phase 35: best of 5 warm passes a plan
SMALL_SLICE_PLAN = "example_m10_2^22"
# phase 35: plans timed for the cost model (plan, slices a call or None
# for slice by slice, mode, in the calibration set); phases 32-33 add t27
# and m20 under both modes to the set, phase 34 the small slices beside
# it (held out of the fit, as t27 slice by slice: checks of the model)
CALIBRATION = (
    (T27, None, None, False),
    ("sycamore53_m10_t29", None, None, True),
    ("sycamore53_m10_t27_combo", 16, "scan", True),
    ("sycamore53_m10_t27_combo-256", 4, "scan", True),
    ("sycamore53_m10_t27_tpu", None, None, True),
    ("r5b_m10_tpu", None, None, True),
)
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

    from cotengra_tpu_torch.ops.qr_core import qr_apply_cuda, qr_factor_cuda
    from cotengra_tpu_torch.ops.svd_core import svd_topk_cuda

    return {"gate_chain": run_chain_cuda, "bmm_absmax": bmm_absmax_cuda,
            "svd_core": svd_topk_cuda, "qr_core": qr_factor_cuda,
            "qr_apply": qr_apply_cuda}


def _launches(gate_chain=0, bmm_absmax=0, svd_core=0, qr_core=0, qr_apply=0):
    """What ``_read_launches`` reads where each kernel launched as given
    (``qr_core``: the QR kernel's factor launches, ``qr_apply`` its apply
    launches, one of each a truncation)."""
    return {"gate_chain": gate_chain, "bmm_absmax": bmm_absmax,
            "svd_core": svd_core, "qr_core": qr_core, "qr_apply": qr_apply}


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


def _smi_line():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_device():
    print(_smi_line(), flush=True)
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
    checked (39 in all, one chain of two)."""
    tree, _, _ = _load_instance(M20)
    recs = _chain_recs(tree)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rows = _measure_chains(
        "m20", recs,
        lambda spec, kn: _chain_inputs_on_card(gen, spec, kn, dev),
    )
    passes = [r[5] for r in rows]
    if sum(passes) != M20_PASSES or sorted(passes)[-2:] != [1, 2]:
        raise AssertionError(
            f"m20 chains: passes {passes}, expected {M20_PASSES} in all "
            "with one chain of two"
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
    if counts != _launches(gate_chain=expect):
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
    tree.contraction_cores.clear()  # kept for phase 42: no device state
    return launches, tree


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
    if counts != _launches(bmm_absmax=expect):
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
    if counts != _launches(gate_chain=expect):
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


def _batched_chain_passes(fn, n_slices, batch=None):
    """Chain-kernel launches of batched calls over ``n_slices`` slices,
    ``batch`` a call (default: all in one): the passes of the
    slice-invariant chains once per call, the others once per slice
    (``"scan"``) or once per call (``"vmap"``: one launch a pass for the
    batch)."""
    from cotengra_tpu_torch.ops.gate_chains import chain_tile_plan

    def passes(steps):
        return sum(
            len(chain_tile_plan(fn.plans[si][1].spec))
            for si in steps if fn.plans[si][0] == "inplace"
        )

    calls = 1 if batch is None else -(-n_slices // batch)
    each = calls if fn.mode == "vmap" else n_slices
    return calls * passes(fn.batch.steps_once) + each * passes(
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
    fn = ctt.make_grouped_contractor(tree, dev, torch.float32, slice_batch=n,
                                     slice_batch_mode="scan")
    # contract_tree keeps "auto"
    expect = _batched_chain_passes(
        ctt.make_grouped_contractor(tree, dev, torch.float32, slice_batch=n),
        n,
    )
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
        if counts != _launches(gate_chain=expect):
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
    _fresh_cache()
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
        tree, dev, torch.float32, slice_batch=M20_SLICES,
        slice_batch_mode="scan",
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

    if counts != _launches(gate_chain=expect):
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

    _fresh_cache()
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
    tree.contraction_cores.clear()  # kept for phase 42: no device state
    return counts["gate_chain"], tree


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
    if counts != _launches(bmm_absmax=expect):
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
    if counts != _launches(gate_chain=expect):
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
    if (counts["gate_chain"] != 0 or counts["bmm_absmax"] <= 0
            or counts["svd_core"] != 0):
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


# the note torch gives the first time sync debugging is switched on: it
# names no synchronising call
SYNC_DEBUG_NOTE = "Synchronization debug mode is a prototype feature"


@contextlib.contextmanager
def _count_linalg(cores=None, operands=None):
    """Count ``torch.linalg.qr`` and ``torch.linalg.svd`` calls (looked up
    at call time by ``ops/compressed.py`` and ``ops/svd_core.py``) and the
    host syncs that ``set_sync_debug_mode("warn")`` reports, inside the
    block. Where ``cores`` is a list, every core that reaches ``svd_topk``
    is cloned into it (a device copy: no sync); where ``operands`` is a
    list, every pair of bond sides that reaches the QR kernel."""
    from cotengra_tpu_torch.ops import compressed

    counts = {"qr": 0, "svd": 0, "syncs": 0}
    real = {k: getattr(torch.linalg, k) for k in ("qr", "svd")}
    topk = compressed.svd_topk
    factor = compressed.qr_factor_cuda

    def factoring(A, B=None):
        if operands is not None:
            operands.append((A.clone(), B.clone()))
        return factor(A, B)

    def counted(k):
        def fn(*args, **kwargs):
            counts[k] += 1
            return real[k](*args, **kwargs)

        return fn

    def keeping(M, k):
        if cores is not None:
            cores.append(M.clone())
        return topk(M, k)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for k in real:
            setattr(torch.linalg, k, counted(k))
        compressed.svd_topk = keeping
        compressed.qr_factor_cuda = factoring
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield counts
        finally:
            torch.cuda.set_sync_debug_mode("default")
            compressed.svd_topk = topk
            compressed.qr_factor_cuda = factor
            for k, fn in real.items():
                setattr(torch.linalg, k, fn)
    syncs = [w for w in caught if "synchroniz" in str(w.message)
             and not str(w.message).startswith(SYNC_DEBUG_NOTE)]
    counts["syncs"] = len(syncs)
    counts["sync_sites"] = sorted(
        {f"{os.path.basename(w.filename)}:{w.lineno}" for w in syncs}
    )


def _stripped_pass(tree, tensors):
    """One compressed contraction at chi=32, pulled to the host."""
    m, e = tree.contract_compressed(
        tensors, chi=COMPRESSED_CHI, strip_exponent=True,
        device=tensors[0].device,
    )
    if m.shape != () or e.dtype != torch.float64:
        raise AssertionError(f"{COMPRESSED}: mantissa {m.shape}, {e.dtype}")
    return m.item(), e.item()


def phase_compressed(dev, passes=3):
    """The compressed 16x16 lattice: planned by the port, contracted on
    the card in float64 and float32, held to the JAX package's value."""
    from cotengra_tpu_torch.ops import compressed
    from cotengra_tpu_torch.ops.svd_core import unconverged
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

    rows, qr_rows = {}, {}
    for dtype in (torch.float64, torch.float32):
        tensors = [torch.as_tensor(a, dtype=dtype, device=dev) for a in arrays]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        capped = unconverged(dev)
        before = dict(compressed.COUNTS)
        cores, operands = [], []
        t0 = time.perf_counter()
        with _count_linalg(cores, operands) as counts:
            m, e = tree.contract_compressed(
                tensors, chi=COMPRESSED_CHI, strip_exponent=True, device=dev
            )
        mant, expo = m.item(), e.item()
        first_s = time.perf_counter() - t0
        launches = _read_launches()
        grown = {k: compressed.COUNTS[k] - before[k] for k in before}
        truncations = grown["truncations"]
        log10 = float(np.log10(abs(mant)) + expo)
        d_log10 = abs(log10 - COMPRESSED_LOG10)
        # real operands and cores: every truncation one launch of the SVD
        # kernel, converged under its sweep cap, and one factor and one
        # apply launch of the QR kernel for its two sides; no library QR
        # or SVD, and nothing that makes the host wait for the card
        if (launches != _launches(svd_core=truncations, qr_core=truncations,
                                  qr_apply=truncations)
                or truncations <= 0 or len(cores) != truncations
                or len(operands) != truncations):
            raise AssertionError(
                f"{COMPRESSED} {dtype}: launches {launches} for "
                f"{truncations} truncations ({len(cores)} cores kept)"
            )
        if (counts["svd"] != 0 or counts["qr"] != 0
                or grown["qr_kernel"] != 2 * truncations
                or grown["qr_library"] != 0):
            raise AssertionError(f"{COMPRESSED} {dtype}: {counts} {grown}")
        if counts["syncs"] != 0:
            raise AssertionError(
                f"{COMPRESSED} {dtype}: {counts['syncs']} host syncs at "
                f"{counts['sync_sites']}"
            )
        if unconverged(dev) != capped:
            raise AssertionError(
                f"{COMPRESSED} {dtype}: {unconverged(dev) - capped} "
                "truncation cores reached the kernel's sweep cap"
            )
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
            f"{COMPRESSED_LOG10!r}) |delta log10| {d_log10:.3e} library qr "
            f"{counts['qr']} kernel qr operands {grown['qr_kernel']} "
            f"(qr_core launches {launches['qr_core']} + {launches['qr_apply']}) "
            f"library svd {counts['svd']} svd_core launches "
            f"{launches['svd_core']} host syncs {counts['syncs']} "
            f"first_call_s {first_s:.3f} time_to_value_s "
            f"{' '.join(f'{t:.4f}' for t in times)} (best {min(times):.4f}) "
            f"peak_mem_gib {peak:.2f} launches {launches}",
            flush=True,
        )
        if dtype == torch.float64:
            _compressed_host_share(tree, tensors)
        rows[dtype] = _time_compressed_linalg(dtype, cores)
        rows[dtype]["launches"] = launches["svd_core"]
        qr_rows[dtype] = _time_compressed_qr(dtype, operands)
        qr_rows[dtype]["launches"] = launches["qr_core"] + launches["qr_apply"]
        del tensors, m, e, cores, operands
        torch.cuda.empty_cache()
    qr_rows["async"] = _qr_async(dev)
    print(f"# {COMPRESSED} phase_s {time.perf_counter() - t_phase:.1f}",
          flush=True)
    return rows, qr_rows


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


# the least time of a dense SVD of an (m, n) core on the card: Householder
# bidiagonalisation's 4 m n^2 - 4 n^3 / 3 flops (n <= m) at the 67 TFLOP/s
# FP64 tensor rate, or reading it and writing its k triplets at the HBM
# rate, the larger
FP64_TENSOR_FLOPS = 67e12
# the kernel's singular values against the plain version's on the CPU
# (LAPACK, float64), over the largest; its truncation U diag(s) V^T against
# the plain version's, and its Frobenius error above the optimum, over
# ||M||_F: at most. (cuSOLVER's float64 SVD errs by up to 1.5e-12 on the
# plan's 256 x 256 cores by the same measure.)
SVD_CORE_ATOL = {torch.float64: 1e-13, torch.float32: 1e-5}


def _svd_bound(m, n, k, itemsize):
    """(ms, "bytes" or "operations") for one (m, n) core, k triplets."""
    m, n = max(m, n), min(m, n)
    t_ops = (4 * m * n * n - 4 * n**3 / 3) / FP64_TENSOR_FLOPS
    t_bytes = itemsize * (m * n + (m + n + 1) * k) / HBM_BYTES_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def _svd_core_errors(core, k, U, s, V):
    """The top-k ``(U, s, V)`` of ``core`` against the plain version on the
    CPU (LAPACK) in float64: max |s - s_plain|, that over the largest
    singular value;
    ||U diag(s) V^T - U_p diag(s_p) V_p^T||_F over ||M||_F (first order in
    a vector's error; the rank-k truncation is one matrix wherever s_k >
    s_k+1, and where they tie both cuts are at s_k's level); and
    ||M - U diag(s) V^T||_F above the optimum (the norm of the singular
    values past k) over ||M||_F."""
    from cotengra_tpu_torch.ops.svd_core import svd_topk_plain

    Md = core.double().cpu()
    U_p, s_p, V_p = svd_topk_plain(Md, k)
    full = torch.linalg.svdvals(Md)
    top = max(float(full[0]), 1e-300)
    norm = max(float(torch.linalg.norm(Md)), 1e-300)
    U, s, V = (x.double().cpu() for x in (U, s, V))
    err = float((s - s_p).abs().max())
    cut = (U * s) @ V.T
    gap = float(torch.linalg.norm(cut - (U_p * s_p) @ V_p.T))
    resid = float(torch.linalg.norm(Md - cut))
    opt = float(torch.sqrt((full[k:] ** 2).sum()))
    return err, err / top, gap / norm, (resid - opt) / norm


def _time_compressed_linalg(dtype, cores):
    """The truncation-core kernel on every core of a pass (``cores``, in
    the pass's order), each held to the plain version (``svd_topk_plain``
    on the CPU, float64) within ``SVD_CORE_ATOL``, and the library on the
    card measured the same way; by CUDA events, the first core of
    each shape, and all of a value's cores one after another, beside the
    plain version (``svd_topk_plain``: the library's SVD and the top-k
    slices, in the cores' dtype) and the bound. Returns the kernel's
    row for the ``kernels`` line: errors, ms a value, plain and library ms
    (the same call), the bound and the most sweeps a core took."""
    from cotengra_tpu_torch.ops.svd_core import svd_topk_cuda, svd_topk_plain

    name = str(dtype).removeprefix("torch.")
    ks = [min(COMPRESSED_CHI, *c.shape) for c in cores]
    worst = [0.0, 0.0, 0.0, 0.0]
    library = 0.0
    sweeps = {}
    for core, k in zip(cores, ks):
        U, s, V = svd_topk_cuda(core, k)
        sweep = int(svd_topk_cuda.ctl[2].item())
        errs = _svd_core_errors(core, k, U, s, V)
        worst = [max(a, b) for a, b in zip(worst, errs)]
        library = max(library, _svd_core_errors(
            core, k, *svd_topk_plain(core, k))[1])
        shape = tuple(core.shape)
        sweeps[shape] = max(sweeps.get(shape, 0), sweep)
        if not max(errs[1:]) <= SVD_CORE_ATOL[dtype]:
            raise AssertionError(
                f"{COMPRESSED} {name}: svd core {shape[0]}x{shape[1]} k {k}: "
                f"|s - s_plain| {errs[1]:.3e} of the largest, truncation "
                f"{errs[2]:.3e} of ||M|| from the plain one and "
                f"{errs[3]:.3e} above the optimum (> "
                f"{SVD_CORE_ATOL[dtype]}), {sweep} sweeps"
            )
    firsts = {}
    for core, k in zip(cores, ks):
        firsts.setdefault(tuple(core.shape), (core, k))
    for shape in sorted(firsts, key=lambda s: (s[0] * s[1], s)):
        core, k = firsts[shape]
        reps = max(3, min(50, int(2e8 / (shape[0] * shape[1] * max(shape)))))
        svd_topk_cuda(core, k)
        svd_topk_plain(core, k)
        kernel_ms = _cuda_ms(lambda: svd_topk_cuda(core, k), reps)
        library_ms = _cuda_ms(lambda: svd_topk_plain(core, k), reps)
        print(
            f"# {COMPRESSED} {name}: svd core {shape[0]}x{shape[1]} k {k} "
            f"(x{sum(tuple(c.shape) == shape for c in cores)} a value): "
            f"kernel_ms {kernel_ms:.3f} library_ms {library_ms:.3f} "
            f"(plain, the same call) bound_ms "
            f"{_svd_bound(*shape, k, core.element_size())[0]:.4f} sweeps "
            f"{sweeps[shape]} at most",
            flush=True,
        )

    def value(fn):
        return lambda: [fn(core, k) for core, k in zip(cores, ks)]

    value(svd_topk_cuda)()
    value(svd_topk_plain)()
    ms = _cuda_ms(value(svd_topk_cuda), 3)
    plain_ms = _cuda_ms(value(svd_topk_plain), 3)
    bounds = [_svd_bound(*c.shape, k, c.element_size())
              for c, k in zip(cores, ks)]
    row = {
        "max_abs_err": worst[0], "max_err_over_s0": worst[1],
        "max_cut_err": worst[2], "max_excess": worst[3], "ms": ms, "plain_ms": plain_ms,
        "library_ms": plain_ms, "bound_ms": sum(b[0] for b in bounds),
        "bound_by": _dominant(bounds), "max_sweeps": max(sweeps.values()),
        "library_max_err_over_s0": library,
    }
    print(
        f"# {COMPRESSED} {name}: svd_core on a value's {len(cores)} cores: "
        f"kernel_ms {ms:.3f} plain_ms {plain_ms:.3f} bound_ms "
        f"{row['bound_ms']:.4f} max |s - s_plain| {worst[0]:.3e} "
        f"({worst[1]:.3e} of the largest) truncation from the plain one "
        f"{worst[2]:.3e} and above the optimum {worst[3]:.3e} of ||M|| "
        f"sweeps at most {row['max_sweeps']}; the library's |s - s_plain| "
        f"{library:.3e} of the largest",
        flush=True,
    )
    return row


# the QR kernel against the plain version on the card, over ||A||^2
# (R^T R against A^T A: the rows of R past the operand's numerical rank
# are rounding, their signs and directions any), over ||C||^2 (Q's
# orthonormality, (Q C)^T (Q C) against C^T C) and over ||A|| ||C|| (A^T
# (Q C) against R^T C: Q C tied to A's own factorization, whatever Q's
# directions past the rank): at most
QR_CORE_ATOL = {torch.float64: 1e-13, torch.float32: 1e-5}
# a truncation's ||A B^T - newA newB^T||_F above the optimum (the norm of
# the singular values of A B^T past chi), over ||A|| ||B||: the QRs' and
# the SVD's rounding together (each held to 1e-13 / 1e-5 of its own
# scale); a wrong Q gives O(1). At most
QR_TRUNCATION_ATOL = {torch.float64: 1e-12, torch.float32: 1e-4}


def _qr_bound(m, n, itemsize):
    """(ms, "bytes" or "operations"): geqrf's 2 m k n - 2 k^3 / 3 flops
    (k = min(m, n); the wide operands' R is k x n) at the 67 TFLOP/s FP64
    tensor rate, or the operand's bytes at the HBM rate, the larger."""
    k = min(m, n)
    t_ops = (2 * m * n * k - 2 * k**3 / 3) / FP64_TENSOR_FLOPS
    t_bytes = itemsize * m * n / HBM_BYTES_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def _qr_errors(A, R, X, C, s):
    """The kernel's R and Q C = X of one operand against the plain version
    in float64: ||R^T R - A^T A|| / ||A||^2, ||X^T X - (C sqrt(s))^T (C
    sqrt(s))|| / ||C sqrt(s)||^2 and ||A^T X - R^T C sqrt(s)|| / (||A||
    ||C sqrt(s)||). The last holds for A = Q R whatever Q's directions past
    A's rank, and fails where Q is not applied, applied out of order or
    from another operand's reflectors."""
    Ad, Rd, Xd = A.double(), R.double(), X.double()
    norm_a = max(float(torch.linalg.norm(Ad)), 1e-300)
    gram = float(torch.linalg.norm(Rd.T @ Rd - Ad.T @ Ad)) / norm_a**2
    Cs = C.double() * torch.sqrt(s.double())[None, :]
    g = Cs.T @ Cs
    orth = float(torch.linalg.norm(Xd.T @ Xd - g)) / max(
        float(torch.linalg.norm(g)), 1e-300)
    tie = float(torch.linalg.norm(Ad.T @ Xd - Rd.T @ Cs)) / (
        norm_a * max(float(torch.linalg.norm(Cs)), 1e-300))
    return gram, orth, tie


def _truncation_excess(A, B, Xa, Xb):
    """``||A B^T - Xa Xb^T||_F`` above the optimum over ``||A||_F
    ||B||_F`` (the scale of the QRs' rounding), in float64 on the card,
    ``A B^T`` never formed: the norm of ``[A, Xa] [B, -Xb]^T`` is that of
    the product of the two R factors, and A B^T's singular values are
    those of ``R_a R_b^T`` (the library's R)."""
    Ad, Bd = A.double(), B.double()
    k = Xa.shape[1]
    Ra = torch.linalg.qr(Ad, mode="r")[1]
    Rb = torch.linalg.qr(Bd, mode="r")[1]
    full = torch.linalg.svdvals((Ra @ Rb.T).cpu())
    norm = max(float(torch.linalg.norm(Ad)) * float(torch.linalg.norm(Bd)),
               1e-300)
    opt = float(torch.linalg.norm(full[k:]))
    R1 = torch.linalg.qr(torch.cat([Ad, Xa.double()], 1), mode="r")[1]
    R2 = torch.linalg.qr(torch.cat([Bd, -Xb.double()], 1), mode="r")[1]
    resid = float(torch.linalg.norm(R1 @ R2.T))
    return (resid - opt) / norm


def _time_compressed_qr(dtype, operands):
    """The QR kernel on every truncation of a pass (``operands``: the two
    bond sides of each, in the pass's order) with the truncation's own
    ``U s V`` (``svd_topk`` of the kernel's ``R_a R_b^T``), each side held
    to the plain version on the card within ``QR_CORE_ATOL`` (R's Gram,
    Q's orthonormality, ``A^T Q C = R^T C``) and the truncation within
    ``QR_TRUNCATION_ATOL`` of the optimum, then by CUDA events a value's
    truncations one after another: the kernel (factor both sides, apply
    both Qs), the plain version (``torch.linalg.qr`` twice and the two
    products with Q) and ``torch.linalg.qr`` alone (``library_ms``), the
    first truncation of each shape pair too, beside the bound. Returns the
    kernel's row for the ``kernels`` line."""
    from cotengra_tpu_torch.ops.qr_core import qr_apply_cuda, qr_factor_cuda
    from cotengra_tpu_torch.ops.svd_core import svd_topk

    name = str(dtype).removeprefix("torch.")
    chi = COMPRESSED_CHI
    jobs = []
    worst = [0.0, 0.0, 0.0, 0.0]
    for A, B in operands:
        k = min(chi, *A.shape, *B.shape)
        Ra, Rb, factors = qr_factor_cuda(A, B)
        U, s, V = svd_topk(Ra @ Rb.T, k)
        Xa, Xb = qr_apply_cuda(factors, U, V, s)
        errs = [max(a, b) for a, b in zip(_qr_errors(A, Ra, Xa, U, s),
                                          _qr_errors(B, Rb, Xb, V, s))]
        errs.append(_truncation_excess(A, B, Xa, Xb))
        worst = [max(a, b) for a, b in zip(worst, errs)]
        if not (max(errs[:3]) <= QR_CORE_ATOL[dtype]
                and errs[3] <= QR_TRUNCATION_ATOL[dtype]):
            raise AssertionError(
                f"{COMPRESSED} {name}: qr_core on {tuple(A.shape)} and "
                f"{tuple(B.shape)}: R^T R {errs[0]:.3e} of ||A||^2, (Q C)^T "
                f"(Q C) {errs[1]:.3e} of ||C||^2, A^T Q C - R^T C "
                f"{errs[2]:.3e} of ||A|| ||C|| (> {QR_CORE_ATOL[dtype]}); "
                f"truncation {errs[3]:.3e} of ||A|| ||B|| above the optimum "
                f"(> {QR_TRUNCATION_ATOL[dtype]})"
            )
        jobs.append((A, B, U, V, s))
        del factors

    def kernel(A, B, U, V, s):
        return qr_apply_cuda(qr_factor_cuda(A, B)[2], U, V, s)

    def plain(A, B, U, V, s):
        Qa, _ = torch.linalg.qr(A)
        Qb, _ = torch.linalg.qr(B)
        sq = torch.sqrt(s)[None, :]
        return Qa @ (U * sq), Qb @ (V * sq)

    def library(A, B, U, V, s):
        return torch.linalg.qr(A), torch.linalg.qr(B)

    firsts = {}
    for job in jobs:
        firsts.setdefault((tuple(job[0].shape), tuple(job[1].shape)), job)
    for key in sorted(firsts, key=lambda k: -k[0][0] * k[0][1]):
        job = firsts[key]
        count = sum((tuple(j[0].shape), tuple(j[1].shape)) == key for j in jobs)
        reps = max(2, min(20, int(3e9 / (key[0][0] * key[0][1] ** 2 + 1))))
        for fn in (kernel, plain, library):
            fn(*job)
        print(
            f"# {COMPRESSED} {name}: qr pair {key[0]} {key[1]} (x{count} a "
            f"value): kernel_ms {_cuda_ms(lambda: kernel(*job), reps):.3f} "
            f"plain_ms {_cuda_ms(lambda: plain(*job), reps):.3f} library_ms "
            f"{_cuda_ms(lambda: library(*job), reps):.3f} bound_ms "
            f"{sum(_qr_bound(*X.shape, X.element_size())[0] for X in job[:2]):.4f}",
            flush=True,
        )

    def value(fn):
        return lambda: [fn(*job) for job in jobs]

    value(kernel)()
    ms = _cuda_ms(value(kernel), 3)
    plain_ms = _cuda_ms(value(plain), 3)
    library_ms = _cuda_ms(value(library), 3)
    bounds = [_qr_bound(*X.shape, X.element_size())
              for job in jobs for X in job[:2]]
    row = {
        "max_gram_err": worst[0], "max_orth_err": worst[1],
        "max_tie_err": worst[2], "max_truncation_excess": worst[3], "ms": ms,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": sum(b[0] for b in bounds), "bound_by": _dominant(bounds),
        "operands": 2 * len(jobs),
    }
    print(
        f"# {COMPRESSED} {name}: qr_core on a value's {2 * len(jobs)} "
        f"operands: kernel_ms {ms:.3f} plain_ms {plain_ms:.3f} library_ms "
        f"{library_ms:.3f} bound_ms {row['bound_ms']:.4f} R^T R "
        f"{worst[0]:.3e} of ||A||^2 (Q C)^T (Q C) {worst[1]:.3e} of ||C||^2 "
        f"A^T Q C - R^T C {worst[2]:.3e} of ||A|| ||C|| truncation "
        f"{worst[3]:.3e} of ||A|| ||B|| above the optimum",
        flush=True,
    )
    return row


def _qr_async(dev):
    """Does the host wait: a 200 ms spin on the card, then the QR work of
    the plan's largest truncation ((131072, 1024) against (1024, 1024)),
    the kernel's two launches and then ``torch.linalg.qr`` of the large
    side, each timed on the host from its call to its return, the spin
    before each. The kernel's launches must return in under 1 ms (the
    library's waited ~228 ms in the same place before the kernel).
    Returns both host times in ms."""
    from cotengra_tpu_torch.ops.qr_core import qr_apply_cuda, qr_factor_cuda

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    A = torch.randn((131072, 1024), generator=gen, device=dev,
                    dtype=torch.float64)
    B = torch.randn((1024, 1024), generator=gen, device=dev,
                    dtype=torch.float64)
    U = torch.randn((1024, COMPRESSED_CHI), generator=gen, device=dev,
                    dtype=torch.float64)
    s = torch.rand(COMPRESSED_CHI, generator=gen, device=dev,
                   dtype=torch.float64) + 0.5
    cycles = int(torch.cuda.get_device_properties(dev).clock_rate * 1e3 * 0.2)
    host = {}
    for _ in range(2):  # the second pass finds the allocator's blocks cached
        for name in ("kernel", "library"):
            torch.cuda.synchronize()
            torch.cuda._sleep(cycles)
            t0 = time.perf_counter()
            if name == "kernel":
                out = qr_apply_cuda(qr_factor_cuda(A, B)[2], U, U, s)
            else:
                out = torch.linalg.qr(A)
            host[name] = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            del out
    print(
        f"# {COMPRESSED}: behind a 200 ms spin the QR kernel's two launches "
        f"returned to the host after {host['kernel']:.3f} ms, "
        f"torch.linalg.qr (131072, 1024) after {host['library']:.3f} ms",
        flush=True,
    )
    if not host["kernel"] < 1.0:
        raise AssertionError(
            f"{COMPRESSED}: the QR kernel's launches held the host "
            f"{host['kernel']:.3f} ms behind a busy card"
        )
    del A, B
    torch.cuda.empty_cache()
    return host


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
    if counts != _launches(gate_chain=expect) or expect <= 0:
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
    if counts != _launches(bmm_absmax=expect) or expect <= 0:
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
        if r["counts"] != _launches(gate_chain=expect):
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
        if r["counts"] != _launches(bmm_absmax=expect):
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


def _kernel_step_ids(tree, complex_inputs=()):
    """The IR steps of ``tree`` that go through ``bmm_absmax`` (float32,
    stripped), by the executor's rule; with ``complex_inputs`` (input
    positions) complex64, a step's output complex where an operand is,
    so that only the steps whose operands both stay real count."""
    from cotengra_tpu_torch.ops.executor import _pallas_step_ok
    from cotengra_tpu_torch.ops.lowering import (
        PairStep,
        extract_contractions,
    )

    sizes = tree.size_dict
    ir = extract_contractions(tree)
    cplx = set(complex_inputs)
    ids = set()
    for si, step in enumerate(ir.steps):
        if isinstance(step, PairStep):
            dts = [torch.complex64 if i in cplx else torch.float32
                   for i in (step.l, step.r)]
            x = torch.empty([sizes[ix] for ix in step.l_legs],
                            dtype=dts[0], device="meta")
            y = torch.empty([sizes[ix] for ix in step.r_legs],
                            dtype=dts[1], device="meta")
            if _pallas_step_ok(x, y, step):
                ids.add(si)
            if step.l in cplx or step.r in cplx:
                cplx.add(step.out)
        elif step.inp in cplx:
            cplx.add(step.out)
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
            and c1 == _launches(bmm_absmax=k_fold + k_rest)
            and c2 == _launches(bmm_absmax=k_rest)):
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


def _phase_error(value):
    """|angle(value) - MIXED_PHASE| in radians, wrapped to [0, pi]."""
    d = (np.angle(value) - MIXED_PHASE + np.pi) % (2 * np.pi) - np.pi
    return abs(float(d))


def phase_mixed_lattice(dev):
    """The 7x7 lattice with input ``MIXED_INPUT`` times exp(i pi/3) as
    complex64 and the rest real float32, stripped through
    ``bmm_absmax``: the real x real steps launch the kernel, the others
    promote and take ``torch.einsum``. Held to the plan's reference
    times the phase. Returns the kernel launches."""
    import cotengra_tpu_torch as ctt

    t_phase = time.perf_counter()
    tree, arrays, ref = _load_lattice()
    arrays = list(arrays)
    arrays[MIXED_INPUT] = (
        arrays[MIXED_INPUT] * np.exp(1j * MIXED_PHASE)
    ).astype(np.complex64)
    per_slice = len(_kernel_step_ids(tree, {MIXED_INPUT}))
    expect = per_slice * tree.multiplicity
    real_expect = len(_kernel_step_ids(tree)) * tree.multiplicity
    if not 0 < expect < real_expect:
        raise AssertionError(
            f"mixed {LATTICE}: {expect} kernel steps, not in (0, "
            f"{real_expect})"
        )
    _reset_launches()
    m, e = ctt.contract_tree(
        tree, arrays, device=dev, strip_exponent=True,
        implementation="pallas",
    )
    torch.cuda.synchronize()
    counts = _read_launches()
    val = complex(m.item())
    log10 = float(np.log10(abs(val)) + e.item())
    d_log10 = abs(log10 - ref["log10"])
    d_phase = _phase_error(val)
    if m.dtype != torch.complex64 or e.dtype != torch.float32:
        raise AssertionError(f"mixed {LATTICE}: {m.dtype}, {e.dtype}")
    if counts != _launches(bmm_absmax=expect):
        raise AssertionError(
            f"mixed {LATTICE}: launches {counts}, {expect} real kernel "
            "steps expected"
        )
    if not (np.isfinite(log10) and d_log10 <= LOG10_ATOL
            and d_phase <= LOG10_ATOL):
        raise AssertionError(
            f"mixed {LATTICE}: log10 {log10!r} vs {ref['log10']!r} "
            f"(|delta| {d_log10:.3e}), phase error {d_phase:.3e} rad; "
            f"limits {LOG10_ATOL}"
        )
    print(
        f"# main path mixed {LATTICE}: input {MIXED_INPUT} x exp(i pi/3) "
        f"complex64, the rest float32: value {val:.9e} x "
        f"10^{e.item():.6f} |delta log10| {d_log10:.3e} phase error "
        f"{d_phase:.3e} rad bmm_absmax launches {counts['bmm_absmax']} "
        f"({per_slice} real kernel steps per slice; {real_expect} with "
        f"every input real) phase_s {time.perf_counter() - t_phase:.1f}",
        flush=True,
    )
    return counts["bmm_absmax"]


def phase_mixed_compressed(dev):
    """The compressed 16x16 lattice at chi=32 in float64 with input
    ``MIXED_INPUT`` times exp(i pi/3) (complex128): the truncations
    depend only on singular values, so the value is the real one's
    times the phase. Complex cores take the library's SVD, real ones the
    kernel: one or the other a truncation."""
    from cotengra_tpu_torch.ops import compressed
    from cotengra_tpu_torch.pathfinders.compressed import (
        greedy_compressed_ssa,
    )
    from cotengra_tpu_torch.tree_compressed import ContractionTreeCompressed

    t_phase = time.perf_counter()
    inputs, output, size_dict, arrays = _compressed_inputs()
    tree = ContractionTreeCompressed.from_path(
        inputs, output, size_dict, ssa_path=greedy_compressed_ssa(
            inputs, output, size_dict, chi=COMPRESSED_CHI
        ),
    )
    arrays[MIXED_INPUT] = arrays[MIXED_INPUT] * np.exp(1j * MIXED_PHASE)
    tensors = [torch.as_tensor(a, device=dev) for a in arrays]
    _reset_launches()
    before = dict(compressed.COUNTS)
    with _count_linalg() as counts:
        m, e = tree.contract_compressed(
            tensors, chi=COMPRESSED_CHI, strip_exponent=True, device=dev
        )
    val = complex(m.item())
    launches = _read_launches()
    grown = {k: compressed.COUNTS[k] - before[k] for k in before}
    truncations = grown["truncations"]
    log10 = float(np.log10(abs(val)) + e.item())
    d_log10 = abs(log10 - COMPRESSED_LOG10)
    d_phase = _phase_error(val)
    # a truncation with a complex side takes the library's QRs and SVD,
    # one with two real sides the QR kernel (both sides) and the SVD kernel
    real = truncations - counts["svd"]
    if (m.dtype != torch.complex128 or counts["svd"] <= 0
            or launches != _launches(svd_core=real, qr_core=real,
                                     qr_apply=real)
            or counts["qr"] != 2 * counts["svd"]
            or grown["qr_library"] != counts["qr"]
            or grown["qr_kernel"] != 2 * real):
        raise AssertionError(
            f"mixed {COMPRESSED}: {m.dtype}, launches {launches}, library "
            f"svd {counts['svd']} and qr {counts['qr']} of {truncations} "
            f"truncations, counts {grown}"
        )
    if not (np.isfinite(log10) and d_log10 <= COMPRESSED_ATOL[torch.float64]
            and d_phase <= COMPRESSED_ATOL[torch.float64]):
        raise AssertionError(
            f"mixed {COMPRESSED}: log10 {log10!r} vs {COMPRESSED_LOG10!r} "
            f"(|delta| {d_log10:.3e}), phase error {d_phase:.3e} rad"
        )
    print(
        f"# main path mixed {COMPRESSED}: input {MIXED_INPUT} x "
        f"exp(i pi/3) complex128, the rest float64: value {val!r} x "
        f"10^{e.item()!r} |delta log10| {d_log10:.3e} library qr "
        f"{counts['qr']} kernel qr operands {grown['qr_kernel']} library svd "
        f"{counts['svd']} svd_core launches {launches['svd_core']} host "
        f"syncs {counts['syncs']} phase error "
        f"{d_phase:.3e} rad phase_s {time.perf_counter() - t_phase:.1f}",
        flush=True,
    )


def _example_plan(inputs, output, size_dict):
    """``examples/ex_plan_slice_contract.py``'s planning steps through the
    port (seed 0, the slice finder at temperature 0), sliced to
    ``EXAMPLE_TARGET``: the same tree every run. Returns it and the
    planning seconds."""
    import cotengra_tpu_torch as ctt

    t0 = time.perf_counter()
    ssa, _ = ctt.optimize_random_greedy_track_flops(
        inputs, output, size_dict, ntrials=128, seed=0, use_ssa=True
    )
    tree = ctt.ContractionTree.from_path(
        inputs, output, size_dict, ssa_path=ssa
    )
    tree.subtree_reconfigure_(subtree_size=10)
    tree.slice_and_reconfigure_(EXAMPLE_TARGET, temperature=0)
    return tree, time.perf_counter() - t0


def phase_example(dev):
    """The JAX package's example on m10 at full width, through the port:
    its plan's ``describe("full")`` equal to the CPU's, then
    ``tree.contract`` on its default route (the grouped one, with the
    chain kernel) held to the sidecar's full amplitude, and
    ``tree.benchmark``'s seconds. Returns the chain launches."""
    t_phase = time.perf_counter()
    committed, arrays, refs = _load_instance(T27)
    ref = refs[committed.multiplicity]
    tree, plan_s = _example_plan(
        committed.inputs, committed.output, committed.size_dict
    )
    described = tree.describe("full")
    print(
        f"# example m10: planned in {plan_s:.1f}s ({_accel_note()}; tree "
        f"{_tree_hash(tree)}): {described}",
        flush=True,
    )
    if described != EXAMPLE_DESCRIBE:
        raise AssertionError(
            f"example m10: describe {described!r} != the CPU's "
            f"{EXAMPLE_DESCRIBE!r}"
        )
    expect = _chain_passes(tree) * tree.multiplicity
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    amp = tree.contract(arrays, device=dev)
    torch.cuda.synchronize()
    counts = _read_launches()
    amp0 = complex(amp.cpu().item())
    relerr = abs(amp0 - ref) / abs(ref)
    if counts != _launches(gate_chain=expect) or expect <= 0:
        raise AssertionError(
            f"example m10: launches {counts}, the plan has {expect} passes"
        )
    if not relerr <= AMP_RTOL:
        raise AssertionError(
            f"example m10: amplitude {amp0} vs reference {ref}: relerr "
            f"{relerr:.3e} > {AMP_RTOL}"
        )
    peak = torch.cuda.max_memory_allocated() / 2**30
    bench = tree.benchmark(arrays=arrays, device=dev, repeats=3)
    print(
        f"# main path example m10: slices {tree.multiplicity} amplitude "
        f"{amp0.real:.12e}{amp0.imag:+.12e}j relerr {relerr:.3e} chain "
        f"launches {counts['gate_chain']} ({_chain_passes(tree)} per "
        f"slice) peak_mem_gib {peak:.2f} benchmark_s {bench['time']:.4f} "
        f"(best of 3, {bench['tflops_per_sec']:.2f} TFLOP/s of the tree's "
        f"float32 count) phase_s {time.perf_counter() - t_phase:.1f}",
        flush=True,
    )
    return counts["gate_chain"]


def _multi_plan(tree):
    """``HyperMultiOptimizer`` on the instance of ``tree`` over
    ``MULTI_CONFIGS`` configurations of ``MULTI_VARMULTS``, with the
    seeded greedy and labels methods of phases 17-20 (one seed stream)
    and subtree reconfiguration; the same tree every run. Returns it
    and the planning seconds."""
    import random

    import cotengra_tpu_torch as ctt

    opt = ctt.HyperMultiOptimizer(
        varmults=MULTI_VARMULTS, numconfigs=MULTI_CONFIGS,
        methods=_seeded_methods(HYPER_LABELS, random.Random(HYPER_SEED)),
        max_repeats=MULTI_TRIALS, seed=HYPER_SEED, reconf_opts={},
        parallel=False,
    )
    t0 = time.perf_counter()
    multi = opt.search(tree.inputs, tree.output, tree.size_dict)
    return multi, time.perf_counter() - t0


def _multi_configs(tree):
    return [
        dict(zip(MULTI_VARMULTS, values))
        for values in itertools.product(
            *(range(tree.size_dict[ix]) for ix in MULTI_VARMULTS)
        )
    ]


def _multi_sliced(multi):
    """The multi tree's contractions as a plain tree with its variable
    indices sliced: one slice per configuration."""
    import cotengra_tpu_torch as ctt

    tree = ctt.ContractionTree.from_path(
        multi.inputs, multi.output, multi.size_dict,
        ssa_path=multi.get_ssa_path(),
    )
    for ix in MULTI_VARMULTS:
        tree.remove_ind_(ix)
    return tree


def phase_multi(dev):
    """A multi-contraction plan of m10 over t27's two sliced indices,
    its stats over the 4 configurations, and its path contracted with
    those indices sliced through the grouped route on the card, summed
    over the 4 slices and held to the sidecar's full amplitude.
    Returns the chain launches."""
    t_phase = time.perf_counter()
    committed, arrays, refs = _load_instance(T27)
    ref = refs[committed.multiplicity]
    if set(committed.sliced_inds) != set(MULTI_VARMULTS):
        raise AssertionError(f"multi m10: t27 slices {committed.sliced_inds}")
    multi, plan_s = _multi_plan(committed)
    configs = _multi_configs(committed)
    stats = multi.exact_multi_stats(configs)
    print(
        f"# multi m10: planned in {plan_s:.1f}s ({MULTI_TRIALS} trials, "
        f"methods {HYPER_LABELS} seeded, {_accel_note()}; tree "
        f"{_tree_hash(multi)}): {type(multi).__name__} total_flops "
        f"{multi.total_flops():.6e} (log10 {multi.total_flops(log=10):.3f}) "
        f"log2 max {multi.max_size(log=2):.2f}; exact_multi_stats over "
        f"{len(configs)} configurations {stats}",
        flush=True,
    )
    if multi.max_size() > MULTI_MAX_SIZE:
        raise AssertionError(
            f"multi m10: largest intermediate 2^"
            f"{multi.max_size(log=2):.2f} > 2^"
            f"{math.log2(MULTI_MAX_SIZE):.0f}"
        )
    tree = _multi_sliced(multi)
    if tree.multiplicity != len(configs):
        raise AssertionError(f"multi m10: {tree.multiplicity} slices")
    expect = _chain_passes(tree) * tree.multiplicity
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    amp = tree.contract(arrays, device=dev, implementation="grouped")
    torch.cuda.synchronize()
    counts = _read_launches()
    amp0 = complex(amp.cpu().item())
    relerr = abs(amp0 - ref) / abs(ref)
    if counts != _launches(gate_chain=expect):
        raise AssertionError(
            f"multi m10: launches {counts}, the plan has {expect} passes"
        )
    if not relerr <= AMP_RTOL:
        raise AssertionError(
            f"multi m10: amplitude {amp0} vs reference {ref}: relerr "
            f"{relerr:.3e} > {AMP_RTOL}"
        )
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(
        f"# main path multi m10: slices {tree.multiplicity} (one per "
        f"configuration) amplitude {amp0.real:.12e}{amp0.imag:+.12e}j "
        f"relerr {relerr:.3e} chain launches {counts['gate_chain']} "
        f"({_chain_passes(tree)} per slice) peak_mem_gib {peak:.2f} "
        f"phase_s {time.perf_counter() - t_phase:.1f}",
        flush=True,
    )
    return counts["gate_chain"], plan_s


# ---------------------------------------------------------------------------
# phases 31-36: the "vmap" slice-batch mode, the batched chain kernel and
# the GPU cost model


def _batched_gates(fn, rec, n, gen, dev):
    """Gate inputs of chain ``rec`` for a batch of ``n`` slices, as the
    plan batches them: ``(n, 2, K, N)`` where the gate reads a sliced
    index, else ``(2, K, N)``; drawn on the card."""
    return [
        torch.randn(((n,) if y_id in fn.batch.varying else ())
                    + (2, K, N), generator=gen, device=dev)
        for y_id, _, K, N in rec.ys
    ]


def _vmap_chain_row(label, ci, spec, x, ys, per_slice_plain):
    """One chain on a batch: kernel (one launch a pass) vs plain, and
    its batched ms against the batch size x one slice's kernel ms."""
    from cotengra_tpu_torch.ops.gate_chains import (
        chain_tile_plan,
        run_chain_cuda,
        run_chain_plain,
    )

    n = x.shape[0]
    plan = chain_tile_plan(spec)
    before = run_chain_cuda.launches
    got = run_chain_cuda(spec, x, ys)
    if run_chain_cuda.launches - before != len(plan):
        raise AssertionError(
            f"{label} chain {ci}: {run_chain_cuda.launches - before} "
            f"launches for the batch, the plan has {len(plan)} passes"
        )
    err = scale = 0.0
    if per_slice_plain:
        # the batch holds too much for a batched plain version beside it
        for s in range(n):
            ref = run_chain_plain(
                spec, x[s], [y[s] if y.dim() == 4 else y for y in ys]
            )
            scale = max(scale, ref.abs().max().item())
            err = max(err, (got[s] - ref).abs().max().item())
            del ref
    else:
        ref = run_chain_plain(spec, x, ys)
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        del ref
    torch.cuda.synchronize()
    if not err <= CHAIN_RTOL * scale:
        raise AssertionError(
            f"{label} chain {ci}: batched kernel off the plain version by "
            f"{err:.3e} > {CHAIN_RTOL} x {scale:.3e}"
        )
    del got
    one_ys = [y[0] if y.dim() == 4 else y for y in ys]
    x0 = x[0].contiguous()
    reps = 3 if x.numel() >= 2**30 else 10
    batched_ms = _cuda_ms(lambda: run_chain_cuda(spec, x, ys), reps)
    one_ms = _cuda_ms(lambda: run_chain_cuda(spec, x0, one_ys), reps)
    batched_ms = (batched_ms + _cuda_ms(
        lambda: run_chain_cuda(spec, x, ys), reps)) / 2
    kn = [tuple(y.shape[-2:]) for y in ys]
    bound = _chain_bound(spec, kn)
    bound_b = (n * bound[0], bound[1])
    print(
        f"# {label} chain {ci:2d} x{n}: numel 2^"
        f"{int(np.log2(x.shape[1] // 2))} batched gates "
        f"{[y.dim() == 4 for y in ys]} max_abs_err {err:.3e} (max|plain| "
        f"{scale:.3e}) batched {batched_ms:.3f} ms vs {n} x one slice "
        f"{n * one_ms:.3f} ms ({batched_ms / (n * one_ms):.3f}) bound "
        f"{bound_b[0]:.3f} ms ({100 * bound_b[0] / batched_ms:.0f}% of it)",
        flush=True,
    )
    return err, batched_ms, n * one_ms, bound_b


def phase_vmap_chains(dev):
    """The batched chain kernel against its plain version: every t27
    chain at 4 slices (plain batched on the same batch) and the largest
    m20 chain at 16 slices, 2^33 floats in x (plain slice by slice)."""
    import cotengra_tpu_torch as ctt

    rows = []
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    for plan_name, n, pick in ((T27, VMAP_T27_BATCH, None),
                               (M20, M20_SLICES, "largest")):
        tree, _, _ = _load_instance(plan_name)
        fn = ctt.make_grouped_contractor(tree, dev, torch.float32,
                                         slice_batch=n,
                                         slice_batch_mode="vmap")
        chains = [(si, rec) for si, (kind, rec) in enumerate(fn.plans)
                  if kind == "inplace"]
        if pick:
            chains = [max(chains, key=lambda c: (
                c[1].spec.gate_strides[0].numel_in, len(c[1].ys)))]
        label = plan_name.split("_", 1)[1]
        for ci, (si, rec) in enumerate(chains):
            n_in = rec.spec.gate_strides[0].numel_in
            x = torch.randn((n, 2 * n_in), generator=gen, device=dev)
            ys = _batched_gates(fn, rec, n, gen, dev)
            rows.append(_vmap_chain_row(label, ci if not pick else si,
                                        rec.spec, x, ys, bool(pick)))
            if pick and x.numel() <= 2**31:
                raise AssertionError(
                    f"{label}: the largest chain's batch holds "
                    f"{x.numel()} floats, not over 2^31"
                )
            del x, ys
            torch.cuda.empty_cache()
    t27 = rows[:-1]
    print(
        f"# vmap chains t27 x{VMAP_T27_BATCH}: batched "
        f"{sum(r[1] for r in t27):.3f} ms vs {VMAP_T27_BATCH} x one slice "
        f"{sum(r[2] for r in t27):.3f} ms, bound "
        f"{sum(r[3][0] for r in t27):.3f} ms",
        flush=True,
    )
    return rows


def _fresh_cache():
    """Collect garbage and hand the caching allocator's blocks back, so
    that a timed pass does not pay for an earlier phase's layout (a
    49 GiB m20 batch leaves segments that smaller passes split)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _warm_modes(label, calls, pull, peaks=None, passes=3):
    """Warm seconds of each call of ``calls`` (mode -> fn), in turns,
    and peak GiB (``peaks``: those measured already, by mode; one more
    pass for each other); ``pull`` makes each result a host value that
    must be finite and stable."""
    peaks = dict(peaks or {})
    for k, call in calls.items():
        if k not in peaks:
            _fresh_cache()
            torch.cuda.reset_peak_memory_stats()
            pull(call())
            peaks[k] = torch.cuda.max_memory_allocated() / 2**30
    _fresh_cache()
    times = _in_turns(label, calls, pull, passes)
    return times, peaks


def _modes_line(times, peaks):
    return "; ".join(
        f"{k} {' '.join(f'{t:.4f}' for t in ts)} (best {min(ts):.4f}, "
        f"peak_mem_gib {peaks[k]:.2f})"
        for k, ts in times.items()
    )


def _calls_of(fn, planes, ids, batch):
    """The sum over ``ids`` by calls of ``batch`` slices (a host value)."""
    def run():
        out = sum(fn(planes, ids[k:k + batch]).sum(0)
                  for k in range(0, len(ids), batch))
        return complex(out[0].item(), out[1].item())

    return run


def _step_calls(fn, n_slices, batch):
    """Step calls of ``n_slices`` slices in calls of ``batch``."""
    calls = -(-n_slices // batch)
    each = calls if fn.mode == "vmap" else n_slices
    return calls * len(fn.batch.steps_once) + each * len(fn.batch.steps_each)


def phase_vmap_t27(dev):
    """m10-t27 through "vmap" (4 slices a call), plain and stripped,
    held to the sidecar; its launches against the plan's count; warm
    time in turns with "scan", and peak memory."""
    import cotengra_tpu_torch as ctt

    _fresh_cache()
    tree, arrays, refs = _load_instance(T27)
    n = tree.multiplicity
    ref = refs[n]
    planes = ctt.to_plane_tensors(arrays, dev, torch.float32)
    fns = {mode: ctt.make_grouped_contractor(
        tree, dev, torch.float32, slice_batch=n, slice_batch_mode=mode)
        for mode in ("scan", "vmap")}
    expect = _batched_chain_passes(fns["vmap"], n)
    for strip in (False, True):
        fn = ctt.make_grouped_contractor(
            tree, dev, torch.float32, slice_batch=n, slice_batch_mode="vmap",
            strip_exponent=strip,
        )
        _reset_launches()
        res = fn(planes, range(n))
        torch.cuda.synchronize()
        counts = _read_launches()
        if strip:
            m, e = res
            amp = complex(sum(
                complex(m[s, 0].item(), m[s, 1].item()) * 10.0 ** e[s].item()
                for s in range(n)))
        else:
            total = res.sum(0)
            amp = complex(total[0].item(), total[1].item())
        relerr = abs(amp - ref) / abs(ref)
        if counts != _launches(gate_chain=expect):
            raise AssertionError(
                f"vmap t27 (strip {strip}): launches {counts}, the plan "
                f"gives {expect}"
            )
        if not relerr <= AMP_RTOL:
            raise AssertionError(
                f"vmap t27 (strip {strip}): amplitude {amp} vs {ref}: "
                f"relerr {relerr:.3e} > {AMP_RTOL}"
            )
        print(
            f"# vmap {T27} (slice_batch {n}, strip {strip}): amplitude "
            f"{amp.real:.12e}{amp.imag:+.12e}j relerr {relerr:.3e} chain "
            f"launches {counts['gate_chain']} (scan: "
            f"{_batched_chain_passes(fns['scan'], n)}); step calls "
            f"{_step_calls(fns['vmap'], n, n)} (scan: "
            f"{_step_calls(fns['scan'], n, n)})",
            flush=True,
        )
    ids = list(range(n))
    times, peaks = _warm_modes(
        "vmap t27", {k: _calls_of(f, planes, ids, n) for k, f in fns.items()},
        lambda v: abs(v),
    )
    print(f"# warm vmap {T27} x{n}: " + _modes_line(times, peaks),
          flush=True)
    return counts["gate_chain"], {k: min(t) for k, t in times.items()}


def _m20_vmap_batch(dev):
    """The most m20 slices a "vmap" call fits on this card (at most 16),
    from the plan's per-slice live peak."""
    from cotengra_tpu_torch.ops import grouped
    from cotengra_tpu_torch.ops.simulate import step_records

    recs = step_records(_load_instance(M20)[0])
    total = torch.cuda.get_device_properties(dev).total_memory
    return min(M20_SLICES, grouped.vmap_max_batch(
        recs["slice_bytes"], recs["raw_bytes"], total))


def phase_vmap_m20(dev):
    """m20-t28 slices 0..15 through "vmap" at the largest batch that
    fits the card (``vmap_max_batch`` from the plan's per-slice peak):
    partial sums over 4, 8 and 16 slices held to the sidecar, launches,
    warm time in turns with "scan" (16 a call) and peak memory."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.ops import grouped
    from cotengra_tpu_torch.ops.simulate import step_records

    tree, arrays, refs = _load_instance(M20)
    recs = step_records(tree)
    total = torch.cuda.get_device_properties(dev).total_memory
    fits = grouped.vmap_max_batch(recs["slice_bytes"], recs["raw_bytes"],
                                  total)
    batch = min(M20_SLICES, fits)
    print(
        f"# vmap {M20}: per-slice live peak "
        f"{recs['slice_bytes'] / 2**30:.2f} GiB (reckoned from the plan), "
        f"card {total / 2**30:.2f} GiB: the largest batch that fits is "
        f"{fits}; this phase takes {batch}",
        flush=True,
    )
    planes = ctt.to_plane_tensors(arrays, dev, torch.float32)
    fn = ctt.make_grouped_contractor(tree, dev, torch.float32,
                                     slice_batch=batch,
                                     slice_batch_mode="vmap")
    scan = ctt.make_grouped_contractor(tree, dev, torch.float32,
                                       slice_batch=M20_SLICES,
                                       slice_batch_mode="scan")
    ids = list(range(M20_SLICES))
    expect = _batched_chain_passes(fn, M20_SLICES, batch)
    _fresh_cache()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    per_slice = torch.cat([fn(planes, ids[k:k + batch])
                           for k in range(0, M20_SLICES, batch)])
    torch.cuda.synchronize()
    counts = _read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if counts != _launches(gate_chain=expect):
        raise AssertionError(
            f"vmap {M20}: launches {counts}, the plan gives {expect}"
        )
    partial = per_slice.cpu().double().cumsum(0)
    errs = {}
    for k, ref in sorted(refs.items()):
        amp = complex(partial[k - 1, 0].item(), partial[k - 1, 1].item())
        errs[k] = abs(amp - ref) / abs(ref)
        if not errs[k] <= AMP_RTOL:
            raise AssertionError(
                f"vmap {M20}: first {k} slices {amp} vs {ref}: relerr "
                f"{errs[k]:.3e} > {AMP_RTOL}"
            )
    del per_slice
    times, peaks = _warm_modes(
        f"vmap {M20}",
        {"scan": _calls_of(scan, planes, ids, M20_SLICES),
         "vmap": _calls_of(fn, planes, ids, batch)},
        lambda v: abs(v), {"vmap": peak},
    )
    print(
        f"# main path vmap {M20}: slices 0..{M20_SLICES - 1} in calls of "
        f"{batch}; partial amplitudes "
        + " ".join(f"[{k}] relerr {e:.3e}" for k, e in sorted(errs.items()))
        + f"; chain launches {counts['gate_chain']} (scan: "
        f"{_batched_chain_passes(scan, M20_SLICES)}); step calls "
        f"{_step_calls(fn, M20_SLICES, batch)} (scan: "
        f"{_step_calls(scan, M20_SLICES, M20_SLICES)}); warm "
        + _modes_line(times, peaks),
        flush=True,
    )
    return counts["gate_chain"], batch, {k: min(t) for k, t in times.items()}


def _small_slices_tree(committed):
    """Phase 29's example tree sliced to ``SMALL_SLICE_TARGET`` at
    temperature 0 (the same tree every run), and its planning
    seconds."""
    import cotengra_tpu_torch as ctt

    t0 = time.perf_counter()
    ssa, _ = ctt.optimize_random_greedy_track_flops(
        committed.inputs, committed.output, committed.size_dict,
        ntrials=128, seed=0, use_ssa=True,
    )
    tree = ctt.ContractionTree.from_path(
        committed.inputs, committed.output, committed.size_dict,
        ssa_path=ssa,
    )
    tree.subtree_reconfigure_(subtree_size=10)
    tree.slice_and_reconfigure_(SMALL_SLICE_TARGET, temperature=0)
    return tree, time.perf_counter() - t0


def phase_small_slices(dev):
    """Many small slices: the example's m10 tree sliced to 2^22, all its
    slices in calls of ``SMALL_SLICE_BATCH`` under "scan" and "vmap" in
    turns, held to the sidecar's full amplitude."""
    import cotengra_tpu_torch as ctt

    committed, arrays, refs = _load_instance(T27)
    ref = refs[committed.multiplicity]
    tree, plan_s = _small_slices_tree(committed)
    n, b = tree.multiplicity, SMALL_SLICE_BATCH
    planes = ctt.to_plane_tensors(arrays, dev, torch.float32)
    fns = {mode: ctt.make_grouped_contractor(
        tree, dev, torch.float32, slice_batch=b, slice_batch_mode=mode)
        for mode in ("scan", "vmap")}
    ids = list(range(n))
    out, peaks, checked = {}, {}, {}
    for mode, fn in fns.items():
        _fresh_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        amp = _calls_of(fn, planes, ids, b)()
        checked[mode] = time.perf_counter() - t0
        counts = _read_launches()
        peaks[mode] = torch.cuda.max_memory_allocated() / 2**30
        expect = _batched_chain_passes(fn, n, b)
        relerr = abs(amp - ref) / abs(ref)
        if counts != _launches(gate_chain=expect):
            raise AssertionError(
                f"small slices {mode}: launches {counts}, the plan gives "
                f"{expect}"
            )
        if not relerr <= AMP_RTOL:
            raise AssertionError(
                f"small slices {mode}: amplitude {amp} vs {ref}: relerr "
                f"{relerr:.3e} > {AMP_RTOL}"
            )
        out[mode] = (relerr, counts["gate_chain"], _step_calls(fn, n, b))
    # a scan pass takes seconds here: the checked pass counts as one (its
    # one-time costs, the chains' index tables, are milliseconds) and one
    # more each
    times, peaks = _warm_modes(
        "small slices", {k: _calls_of(f, planes, ids, b)
                         for k, f in fns.items()},
        lambda v: abs(v), peaks, passes=1,
    )
    times = {k: [checked[k]] + ts for k, ts in times.items()}
    print(
        f"# main path small slices m10 (tree {_tree_hash(tree)}, planned in "
        f"{plan_s:.1f}s): {_plan_stats(tree)}; {n} slices in calls of {b}: "
        + "; ".join(
            f"{k} relerr {r:.3e} chain launches {la} step calls {sc}"
            for k, (r, la, sc) in out.items()
        )
        + "; warm " + _modes_line(times, peaks),
        flush=True,
    )
    return tree, out["vmap"][1], {k: min(t) for k, t in times.items()}


def _model_s(tree, batch, mode, nslices=None):
    from cotengra_tpu_torch.ops.simulate import simulate_grouped

    return simulate_grouped(tree, slice_batch=batch,
                            slice_batch_mode=mode or "auto",
                            nslices=nslices)


def vmap_measured(t27_modes, m20_batch, m20_modes, small_tree,
                  small_modes):
    """The runs of phases 32-34 for the calibration: t27 and m20 under
    both modes, and the small slices."""
    t27, m20 = _load_instance(T27)[0], _load_instance(M20)[0]
    return [
        {"plan": T27, "tree": t27, "slice_batch": VMAP_T27_BATCH,
         "mode": mode, "nslices": t27.multiplicity,
         "seconds": t27_modes[mode], "fit": True}
        for mode in ("scan", "vmap")
    ] + [
        {"plan": M20, "tree": m20,
         "slice_batch": M20_SLICES if mode == "scan" else m20_batch,
         "mode": mode, "nslices": M20_SLICES, "seconds": m20_modes[mode],
         "fit": True}
        for mode in ("scan", "vmap")
    ] + [
        {"plan": SMALL_SLICE_PLAN, "tree": small_tree,
         "slice_batch": SMALL_SLICE_BATCH, "mode": mode,
         "nslices": small_tree.multiplicity, "seconds": small_modes[mode],
         "fit": False}
        for mode in ("scan", "vmap")
    ]


def phase_calibration(dev, measured):
    """The warm seconds of each plan of ``CALIBRATION``, held to its
    sidecar, then of ``measured`` (the runs that phases 32-34 timed:
    dicts of plan, tree, slice_batch, mode, nslices, seconds), each
    beside the cost model's. Prints the runs as one JSON line, as
    ``ops/simulate.py``'s ``H100_MEASURED`` keeps them, and returns
    them."""
    import cotengra_tpu_torch as ctt

    runs = []
    for plan_name, batch, mode, fit in CALIBRATION:
        tree, arrays, refs = _load_instance(plan_name)
        n = tree.multiplicity
        ref = refs[n]
        planes = ctt.to_plane_tensors(arrays, dev, torch.float32)
        if batch is None:
            core = ctt.make_grouped_contractor(tree, dev, torch.float32)

            def one_pass():
                out = ctt.contract_slices(tree, core, planes)
                return complex(out[0].item(), out[1].item())
        else:
            fn = ctt.make_grouped_contractor(
                tree, dev, torch.float32, slice_batch=batch,
                slice_batch_mode=mode)
            one_pass = _calls_of(fn, planes, list(range(n)), batch)
        _fresh_cache()
        amp = one_pass()
        relerr = abs(amp - ref) / abs(ref)
        if not relerr <= AMP_RTOL:
            raise AssertionError(
                f"calibration {plan_name}: amplitude {amp} vs {ref}: "
                f"relerr {relerr:.3e} > {AMP_RTOL}"
            )
        times = _in_turns(f"calibration {plan_name}", {"pass": one_pass},
                          lambda v: abs(v), CALIBRATION_PASSES)["pass"]
        runs.append({"plan": plan_name, "tree": tree, "slice_batch": batch,
                     "mode": mode, "nslices": n, "seconds": min(times),
                     "relerr": relerr, "fit": fit})
        del planes
    for r in runs + measured:
        tree = r.pop("tree")
        nsl = r["nslices"] if r["nslices"] != tree.multiplicity else None
        r["model_s"] = _model_s(tree, r["slice_batch"], r["mode"], nsl)
        err = r["model_s"] / r["seconds"] - 1
        rel = f" relerr {r['relerr']:.3e}" if r.get("relerr") else ""
        print(
            f"# calibration {r['plan']} batch {r['slice_batch']} mode "
            f"{r['mode']} slices {r['nslices']}: warm {r['seconds']:.4f} s"
            f"{rel}; model {r['model_s']:.4f} s ({100 * err:+.1f}%)"
            f"{'' if r['fit'] else ' (held out of the fit)'}",
            flush=True,
        )
    runs += measured
    print(json.dumps({"calibration": {
        "card": _card_name(), "runs": [
            {k: r[k] for k in ("plan", "slice_batch", "mode", "nslices",
                               "seconds", "fit")}
            for r in runs
        ],
    }}), flush=True)
    return runs


def _card_name():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_gpu_planned(dev):
    """m10 planned for the card: the port's hyper-optimizer with
    ``minimize="gpu"`` (phase 17's seeded methods, 2^27, few repeats),
    contracted and held to key "4"; its modelled and measured seconds
    beside t27's. Returns its chain launches."""
    import random

    import cotengra_tpu_torch as ctt

    committed, arrays, refs = _load_instance(T27)
    ref = refs[committed.multiplicity]
    opt = ctt.HyperOptimizer(
        methods=_seeded_methods(HYPER_LABELS, random.Random(HYPER_SEED)),
        max_repeats=GPU_PLAN_TRIALS, seed=HYPER_SEED, minimize="gpu",
        slicing_reconf_opts={"target_size": HYPER_M10_TARGET,
                             "temperature": 0},
        parallel=False,
    )
    t0 = time.perf_counter()
    tree = opt.search(committed.inputs, committed.output,
                      committed.size_dict)
    plan_s = time.perf_counter() - t0
    if tree.max_size() > HYPER_M10_TARGET:
        raise AssertionError(f"gpu m10: 2^{tree.max_size(log=2):.2f}")
    expect = _chain_passes(tree) * tree.multiplicity
    _reset_launches()
    amp = complex(ctt.contract_tree(tree, arrays, device=dev).cpu().item())
    torch.cuda.synchronize()
    counts = _read_launches()
    relerr = abs(amp - ref) / abs(ref)
    if counts != _launches(gate_chain=expect):
        raise AssertionError(
            f"gpu m10: launches {counts}, the plan has {expect} passes"
        )
    if not relerr <= AMP_RTOL:
        raise AssertionError(
            f"gpu m10: amplitude {amp} vs {ref}: relerr {relerr:.3e} > "
            f"{AMP_RTOL}"
        )
    planes = ctt.to_plane_tensors(arrays, dev, torch.float32)
    _fresh_cache()
    times = _warm_in_turns("gpu m10", {
        "gpu-planned": _amp_pass(tree, dev, planes),
        T27: _amp_pass(committed, dev, planes),
    })
    model = {"gpu-planned": _model_s(tree, None, None),
             T27: _model_s(committed, None, None)}
    print(
        f"# main path gpu-planned m10: planned in {plan_s:.1f}s "
        f"({len(opt.trials)} trials, minimize='gpu', tree "
        f"{_tree_hash(tree)}): {_plan_stats(tree)}; relerr {relerr:.3e} "
        f"chain launches {counts['gate_chain']}; slice by slice: "
        + "; ".join(
            f"{k} model {model[k]:.4f} s measured "
            f"{' '.join(f'{t:.4f}' for t in ts)} (best {min(ts):.4f})"
            for k, ts in times.items()
        ),
        flush=True,
    )
    return counts["gate_chain"]


# phases 37-41: the window engine, fused kron chains and the layout
# lookahead (opt-in engines of the grouped executor)
M20_WINDOW_SLICES = 4     # phase 40: slices 0..3 (the sidecar's key 4)
T27_WINDOW_STEPS = 15     # window steps a slice of each plan
M20_WINDOW_STEPS = 44
T27_FUSED_STEPS = {"inplace": 1, None: 11}   # fused chains a t27 slice


@contextlib.contextmanager
def _step_events(kinds):
    """CUDA event pairs around every executor step of ``kinds`` run
    inside the block, by kind (``grouped._exec_steps_split`` split into
    one call per step). No synchronisation: a pair times the step's own
    kernels once the stream reaches it, plus any gap while the host
    still issues them."""
    from cotengra_tpu_torch.ops import grouped

    run = grouped._exec_steps_split
    pairs = {k: [] for k in kinds}

    def per_step(plans, steps, temps, shapes, last_use,
                 strip_exponent=False):
        exponent = None
        for si in steps:
            kind = plans[si][0]
            if kind in pairs:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            e = run(plans, [si], temps, shapes, last_use, strip_exponent)
            if kind in pairs:
                ev[1].record()
                pairs[kind].append(ev)
            if e is not None:
                exponent = e if exponent is None else exponent + e
        return exponent

    grouped._exec_steps_split = per_step
    try:
        yield pairs
    finally:
        grouped._exec_steps_split = run


@contextlib.contextmanager
def _copy_events():
    """CUDA event pairs around every block transpose
    (``grouped._apply_block_plan_split`` with a plan) inside the block."""
    from cotengra_tpu_torch.ops import grouped

    apply = grouped._apply_block_plan_split
    pairs = []

    def timed(flat, plan):
        if plan is None:
            return flat
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = apply(flat, plan)
        ev[1].record()
        pairs.append(ev)
        return out

    grouped._apply_block_plan_split = timed
    try:
        yield pairs
    finally:
        grouped._apply_block_plan_split = apply


def _events_ms(pairs):
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs)


def _held_to(label, ref):
    """A pull for ``_in_turns``: each pass's amplitude within
    ``AMP_RTOL`` of ``ref`` (engines sum in other orders, so passes of
    two engines are held to the reference, not to each other)."""
    def pull(amp):
        relerr = abs(amp - ref) / abs(ref)
        if not relerr <= AMP_RTOL:
            raise AssertionError(
                f"{label}: amplitude {amp} vs {ref}: relerr {relerr:.3e} > "
                f"{AMP_RTOL}"
            )
        return 1.0

    return pull


def _window_stats(fn):
    """Window steps, operator builds run once per call and per slice
    (``SliceBatch``'s split of the executor plan), and the largest
    operator ``W2`` in bytes (float32: 16 S_in S_out)."""
    kinds = [k for k, _ in fn.plans]
    builds = [si for si, k in enumerate(kinds) if k == "w2build"]
    once = sum(si in set(fn.batch.steps_once) | set(fn.batch.steps_fold)
               for si in builds)
    w2 = max((16 * info.rec.S_in * info.rec.S_out
              for k, info in fn.plans if k == "w2build"), default=0)
    return kinds.count("window"), once, len(builds) - once, w2


def _check_amp(label, amp, ref, counts, chain_expect):
    relerr = abs(amp - ref) / abs(ref)
    if counts != _launches(gate_chain=chain_expect):
        raise AssertionError(
            f"{label}: launches {counts}, expected {chain_expect} chain "
            "launches"
        )
    if not relerr <= AMP_RTOL:
        raise AssertionError(
            f"{label}: amplitude {amp} vs {ref}: relerr {relerr:.3e} > "
            f"{AMP_RTOL}"
        )
    return relerr


def phase_window_t27(dev):
    """m10-t27 at full width with ``gate_mode="window"``: slice by slice
    and under "vmap" (4 slices a call), held to key "4"; 15 window steps
    a slice and no chain launch; the operator builds the hoist runs once
    and per slice; the largest W2; the window steps' and operator
    builds' device ms per call (CUDA events); warm seconds in turns with
    "inplace" on the same planes. Returns (chain launches, warm seconds
    by run)."""
    import cotengra_tpu_torch as ctt

    _fresh_cache()
    tree, arrays, refs = _load_instance(T27)
    n = tree.multiplicity
    ref = refs[n]
    planes = ctt.to_plane_tensors(arrays, dev, torch.float32)
    core = ctt.make_grouped_contractor(tree, dev, torch.float32,
                                       gate_mode="window")
    vmap = ctt.make_grouped_contractor(
        tree, dev, torch.float32, slice_batch=n, slice_batch_mode="vmap",
        gate_mode="window",
    )
    steps, once, each, w2 = _window_stats(vmap)
    if steps != T27_WINDOW_STEPS:
        raise AssertionError(f"window t27: {steps} window steps a slice, "
                             f"expected {T27_WINDOW_STEPS}")

    def by_slice(c):
        def run():
            out = ctt.contract_slices(tree, c, planes)
            return complex(out[0].item(), out[1].item())
        return run

    runs = {"window slice by slice": by_slice(core),
            "window vmap": _calls_of(vmap, planes, list(range(n)), n)}
    launches = 0
    for label, run in runs.items():
        _reset_launches()
        with _step_events(("window", "w2build")) as ev:
            amp = run()
        counts = _read_launches()
        relerr = _check_amp(f"{label} t27", amp, ref, counts, 0)
        launches += counts["gate_chain"]
        print(
            f"# {label} {T27}: amplitude {amp.real:.12e}{amp.imag:+.12e}j "
            f"relerr {relerr:.3e} chain launches {counts['gate_chain']}; "
            f"window steps a slice {steps} ({len(ev['window'])} run), "
            f"operator builds run {len(ev['w2build'])} (a batched call "
            f"builds {once} once and {each} per slice); device ms: window "
            f"steps "
            f"{_events_ms(ev['window']):.3f}, operator builds "
            f"{_events_ms(ev['w2build']):.3f}; largest W2 {w2} bytes",
            flush=True,
        )
    runs["inplace slice by slice"] = by_slice(
        ctt.make_grouped_contractor(tree, dev, torch.float32))
    runs["inplace vmap"] = _calls_of(ctt.make_grouped_contractor(
        tree, dev, torch.float32, slice_batch=n, slice_batch_mode="vmap"),
        planes, list(range(n)), n)
    times, peaks = _warm_modes("window t27", runs, _held_to("t27", ref))
    print(f"# warm window {T27} x{n}: " + _modes_line(times, peaks),
          flush=True)
    return launches, {k: min(t) for k, t in times.items()}


def phase_fused_t27(dev):
    """m10-t27 with ``fuse_gates=True`` under "inplace" and under None,
    4 slices in one "scan" call: held to key "4"; fused steps a slice
    (1 and 11); chain launches (52 under "inplace", none under None);
    the fused steps' device ms; warm seconds in turns with the same
    engine unfused. Returns (chain launches under "inplace", warm
    seconds by run)."""
    import cotengra_tpu_torch as ctt

    _fresh_cache()
    tree, arrays, refs = _load_instance(T27)
    n = tree.multiplicity
    ref = refs[n]
    planes = ctt.to_plane_tensors(arrays, dev, torch.float32)
    ids = list(range(n))
    runs, launches = {}, None
    for gate_mode, fused_expect in T27_FUSED_STEPS.items():
        fn = ctt.make_grouped_contractor(
            tree, dev, torch.float32, slice_batch=n, slice_batch_mode="scan",
            gate_mode=gate_mode, fuse_gates=True,
        )
        fused = sum(k == "fusedchain" for k, _ in fn.plans)
        if fused != fused_expect:
            raise AssertionError(f"fused t27 {gate_mode}: {fused} fused "
                                 f"steps a slice, expected {fused_expect}")
        expect = _batched_chain_passes(fn, n)
        _reset_launches()
        with _step_events(("fusedchain",)) as ev:
            amp = _calls_of(fn, planes, ids, n)()
        counts = _read_launches()
        relerr = _check_amp(f"fused t27 {gate_mode}", amp, ref, counts,
                            expect)
        if gate_mode == "inplace":
            launches = counts["gate_chain"]
        print(
            f"# fused {T27} gate_mode {gate_mode} (scan, 4 slices a call): "
            f"amplitude {amp.real:.12e}{amp.imag:+.12e}j relerr "
            f"{relerr:.3e} chain launches {counts['gate_chain']}; fused "
            f"steps a slice {fused}, device ms "
            f"{_events_ms(ev['fusedchain']):.3f} for "
            f"{len(ev['fusedchain'])}",
            flush=True,
        )
        runs[f"{gate_mode} fused"] = _calls_of(fn, planes, ids, n)
        runs[f"{gate_mode}"] = _calls_of(ctt.make_grouped_contractor(
            tree, dev, torch.float32, slice_batch=n, slice_batch_mode="scan",
            gate_mode=gate_mode), planes, ids, n)
    times, peaks = _warm_modes("fused t27", runs, _held_to("t27", ref))
    print(f"# warm fused {T27} x{n} (scan): " + _modes_line(times, peaks),
          flush=True)
    return launches, {k: min(t) for k, t in times.items()}


def phase_lookahead_t27(dev):
    """m10-t27 under "inplace" with the layout lookahead on
    (``grouped_plan._LAYOUT_LOOKAHEAD``, restored after), slice by
    slice: held to key "4"; the plan's stored orders that changed; block
    transposes of one slice and their device ms against the default."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.ops import grouped_plan
    from cotengra_tpu_torch.ops.lowering import (
        extract_contractions,
        sliced_input_legs,
    )

    _fresh_cache()
    tree, arrays, refs = _load_instance(T27)
    ref = refs[tree.multiplicity]
    planes = ctt.to_plane_tensors(arrays, dev, torch.float32)
    ir = extract_contractions(tree)
    orders = [sliced_input_legs(tree, i) for i in range(tree.N)]
    out = {}
    default = grouped_plan._LAYOUT_LOOKAHEAD
    try:
        for lookahead in (False, True):
            grouped_plan._LAYOUT_LOOKAHEAD = lookahead
            storage = grouped_plan.plan_grouped(
                ir, tree.size_dict, orders, gate_mode="inplace")[1]
            core = ctt.make_grouped_contractor(tree, dev, torch.float32)
            _reset_launches()
            res = ctt.contract_slices(tree, core, planes)
            amp = complex(res[0].item(), res[1].item())
            relerr = _check_amp(
                f"lookahead {lookahead} t27", amp, ref, _read_launches(),
                _chain_passes(tree) * tree.multiplicity,
            )
            with _copy_events() as ev:
                ctt.contract_slices(tree, core, planes)
            out[lookahead] = (storage, relerr, len(ev), _events_ms(ev))
    finally:
        grouped_plan._LAYOUT_LOOKAHEAD = default
    changed = sum(out[True][0].get(k) != v for k, v in out[False][0].items())
    print(
        f"# lookahead {T27} (inplace, slice by slice): relerr "
        f"{out[True][1]:.3e} (off: {out[False][1]:.3e}); stored orders "
        f"changed {changed} of {len(out[False][0])}; block transposes a "
        f"pass of {tree.multiplicity} slices {out[True][2]} in "
        f"{out[True][3]:.3f} ms (off: {out[False][2]} in "
        f"{out[False][3]:.3f} ms)",
        flush=True,
    )


def _window_vmap_batch(dev, tree):
    """The most slices (at most ``M20_WINDOW_SLICES``) a "vmap" call of
    the window plan fits on this card, from its per-slice live peak."""
    from cotengra_tpu_torch.ops import grouped
    from cotengra_tpu_torch.ops.simulate import step_records

    recs = step_records(tree, gate_mode="window")
    total = torch.cuda.get_device_properties(dev).total_memory
    return min(M20_WINDOW_SLICES, grouped.vmap_max_batch(
        recs["slice_bytes"], recs["raw_bytes"], total))


def phase_window_m20(dev):
    """m20-t28 slices 0..3 with ``gate_mode="window"`` in one "scan"
    call, and under "vmap" in calls of the batch that fits (from the
    window plan's per-slice peak): held to the sidecar's key "4"; 44
    window steps a slice and no chain launch; the operators stacked per
    slice (those whose gates read a sliced index); warm seconds of one
    more call in each mode."""
    import cotengra_tpu_torch as ctt

    _fresh_cache()
    tree, arrays, refs = _load_instance(M20)
    n = M20_WINDOW_SLICES
    ref = refs[n]
    planes = ctt.to_plane_tensors(arrays, dev, torch.float32)
    ids = list(range(n))
    scan = ctt.make_grouped_contractor(
        tree, dev, torch.float32, slice_batch=n, slice_batch_mode="scan",
        gate_mode="window",
    )
    steps, once, each, w2 = _window_stats(scan)
    if steps != M20_WINDOW_STEPS:
        raise AssertionError(f"window m20: {steps} window steps a slice, "
                             f"expected {M20_WINDOW_STEPS}")
    batch = _window_vmap_batch(dev, tree)
    runs = {"scan": _calls_of(scan, planes, ids, n)}
    if batch:
        vmap = ctt.make_grouped_contractor(
            tree, dev, torch.float32, slice_batch=batch,
            slice_batch_mode="vmap", gate_mode="window",
        )
        runs["vmap"] = _calls_of(vmap, planes, ids, batch)
    times = {}
    for mode, run in runs.items():
        _fresh_cache()
        _reset_launches()
        t0 = time.perf_counter()
        amp = run()
        cold = time.perf_counter() - t0
        counts = _read_launches()
        relerr = _check_amp(f"window m20 {mode}", amp, ref, counts, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _held_to("window m20", ref)(run())
        times[mode] = time.perf_counter() - t0
        print(
            f"# window {M20} slices 0..{n - 1} {mode}"
            f"{f' (calls of {batch})' if mode == 'vmap' else ''}: "
            f"amplitude {amp.real:.12e}{amp.imag:+.12e}j relerr "
            f"{relerr:.3e} chain launches {counts['gate_chain']}; window "
            f"steps a slice {steps}, operators once a call {once}, stacked "
            f"per slice {each}; largest W2 {w2} bytes; first call "
            f"{cold:.4f} s, warm {times[mode]:.4f} s; peak_mem_gib "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
            flush=True,
        )
    print(f"# window {M20}: vmap batch that fits {batch}", flush=True)
    return times


def phase_engine_model(window_s, fused_s):
    """``simulate_grouped`` with ``gate_mode="window"`` and with
    ``fuse_gates`` on t27, beside phases 37-38's warm seconds (no limit:
    no constant was fitted to these runs)."""
    from cotengra_tpu_torch.ops.simulate import simulate_grouped

    tree = _load_instance(T27)[0]
    n = tree.multiplicity
    rows = {
        "window slice by slice": dict(gate_mode="window"),
        "window vmap": dict(gate_mode="window", slice_batch=n,
                            slice_batch_mode="vmap"),
        "inplace slice by slice": dict(),
        "inplace vmap": dict(slice_batch=n, slice_batch_mode="vmap"),
        "inplace fused": dict(fuse_gates=True, slice_batch=n,
                              slice_batch_mode="scan"),
        "inplace": dict(slice_batch=n, slice_batch_mode="scan"),
        "None fused": dict(gate_mode=None, fuse_gates=True, slice_batch=n,
                           slice_batch_mode="scan"),
        "None": dict(gate_mode=None, slice_batch=n, slice_batch_mode="scan"),
    }
    measured = {**window_s, **fused_s}
    parts = []
    for label, kw in rows.items():
        model = simulate_grouped(tree, **kw)
        parts.append(f"{label} model {model:.4f} s measured "
                     f"{measured[label]:.4f} s (x{model / measured[label]:.3f})")
    print(f"# engine model {T27}: " + "; ".join(parts), flush=True)


# the methods that plot.py binds onto the port's classes (phase 42)
PLOT_METHODS = {
    "ContractionTree": (
        "plot_tree", "plot_ring", "plot_tent", "plot_span", "plot_flat",
        "plot_rubberband", "plot_circuit", "plot_contractions",
        "plot_contractions_alt", "to_networkx", "to_df",
    ),
    "HyperOptimizer": (
        "plot_trials", "plot_trials_alt", "plot_scatter", "plot_scatter_alt",
        "plot_parameters_parallel",
    ),
    "SliceFinder": ("plot_slicings", "plot_slicings_alt"),
    "HyperGraph": ("plot",),
}


def _check_layouts(label, tree):
    """The ring and tent layouts of ``tree`` and the convex hull of the
    ring positions of its last step's leaves, checked; returns the
    hull's vertex count."""
    from cotengra_tpu_torch import plot

    n = tree.N
    nodes = set(tree.gen_leaves()) | set(tree.children)
    leaves = plot._leaf_angles(tree)
    if sorted(leaves) != list(tree.gen_leaves()):
        raise AssertionError(f"plots {label}: leaf order is not the leaves")
    ring = plot._tree_positions(tree, "ring")
    tent = plot._tree_positions(tree, "tent")
    for layout, pos in (("ring", ring), ("tent", tent)):
        if len(pos) != 2 * n - 1 or set(pos) != nodes:
            raise AssertionError(
                f"plots {label}: {layout} has {len(pos)} positions for "
                f"{2 * n - 1} nodes"
            )
    outside = [p for p in tree.children if not math.hypot(*ring[p]) < 1]
    if outside:
        raise AssertionError(
            f"plots {label}: {len(outside)} ring nodes outside the unit disc"
        )
    wrong = [p for p in tree.children if tent[p][1] != p.bit_count() / n]
    if wrong:
        raise AssertionError(
            f"plots {label}: {len(wrong)} tent heights are not extent / N"
        )
    last = list(tree.traverse())[-1][0]
    points = [ring[1 << i] for i in range(n) if (last >> i) & 1]
    hull = plot._convex_hull(points)
    if len(hull) != len(points):
        raise AssertionError(
            f"plots {label}: hull of {len(points)} points on the unit "
            f"circle has {len(hull)} vertices"
        )
    return len(hull)


def phase_plots(trees):
    """The plots on the host, on the trees the card contracted (``trees``:
    plan name -> tree): the bound methods, the layouts, and a plot that
    draws where matplotlib is installed and raises its ImportError where
    it is not."""
    import importlib.util

    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch import plot, schematic

    t0 = time.perf_counter()
    _reset_launches()
    unbound = [
        f"{cls}.{name}" for cls, names in PLOT_METHODS.items()
        for name in names
        if getattr(getattr(ctt, cls), name, None) is None
        or getattr(ctt, cls).__dict__[name].__module__ != plot.__name__
    ]
    if unbound or not hasattr(schematic, "Drawing"):
        raise AssertionError(f"plots: methods not bound {unbound}")
    parts = []
    for label, tree in trees.items():
        t = time.perf_counter()
        hull = _check_layouts(label, tree)
        parts.append(
            f"{label} leaves {tree.N} positions {2 * tree.N - 1} hull {hull} "
            f"layout_ms {1e3 * (time.perf_counter() - t):.3f}"
        )
    tree = trees[T27]
    have = {name: importlib.util.find_spec(name) is not None
            for name in ("matplotlib", "networkx", "pandas", "altair")}
    if not have["matplotlib"]:
        try:
            tree.plot_ring()
        except ImportError as e:
            if "matplotlib" not in str(e):
                raise AssertionError(
                    f"plots: plot_ring raised an ImportError not naming "
                    f"matplotlib: {e}"
                ) from e
            drew = f"plot_ring raises ImportError ({e})"
        else:
            raise AssertionError("plots: plot_ring ran without matplotlib")
    else:
        import matplotlib.pyplot as plt

        fig, ax = tree.plot_ring()
        edges = len(ax.lines)
        plt.close(fig)
        if edges != 2 * (tree.N - 1):
            raise AssertionError(
                f"plots: the t27 ring has {edges} edge lines, not "
                f"{2 * (tree.N - 1)}"
            )
        drew = f"plot_ring drew {edges} edge lines on Agg"
    counts = _read_launches()
    if any(counts.values()):
        raise AssertionError(f"plots: kernels launched {counts}")
    host_ms = 1e3 * (time.perf_counter() - t0)
    print(
        f"# plots (host) {sum(map(len, PLOT_METHODS.values()))} methods "
        f"bound; installed: "
        + " ".join(f"{k} {'yes' if v else 'no'}" for k, v in have.items())
        + "; " + "; ".join(parts) + f"; {drew}; host_ms {host_ms:.3f} "
        f"on {_smi_line()}",
        flush=True,
    )


STAGE_SIZE = 12         # phases 43-46: plan steps a stage (the reference's)
STAGED_PASSES = 5       # phases 43 and 46: best of 5 warm passes in turns
M20_STAGED_BATCH = 4    # phase 44: slices a call (ids 0..3, ..., 12..15)


def _profiled(call):
    """Device busy ms of one profiled call, the same call's wall ms (from
    before it starts to the card's last kernel), and its device kernels
    by name (the profiler sees each kernel inside a replayed CUDA
    graph)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, kernels = 0.0, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        busy += e.time_range.elapsed_us() / 1e3
        kernels[e.name] = kernels.get(e.name, 0) + 1
    if not kernels:
        raise AssertionError("the profiler saw no device time")
    return busy, wall, kernels


def _replays(fn):
    """Graph replays so far of a captured contractor (``fn.graphs``:
    ``Graphs``, or ``(Graphs, static buffers)`` pairs)."""
    return sum(
        (g[0] if isinstance(g, tuple) else g).replays
        for g in fn.graphs.values()
    )


def _capture_s(fn):
    return sum(
        (g[0] if isinstance(g, tuple) else g).capture_s
        for g in fn.graphs.values()
    )


def _python_step_calls():
    """Python step calls so far, of both executors."""
    from cotengra_tpu_torch.tracing import STEP_CALLS

    return sum(STEP_CALLS.values())


def _captured_against_eager(label, fn, capture, call, eager, pull, kernel,
                            expect, passes, calls=1):
    """Captured graphs (``fn``, captured by ``capture()``, called by
    ``call``) against the eager contractor (``eager``), on one card:
    each side's peak (eager: GiB allocated over a pass; captured: GiB
    the graphs' pool and static buffers reserve); ``kernel`` launches,
    exactly, by its wrapper's counter: an eager call's (held to
    ``expect``), and the kernels recorded into the graphs by
    ``capture()`` (its eager warm-up launches them and its capture
    records them, one call of ``expect / calls`` each: each replay then
    runs those nodes once); the captured call's replays (one per graph
    for each of its ``calls`` contractor calls) and Python step calls
    (none); then warm seconds in turns, each pass ending in ``pull``.
    One profiled call on each side gives the device busy ms, the wall ms
    of that same call, the idle share 1 - busy / wall (the profiler
    slows the host, so that wall exceeds the unprofiled passes') and
    ``kernel``'s count among the device records: it must see the kernel
    run inside the replays, and no more often than the plan says, but
    it now and then loses a block of records in a window of ~8k
    (``scratch/profiler_counts.py``), so it is not the exact count.
    Returns the captured side's numbers."""
    counter = _kernel_counters()[kernel.removesuffix("_kernel")]
    _fresh_cache()
    torch.cuda.reset_peak_memory_stats()
    before = counter.launches
    pull(eager())
    eager_launches = counter.launches - before
    eager_gib = torch.cuda.max_memory_allocated() / 2**30
    eager_busy, eager_wall, kernels = _profiled(eager)
    eager_seen = sum(n for k, n in kernels.items() if kernel in k)
    eager_records = sum(kernels.values())

    _fresh_cache()
    r0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    before = counter.launches
    n_graphs = capture()
    recorded = counter.launches - before
    capture_s = time.perf_counter() - t0
    _fresh_cache()
    pool_gib = (torch.cuda.memory_reserved() - r0) / 2**30
    replays, steps = _replays(fn), _python_step_calls()
    before = counter.launches
    pull(call())
    replays = _replays(fn) - replays
    busy, wall, kernels = _profiled(call)
    steps = _python_step_calls() - steps
    ticked = counter.launches - before
    seen = sum(n for k, n in kernels.items() if kernel in k)
    records = sum(kernels.values())
    if replays != calls * n_graphs or steps or ticked:
        raise AssertionError(
            f"{label}: {replays} replays a call for {n_graphs} graphs, "
            f"{steps} Python step calls and {ticked} wrapper launches in "
            "replays"
        )
    launches = recorded // 2 * calls
    if (eager_launches != expect or recorded != 2 * expect // calls
            or launches != expect):
        raise AssertionError(
            f"{label}: {kernel} launches {eager_launches} eager, "
            f"{recorded} in the warm-up and capture of one call "
            f"({calls} a replayed set); the plan gives {expect}"
        )
    if not (0 < seen <= expect and 0 < eager_seen <= expect):
        raise AssertionError(
            f"{label}: the profiler saw {kernel} {seen} times in a "
            f"replayed call, {eager_seen} eager; the plan gives {expect}"
        )
    _fresh_cache()
    times = _in_turns(label, {"captured": call, "eager": eager}, pull,
                      passes)
    walls = {k: float(np.median(ts)) for k, ts in times.items()}
    busy_of = {"captured": busy, "eager": eager_busy}
    profiled_of = {"captured": wall, "eager": eager_wall}
    print(
        f"# staged {label}: graphs {n_graphs} (replays a call {replays}, "
        f"Python step calls in replays {steps}), capture_s "
        f"{capture_s:.3f} (graphs' own {_capture_s(fn):.3f}), {kernel} "
        f"launches in a replayed call {launches} (recorded into the "
        f"graphs; eager {eager_launches}, plan {expect}; the profiler "
        f"saw {seen} among {records} device records, eager {eager_seen} "
        f"among {eager_records}); warm_s "
        + "; ".join(
            f"{k} {' '.join(f'{t:.4f}' for t in ts)} (best {min(ts):.4f}, "
            f"median {walls[k]:.4f}; profiled call: busy {busy_of[k]:.1f} "
            f"ms, wall {profiled_of[k]:.1f} ms, idle share "
            f"{1 - busy_of[k] / profiled_of[k]:.3f})"
            for k, ts in times.items()
        )
        + "; captured / eager best "
        f"{min(times['captured']) / min(times['eager']):.3f}"
        f"; peak: eager {eager_gib:.2f} GiB allocated, captured graphs and "
        f"buffers {pool_gib:.2f} GiB reserved",
        flush=True,
    )
    return {"launches": launches, "graphs": n_graphs, "capture_s": capture_s,
            "wall_s": min(times["captured"]), "busy_ms": busy,
            "profiled_wall_ms": wall, "profiled_launches": seen,
            "pool_gib": pool_gib}
def _sum_amp(res):
    """The amplitude summed over a batch's per-slice planes."""
    out = res.sum(0)
    return complex(out[0].item(), out[1].item())


def phase_staged_t27(dev):
    """m10-t27 through the staged contractor (captured CUDA graphs), 4
    slices a call under "vmap" and "scan", against the eager contractor
    in the same mode; relerr against the sidecar."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.ops.grouped import make_grouped_staged_contractor

    _fresh_cache()
    tree, arrays, refs = _load_instance(T27)
    n = tree.multiplicity
    planes = ctt.to_plane_tensors(arrays, dev, torch.float32)
    ids = list(range(n))
    out = {}
    for mode in ("vmap", "scan"):
        fn = make_grouped_staged_contractor(
            tree, stage_size=STAGE_SIZE, device=dev, slice_batch=n,
            slice_batch_mode=mode,
        )
        eager = ctt.make_grouped_contractor(
            tree, dev, torch.float32, slice_batch=n, slice_batch_mode=mode
        )
        label = f"{T27} {mode} ({n} slices a call, stage_size {STAGE_SIZE})"
        out[mode] = _captured_against_eager(
            label, fn, lambda: fn.precompile(planes, ids),
            lambda: fn(planes, ids), lambda: eager(planes, ids), _sum_amp,
            "gate_chain_kernel", _batched_chain_passes(fn, n),
            STAGED_PASSES,
        )
        amp = _sum_amp(fn(planes, ids))
        relerr = abs(amp - refs[n]) / abs(refs[n])
        print(f"# staged {label}: amplitude {amp.real:.12e}"
              f"{amp.imag:+.12e}j relerr {relerr:.3e}", flush=True)
        if not relerr <= AMP_RTOL:
            raise AssertionError(
                f"staged {label}: relerr {relerr:.3e} > {AMP_RTOL}"
            )
        del fn, eager
        _fresh_cache()
    return out


def phase_staged_m20(dev):
    """m20-t28 slices 0..15 through the staged contractor in "scan", 4
    slices a call: the same graphs replayed on ids 0..3, 4..7, 8..11 and
    12..15, the partial sums at 4, 8 and 16 slices held to the sidecar
    (a slice baked into a graph at capture would repeat); against the
    eager contractor in calls of the same ids."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.ops.grouped import make_grouped_staged_contractor

    _fresh_cache()
    tree, arrays, refs = _load_instance(M20)
    planes = ctt.to_plane_tensors(arrays, dev, torch.float32)
    B = M20_STAGED_BATCH
    batches = [list(range(k, k + B)) for k in range(0, M20_SLICES, B)]
    fn = make_grouped_staged_contractor(
        tree, stage_size=STAGE_SIZE, device=dev, slice_batch=B,
        slice_batch_mode="scan",
    )
    eager = ctt.make_grouped_contractor(
        tree, dev, torch.float32, slice_batch=B, slice_batch_mode="scan"
    )

    def staged():
        return torch.cat([fn(planes, ids) for ids in batches])

    def eager_calls():
        return torch.cat([eager(planes, ids) for ids in batches])

    label = (f"{M20} scan (slices 0..{M20_SLICES - 1} in calls of {B}, "
             f"stage_size {STAGE_SIZE})")
    res = _captured_against_eager(
        label, fn, lambda: fn.precompile(planes, batches[0]), staged,
        eager_calls, _sum_amp, "gate_chain_kernel",
        _batched_chain_passes(fn, M20_SLICES, B), 3, calls=len(batches),
    )
    partial = staged().cpu().double().cumsum(0)
    errs = {}
    for k, ref in sorted(refs.items()):
        amp = complex(partial[k - 1, 0].item(), partial[k - 1, 1].item())
        errs[k] = abs(amp - ref) / abs(ref)
        if not errs[k] <= AMP_RTOL:
            raise AssertionError(
                f"staged {label}: first {k} slices {amp} vs {ref}: relerr "
                f"{errs[k]:.3e} > {AMP_RTOL}"
            )
    print(f"# staged {label}: partial amplitudes "
          + " ".join(f"[{k}] relerr {e:.3e}" for k, e in sorted(errs.items())),
          flush=True)
    del fn, eager
    _fresh_cache()
    return res


def phase_staged_lattice(dev):
    """The stripped 7x7 lattice through ``make_full_contractor(...,
    autojit=True, implementation="pallas")``: the 16 slices and their
    stripped sum as one CUDA graph, against the eager contractor."""
    import cotengra_tpu_torch as ctt

    _fresh_cache()
    tree, arrays, ref = _load_lattice()
    tensors = ctt.to_tensors(arrays, dev, torch.float32)
    fn = ctt.make_full_contractor(
        tree, dev, strip_exponent=True, implementation="pallas",
        autojit=True,
    )
    eager = ctt.make_full_contractor(
        tree, dev, strip_exponent=True, implementation="pallas"
    )

    def capture():
        fn(*tensors)
        return 1

    label = f"{LATTICE} autojit ({tree.multiplicity} slices, one graph)"
    res = _captured_against_eager(
        label, fn, capture, lambda: fn(*tensors), lambda: eager(*tensors),
        _stripped_log10, "bmm_absmax_kernel",
        sum(_lattice_kernel_shapes(tree).values()) * tree.multiplicity, 3,
    )
    log10 = _stripped_log10(fn(*tensors))
    d_log10 = abs(log10 - ref["log10"])
    print(f"# staged {label}: log10 {log10:.7f} (reference "
          f"{ref['log10']:.7f}) |delta log10| {d_log10:.3e}", flush=True)
    if not (np.isfinite(log10) and d_log10 <= LOG10_ATOL):
        raise AssertionError(
            f"staged {label}: |delta log10| {d_log10:.3e} > {LOG10_ATOL}"
        )
    del fn, eager
    _fresh_cache()
    return res


def phase_staged_one_graph(dev):
    """m10-t27 under "vmap" (4 slices a call): stages of ``STAGE_SIZE``
    steps against the whole plan as one graph, in turns."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.ops.grouped import make_grouped_staged_contractor

    _fresh_cache()
    tree, arrays, refs = _load_instance(T27)
    n = tree.multiplicity
    planes = ctt.to_plane_tensors(arrays, dev, torch.float32)
    ids = list(range(n))
    fns, graphs = {}, {}
    for label, size in (("stage_size 12", STAGE_SIZE), ("one graph", None)):
        fn = make_grouped_staged_contractor(
            tree, stage_size=size or 10**9, device=dev, slice_batch=n,
            slice_batch_mode="vmap",
        )
        graphs[label] = fn.precompile(planes, ids)
        fns[label] = fn
    if graphs["one graph"] != 1:
        raise AssertionError(f"one graph: {graphs['one graph']} graphs")
    times = _in_turns(
        f"staged {T27} vmap", {k: (lambda f=f: f(planes, ids))
                               for k, f in fns.items()},
        _sum_amp, STAGED_PASSES,
    )
    amp = _sum_amp(fns["one graph"](planes, ids))
    relerr = abs(amp - refs[n]) / abs(refs[n])
    if not relerr <= AMP_RTOL:
        raise AssertionError(f"one graph: relerr {relerr:.3e} > {AMP_RTOL}")
    print(
        f"# staged {T27} vmap: "
        + "; ".join(
            f"{k} ({graphs[k]} graphs) {' '.join(f'{t:.4f}' for t in ts)} "
            f"(best {min(ts):.4f})" for k, ts in times.items()
        )
        + f"; one graph relerr {relerr:.3e}",
        flush=True,
    )
    del fns
    _fresh_cache()


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


def _warm_pass(plan_name, dev, slice_batch=None, mode="scan", n_slices=None,
               gate_mode="auto"):
    """One warm pass of a main path as a function (contractor and device
    inputs made once), ending in a host pull; with ``slice_batch``, the
    first ``n_slices`` (default ``slice_batch``) in calls of
    ``slice_batch`` slices in ``mode``; circuits with ``gate_mode``."""
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
            tree, dev, torch.float32, slice_batch=slice_batch,
            slice_batch_mode=mode, gate_mode=gate_mode,
        )
        return _calls_of(fn, planes, list(range(n_slices or slice_batch)),
                         slice_batch)
    core = ctt.make_grouped_contractor(tree, dev, torch.float32,
                                       gate_mode=gate_mode)

    def one_pass():
        out = ctt.contract_slices(tree, core, planes)
        return complex(out[0].item(), out[1].item())

    return one_pass


@contextlib.contextmanager
def _window_ranges():
    """The window steps and operator builds of the grouped executor in
    ``torch.profiler`` ranges of their own, inside the block."""
    from torch.profiler import record_function

    from cotengra_tpu_torch.ops import grouped

    saved = {}
    for name, label in (("exec_window", "window step"),
                        ("build_w4", "window operator build")):
        fn = saved[name] = getattr(grouped, name)

        def ranged(*args, _fn=fn, _label=label, **kw):
            with record_function(_label):
                return _fn(*args, **kw)

        setattr(grouped, name, ranged)
    try:
        yield ("window step", "window operator build")
    finally:
        for name, fn in saved.items():
            setattr(grouped, name, fn)


def _range_kernels(event):
    """(name, us) of every device kernel launched under a CPU event."""
    for k in event.kernels:
        yield k.name, k.duration
    for child in event.cpu_children:
        yield from _range_kernels(child)


def phase_profile(plan_name, dev, slice_batch=None, classify=None,
                  mode="scan", n_slices=None, gate_mode="auto"):
    """Device time by kernel over one warm pass of the main path,
    grouped by ``classify`` (default ``_kernel_class``); under
    ``gate_mode="window"`` also the device time of the window steps
    (their GEMMs and rotation copies) and of the operator builds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    one_pass = _warm_pass(plan_name, dev, slice_batch, mode, n_slices,
                          gate_mode)
    if slice_batch:
        plan_name = (
            f"{plan_name} {mode} {n_slices or slice_batch} slices in calls "
            f"of {slice_batch}"
        )
    if gate_mode != "auto":
        plan_name = f"{plan_name} gate_mode {gate_mode}"
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
    ranges = (_window_ranges() if gate_mode == "window"
              else contextlib.nullcontext(()))
    with ranges as names, profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
    ) as prof:
        t0 = time.perf_counter()
        one_pass()
        prof_wall = time.perf_counter() - t0

    per_kernel = {}
    for e in prof.events():
        # the profiler mirrors a record_function range on the device's
        # timeline: not a kernel
        if e.device_type != DeviceType.CUDA or e.name in names:
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
    for label in names:
        # the kernels under the range, by class (the window GEMMs are
        # the "GEMM" class of "window step")
        in_range = {}
        for e in prof.events():
            if e.device_type == DeviceType.CPU and e.name == label:
                for name, us in _range_kernels(e):
                    cls = classify(name)
                    c_ms, c_n = in_range.get(cls, (0.0, 0))
                    in_range[cls] = (c_ms + us / 1e3, c_n + 1)
        print(
            f"#   under {label}: " + ", ".join(
                f"{cls} {ms:.3f} ms x {n}" for cls, (ms, n) in sorted(
                    in_range.items(), key=lambda kv: -kv[1][0])
            ),
            flush=True,
        )
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
        phase_profile(T27, dev, slice_batch=4, mode="vmap")
        phase_profile(M20, dev, slice_batch=_m20_vmap_batch(dev),
                      mode="vmap", n_slices=M20_SLICES)
        phase_profile(T27, dev, slice_batch=4, mode="vmap",
                      gate_mode="window")
        return 0
    chain_rows = phase_chains(dev)
    chain_launches, t27_tree = phase_main_path(T27, 4, dev)
    phase_main_path("sycamore53_m10_t29", 1, dev)
    bmm_rows = phase_bmm(dev)
    bmm_launches = phase_lattice(dev)
    phase_t27_stripped(dev)
    phase_t27_batched(dev)
    m20_rows = phase_chains_m20(dev)
    m20_launches, m20_tree = phase_m20(dev)
    phase_front_lattice(dev)
    phase_front_t27(dev)
    auto_plan_s = phase_front_auto(dev)
    svd_rows, qr_rows = phase_compressed(dev)
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
    mixed_lattice = phase_mixed_lattice(dev)
    phase_mixed_compressed(dev)
    example_launches = phase_example(dev)
    multi_launches, multi_plan_s = phase_multi(dev)
    vmap_rows = phase_vmap_chains(dev)
    vmap_t27_launches, t27_modes = phase_vmap_t27(dev)
    vmap_m20_launches, m20_batch, m20_modes = phase_vmap_m20(dev)
    small_tree, small_launches, small_modes = phase_small_slices(dev)
    phase_calibration(dev, vmap_measured(
        t27_modes, m20_batch, m20_modes, small_tree, small_modes,
    ))
    gpu_launches = phase_gpu_planned(dev)
    window_launches, window_s = phase_window_t27(dev)
    fused_launches, fused_s = phase_fused_t27(dev)
    phase_lookahead_t27(dev)
    phase_window_m20(dev)
    phase_engine_model(window_s, fused_s)
    phase_plots({T27: t27_tree, M20: m20_tree})
    staged_t27 = phase_staged_t27(dev)
    staged_m20 = phase_staged_m20(dev)
    staged_lattice = phase_staged_lattice(dev)
    phase_staged_one_graph(dev)
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
            # all slices of the example's m10 plan and of the multi plan
            # sliced over its configurations
            "example_m10_launches": example_launches,
            "multi_m10_launches": multi_launches,
            # "vmap": one launch a pass for a batch of slices; t27 (4
            # slices a call), m20 (16 slices in calls of vmap_m20_batch),
            # the 2^22-sliced m10 (all slices in calls of 16), and the
            # minimize="gpu" m10 tree slice by slice
            "vmap_t27_launches": vmap_t27_launches,
            "vmap_m20_launches": vmap_m20_launches,
            "vmap_m20_batch": m20_batch,
            "small_slices_vmap_launches": small_launches,
            "gpu_m10_launches": gpu_launches,
            # the batched kernel on every t27 chain at 4 slices (summed)
            # and on the largest m20 chain at 16 (the last row): error,
            # ms per batched pass, 4 (16) x one slice's ms, the bound
            "vmap_max_abs_err": max(r[0] for r in vmap_rows),
            "vmap_t27_ms": sum(r[1] for r in vmap_rows[:-1]),
            "vmap_t27_single_x4_ms": sum(r[2] for r in vmap_rows[:-1]),
            "vmap_t27_bound_ms": sum(r[3][0] for r in vmap_rows[:-1]),
            "vmap_m20_chain_ms": vmap_rows[-1][1],
            "vmap_m20_chain_single_x16_ms": vmap_rows[-1][2],
            "vmap_m20_chain_bound_ms": vmap_rows[-1][3][0],
            # t27 (4 slices) with gate_mode="window" (slice by slice and
            # under vmap: none), and with fuse_gates under "inplace"
            # (one scan call of 4 slices: 13 a slice, as unfused)
            "window_t27_chain_launches": window_launches,
            "fused_t27_launches": fused_launches,
            # inside replayed CUDA graphs (the staged contractor; the
            # profiler's count of one call): t27 4 slices a call under
            # vmap and scan, m20 slices 0..15 in calls of 4 under scan
            "captured_t27_vmap_launches": staged_t27["vmap"]["launches"],
            "captured_t27_scan_launches": staged_t27["scan"]["launches"],
            "captured_m20_scan_launches": staged_m20["launches"],
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
            # the 7x7 with one complex input: its real x real steps
            "mixed_lattice_launches": mixed_lattice,
            # the lattice's 16 slices as one CUDA graph (autojit),
            # counted by the profiler in one replayed call
            "captured_lattice_launches": staged_lattice["launches"],
        },
        {
            # per value of the compressed 16x16 lattice (float64): its
            # truncation cores one after another; errors against the plain
            # version on the CPU in float64 on every core (s absolute and
            # over the largest; the truncation from the plain one's and
            # above the optimum, over ||M||), and the library's s error
            "name": "svd_core",
            "route": "cuda",
            "source": "cotengra_tpu_torch/csrc/svd_core.cu",
            # no TPU kernel: the JAX package takes XLA's SVD
            "replaces": None,
            **svd_rows[torch.float64],
            "f32_max_err_over_s0": svd_rows[torch.float32]["max_err_over_s0"],
            "f32_ms": svd_rows[torch.float32]["ms"],
            "f32_plain_ms": svd_rows[torch.float32]["plain_ms"],
        },
        {
            # per value of the compressed 16x16 lattice (float64): its
            # truncations one after another, both sides of each factored
            # in one launch and both Qs applied in another; R's Gram, Q's
            # orthonormality, A^T Q C against R^T C and the truncation
            # above the optimum, against the plain version on the card;
            # the host's time behind a 200 ms spin, the kernel's two
            # launches against torch.linalg.qr of the largest side
            "name": "qr_core",
            "route": "cuda",
            "source": "cotengra_tpu_torch/csrc/qr_core.cu",
            # no TPU kernel: the JAX package takes XLA's QR
            "replaces": None,
            **qr_rows[torch.float64],
            "f32_max_gram_err": qr_rows[torch.float32]["max_gram_err"],
            "f32_max_orth_err": qr_rows[torch.float32]["max_orth_err"],
            "f32_max_tie_err": qr_rows[torch.float32]["max_tie_err"],
            "f32_max_truncation_excess":
                qr_rows[torch.float32]["max_truncation_excess"],
            "f32_ms": qr_rows[torch.float32]["ms"],
            "f32_plain_ms": qr_rows[torch.float32]["plain_ms"],
            "host_ms_behind_spin": qr_rows["async"]["kernel"],
            "library_host_ms_behind_spin": qr_rows["async"]["library"],
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
        "multi_m10_plan_s": multi_plan_s,
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
