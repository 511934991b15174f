#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``cotengra_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py              # the smoke run below
    python3 chip_smoke.py --profile    # phases 1-2, then where the time goes

Run from the root of a checkout. Phases:

1. the card's name and power limit, torch and CUDA versions;
2. build the CUDA kernels from ``cotengra_tpu_torch/csrc`` (nvcc,
   sm_90a) and print the build seconds;
3. the gate-chain kernel against its plain PyTorch version on every
   chain of the Sycamore-53 m=10 t27 plan at full size, float32 inputs
   from a fixed numpy seed: max|kernel - plain| <= 1e-5 * max|plain|,
   with both times from CUDA events;
4. the main path: the Sycamore-53 m=10 amplitude over all 4 slices of
   ``plans/sycamore53_m10_t27.json`` in float32 planes, held to the
   complex128 reference amplitude at relerr <= 1e-5, with the chain
   kernel's launch count and the warm time-to-amplitude;
5. the same for the unsliced ``plans/sycamore53_m10_t29.json`` (no
   chains: the pair and fallback steps only);
6. one JSON line of kernel results, then the last line
   ``{"ok": true, "device": {...}}``.

Any failed phase raises, and the script exits non-zero without the last
line. It needs a CUDA device and never falls back to the CPU.

``--profile`` instead runs ``torch.profiler`` over one warm pass of each
main path and prints the median wall time of 5 unprofiled passes, the device's
busy time and idle share, and every device kernel's time grouped by
class (the breakdown in ``PERF.md`` section 5).
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CHAIN_RTOL = 1e-5   # float32 sums in another order: a few ulps per gate
AMP_RTOL = 1e-5     # float32 planes at full fp32 matmul precision
SEED = 1234
PROFILE_WALL_PASSES = 5


def _load_instance(plan_name):
    """The Sycamore-53 m=10 network (seed 42, absorbed as the benchmark
    does), the plan's tree, and its reference amplitudes."""
    from cotengra_tpu.models.circuits import rand_circuit_tn
    from cotengra_tpu.utils.io import load_tree

    from cotengra_tpu_torch import absorb_simple_tensors

    inputs, output, _, _, arrays = rand_circuit_tn(53, 10, seed=42)
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


def phase_build():
    from cotengra_tpu_torch.ops._build import library_path, load_library

    t0 = time.perf_counter()
    load_library()
    print(
        f"# build: {library_path().name} in "
        f"{time.perf_counter() - t0:.2f}s",
        flush=True,
    )


def phase_chains(dev):
    """Every chain of the t27 plan, kernel vs plain, at full size."""
    from cotengra_tpu_torch.ops.gate_chains import (
        run_chain_cuda,
        run_chain_plain,
    )

    tree, _, _ = _load_instance("sycamore53_m10_t27")
    recs = _chain_recs(tree)
    rng = np.random.default_rng(SEED)
    rows = []
    for ci, rec in enumerate(recs):
        spec = rec.spec
        n_in = spec.gate_strides[0].numel_in
        x = torch.from_numpy(
            rng.standard_normal(2 * n_in, dtype=np.float32)
        ).to(dev)
        ys = [
            torch.from_numpy(
                rng.standard_normal((2, K, N), dtype=np.float32)
            ).to(dev)
            for _, _, K, N in rec.ys
        ]
        plain = run_chain_plain(spec, x, ys)
        kern = run_chain_cuda(spec, x, ys)
        torch.cuda.synchronize()
        err = (kern - plain).abs().max().item()
        scale = plain.abs().max().item()
        if not (np.isfinite(err) and err <= CHAIN_RTOL * scale):
            raise AssertionError(
                f"chain {ci}: max|kernel-plain| = {err:.3e} > "
                f"{CHAIN_RTOL} * {scale:.3e}"
            )
        reps = 3 if n_in >= 2**26 else 10
        plain_ms = _cuda_ms(lambda: run_chain_plain(spec, x, ys), reps)
        ms = _cuda_ms(lambda: run_chain_cuda(spec, x, ys), reps)
        gates = [(g.kdims, g.ndims) for g in spec.gate_strides]
        kn = [
            (int(np.prod([d[0] for d in k])), int(np.prod([d[0] for d in n])))
            for k, n in gates
        ]
        print(
            f"# chain {ci:2d}: numel 2^{int(np.log2(n_in))} gates (K,N) "
            f"{kn} max_abs_err {err:.3e} (max|plain| {scale:.3e}) "
            f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms",
            flush=True,
        )
        rows.append((err, ms, plain_ms))
        del x, ys, plain, kern
    torch.cuda.empty_cache()
    return rows


def phase_main_path(plan_name, n_ref, dev, passes=3):
    """contract_tree over all slices, checked against the sidecar."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.ops.gate_chains import run_chain_cuda

    tree, arrays, refs = _load_instance(plan_name)
    if tree.multiplicity != n_ref or n_ref not in refs:
        raise AssertionError(
            f"{plan_name}: {tree.multiplicity} slices, sidecar has "
            f"{sorted(refs)}"
        )
    expect = sum(len(rec.ys) for rec in _chain_recs(tree)) * n_ref
    torch.cuda.reset_peak_memory_stats()

    run_chain_cuda.launches = 0
    amp = ctt.contract_tree(tree, arrays, device=dev)
    torch.cuda.synchronize()
    launches = run_chain_cuda.launches

    amp0 = complex(amp.cpu().item())
    ref = refs[n_ref]
    relerr = abs(amp0 - ref) / abs(ref)
    if launches != expect:
        raise AssertionError(
            f"{plan_name}: {launches} chain-kernel launches, plan has "
            f"{expect}"
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


def _kernel_class(name):
    if "gate_apply_kernel" in name:
        return "gate-chain kernel"
    if "gemv" in name:
        return "gemv"
    if "gemm" in name:
        return "GEMM"
    if "copy" in name.lower():
        return "copies"
    return "other"


def phase_profile(plan_name, dev):
    """Device time by kernel over one warm pass of the main path."""
    import cotengra_tpu_torch as ctt
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tree, arrays, _ = _load_instance(plan_name)
    core = ctt.make_grouped_contractor(tree, dev, torch.float32)
    planes = ctt.to_plane_tensors(arrays, dev, torch.float32)

    def one_pass():
        out = ctt.contract_slices(tree, core, planes)
        return complex(out[0].item(), out[1].item())

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
    by_class = {}
    for name, (ms, n) in per_kernel.items():
        cls = _kernel_class(name)
        c_ms, c_n = by_class.get(cls, (0.0, 0))
        by_class[cls] = (c_ms + ms, c_n + n)
    for cls, (ms, n) in sorted(by_class.items(), key=lambda kv: -kv[1][0]):
        print(f"#   {cls}: {ms:.3f} ms x {n}", flush=True)
        for name, (k_ms, k_n) in sorted(
            per_kernel.items(), key=lambda kv: -kv[1][0]
        ):
            if _kernel_class(name) == cls:
                print(f"#     {k_ms:9.3f} ms x {k_n:5d}  {name[:110]}",
                      flush=True)


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
    phase_build()
    if args == ["--profile"]:
        phase_profile("sycamore53_m10_t27", dev)
        phase_profile("sycamore53_m10_t29", dev)
        return 0
    rows = phase_chains(dev)
    launches = phase_main_path("sycamore53_m10_t27", 4, dev)
    phase_main_path("sycamore53_m10_t29", 1, dev)
    kernels = [{
        "name": "gate_chain",
        "route": "cuda",
        "source": "cotengra_tpu_torch/csrc/gate_chain.cu",
        "replaces": "cotengra_tpu/ops/pallas_gates.py:557",
        "launches": launches,
        "max_abs_err": max(r[0] for r in rows),
        "ms": sum(r[1] for r in rows),
        "plain_ms": sum(r[2] for r in rows),
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
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
