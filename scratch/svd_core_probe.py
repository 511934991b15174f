"""Probes of the truncation-core SVD on the card.

    python scratch/svd_core_probe.py library   # cuSOLVER per core size,
                                               # and the plan's real cores
    python scratch/svd_core_probe.py kernel    # the kernel against the
                                               # plain version, and timed
    python scratch/svd_core_probe.py graded    # sweeps to converge on
                                               # graded cores
    python scratch/svd_core_probe.py async     # which calls block the host

``library`` times ``torch.linalg.svd`` (cuSOLVER) on random cores of each
size the 16x16 bond-4 lattice at chi=32 truncates, and saves one real core
of each size of that plan (the port's greedy compressed plan, phase 16's
inputs) to ``chiprun_out/svd_cores/``; ``kernel`` and ``graded`` read them
back where they exist. Times are CUDA events over repeated calls, after a
warm-up, on the card named in the first line.
"""

import collections
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SIZES = [(1, 1), (32, 32), (64, 64), (128, 128), (256, 32), (256, 128),
         (256, 256), (512, 512), (1024, 1024)]
OUT = os.path.join("chiprun_out", "svd_cores")
CHI = 32


def _ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _reps(m, n):
    return max(3, min(50, int(2e8 / (m * n * max(m, n)) + 3)))


def _card():
    import subprocess

    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(f"# card: {q}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)


def _graded(m, n, dtype, gen, low=1e-8):
    """A random core with singular values 1 .. low (geometric)."""
    p = min(m, n)
    a = torch.linalg.qr(torch.randn(m, p, generator=gen, dtype=torch.float64,
                                    device="cuda"))[0]
    b = torch.linalg.qr(torch.randn(n, p, generator=gen, dtype=torch.float64,
                                    device="cuda"))[0]
    s = torch.logspace(0, float(np.log10(low)), p, dtype=torch.float64,
                       device="cuda")
    return ((a * s) @ b.T).to(dtype).contiguous()


def _real_cores():
    """The plan's cores, one of each shape, on the card (float64)."""
    cores = {}
    if os.path.isdir(OUT):
        for name in sorted(os.listdir(OUT)):
            if name.endswith(".npy"):
                cores[name[:-4]] = torch.as_tensor(
                    np.load(os.path.join(OUT, name)), device="cuda"
                )
    return cores


def library():
    _card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    for dtype in (torch.float64, torch.float32):
        for m, n in SIZES:
            M = _graded(m, n, dtype, gen)
            ms = _ms(lambda: torch.linalg.svd(M, full_matrices=False),
                     _reps(m, n))
            print(f"library svd {str(dtype)[6:]} {m}x{n}: {ms:.3f} ms",
                  flush=True)
    dump_cores()


def dump_cores():
    """Run the 16x16 lattice's compressed contraction once on the card,
    keeping every core's shape and one core of each shape."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.ops import compressed, svd_core
    from cotengra_tpu_torch.pathfinders.compressed import greedy_compressed_ssa
    from cotengra_tpu_torch.tree_compressed import ContractionTreeCompressed

    inputs, output, shapes, size_dict = ctt.lattice_equation([16, 16], d_min=4)
    rng = np.random.default_rng(0)
    arrays = [np.ones(s) + 0.05 * rng.normal(size=s) for s in shapes]
    tree = ContractionTreeCompressed.from_path(
        inputs, output, size_dict,
        ssa_path=greedy_compressed_ssa(inputs, output, size_dict, chi=CHI),
    )
    seen = collections.Counter()
    os.makedirs(OUT, exist_ok=True)
    plain = svd_core.svd_topk_plain

    def recording(M, k):
        shape = tuple(M.shape)
        if not seen[shape]:
            np.save(os.path.join(OUT, f"core_{shape[0]}x{shape[1]}.npy"),
                    M.cpu().numpy())
        seen[shape] += 1
        return plain(M, k)

    compressed.svd_topk = recording
    try:
        tensors = [torch.as_tensor(a, device="cuda") for a in arrays]
        m, e = tree.contract_compressed(tensors, chi=CHI, strip_exponent=True)
        print(f"# value log10 {np.log10(abs(m.item())) + e.item()!r}")
    finally:
        compressed.svd_topk = svd_core.svd_topk
    print(f"# cores {sum(seen.values())}: "
          + ", ".join(f"{a}x{b} x{c}" for (a, b), c in sorted(seen.items())),
          flush=True)


def _check(M, k, U, s, V):
    """Errors of the kernel's top-k against the library's singular values:
    max |s - s_ref| / s_ref[0], the truncation's Frobenius error above the
    optimum over ||M||, and the kept columns' loss of orthonormality."""
    ref = torch.linalg.svdvals(M.double())
    Md = M.double()
    s_err = ((s.double() - ref[:k]).abs().max() / ref[0].clamp_min(1e-300)).item()
    resid = torch.linalg.norm(Md - (U.double() * s.double()) @ V.double().T)
    opt = torch.sqrt((ref[k:] ** 2).sum())
    excess = ((resid - opt) / torch.linalg.norm(Md).clamp_min(1e-300)).item()
    live = s.double() > 1e-12 * ref[0]
    Uk, Vk = U.double()[:, live], V.double()[:, live]
    eye = torch.eye(int(live.sum()), dtype=torch.float64, device=M.device)
    orth = max((Uk.T @ Uk - eye).abs().max().item() if live.any() else 0.0,
               (Vk.T @ Vk - eye).abs().max().item() if live.any() else 0.0)
    return s_err, excess, orth


def kernel():
    from cotengra_tpu_torch.ops import svd_core

    _card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    cases = [(f"graded {m}x{n}", _graded(m, n, torch.float64, gen))
             for m, n in SIZES]
    cases += [(f"real {k}", v) for k, v in _real_cores().items()]
    for dtype in (torch.float64, torch.float32):
        for name, M in cases:
            M = M.to(dtype).contiguous()
            k = min(CHI, *M.shape)
            U, s, V = svd_core.svd_topk_cuda(M, k)
            torch.cuda.synchronize()
            sweeps, conv = svd_core.svd_topk_cuda.ctl[2:4].tolist()
            s_err, excess, orth = _check(M, k, U, s, V)
            ms = _ms(lambda: svd_core.svd_topk_cuda(M, k), _reps(*M.shape))
            lib = _ms(lambda: torch.linalg.svd(M, full_matrices=False),
                      _reps(*M.shape))
            print(f"kernel {str(dtype)[6:]} {name} k={k}: sweeps {sweeps} "
                  f"converged {conv} s_err {s_err:.2e} excess {excess:.2e} "
                  f"orth {orth:.2e} kernel_ms {ms:.3f} library_ms {lib:.3f}",
                  flush=True)


# how often the plan truncates a core of each shape, a value
PLAN_CORES = {"core_1x1": 1, "core_32x32": 1, "core_64x64": 22,
              "core_128x128": 10, "core_256x32": 1, "core_256x128": 1,
              "core_256x256": 23, "core_512x512": 11, "core_1024x1024": 2}


def graded():
    """Sweeps to converge, and the errors, on graded cores (singular values
    1 .. 1e-8 and 1 .. 1e-14) at 256 to 1024, and the plan's real cores, in
    both dtypes; and the kernel's count of launches that hit its cap. The
    cap and the other settings are compile-time constants of
    ``csrc/svd_core.cu``: build a variant to compare them."""
    from cotengra_tpu_torch.ops import svd_core

    _card()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2468)
    cases = [(f"graded 1e{int(np.log10(low))} {n}x{n}",
              _graded(n, n, torch.float64, gen, low))
             for low in (1e-8, 1e-14) for n in (256, 512, 1024)]
    cases += [(f"real {k}", v) for k, v in _real_cores().items()]
    total = {}
    for dtype in (torch.float64, torch.float32):
        for name, M in cases:
            M = M.to(dtype).contiguous()
            k = min(CHI, *M.shape)
            U, s, V = svd_core.svd_topk_cuda(M, k)
            torch.cuda.synchronize()
            sweeps, conv = svd_core.svd_topk_cuda.ctl[2:4].tolist()
            s_err, excess, orth = _check(M, k, U, s, V)
            ms = _ms(lambda: svd_core.svd_topk_cuda(M, k), _reps(*M.shape))
            key = name.removeprefix("real ")
            total[dtype] = total.get(dtype, 0.0) + ms * PLAN_CORES.get(key, 0)
            print(f"graded {str(dtype)[6:]} {name}: sweeps {sweeps} converged "
                  f"{conv} s_err {s_err:.1e} excess {excess:.1e} orth "
                  f"{orth:.1e} ms {ms:.3f}", flush=True)
    print("graded: a value's real cores "
          + " ".join(f"{str(d)[6:]} {t:.1f} ms" for d, t in total.items())
          + f"; launches at the cap {svd_core.unconverged('cuda')}",
          flush=True)


def asyncprobe():
    """Whether each call of a truncation returns to the host before the
    card has run it: each issued behind a ~0.2 s spin on the card, with the
    host's time in the call and until the card is idle."""
    from cotengra_tpu_torch.ops.svd_core import svd_topk_cuda

    _card()
    f64 = dict(dtype=torch.float64, device="cuda")
    core = torch.randn(256, 256, **f64)
    ops = {}
    for rows, d in ((4096, 64), (65536, 256), (262144, 256), (131072, 1024)):
        A = torch.randn(rows, d, **f64)
        ops[f"qr {rows}x{d}"] = lambda A=A: torch.linalg.qr(A)
    B = torch.randn(131072, 1024, **f64)
    ops["matmul 131072x1024 @ 1024x32"] = lambda: B @ core[:, :32].repeat(4, 1)
    ops["svd_topk_cuda 256x256"] = lambda: svd_topk_cuda(core, 32)
    ops["linalg.svd 256x256"] = lambda: torch.linalg.svd(core, full_matrices=False)
    for name, fn in ops.items():
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(int(4e8))
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        print(f"async {name}: host in the call {1e3 * (t1 - t0):.3f} ms, "
              f"until the card is idle {1e3 * (t2 - t0):.3f} ms", flush=True)


if __name__ == "__main__":
    t0 = time.perf_counter()
    {"library": library, "kernel": kernel, "graded": graded,
     "dump": dump_cores, "async": asyncprobe}[sys.argv[1]]()
    print(f"# {sys.argv[1]} done in {time.perf_counter() - t0:.1f} s")
