"""Probes of the truncation's QR kernel (``csrc/qr_core.cu``) on the card.

    python scratch/qr_core_probe.py check      # the kernel against LAPACK on
                                               # the CPU: ragged, wide, tall,
                                               # rank-deficient, paired
    python scratch/qr_core_probe.py value [f32] [check]
                                               # a value's 72 truncations in
                                               # turn: kernel against
                                               # torch.linalg.qr + Q C and
                                               # torch.geqrf + torch.ormqr,
                                               # per shape
    python scratch/qr_core_probe.py shapes [f32]  # each of the 32 shapes
                                               # beside a (chi, n) partner,
                                               # kernel against
                                               # torch.linalg.qr + Q C
    python scratch/qr_core_probe.py singles    # an operand and its (chi, n)
                                               # partner a launch
    python scratch/qr_core_probe.py async      # does the host wait

``value`` takes the truncation pairs of the committed plan of
``tnbench/configs/lattice16x16-d4-chi32.json`` (counted on meta tensors),
random operands of those shapes, and times, by CUDA events after a
warm-up, the kernel's two launches (factor both sides, apply both Qs),
the library's route (``torch.linalg.qr`` twice, ``Q @ (U sqrt(s))``
twice) and the library's Householder route without Q formed
(``torch.geqrf`` twice, ``torch.ormqr`` of ``[U sqrt(s); 0]`` twice) with
the same U, s, V. ``async`` launches a 200 ms spin on the card and then
one truncation's QR work of the (131072, 1024) operand by each route, and
prints the host's time in each call. The card is named in the first line.
"""

import io
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from cotengra_tpu_torch.ops import compressed  # noqa: E402
from cotengra_tpu_torch.ops.qr_core import (  # noqa: E402
    qr_apply_cuda,
    qr_factor_cuda,
)

CHI = 32
FP64_TENSOR_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def _card():
    import subprocess

    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(f"# card: {q}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)


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


def value_pairs():
    """The plan's truncations in order: ``[(shape_a, shape_b, k)]``."""
    from cotengra_tpu_torch import lattice_equation, load_tree
    from cotengra_tpu_torch.tree_compressed import ContractionTreeCompressed

    with open(os.path.join(ROOT, "tnbench/configs/lattice16x16-d4-chi32.json")) as f:
        cfg = json.load(f)
    inputs, output, shapes, size_dict = lattice_equation([16, 16], d_min=4)
    t = load_tree(io.StringIO(json.dumps(cfg["plan"])), inputs, output, size_dict)
    tree = ContractionTreeCompressed(t.inputs, t.output, t.size_dict,
                                     children=t.children)
    pairs = []

    def record(A, B, chi):
        pairs.append((tuple(A.shape), tuple(B.shape), chi))
        return (torch.empty((A.shape[0], chi), device="meta", dtype=A.dtype),
                torch.empty((B.shape[0], chi), device="meta", dtype=B.dtype))

    core, resolve = compressed._compress_pair_core, compressed.resolve_device
    compressed._compress_pair_core = record
    compressed.resolve_device = lambda d: torch.device("meta")
    try:
        arrays = [torch.empty(s, dtype=torch.float64, device="meta") for s in shapes]
        tree.contract_compressed(arrays, chi=CHI, strip_exponent=True, device="cpu")
    finally:
        compressed._compress_pair_core, compressed.resolve_device = core, resolve
    return pairs


def bound_ms(m, n):
    """geqrf's 2 m n^2 - 2 n^3 / 3 flops at the FP64 tensor rate, or the
    operand's bytes at the HBM rate, the larger (n <= m; else swapped)."""
    k = min(m, n)
    flops = 2 * m * n * k - 2 * k**3 / 3 if m >= n else 2 * n * m * m - 2 * m**3 / 3
    return max(flops / FP64_TENSOR_FLOPS, 8 * m * n / HBM_BYTES_PER_S) * 1e3


def _operand(shape, kind, dtype, gen):
    m, n = shape
    if kind == "rank-deficient":
        r = max(1, min(m, n) // 4)
        A = (torch.randn((m, r), generator=gen, dtype=torch.float64)
             @ torch.randn((r, n), generator=gen, dtype=torch.float64))
    else:
        A = torch.randn((m, n), generator=gen, dtype=torch.float64)
    return A.to(dtype)


def errors(A, R, X, C, s):
    """Against LAPACK on the CPU in float64: R row by row up to sign, over
    ||A||; X = Q [C sqrt(s); 0] against Q_lapack [D C sqrt(s); 0] (D the
    row signs), over ||X||; and ||X^T X - (C sqrt s)^T (C sqrt s)|| (Q
    orthonormal on the span), over its norm."""
    Ad = A.double().cpu()
    Q_l, R_l = torch.linalg.qr(Ad)
    Rd, Xd = R.double().cpu(), X.double().cpu()
    d = torch.diagonal(Rd) * torch.diagonal(R_l)
    d = torch.where(d < 0, -1.0, 1.0).double()
    scale = max(float(torch.linalg.norm(Ad)), 1e-300)
    r_err = float(torch.linalg.norm(d[:, None] * Rd - R_l)) / scale
    Cs = C.double().cpu() * torch.sqrt(s.double().cpu())[None, :]
    want = Q_l @ (d[:, None] * Cs)
    x_err = float(torch.linalg.norm(Xd - want)) / max(
        float(torch.linalg.norm(want)), 1e-300)
    g = Cs.T @ Cs
    o_err = float(torch.linalg.norm(Xd.T @ Xd - g)) / max(
        float(torch.linalg.norm(g)), 1e-300)
    return r_err, x_err, o_err


def run_pair(A, B, chi, gen):
    Ra, Rb, fac = qr_factor_cuda(A, B)
    ka, kb = Ra.shape[0], Rb.shape[0]
    U = torch.randn((ka, chi), generator=gen, dtype=torch.float64).to(A.dtype)
    s = (torch.rand(chi, generator=gen, dtype=torch.float64) + 0.5).to(A.dtype)
    dev = A.device
    U, s = U.to(dev), s.to(dev)
    V = torch.randn((kb, chi), generator=gen, dtype=torch.float64).to(A.dtype).to(dev)
    Xa, Xb = qr_apply_cuda(fac, U, V, s)
    return (Ra, Rb), (Xa, Xb), (U, V), s


def check():
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    cases = [
        [(300, 100), (32, 100)], [(100, 300), (32, 300)], [(97, 64), (64, 97)],
        [(1, 5), (5, 1)],
        [(33, 33), (2048, 33)], [(4096, 256), (256, 256)],
        [(20000, 70), (700, 70)], [(1, 1024), (1, 1024)], [(32, 512)] * 2,
        [(8192, 512), (512, 512)], [(65536, 128), (32, 128)],
    ]
    worst = {}
    for dtype in (torch.float64, torch.float32):
        for kind in ("random", "rank-deficient"):
            for shapes in cases:
                ops = [_operand(sh, kind, dtype, gen).to(dev) for sh in shapes]
                chi = min(CHI, *[min(sh) for sh in shapes])
                Rs, Xs, Cs, s = run_pair(ops[0], ops[1], chi, gen)
                torch.cuda.synchronize()
                for A, R, X, C in zip(ops, Rs, Xs, Cs):
                    e = errors(A, R, X, C, s)
                    key = (str(dtype)[6:], kind)
                    worst[key] = [max(a, b) for a, b in zip(worst.get(key, (0, 0, 0)), e)]
                    print(f"# check {key[0]} {kind} {tuple(A.shape)} with "
                          f"{[tuple(o.shape) for o in ops]}: R {e[0]:.2e} "
                          f"QC {e[1]:.2e} orth {e[2]:.2e}", flush=True)
    for key, e in worst.items():
        print(f"# worst {key}: R {e[0]:.2e} QC {e[1]:.2e} orth {e[2]:.2e}",
              flush=True)
    tol = {"float64": 1e-12, "float32": 1e-5}
    bad = [k for k, e in worst.items()
           if e[0] > tol[k[0]] or e[2] > tol[k[0]]
           or (k[1] == "random" and e[1] > 1e3 * tol[k[0]])]
    print(json.dumps({"check_ok": not bad, "bad": bad}), flush=True)


def householder(A, B, U, V, s):
    """The library's Householder route with Q applied, not formed:
    ``torch.geqrf`` of each side, then ``torch.ormqr`` of ``[U sqrt(s);
    0]`` and ``[V sqrt(s); 0]``."""
    sq = torch.sqrt(s)
    out = []
    for X, C in ((A, U), (B, V)):
        a, tau = torch.geqrf(X)
        pad = torch.zeros((X.shape[0], C.shape[1]), dtype=X.dtype,
                          device=X.device)
        pad[:C.shape[0]] = C * sq[None, :]
        out.append(torch.ormqr(a, tau, pad))
    return out


def value(dtype, with_check):
    dev = torch.device("cuda")
    pairs = value_pairs()
    gen = torch.Generator().manual_seed(1)
    ops = []
    for sa, sb, k in pairs:
        A = _operand(sa, "random", dtype, gen).to(dev)
        B = _operand(sb, "random", dtype, gen).to(dev)
        ka, kb = min(sa), min(sb)
        U = torch.randn((ka, k), generator=gen, dtype=torch.float64).to(dtype).to(dev)
        V = torch.randn((kb, k), generator=gen, dtype=torch.float64).to(dtype).to(dev)
        s = (torch.rand(k, generator=gen, dtype=torch.float64) + 0.5).to(dtype).to(dev)
        ops.append((A, B, U, V, s))
    torch.cuda.synchronize()

    def kernel(A, B, U, V, s):
        _, _, fac = qr_factor_cuda(A, B)
        return qr_apply_cuda(fac, U, V, s)

    def library(A, B, U, V, s):
        Qa, _ = torch.linalg.qr(A)
        Qb, _ = torch.linalg.qr(B)
        sq = torch.sqrt(s)
        return Qa @ (U * sq[None, :]), Qb @ (V * sq[None, :])

    by_shape = {}
    for (sa, sb, k), op in zip(pairs, ops):
        key = (sa, sb)
        if key in by_shape:
            by_shape[key][0] += 1
            continue
        reps = max(2, min(20, int(3e9 / (sa[0] * sa[1] * min(sa) + 1))))
        km = _ms(lambda: kernel(*op), reps)
        lm = _ms(lambda: library(*op), reps)
        hm = _ms(lambda: householder(*op), reps)
        by_shape[key] = [1, km, lm, hm]
    t_k, t_l, t_h = (sum(row[0] * row[i] for row in by_shape.values())
                     for i in (1, 2, 3))
    for (sa, sb), (c, km, lm, hm) in sorted(by_shape.items(),
                                            key=lambda x: -x[1][0] * x[1][1]):
        print(f"# value {str(dtype)[6:]} pair {sa} {sb} x{c}: kernel_ms {km:.3f} "
              f"library_ms {lm:.3f} geqrf_ormqr_ms {hm:.3f} bound_ms "
              f"{bound_ms(*sa) + bound_ms(*sb):.4f}", flush=True)
    value_k = _ms(lambda: [kernel(*op) for op in ops], 2)
    value_l = _ms(lambda: [library(*op) for op in ops], 2)
    value_h = _ms(lambda: [householder(*op) for op in ops], 2)
    b = sum(bound_ms(*sa) + bound_ms(*sb) for sa, sb, _ in pairs)
    print(f"# value {str(dtype)[6:]}: 72 truncations in turn kernel_ms "
          f"{value_k:.3f} library_ms {value_l:.3f} geqrf_ormqr_ms "
          f"{value_h:.3f} (per-shape sums {t_k:.3f} / {t_l:.3f} / {t_h:.3f}) "
          f"bound_ms {b:.4f}", flush=True)
    if with_check:
        worst = [0.0, 0.0, 0.0]
        for (sa, sb, k), (A, B, U, V, s) in zip(pairs, ops):
            if sa[0] * sa[1] > 2**25 and sa != (131072, 1024):
                continue
            Ra, Rb, fac = qr_factor_cuda(A, B)
            Xa, Xb = qr_apply_cuda(fac, U, V, s)
            for X_, R_, C_, O_ in ((Xa, Ra, U, A), (Xb, Rb, V, B)):
                e = errors(O_, R_, X_, C_, s)
                worst = [max(a, b) for a, b in zip(worst, e)]
        print(f"# value {str(dtype)[6:]} checked against LAPACK: R {worst[0]:.2e} "
              f"QC {worst[1]:.2e} orth {worst[2]:.2e}", flush=True)
    print(json.dumps({"value_kernel_ms": value_k, "value_library_ms": value_l,
                      "value_geqrf_ormqr_ms": value_h, "bound_ms": b, "dtype": str(dtype)[6:]}), flush=True)


def shapes(dtype):
    """Each of the 32 operand shapes of a value on its own: the kernel's
    two launches (factor, apply to a (k, 32) factor) against
    torch.linalg.qr and the product of its Q with the same factor, and
    the bound; a markdown row each."""
    import collections

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(5)
    count = collections.Counter()
    for sa, sb, _ in value_pairs():
        count[sa] += 1
        count[sb] += 1
    tot = [0.0, 0.0, 0.0]
    for shape in sorted(count, key=lambda s: -s[0] * s[1] * min(s)):
        A = _operand(shape, "random", dtype, gen).to(dev)
        k = min(shape)
        chi = min(k, CHI)
        B = _operand((chi, shape[1]), "random", dtype, gen).to(dev)
        C = torch.randn((k, chi), generator=gen, dtype=torch.float64).to(dtype).to(dev)
        D = torch.randn((chi, chi), generator=gen, dtype=torch.float64).to(dtype).to(dev)
        s = (torch.rand(chi, generator=gen, dtype=torch.float64) + 0.5).to(dtype).to(dev)

        def kernel():
            return qr_apply_cuda(qr_factor_cuda(A, B)[2], C, D, s)

        def library():
            Q, _ = torch.linalg.qr(A)
            return Q @ (C * torch.sqrt(s)[None, :])

        reps = max(2, min(20, int(3e9 / (shape[0] * shape[1] * k + 1))))
        kernel()
        library()
        km, lm = _ms(kernel, reps), _ms(library, reps)
        b = bound_ms(*shape)
        c = count[shape]
        tot = [tot[0] + c * b, tot[1] + c * km, tot[2] + c * lm]
        print(f"| ({shape[0]}, {shape[1]}) x{c} | {b:.4f} | {km:.3f} | {lm:.3f} |",
              flush=True)
    print(f"| a value, 144 operands | {tot[0]:.3f} | {tot[1]:.3f} | {tot[2]:.3f} |",
          flush=True)


def singles():
    """One operand at a time beside a (chi, n) partner: the factor launch
    and the apply launch on their own, a panel-only width beside the plan's
    widths."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    for shape in [(131072, 32), (131072, 1024), (262144, 32), (262144, 256),
                  (32768, 256), (16384, 512), (8192, 512), (4096, 256),
                  (1024, 1024), (512, 512), (256, 256), (1024, 64), (64, 64)]:
        A = torch.randn(shape, generator=gen, dtype=torch.float64).to(dev)
        k = min(shape)
        chi = min(k, CHI)
        B = torch.randn((chi, shape[1]), generator=gen, dtype=torch.float64).to(dev)
        C = torch.randn((k, chi), dtype=torch.float64, device=dev)
        D = torch.randn((chi, chi), dtype=torch.float64, device=dev)
        s = torch.rand(chi, dtype=torch.float64, device=dev) + 0.5
        _, _, fac = qr_factor_cuda(A, B)
        reps = max(2, min(20, int(3e9 / (shape[0] * shape[1] * k + 1))))
        f_ms = _ms(lambda: qr_factor_cuda(A, B), reps)
        a_ms = _ms(lambda: qr_apply_cuda(fac, C, D, s), reps)
        print(f"# single {shape}: factor_ms {f_ms:.3f} apply_ms {a_ms:.3f} "
              f"bound_ms {bound_ms(*shape):.4f} blocks {fac.nblk}", flush=True)


def asynchronous():
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    A = torch.randn((131072, 1024), generator=gen, dtype=torch.float64).to(dev)
    B = torch.randn((1024, 1024), generator=gen, dtype=torch.float64).to(dev)
    U = torch.randn((1024, CHI), dtype=torch.float64, device=dev)
    s = torch.rand(CHI, dtype=torch.float64, device=dev) + 0.5
    pad = torch.zeros((A.shape[0], CHI), dtype=torch.float64, device=dev)
    pad[:1024] = U
    cycles = int(torch.cuda.get_device_properties(dev).clock_rate * 1e3 * 0.2)
    for label in ("warm", "measured"):
        for name in ("kernel", "library", "geqrf_ormqr"):
            torch.cuda.synchronize()
            torch.cuda._sleep(cycles)
            t0 = time.perf_counter()
            if name == "kernel":
                _, _, fac = qr_factor_cuda(A, B)
                t1 = time.perf_counter()
                qr_apply_cuda(fac, U, U, s)
            elif name == "library":
                Qa, _ = torch.linalg.qr(A)
                t1 = time.perf_counter()
                Qa @ U
            else:
                a, tau = torch.geqrf(A)
                t1 = time.perf_counter()
                torch.ormqr(a, tau, pad)
            t2 = time.perf_counter()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            if label == "measured":
                print(f"# async {name}: first call returned after "
                      f"{(t1 - t0) * 1e3:.3f} ms, second after "
                      f"{(t2 - t1) * 1e3:.3f} ms, the card done "
                      f"{(t3 - t0) * 1e3:.1f} ms after the first call, "
                      "behind a 200 ms spin", flush=True)


if __name__ == "__main__":
    _card()
    for arg in sys.argv[2:]:
        if arg.startswith("rows="):
            from cotengra_tpu_torch.ops import qr_core

            qr_core.ROWS_PER_BLOCK = int(arg[5:])
            print(f"# rows a block {qr_core.ROWS_PER_BLOCK}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    mode = sys.argv[1] if len(sys.argv) > 1 else "check"
    if mode == "check":
        check()
    elif mode == "value":
        value(torch.float32 if "f32" in sys.argv else torch.float64,
              "check" in sys.argv)
    elif mode == "shapes":
        shapes(torch.float32 if "f32" in sys.argv else torch.float64)
    elif mode == "singles":
        singles()
    elif mode == "async":
        asynchronous()
    else:
        raise SystemExit(f"unknown mode {mode}")
