"""The QR kernel's algorithm (``csrc/qr_core.cu``) emulated in plain
PyTorch on the CPU, held to the library's QR; the dispatch of the
compressed truncation between the kernel and the library; the host half
of the wrappers.

The emulation repeats the kernel's arithmetic in the kernel's order of
operations (its sums across blocks aside): the operand scaled by a power
of two, panels of ``PANEL`` columns factored column by column with
LAPACK's reflector (dlarfg), each panel's T from ``Y^T Y`` and the taus
(dlarft), the trailing columns updated by ``Y (T^T (Y^T A))``, and Q
applied to ``[C sqrt(s); 0]`` panel by panel backwards, never formed. It
is held to ``torch.linalg.qr`` and ``@`` in float64 at 1e-12: R row by
row up to its sign, ``Q C`` where R has full rank, and everywhere ``Q``
orthonormal with ``Q R = A``.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from cotengra_tpu_torch.ops import compressed, qr_core
from cotengra_tpu_torch.ops.qr_core import (
    PANEL,
    ROWS_PER_BLOCK,
    panels,
    qr_apply_cuda,
    qr_factor_cuda,
    split_blocks,
)
from cotengra_tpu_torch.ops.svd_core import svd_topk

F64 = torch.float64
TOL = 1e-12

# every QR operand shape of a value of the 16x16 bond-4 lattice at chi=32
# (the committed plan of tnbench's lattice16x16-d4-chi32: 144 operands in
# 32 shapes), with its count
VALUE_SHAPES = {
    (131072, 1024): 1, (262144, 256): 5, (16384, 512): 6, (32768, 256): 8,
    (8192, 512): 8, (8192, 1024): 1, (262144, 128): 1, (16384, 256): 3,
    (4096, 256): 6, (1024, 1024): 2, (512, 512): 6, (512, 1024): 2,
    (8192, 128): 3, (16384, 64): 4, (4096, 128): 4, (256, 256): 23,
    (8192, 64): 5, (1024, 256): 1, (2048, 64): 7, (512, 256): 2,
    (4096, 64): 3, (1024, 64): 12, (1024, 128): 3, (2048, 128): 1,
    (256, 128): 6, (512, 128): 2, (128, 256): 1, (64, 64): 12, (512, 64): 1,
    (32, 512): 2, (32, 256): 1, (1, 1024): 2,
}


def _ilogb(x):
    return math.frexp(x)[1] - 1


def _y(W, c0, bw):
    """The panel's reflectors as columns, rows c0 and below: unit
    diagonal, the tails below it, zero above."""
    Y = torch.tril(W[c0:, c0:c0 + bw], -1)
    Y[torch.arange(bw), torch.arange(bw)] = 1.0
    return Y


def _larft(G, taus):
    """T (upper triangular) with H_0 ... H_{b-1} = I - Y T Y^T, from G =
    Y^T Y: T_ii = tau_i, T[:i, i] = -tau_i T[:i, :i] G[:i, i]."""
    b = len(taus)
    T = torch.zeros((PANEL, PANEL), dtype=F64)
    for i in range(b):
        T[i, i] = taus[i]
        if i:
            T[:i, i] = -taus[i] * (T[:i, :i] @ G[:i, i])
    return T


def emulate_factor(A):
    """``(W, Tm, R)`` as the factor kernel leaves them: W the scaled
    operand factored in place (R on and above the diagonal, reflector
    tails below), Tm each panel's T, R = triu(W[:k]) scaled back."""
    m, n = A.shape
    k = min(m, n)
    amax = float(A.abs().max())
    sc = 2.0 ** -_ilogb(amax) if amax > 0 else 1.0
    W = (A * sc).to(F64)
    Tm = []
    for c0 in range(0, k, PANEL):
        bw = min(PANEL, k - c0)
        end = c0 + bw
        taus = []
        for i in range(bw):
            j = c0 + i
            alpha = float(W[j, j])
            x = W[j + 1:, j]
            xn2 = float((x * x).sum())
            if xn2 != 0.0:
                beta = -math.copysign(math.sqrt(alpha * alpha + xn2), alpha)
                tau = (beta - alpha) / beta
                scal = 1.0 / (alpha - beta)
            else:
                beta, tau, scal = alpha, 0.0, 0.0
            top = W[j, j + 1:end].clone()
            dots = x @ W[j + 1:, j + 1:end]
            w = tau * (top + scal * dots)
            W[j, j] = beta
            W[j + 1:, j] = x * scal
            W[j, j + 1:end] -= w
            W[j + 1:, j + 1:end] -= torch.outer(W[j + 1:, j], w)
            taus.append(tau)
        Y = _y(W, c0, bw)
        T = _larft(Y.T @ Y, taus)
        Tm.append(T)
        if end < n:
            Wt = W[c0:, end:]
            W[c0:, end:] = Wt - Y @ (T[:bw, :bw].T @ (Y.T @ Wt))
    R = torch.triu(W[:k]) / sc
    return W, Tm, R


def emulate_apply(W, Tm, C, s):
    """``Q [C diag(sqrt(s)); 0]`` as the apply kernel computes it: the
    panels backwards, ``X -= Y (T (Y^T X))``."""
    m, n = W.shape
    k = min(m, n)
    X = torch.zeros((m, C.shape[1]), dtype=F64)
    X[:k] = C * torch.sqrt(s)[None, :]
    for p in reversed(range(panels(k))):
        c0 = p * PANEL
        bw = min(PANEL, k - c0)
        Y = _y(W, c0, bw)
        T = Tm[p][:bw, :bw]
        X[c0:] = X[c0:] - Y @ (T @ (Y.T @ X[c0:]))
    return X


def _operand(shape, kind, seed=0):
    m, n = shape
    k = min(m, n)
    gen = torch.Generator().manual_seed(seed)
    if kind == "random":
        return torch.randn(shape, generator=gen, dtype=F64)
    if kind == "rank-deficient":
        r = max(1, k // 4)
        return (torch.randn((m, r), generator=gen, dtype=F64)
                @ torch.randn((r, n), generator=gen, dtype=F64))
    if kind == "zero-columns":
        A = torch.randn(shape, generator=gen, dtype=F64)
        A[:, ::3] = 0.0
        return A
    if kind == "graded":
        qa = torch.linalg.qr(torch.randn((m, k), generator=gen, dtype=F64))[0]
        qb = torch.linalg.qr(torch.randn((n, k), generator=gen, dtype=F64))[0]
        return (qa * torch.logspace(0, -12, k, dtype=F64)) @ qb.T
    if kind == "zero":
        return torch.zeros(shape, dtype=F64)
    raise ValueError(kind)


def _signs(R_got, R_want):
    """+-1 a row aligning R_got's diagonal with R_want's (1 where either
    is 0)."""
    d = torch.diagonal(R_got) * torch.diagonal(R_want)
    return torch.where(d < 0, -1.0, 1.0).to(F64)


def _check_against_library(A, full_rank):
    k = min(A.shape)
    scale = max(float(torch.linalg.norm(A)), 1e-300)
    W, Tm, R = emulate_factor(A)
    assert torch.equal(R, torch.triu(R)) and R.shape == (k, A.shape[1])
    eye = torch.eye(k, dtype=F64)
    Q = emulate_apply(W, Tm, eye, torch.ones(k, dtype=F64))
    assert float((Q.T @ Q - eye).abs().max()) <= TOL * max(1, k) ** 0.5
    assert float(torch.linalg.norm(Q @ R - A)) <= TOL * scale
    Q_lib, R_lib = torch.linalg.qr(A)
    d = _signs(R, R_lib)
    if full_rank:
        # R is the library's row by row; so is Q C
        assert float(torch.linalg.norm(d[:, None] * R - R_lib)) <= TOL * scale
        gen = torch.Generator().manual_seed(1)
        chi = min(k, 32)
        C = torch.randn((k, chi), generator=gen, dtype=F64)
        s = torch.rand(chi, generator=gen, dtype=F64) + 0.5
        got = emulate_apply(W, Tm, C, s)
        want = Q_lib @ (d[:, None] * C * torch.sqrt(s)[None, :])
        assert float(torch.linalg.norm(got - want)) <= TOL * float(
            torch.linalg.norm(want))
    else:
        # past the numerical rank R's rows are rounding, of any sign and
        # direction: R is held to the library's in norm only
        assert abs(float(torch.linalg.norm(R)) - float(
            torch.linalg.norm(R_lib))) <= TOL * scale


def _scaled(shape):
    """A shape class of the plan scaled down eightfold (at least one row
    and column), tall staying tall and wide wide."""
    return tuple(max(1, d // 8) for d in shape)


@pytest.mark.parametrize(
    "shape", sorted(VALUE_SHAPES), ids=lambda s: f"{s[0]}x{s[1]}")
def test_emulation_matches_the_library_on_the_plans_shapes(shape):
    """Each of the 32 operand shape classes of a value, scaled down."""
    A = _operand(_scaled(shape), "random")
    _check_against_library(A, full_rank=True)


@pytest.mark.parametrize("shape", [(300, 100), (100, 300), (97, 64),
                                   (64, 97), (33, 33), (1, 5), (5, 1),
                                   (260, 70)])
@pytest.mark.parametrize("kind", ["random", "rank-deficient",
                                  "zero-columns", "graded", "zero"])
def test_emulation_on_hard_operands(shape, kind):
    """Several panels, wide and tall, ragged last panels; rank-deficient,
    zero columns (their reflector the identity), graded singular values
    down to 1e-12, all zero."""
    A = _operand(shape, kind)
    # past the random operands, Q's trailing columns hang on rounding (the
    # graded ones' by up to 1e-12 / 1e-16): Q orthonormal, Q R = A
    _check_against_library(A, full_rank=kind == "random")
    if kind == "zero":
        W, Tm, R = emulate_factor(A)
        assert float(R.abs().max()) == 0.0
        assert all(float(T.abs().max()) == 0.0 for T in Tm)


def test_emulation_keeps_scale_out_of_range_of_squares():
    """Entries near 1e200 square past float64's range: the power-of-two
    scaling keeps the sums finite and R exact in scale."""
    A = _operand((80, 40), "random") * 1e200
    W, Tm, R = emulate_factor(A)
    _, R_lib = torch.linalg.qr(A)
    d = _signs(R, R_lib)
    assert torch.isfinite(R).all()
    assert float(torch.linalg.norm(d[:, None] * R - R_lib)) <= TOL * float(
        torch.linalg.norm(A))


def test_truncation_through_the_emulation_equals_the_library_route():
    """One truncation of a shared bond, the products ``Q_a U sqrt(s)`` and
    ``Q_b V sqrt(s)`` taken through the emulated kernel, against today's
    library route: the truncated pair's product ``newA newB^T`` agrees."""
    gen = torch.Generator().manual_seed(3)
    A = torch.randn((300, 96), generator=gen, dtype=F64)
    B = torch.randn((200, 96), generator=gen, dtype=F64)
    chi = 16
    Wa, Ta, Ra = emulate_factor(A)
    Wb, Tb, Rb = emulate_factor(B)
    U, s, V = svd_topk(Ra @ Rb.T, chi)
    newA = emulate_apply(Wa, Ta, U, s)
    newB = emulate_apply(Wb, Tb, V, s)
    wantA, wantB = compressed._compress_pair_core(A, B, chi)
    got, want = newA @ newB.T, wantA @ wantB.T
    assert float(torch.linalg.norm(got - want)) <= TOL * float(
        torch.linalg.norm(want))


def _library_core(A, B, chi):
    """The truncation as it was before the kernel: ``torch.linalg.qr`` and
    ``@``, written out."""
    Qa, Ra = torch.linalg.qr(A)
    Qb, Rb = torch.linalg.qr(B)
    U, s, V = svd_topk(compressed._mm(Ra, Rb.T), chi)
    sq = torch.sqrt(s)
    return compressed._mm(Qa, U * sq[None, :]), compressed._mm(Qb, V * sq[None, :])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.complex128])
def test_cpu_and_complex_operands_take_the_library(dtype, monkeypatch):
    """On the CPU, real or complex, the truncation is the library's QR and
    ``@``, bit for bit, and counts two library operands; the kernel's
    wrappers are never called."""
    def refuse(*args, **kwargs):
        raise AssertionError("the QR kernel was called")

    monkeypatch.setattr(compressed, "qr_factor_cuda", refuse)
    monkeypatch.setattr(compressed, "qr_apply_cuda", refuse)
    gen = torch.Generator().manual_seed(5)
    A = torch.randn((64, 48), generator=gen, dtype=F64).to(dtype)
    B = torch.randn((40, 48), generator=gen, dtype=F64).to(dtype)
    if dtype.is_complex:
        A = A + 1j * torch.randn((64, 48), generator=gen, dtype=F64)
    before = dict(compressed.COUNTS)
    got = compressed._compress_pair_core(A, B, 8)
    assert compressed.COUNTS["qr_library"] == before["qr_library"] + 2
    assert compressed.COUNTS["qr_kernel"] == before["qr_kernel"]
    want = _library_core(A, B, 8)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_a_cpu_contraction_counts_library_operands():
    """A compressed contraction on the CPU: two library operands a
    truncation, no kernel operand, no launch."""
    import cotengra_tpu_torch as ctt

    inputs, output, shapes, size_dict = ctt.lattice_equation([4, 4], d_min=3)
    rng = np.random.default_rng(0)
    arrays = [np.ones(s) + 0.05 * rng.normal(size=s) for s in shapes]
    tree = ctt.array_contract_tree(
        inputs, output, size_dict=size_dict, optimize="greedy-compressed"
    )
    before = dict(compressed.COUNTS)
    launches = (qr_factor_cuda.launches, qr_apply_cuda.launches)
    tree.contract_compressed(arrays, chi=4, device="cpu")
    grown = {k: compressed.COUNTS[k] - before[k] for k in before}
    assert grown["truncations"] > 0
    assert grown == {"truncations": grown["truncations"], "qr_kernel": 0,
                     "qr_library": 2 * grown["truncations"]}
    assert (qr_factor_cuda.launches, qr_apply_cuda.launches) == launches


def test_wrappers_refuse_cpu_and_bad_operands():
    """The wrappers raise before any build or launch on what the kernel
    does not take; their launch counts stay."""
    A = torch.zeros((8, 4), dtype=F64)
    launches = qr_factor_cuda.launches
    for bad in (A, A.to(torch.float16), A.T, torch.zeros((0, 4), dtype=F64),
                torch.zeros(8, dtype=F64)):
        with pytest.raises(ValueError):
            qr_factor_cuda(bad, A)
    with pytest.raises(ValueError):
        qr_factor_cuda(A.to(torch.complex128), A)
    assert qr_factor_cuda.launches == launches


@pytest.mark.parametrize("shapes", [
    [(131072, 1024), (1024, 1024)], [(262144, 256), (256, 256)],
    [(64, 64), (1024, 64)], [(1, 1024), (1, 1024)], [(8192, 512)] * 2,
    [(300, 100), (100, 100)], [(131072, 1024), (32, 1024)],
])
@pytest.mark.parametrize("blocks", [2, 132, 264])
def test_split_blocks(shapes, blocks):
    """Each side at least one block and at most one a row; the grid no
    larger than the card holds; ``ROWS_PER_BLOCK`` rows a block where it
    fits; otherwise the larger side's work takes the larger share."""
    rows = [m for m, _ in shapes]
    work = [qr_core._side_work(m, n) for m, n in shapes]
    got = split_blocks(rows, work, blocks)
    assert len(got) == 2 and sum(got) <= blocks
    assert all(1 <= b <= m for b, m in zip(got, rows))
    want = [min(m, -(-m // ROWS_PER_BLOCK)) for m in rows]
    if sum(want) <= blocks:
        assert got == want
    elif work[0] != work[1]:
        big = int(work[1] > work[0])
        assert got[big] >= got[1 - big] or got[big] == want[big]


def test_value_shapes_are_the_plans():
    """``VALUE_SHAPES`` is the committed plan's: 72 truncations, 144
    operands in 32 shapes, counted on meta tensors (no arithmetic)."""
    import io

    from cotengra_tpu_torch import lattice_equation, load_tree
    from cotengra_tpu_torch.tree_compressed import ContractionTreeCompressed

    root = Path(__file__).resolve().parents[1]
    with open(root / "tnbench" / "configs" / "lattice16x16-d4-chi32.json") as f:
        cfg = json.load(f)
    inputs, output, shapes, size_dict = lattice_equation([16, 16], d_min=4)
    t = load_tree(io.StringIO(json.dumps(cfg["plan"])), inputs, output,
                  size_dict)
    tree = ContractionTreeCompressed(t.inputs, t.output, t.size_dict,
                                     children=t.children)
    seen = {}

    def record(A, B, chi):
        for X in (A, B):
            seen[tuple(X.shape)] = seen.get(tuple(X.shape), 0) + 1
        return (torch.empty((A.shape[0], chi), device="meta", dtype=A.dtype),
                torch.empty((B.shape[0], chi), device="meta", dtype=B.dtype))

    arrays = [torch.empty(s, dtype=F64, device="meta") for s in shapes]
    mp = pytest.MonkeyPatch()
    mp.setattr(compressed, "_compress_pair_core", record)
    mp.setattr(compressed, "resolve_device", lambda d: torch.device("meta"))
    try:
        tree.contract_compressed(arrays, chi=32, strip_exponent=True,
                                 device="cpu")
    finally:
        mp.undo()
    assert seen == VALUE_SHAPES
