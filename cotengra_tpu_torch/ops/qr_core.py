"""Householder QR of a truncation's two bond sides, with each side's Q
applied to its small factor without being formed: the CUDA kernel's
wrappers and the host half they share with the CPU tests.

``ops/compressed.py`` truncates a bond between ``A (la, D)`` and ``B (lb,
D)`` as ``Q_a R_a = A``, ``Q_b R_b = B``, ``U s V = svd(R_a R_b^T)`` and
keeps ``Q_a U sqrt(s)`` and ``Q_b V sqrt(s)``. On the card, for real
operands (float32, float64), the QR work is two launches of
``csrc/qr_core.cu``:

- ``qr_factor_cuda(A, B)``: both sides factored by Householder
  reflections in one cooperative launch, the reflectors and each panel's
  compact-WY factor left on the card, ``R_a`` and ``R_b`` returned;
- ``qr_apply_cuda(factors, U, V, s)``: ``Q_a [U sqrt(s); 0]`` and ``Q_b
  [V sqrt(s); 0]`` in one launch, Q never formed.

Neither makes the host wait: no info word, no workspace query, no library
call. CPU tensors and complex operands keep the library's
``torch.linalg.qr`` and ``@`` (``ops/compressed.py``), which is the plain
version. The kernel replaces no TPU kernel: the JAX package leaves this
QR to XLA (``jnp.linalg.qr``). Its note in the source says what bounds it
and what the design does about that.
"""

import ctypes

import torch

from .. import tracing

# columns a panel (``kB`` in csrc/qr_core.cu): reflectors a (Y, T)
PANEL = 32
# a column's sums in the kernel: norm, products, diagonal row
SLOTS = 2 * PANEL + 1
# a side's zeroed control words, in doubles: the barrier's arrivals (two
# words), three columns' sums in 8 copies (``kCopies``), max |A|
CTL = 2 + 3 * 8 * SLOTS + 1
# rows of a side a block takes, where the card holds enough blocks (64:
# the fastest of 512, 256, 128, 96 and 64 on a value's 72 truncations)
ROWS_PER_BLOCK = 64
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
_BLOCKS = {}  # device -> blocks resident at once


def panels(k):
    """Panels (compact-WY blocks) of a factorization with k reflectors."""
    return -(-k // PANEL)


def split_blocks(rows, work, blocks):
    """Blocks of the grid for each of the two sides: ``ceil(m /
    ROWS_PER_BLOCK)`` of a side of m rows (at least one, at most m); where
    those add up to more than ``blocks``, the grid is shared in proportion
    to each side's ``work``, at least one block a side."""
    want = [min(m, max(1, -(-m // ROWS_PER_BLOCK))) for m in rows]
    if sum(want) <= blocks:
        return want
    share = round(blocks * work[0] / max(work[0] + work[1], 1))
    a = min(max(share, 1), blocks - 1, want[0])
    b = min(blocks - a, want[1])
    return [min(want[0], blocks - b), b]


def _side_work(m, n):
    """Householder QR flops of an (m, n) operand, to the leading terms."""
    k = min(m, n)
    return 2 * m * n * k - (m + n) * k * k + 2 * k**3 // 3


def _blocks(lib, device):
    n = _BLOCKS.get(device)
    if n is None:
        with torch.cuda.device(device):
            n = lib.ctg_qr_core_blocks()
        if n < 2:
            raise RuntimeError(f"qr_core kernel: no resident blocks (error {-n})")
        n = _BLOCKS[device] = n
    return n


class Factors:
    """What ``qr_factor_cuda`` leaves on the card for ``qr_apply_cuda``:
    per side its factored matrix ``W`` (R above the diagonal, the
    reflectors' tails below), its panels' T factors (float64), its
    ``(m, n, k)`` and its blocks."""

    def __init__(self, W, Tm, dims, nblk):
        self.W = W
        self.Tm = Tm
        self.dims = dims
        self.nblk = nblk


def _launch(lib, phase, dtype, dims, ptrs, chi, device):
    dims_c = (ctypes.c_int64 * 8)(*dims)
    ptrs_c = (ctypes.c_void_p * 22)(*ptrs)
    stream = torch.cuda.current_stream(device).cuda_stream
    if tracing.ON:
        launched = tracing.now()
    else:
        launched = None
    rc = lib.ctg_qr_core(phase, _DTYPE_CODE[dtype], dims_c, ptrs_c, chi, stream)
    if rc != 0:
        raise RuntimeError(f"qr_core kernel launch failed: error {rc}")
    return launched


def _check_operand(X, dtype, device, name):
    if X.dim() != 2 or X.shape[0] < 1 or X.shape[1] < 1:
        raise ValueError(f"qr_core: {name} must be a non-empty matrix, got "
                         f"{tuple(X.shape)}")
    if X.dtype != dtype or X.dtype not in _DTYPE_CODE:
        raise ValueError(f"qr_core: {name} must be float32 or float64 like "
                         f"the first operand, got {X.dtype}")
    if X.device != device or device.type != "cuda":
        raise ValueError(f"qr_core: {name} must be a CUDA tensor on {device}, "
                         f"got {X.device}")
    if not X.is_contiguous():
        raise ValueError(f"qr_core: {name} must be contiguous")


def qr_factor_cuda(A, B):
    """Factor ``A`` and ``B``, contiguous float32 or float64 CUDA matrices
    of one dtype, by Householder reflections in one launch on the current
    stream; the operands are read, not written. Returns ``(R_a, R_b,
    factors)``: each R ``(min(m, n), n)``, upper trapezoidal, LAPACK's to
    rounding, and the ``Factors`` that ``qr_apply_cuda`` takes.
    ``qr_factor_cuda.launches`` counts the launches; each is a
    ``kernel.launch`` span (``tracing``) of kernel ``qr_core`` with shapes
    ``("factor", (m, n, k), ...)``, a side each."""
    from ._build import load_library

    if tracing.ON:
        tracing.begin()
    sides = [A, B]
    for X, name in zip(sides, ("A", "B")):
        _check_operand(X, A.dtype, A.device, name)
    lib = load_library()
    blocks = _blocks(lib, A.device)
    shapes = [tuple(X.shape) for X in sides]
    nblk = split_blocks([m for m, _ in shapes],
                        [_side_work(m, n) for m, n in shapes], blocks)
    dims, ptrs, Ws, Rs, Tms, scratch_at = [], [], [], [], [], []
    scratch_len = 0
    for (m, n), nb in zip(shapes, nblk):
        # Z's partial sums a block, Z
        scratch_at.append(scratch_len)
        scratch_len += (nb + 1) * PANEL * n
    scratch = torch.empty(scratch_len, dtype=torch.float64, device=A.device)
    ctl = torch.zeros(2 * CTL, dtype=torch.float64, device=A.device)
    for s, (X, (m, n), nb) in enumerate(zip(sides, shapes, nblk)):
        k = min(m, n)
        W = torch.empty((m, n), dtype=A.dtype, device=A.device)
        R = torch.empty((k, n), dtype=A.dtype, device=A.device)
        Tm = torch.empty((panels(k), PANEL, PANEL), dtype=torch.float64,
                         device=A.device)
        pz = scratch.data_ptr() + 8 * scratch_at[s]
        bar = ctl.data_ptr() + 8 * CTL * s
        dims += [m, n, k, nb]
        ptrs += [X.data_ptr(), W.data_ptr(), R.data_ptr(), Tm.data_ptr(),
                 bar + 16, pz, pz + 8 * nb * PANEL * n, bar, None, None, None]
        Ws.append(W)
        Rs.append(R)
        Tms.append(Tm)
    launched = _launch(lib, 0, A.dtype, dims, ptrs, 0, A.device)
    qr_factor_cuda.launches += 1
    if tracing.ON:
        tracing.end(
            "kernel.launch", "qr_core", qr_factor_cuda.launches - 1,
            ("factor", *[(m, n, min(m, n)) for m, n in shapes]), launched,
        )
    factors = Factors(Ws, Tms, [(m, n, min(m, n)) for m, n in shapes], nblk)
    return Rs[0], Rs[1], factors


qr_factor_cuda.launches = 0


def qr_apply_cuda(factors, U, V, s):
    """``(Q_a [U diag(sqrt(s)); 0], Q_b [V diag(sqrt(s)); 0])`` for the two
    sides that ``factors`` holds, in one launch on the current stream, Q
    never formed: ``U (k_a, chi)``, ``V (k_b, chi)`` and ``s (chi)``
    contiguous in the factors' dtype. ``qr_apply_cuda.launches`` counts
    the launches; each is a ``kernel.launch`` span of kernel ``qr_core``
    with shapes ``("apply", (m, n, k), ...)``."""
    from ._build import load_library

    if tracing.ON:
        tracing.begin()
    Cs = [U, V]
    dtype, device = factors.W[0].dtype, factors.W[0].device
    if s.dim() != 1:
        raise ValueError("qr_apply_cuda: s must be a vector")
    _check_operand(s[None], dtype, device, "s")
    chi = s.shape[0]
    for C, (_, _, k), name in zip(Cs, factors.dims, ("U", "V")):
        _check_operand(C, dtype, device, name)
        if C.shape != (k, chi):
            raise ValueError(f"qr_apply_cuda: {name} must be ({k}, {chi}), "
                             f"got {tuple(C.shape)}")
    lib = load_library()
    scratch_at, scratch_len = [], 0
    for nb in factors.nblk:
        scratch_at.append(scratch_len)
        scratch_len += (nb + 1) * PANEL * chi
    scratch = torch.empty(scratch_len, dtype=torch.float64, device=device)
    bar = torch.zeros(8, dtype=torch.int32, device=device)
    dims, ptrs, Xs = [], [], []
    for i, (C, (m, n, k), nb) in enumerate(zip(Cs, factors.dims, factors.nblk)):
        X = torch.empty((m, chi), dtype=dtype, device=device)
        pz = scratch.data_ptr() + 8 * scratch_at[i]
        dims += [m, n, k, nb]
        ptrs += [None, factors.W[i].data_ptr(), None, factors.Tm[i].data_ptr(),
                 None, pz, pz + 8 * nb * PANEL * chi, bar.data_ptr() + 16 * i,
                 C.data_ptr(), s.data_ptr(), X.data_ptr()]
        Xs.append(X)
    launched = _launch(lib, 1, dtype, dims, ptrs, chi, device)
    qr_apply_cuda.launches += 1
    if tracing.ON:
        tracing.end(
            "kernel.launch", "qr_core", qr_apply_cuda.launches - 1,
            ("apply", *factors.dims), launched,
        )
    return Xs[0], Xs[1]


qr_apply_cuda.launches = 0

