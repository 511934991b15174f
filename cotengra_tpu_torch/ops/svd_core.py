"""The k largest singular triplets of a truncation core: the plain
PyTorch version, the CUDA kernel's wrapper, and the dispatch between them.

``ops/compressed.py`` truncates each bond through ``svd_topk(M, k)``,
``M = R_a R_b^T``, and keeps ``U (m, k)``, ``s (k)`` descending and
``V (n, k)`` with ``M ~ U diag(s) V^T`` (``V`` the bilinear transpose of
the library's ``Vh``, as the reference's ``Vh.T``).

- CPU tensors and complex cores take ``svd_topk_plain``:
  ``torch.linalg.svd`` and the top-k slices, bit for bit what the
  truncation did before the kernel (on the card, cuSOLVER, which checks its
  result on the host: two synchronisations a call).
- Real CUDA cores (float32, float64) launch ``csrc/svd_core.cu``
  (``svd_topk_cuda``): block one-sided Jacobi in one cooperative launch
  that decides its convergence on the card and never waits for the host.

The kernel replaces no TPU kernel: the JAX package leaves this SVD to XLA
(``jnp.linalg.svd``). Its note in the source says what bounds it and what
the design does about that.
"""

import torch

from .. import tracing

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
# per device: the kernel's count of launches that hit the sweep cap
_UNCONVERGED = {}


def svd_topk_plain(M, k):
    """``(U[:, :k], s[:k], Vh[:k].T)`` of ``torch.linalg.svd(M)``: any
    dtype, any device. ``svd_topk`` takes it for CPU and complex cores;
    the card's tests compare the kernel with it."""
    U, s, Vh = torch.linalg.svd(M, full_matrices=False)
    return U[:, :k], s[:k], Vh[:k, :].T


def _check(M, k):
    if M.dim() != 2:
        raise ValueError(f"svd_topk takes a matrix, got shape {tuple(M.shape)}")
    if not 1 <= k <= min(M.shape):
        raise ValueError(f"k = {k} outside 1..{min(M.shape)} for {tuple(M.shape)}")


def unconverged(device):
    """How many launches on ``device`` have reached the kernel's sweep cap
    (``kMaxSweeps`` in ``csrc/svd_core.cu``) unconverged, since the process
    started: their triplets were used as they stood. A device word that the
    kernel adds to; reading it synchronises, so read it where the host waits
    for the card anyway."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    word = _UNCONVERGED.get(device)
    return 0 if word is None else int(word.item())


def _unconverged_word(device):
    word = _UNCONVERGED.get(device)
    if word is None:
        word = _UNCONVERGED[device] = torch.zeros(
            1, dtype=torch.int32, device=device)
    return word


def svd_topk_cuda(M, k):
    """Launch ``csrc/svd_core.cu`` on a contiguous float32 or float64 CUDA
    matrix, on the current stream: ``(U (m, k), s (k), V (n, k))``, s
    descending, in M's dtype. Where a singular value is 0 its column of the
    side that comes from W's norms (U where m >= n, else V) is 0.
    ``svd_topk_cuda.launches`` counts the launches; each is a
    ``kernel.launch`` span (``tracing``) with the kernel's name and
    ``(m, n, k)``. ``svd_topk_cuda.ctl`` is the last launch's control words
    on the device (int32: the sweeps run at index 2, 1 at index 3 where the
    last sweep rotated nothing); reading it synchronises. A launch that
    reaches the sweep cap unconverged counts in ``unconverged(device)``."""
    from ._build import load_library

    if tracing.ON:
        tracing.begin()
    _check(M, k)
    if M.dtype not in _DTYPE_CODE:
        raise ValueError(f"svd_core kernel takes float32 or float64, got {M.dtype}")
    if not M.is_contiguous():
        raise ValueError("svd_core kernel needs M contiguous")
    if M.device.type != "cuda":
        raise ValueError(f"svd_topk_cuda needs a CUDA tensor, got {M.device}")
    m, n = M.shape
    lib = load_library()
    U = torch.empty((m, k), dtype=M.dtype, device=M.device)
    s = torch.empty((k,), dtype=M.dtype, device=M.device)
    V = torch.empty((n, k), dtype=M.dtype, device=M.device)
    work = torch.empty(
        lib.ctg_svd_core_workspace(m, n, k, M.element_size()),
        dtype=torch.uint8, device=M.device,
    )
    ctl = torch.zeros(10, dtype=torch.int32, device=M.device)
    word = _unconverged_word(M.device)
    stream = torch.cuda.current_stream(M.device).cuda_stream
    if tracing.ON:
        launched = tracing.now()
    rc = lib.ctg_svd_core(
        _DTYPE_CODE[M.dtype], M.data_ptr(), m, n, k, U.data_ptr(),
        s.data_ptr(), V.data_ptr(), work.data_ptr(), ctl.data_ptr(),
        word.data_ptr(), stream,
    )
    if rc != 0:
        raise RuntimeError(f"svd_core kernel launch failed: error {rc}")
    svd_topk_cuda.launches += 1
    svd_topk_cuda.ctl = ctl
    if tracing.ON:
        tracing.end(
            "kernel.launch", "svd_core", svd_topk_cuda.launches - 1,
            (m, n, k), launched,
        )
    return U, s, V


svd_topk_cuda.launches = 0
svd_topk_cuda.ctl = None


def svd_topk(M, k):
    """The k largest singular triplets ``(U, s, V)`` of the matrix ``M``,
    ``M ~ U diag(s) V^T``. Real CUDA cores launch the kernel (or raise);
    CPU and complex cores take the plain version."""
    if M.device.type == "cpu" or M.is_complex():
        _check(M, k)
        return svd_topk_plain(M, k)
    if M.device.type == "cuda":
        return svd_topk_cuda(M, k)
    raise ValueError(f"no svd_topk path for device {M.device}")
