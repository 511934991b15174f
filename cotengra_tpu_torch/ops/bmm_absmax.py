"""Batched matmul with a fused max|out|: the plain PyTorch version, the
CUDA kernel's wrapper, and the pairwise contraction built on them.

The counterpart of ``cotengra_tpu/ops/pallas_bmm.py``. Exponent
stripping renormalises every intermediate by ``max|out|``; taking that
maximum from the accumulators while the product is formed saves a
second pass over the output. The executor routes a step here when
``implementation="pallas"`` and the step qualifies
(``executor._pallas_step_ok``).

``bmm_absmax`` sends CUDA tensors to ``csrc/bmm_absmax.cu`` (float32
only; anything else raises) and CPU tensors to ``bmm_absmax_plain``, in
their own dtype. The kernel runs 3xTF32 ``wgmma`` on TMA-loaded tiles,
which take both operands K-major: ``x`` as ``(B, M, K)`` and ``y`` as
the transpose of a contiguous ``(B, N, K)``, the layout
``pairwise_bmm_absmax`` makes. Its workspace holds y's two TF32 parts
(split once by a pre-pass) and the split-K partial tiles. The
reference's padding to 256-multiples and its minimum tile sizes
(``_pad_to``, ``bm >= 8``, ``bn >= 128``) were TPU tiling mechanics:
TMA fills ragged edges with zeros, and only K is padded, to a multiple
of 4 (TMA's 16-byte row stride).
"""

import torch

from .. import tracing
from ..utils.misc import prod

# the kernel's tile (csrc/bmm_absmax.cu: BM, BN, BK) and the grid limit
# on output row tiles and on batch x splits
_TILE_M = _TILE_N = 128
_TILE_K = 32
_MAX_ROW_TILES = 65535
_MAX_Z = 65535
# split K only where a chunk keeps at least this many k
_MIN_K_CHUNK = 1024
# TMA: row strides a multiple of 16 bytes, bases 16-byte aligned
_K_ALIGN = 4
_PTR_ALIGN = 16


def _cdiv(a, b):
    return -(-a // b)


def _split_k(B, M, K, N, n_sm):
    """``(splits, k_chunk)`` for the kernel: K is cut into ``splits``
    chunks of ``k_chunk`` (a multiple of the 32-deep k tile) when the
    output tiles alone would leave most of the card's ``n_sm``
    multiprocessors idle (one block fits on each)."""
    if K == 0:
        return 1, _TILE_K
    tiles = B * _cdiv(M, _TILE_M) * _cdiv(N, _TILE_N)
    splits = 1
    if tiles < n_sm and K >= 2 * _MIN_K_CHUNK:
        splits = min(_cdiv(n_sm, tiles), K // _MIN_K_CHUNK)
    k_chunk = _cdiv(_cdiv(K, splits), _TILE_K) * _TILE_K
    return _cdiv(K, k_chunk), k_chunk


def bmm_absmax_plain(x, y):
    """``x: (B, M, K) @ y: (B, K, N) -> (out, max|out|)`` in plain
    PyTorch, in the inputs' dtype. Runs on any device; ``bmm_absmax``
    uses it for CPU tensors only, and ``chip_smoke.py`` compares the
    kernel with it."""
    out = torch.bmm(x, y)
    return out, out.abs().amax()


def _pad_k(t, k):
    """``t`` with its last axis zero-padded to ``k``."""
    out = t.new_zeros(tuple(t.shape[:-1]) + (k,))
    out[..., : t.shape[-1]] = t
    return out


def _aligned(t):
    return t if t.data_ptr() % _PTR_ALIGN == 0 else t.clone()


def bmm_absmax_cuda(x, y):
    """Launch ``csrc/bmm_absmax.cu`` on float32 CUDA tensors, on the
    current stream: ``x`` a contiguous ``(B, M, K)``, ``y`` a ``(B, K,
    N)`` whose transpose is contiguous (no copy) or which is contiguous
    itself (one transposing copy). K is zero-padded to a multiple of 4
    (at least 4) for TMA, which leaves the product exact. Returns ``(out,
    absmax)``, absmax a 0-d float32 tensor on the device.
    ``bmm_absmax_cuda.launches`` counts the calls; each is a
    ``kernel.launch`` span (``tracing``)."""
    from ._build import load_library

    if tracing.ON:
        tracing.begin()
        shapes = (tuple(x.shape), tuple(y.shape))
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError(
            f"bmm_absmax kernel takes float32, got {x.dtype} and {y.dtype}"
        )
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(
            f"bmm_absmax_cuda needs both tensors on one CUDA device, got "
            f"{x.device} and {y.device}"
        )
    if x.dim() != 3 or y.dim() != 3:
        raise ValueError("bmm_absmax kernel takes 3-D (B, M, K), (B, K, N)")
    B, M, K = x.shape
    if tuple(y.shape[:2]) != (B, K):
        raise ValueError(
            f"shapes {tuple(x.shape)} and {tuple(y.shape)} do not chain"
        )
    N = y.shape[2]
    yt = y.transpose(1, 2)
    if not x.is_contiguous():
        raise ValueError("bmm_absmax kernel needs x contiguous")
    if not yt.is_contiguous():
        if not y.is_contiguous():
            raise ValueError(
                "bmm_absmax kernel needs y or its transpose contiguous"
            )
        yt = yt.contiguous()
    kp = max(_K_ALIGN, _cdiv(K, _K_ALIGN) * _K_ALIGN)
    if kp != K:
        x, yt = _pad_k(x, kp), _pad_k(yt, kp)
    x, yt = _aligned(x), _aligned(yt)
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits, k_chunk = _split_k(B, M, kp, N, n_sm)
    if _cdiv(M, _TILE_M) > _MAX_ROW_TILES or B * splits > _MAX_Z:
        raise ValueError(
            f"(B, M, K, N) = {(B, M, K, N)} exceeds the kernel's grid"
        )
    out = torch.empty((B, M, N), dtype=torch.float32, device=x.device)
    absmax = torch.empty((), dtype=torch.float32, device=x.device)
    # y's big and small parts, then the split-K partial tiles
    ws = torch.empty(
        2 * B * N * kp + (splits * B * M * N if splits > 1 else 0),
        dtype=torch.float32, device=x.device,
    )
    lib = load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if tracing.ON:
        launched = tracing.now()
    rc = lib.ctg_bmm_absmax_f32(
        x.data_ptr(), yt.data_ptr(), out.data_ptr(), absmax.data_ptr(),
        ws.data_ptr(), B, M, kp, N, splits, k_chunk, stream,
    )
    if rc != 0:
        raise RuntimeError(f"bmm_absmax kernel launch failed: error {rc}")
    bmm_absmax_cuda.launches += 1
    if tracing.ON:
        tracing.end(
            "kernel.launch", "bmm_absmax", bmm_absmax_cuda.launches - 1, shapes,
            launched,
        )
    return out, absmax


bmm_absmax_cuda.launches = 0


def bmm_absmax(x, y):
    """``x: (B, M, K) @ y: (B, K, N) -> (out: (B, M, N), absmax)``.

    CUDA tensors launch the kernel (or raise); CPU tensors take the
    plain version."""
    if x.device.type == "cuda":
        return bmm_absmax_cuda(x, y)
    if x.device.type == "cpu" and y.device.type == "cpu":
        return bmm_absmax_plain(x, y)
    raise ValueError(f"no bmm_absmax path for devices {x.device}, {y.device}")


def _bmm_layout(l_legs, r_legs, out_legs):
    """Plan the transposes/reshapes taking a pairwise contraction into
    (B, M, K) x (B, K, N) batched-matmul form. Returns None if the step
    is not a clean batched matmul (e.g. needs pre-sums)."""
    l_set, r_set, o_set = set(l_legs), set(r_legs), set(out_legs)
    batch = [ix for ix in l_legs if ix in r_set and ix in o_set]
    contract = [ix for ix in l_legs if ix in r_set and ix not in o_set]
    l_free = [ix for ix in l_legs if ix not in r_set]
    r_free = [ix for ix in r_legs if ix not in l_set]
    if any(ix not in o_set for ix in l_free + r_free):
        return None  # needs pre-sums - not a clean BMM
    return batch, contract, l_free, r_free


def pairwise_bmm_absmax(x, y, l_legs, r_legs, out_legs):
    """Pairwise contraction through ``bmm_absmax``, returning
    ``(out_in_out_legs_order, absmax)``. The caller ensures
    ``_bmm_layout`` is not None and the dtype is real."""
    l_legs, r_legs = list(l_legs), list(r_legs)
    batch, contract, l_free, r_free = _bmm_layout(l_legs, r_legs, out_legs)

    def to3(t, legs, first, second):
        perm = [legs.index(ix) for ix in batch + first + second]
        tt = t.permute(perm)
        shp = tuple(tt.shape)
        nb, nf = len(batch), len(first)
        t3 = tt.reshape(
            prod(shp[:nb]), prod(shp[nb:nb + nf]), prod(shp[nb + nf:])
        )
        return t3.contiguous(), shp[:nb]

    x3, bdims = to3(x, l_legs, l_free, contract)
    # y goes K-major, as the kernel's wgmma takes it: one copy in (batch,
    # r_free, contract) order, handed over as its (B, K, N) transpose
    yt3, _ = to3(y, r_legs, r_free, contract)
    y3 = yt3.transpose(1, 2)

    out3, amax = bmm_absmax(x3, y3)

    shape = (
        bdims
        + tuple(x.shape[l_legs.index(ix)] for ix in l_free)
        + tuple(y.shape[r_legs.index(ix)] for ix in r_free)
    )
    out = out3.reshape(shape)
    computed = tuple(batch) + tuple(l_free) + tuple(r_free)
    if computed != tuple(out_legs):
        out = out.permute([computed.index(ix) for ix in out_legs])
    return out, amax
