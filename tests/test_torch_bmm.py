"""The fused matmul+|max| of the port against the reference's Pallas
kernel (interpret mode), on the same numpy inputs: the plain version
that CPU tensors take, the pairwise layouts around it, and the kernel
wrapper's refusals."""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax.numpy as jnp
from cotengra_tpu.ops.pallas_bmm import bmm_absmax as ref_bmm_absmax
from cotengra_tpu.ops.pallas_bmm import (
    pairwise_bmm_absmax as ref_pairwise_bmm_absmax,
)

from cotengra_tpu_torch.ops import bmm_absmax as bmm_module
from cotengra_tpu_torch.ops.bmm_absmax import (
    _pad_k,
    _split_k,
    bmm_absmax,
    bmm_absmax_cuda,
    pairwise_bmm_absmax,
)

torch.set_num_threads(1)

# float32 sums in another order than the interpreted kernel's. Inputs
# are uniform on [0, 1), as in the lattice the kernel exists for: no
# cancellation, so the |max| agrees to a few ulps
RTOL = 1e-5
# the largest output is a sum of positive terms: it agrees more tightly
AMAX_RTOL = 1e-6


@pytest.mark.parametrize(
    "B,M,K,N",
    [
        (3, 70, 90, 50),     # tests/test_pallas.py's kernel case
        (1, 1, 300, 1),      # M = N = 1: the lattice's final dot
        (2, 130, 17, 129),   # ragged edges of the CUDA kernel's tiles
    ],
)
def test_bmm_absmax_matches_reference(B, M, K, N):
    rng = np.random.default_rng(B * M + K * N)
    x = rng.uniform(size=(B, M, K)).astype(np.float32)
    y = rng.uniform(size=(B, K, N)).astype(np.float32)
    ref, ref_amax = ref_bmm_absmax(
        jnp.asarray(x), jnp.asarray(y), bm=32, bn=128, bk=128,
        interpret=True,
    )
    out, amax = bmm_absmax(torch.from_numpy(x), torch.from_numpy(y))
    scale = np.abs(np.asarray(ref)).max()
    assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                    atol=RTOL * scale)
    assert_allclose(float(amax), float(ref_amax), rtol=AMAX_RTOL)
    # the |max| is the max of the output it returns
    assert float(amax) == float(out.abs().max())


@pytest.mark.parametrize(
    "l_legs,r_legs,out_legs,sizes",
    [
        # tests/test_pallas.py's layout: batch leg, permuted output
        ("bik", "kbj", "jbi", {"b": 4, "i": 5, "k": 6, "j": 7}),
        # no batch, two contracted legs, output permuted across sides
        ("akc", "cbk", "ba", {"a": 9, "k": 3, "c": 4, "b": 11}),
        # the lattice's final step: a full contraction to a scalar
        ("pq", "qp", "", {"p": 8, "q": 16}),
    ],
)
def test_pairwise_bmm_absmax_matches_reference(l_legs, r_legs, out_legs,
                                               sizes):
    rng = np.random.default_rng(len(l_legs) + len(out_legs))
    a = rng.uniform(size=[sizes[ix] for ix in l_legs]).astype(np.float32)
    b = rng.uniform(size=[sizes[ix] for ix in r_legs]).astype(np.float32)
    legs = (tuple(l_legs), tuple(r_legs), tuple(out_legs))
    ref, ref_amax = ref_pairwise_bmm_absmax(
        jnp.asarray(a), jnp.asarray(b), *legs, interpret=True
    )
    got, amax = pairwise_bmm_absmax(
        torch.from_numpy(a), torch.from_numpy(b), *legs
    )
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    assert_allclose(got.numpy(), ref, rtol=RTOL,
                    atol=RTOL * np.abs(ref).max())
    assert_allclose(float(amax), float(ref_amax), rtol=AMAX_RTOL)
    expect = np.einsum(f"{l_legs},{r_legs}->{out_legs}",
                       a.astype(np.float64), b.astype(np.float64))
    assert_allclose(got.numpy(), expect, rtol=RTOL,
                    atol=RTOL * np.abs(expect).max())


@pytest.mark.parametrize(
    "l_legs,r_legs,out_legs,sizes",
    [
        ("bik", "kbj", "jbi", {"b": 4, "i": 5, "k": 6, "j": 7}),
        ("akc", "cbk", "ba", {"a": 9, "k": 3, "c": 4, "b": 11}),
        # y already (contract, r_free) ordered: contiguous before, now
        # one copy into (r_free, contract) order
        ("ik", "kj", "ij", {"i": 3, "k": 8, "j": 5}),
        ("pq", "qp", "", {"p": 8, "q": 16}),
    ],
)
def test_pairwise_hands_the_kernel_k_major_operands(
    monkeypatch, l_legs, r_legs, out_legs, sizes
):
    """x as a contiguous (B, M, K), y as the transpose of a contiguous
    (B, N, K): the layouts TF32 wgmma reads from TMA tiles."""
    seen = []

    def spy(x3, y3):
        seen.append((x3, y3))
        return bmm_module.bmm_absmax_plain(x3, y3)

    monkeypatch.setattr(bmm_module, "bmm_absmax", spy)
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(size=[sizes[ix] for ix in l_legs]))
    b = torch.from_numpy(rng.uniform(size=[sizes[ix] for ix in r_legs]))
    got, _ = pairwise_bmm_absmax(a, b, l_legs, r_legs, out_legs)
    (x3, y3), = seen
    B, M, K = x3.shape
    assert y3.shape[:2] == (B, K)
    assert x3.is_contiguous()
    assert y3.transpose(1, 2).is_contiguous()
    assert y3.stride() == (y3.shape[2] * K, 1, K)
    expect = np.einsum(f"{l_legs},{r_legs}->{out_legs}", a.numpy(), b.numpy())
    assert_allclose(got.numpy(), expect, rtol=1e-12)


def test_k_padding_leaves_the_product_exact():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 5, 7)))
    yt = torch.from_numpy(rng.normal(size=(2, 3, 7)))
    xp, ytp = _pad_k(x, 8), _pad_k(yt, 8)
    assert xp.shape == (2, 5, 8) and ytp.shape == (2, 3, 8)
    assert (xp[..., 7] == 0).all() and torch.equal(xp[..., :7], x)
    # zero terms only: equal up to the summation order
    assert_allclose(
        torch.bmm(xp, ytp.transpose(1, 2)).numpy(),
        torch.bmm(x, yt.transpose(1, 2)).numpy(), rtol=1e-14, atol=1e-14,
    )
    # empty K pads to zeros: the product is zero
    e = _pad_k(torch.zeros(1, 3, 0), 4)
    assert e.shape == (1, 3, 4) and not e.any()


def test_plain_version_keeps_float64():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 3, 4)))
    y = torch.from_numpy(rng.normal(size=(2, 4, 5)))
    out, amax = bmm_absmax(x, y)
    assert out.dtype == amax.dtype == torch.float64
    expect = np.einsum("bmk,bkn->bmn", x.numpy(), y.numpy())
    assert_allclose(out.numpy(), expect, rtol=1e-12)
    assert float(amax) == np.abs(expect).max()


def test_plain_version_propagates_nan():
    x = torch.ones(1, 2, 2)
    x[0, 1, 0] = float("nan")
    _, amax = bmm_absmax(x, torch.ones(1, 2, 2))
    assert torch.isnan(amax)


def test_kernel_wrapper_refuses_what_it_does_not_take():
    x = torch.zeros(1, 4, 4)
    # a CPU tensor handed to the CUDA launcher raises, never computes
    with pytest.raises(ValueError, match="CUDA"):
        bmm_absmax_cuda(x, x)
    # the kernel is float32 only: float64 raises before any device check
    with pytest.raises(ValueError, match="float32"):
        bmm_absmax_cuda(x.double(), x.double())
    # no path for other devices
    m = torch.zeros(1, 4, 4, device="meta")
    with pytest.raises(ValueError):
        bmm_absmax(m, m)


@pytest.mark.parametrize(
    "B,M,K,N,splits",
    [
        (1, 65536, 4096, 4096, 1),   # enough tiles: no split
        (1, 256, 65536, 256, 33),    # 4 tiles, long K: ~one block per SM
        (1, 1, 65536, 1, 64),        # the final dot
        (1, 4096, 256, 256, 1),      # few tiles but short K
        (1, 256, 2048, 256, 2),
        (3, 5, 0, 7, 1),             # empty K
    ],
)
def test_split_k_covers_k(B, M, K, N, splits):
    got, k_chunk = _split_k(B, M, K, N, n_sm=132)
    assert got == splits
    assert k_chunk % 32 == 0 and k_chunk >= 32
    # every split starts inside K and together they cover it
    assert got * k_chunk >= K
    assert (got - 1) * k_chunk < max(K, 1)
