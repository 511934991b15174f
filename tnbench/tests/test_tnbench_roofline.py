"""The roofline arithmetic on hand-worked shapes."""

import pytest

from tnbench import roofline


def test_chain_bound_bytes():
    # x: 2^20 complex values as planes; two 4x4 gates; out the same size
    x, out = (2 * 2**20,), (2 * 2**20,)
    gates = [(2, 4, 4), (2, 4, 4)]
    nbytes = 4 * (2 * 2**20 + 2 * 2**20 + 2 * 32)
    flops = 8 * 2**20 * 4 * 2
    assert roofline.chain_bound_s(x, out, gates) == pytest.approx(
        max(nbytes / 3.35e12, flops / 494.7e12))
    assert nbytes / 3.35e12 > flops / 494.7e12


def test_chain_bound_batched_and_shrinking():
    # 3 slices; a gate taking K=4 to N=2 halves the state
    x, out = (3, 2 * 1024), (3, 2 * 512)
    gates = [(3, 2, 4, 2)]
    nbytes = 4 * (3 * 2048 + 3 * 1024 + 3 * 16)
    assert roofline.chain_bound_s(x, out, gates) == pytest.approx(nbytes / 3.35e12)


def test_bmm_bound():
    # large square: compute-bound at the TF32 rate
    assert roofline.bmm_bound_s((1, 4096, 4096), (1, 4096, 4096)) == pytest.approx(
        2 * 4096**3 / 494.7e12)
    # batched skinny: bytes-bound
    B, M, K, N = 64, 256, 16, 16
    assert roofline.bmm_bound_s((B, M, K), (B, K, N)) == pytest.approx(
        4 * B * (M * K + K * N + M * N) / 3.35e12)


def test_slice_norm_err():
    from tnbench.checks.slice_norm_err import number

    # two slices 3 and -2.9 (sum 0.1, norm ~4.17): an error of 1e-3 reads
    # against the norm, not against the cancelled sum
    norm = (3.0**2 + 2.9**2) ** 0.5
    assert number((0.101, 0.0), (0.1, 0.0), (norm, 0.0)) == pytest.approx(1e-3 / norm)
    # exponents: 1.0e40 vs 1.0000001e40, norm 2e40
    assert number((1.0, 40.0), (1.0000001, 40.0), (2.0, 40.0)) == pytest.approx(5e-8)
    assert number((-1.0, 40.0), (1.0, 40.0), (1.0, 40.0)) == pytest.approx(2.0)
    assert number((1.0, 400.0), (1.0, 0.0), (1.0, 0.0)) == float("inf")
    assert number((1 + 1j, 0.0), (1 + 1j, 0.0), (2**0.5, 0.0)) == 0.0
