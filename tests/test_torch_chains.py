"""The plain gate-chain version (what CPU tensors run) equals the
reference ``run_chain`` in Pallas interpret mode, on the same specs and
the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from cotengra_tpu.ops import pallas_gates as ref_gates

from cotengra_tpu_torch.ops.gate_chains import build_chain_spec, run_chain

torch.set_num_threads(1)


def _gates(n, picks):
    """Named gates on an n-leg tensor of size-2 legs: each pick is
    (positions in the current order, number of new legs)."""
    order0 = tuple(f"a{k}" for k in range(n))
    sizes = {ix: 2 for ix in order0}
    cur = list(order0)
    gates = []
    for g, (pos, nnew) in enumerate(picks):
        c = tuple(cur[p] for p in pos)
        ny = tuple(f"g{g}_{j}" for j in range(nnew))
        for ix in ny:
            sizes[ix] = 2
        rest = [ix for ix in cur if ix not in c]
        cur = rest[: pos[0]] + list(ny) + rest[pos[0]:]
        gates.append((c, ny))
    return order0, sizes, gates


CASES = {
    # two dim gates above the tile
    "dim": (17, [((0, 1), 2), ((2, 3), 2)]),
    # row (R2) and lane (C) gate axes: coefficient-field gates
    "row_lane_field": (17, [((4, 5), 2), ((15, 16), 2)]),
    # a gate spanning a dim axis and a lane axis
    "dim_lane": (17, [((1, 12), 2)]),
    # a dim axis plus two row and two lane axes (K=32, N=16): its
    # coefficient fields exceed the budget -> mix mode
    "mix": (17, [((1, 5, 6, 15, 16), 4)]),
    # K != N: a growing then a shrinking gate
    "grow_shrink": (18, [((0, 1), 3), ((0, 1, 2), 2)]),
}


_F64 = (np.float64, 1e-12)
_F32 = (np.float32, 1e-5)


# the mix case runs in float64 only: interpreting its unrolled kernel
# takes ~10 s
@pytest.mark.parametrize("case,dtype,rtol", [
    (case, *dt)
    for case in sorted(CASES)
    for dt in ((_F64,) if case == "mix" else (_F64, _F32))
])
def test_plain_chain_matches_reference(case, dtype, rtol):
    n, picks = CASES[case]
    order0, sizes, gates = _gates(n, picks)
    ref_spec, ref_order, c_orders = ref_gates.build_chain_spec(
        order0, sizes, gates
    )
    spec, order, _ = build_chain_spec(order0, sizes, gates)
    assert ref_spec is not None, ref_order
    assert order == ref_order and spec.key() == ref_spec.key()
    if case == "mix":
        assert [g[0] for g in spec.gates] == ["mix"]
    if case == "row_lane_field":
        assert {g[0] for g in spec.gates} == {"field"}

    rng = np.random.default_rng(sum(map(ord, case)))
    x = rng.standard_normal(2 * 2**n).astype(dtype)
    ys = [
        rng.standard_normal(
            (2, 2 ** len(c), 2 ** len(ny))
        ).astype(dtype)
        for c, ny in c_orders
    ]
    ref = np.asarray(
        ref_gates.run_chain(
            ref_spec, jnp.asarray(x), [jnp.asarray(y) for y in ys],
            interpret=True,
        )
    )
    got = run_chain(
        spec, torch.from_numpy(x), [torch.from_numpy(y) for y in ys]
    ).numpy()
    assert got.shape == ref.shape
    assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())
