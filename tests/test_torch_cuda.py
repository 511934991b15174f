"""The gate-chain CUDA kernel against its plain PyTorch version, on the
card. Skipped without one; run on a GPU machine with

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: the suite's conftest configures JAX, which a GPU
machine need not have).
"""

import numpy as np
import pytest
import torch

from cotengra_tpu_torch.ops.gate_chains import (
    build_chain_spec,
    run_chain,
    run_chain_cuda,
    run_chain_plain,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cotengra_tpu_torch import resolve_device

    return resolve_device("cuda")


def _chain(n, gates, seed):
    """A spec on an n-leg tensor of size-2 legs, and float32 inputs."""
    order0 = tuple(f"a{k}" for k in range(n))
    sizes = {ix: 2 for ix in order0}
    named = []
    nxt = 0
    cur = list(order0)
    for pos, nnew in gates:
        c = tuple(cur[p] for p in pos)
        ny = tuple(f"b{nxt + j}" for j in range(nnew))
        nxt += nnew
        for ix in ny:
            sizes[ix] = 2
        named.append((c, ny))
        rest = [ix for ix in cur if ix not in c]
        cur = rest[: pos[0]] + list(ny) + rest[pos[0]:]
    spec, out_order, c_orders = build_chain_spec(order0, sizes, named)
    assert spec is not None, out_order
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(2 * 2**n, dtype=np.float32)
    ys = [
        rng.standard_normal(
            (2, 2 ** len(c), 2 ** len(ny)), dtype=np.float32
        )
        for c, ny in c_orders
    ]
    return spec, x, ys


@pytest.mark.parametrize(
    "gates",
    [
        [((0, 1), 2)],                       # grid dims
        [((15, 16), 2), ((3, 9), 2)],        # lane + mixed
        [((10, 11, 12), 5)],                 # K=8 -> N=32 (grows)
        [((0, 1, 2, 3, 4), 3)],              # K=32 -> N=8 (shrinks)
        [((0, 1, 2, 3, 4, 5), 3)],           # K=64: the generic path
        [((1, 2), 2)] * 8,                   # a full 8-gate chain
    ],
)
def test_gate_chain_kernel_matches_plain(cuda, gates):
    spec, x, ys = _chain(19, gates, seed=len(gates))
    xt = torch.from_numpy(x).to(cuda)
    yt = [torch.from_numpy(y).to(cuda) for y in ys]
    before = run_chain_cuda.launches
    got = run_chain(spec, xt, yt)
    assert run_chain_cuda.launches - before == len(gates)
    ref = run_chain_plain(spec, xt, yt)
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= 1e-5 * scale


def test_gate_chain_kernel_rejects_bad_input(cuda):
    spec, x, ys = _chain(17, [((0, 1), 2)], seed=0)
    xt = torch.from_numpy(x).to(cuda)
    yt = [torch.from_numpy(y).to(cuda) for y in ys]
    with pytest.raises(ValueError):
        run_chain(spec, xt.double(), [y.double() for y in yt])
    with pytest.raises(ValueError):
        run_chain(spec, xt, [yt[0].cpu()])
    with pytest.raises(ValueError):
        run_chain(spec, xt[:-2], yt)
