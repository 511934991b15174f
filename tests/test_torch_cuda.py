"""The CUDA kernels (gate chain, matmul with fused |max|) against their
plain PyTorch versions, on the card. Skipped without one; run on a GPU
machine with

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: the suite's conftest configures JAX, which a GPU
machine need not have).
"""

import collections
import itertools

import numpy as np
import pytest
import torch

from cotengra_tpu_torch.ops.bmm_absmax import (
    bmm_absmax,
    bmm_absmax_cuda,
    bmm_absmax_plain,
)
from cotengra_tpu_torch.ops.gate_chains import (
    build_chain_spec,
    chain_tile_plan,
    run_chain,
    run_chain_cuda,
    run_chain_plain,
)
from cotengra_tpu_torch.ops.svd_core import (
    svd_topk,
    svd_topk_cuda,
    svd_topk_plain,
    unconverged,
)

from cotengra_tpu_torch.ops.qr_core import qr_apply_cuda, qr_factor_cuda
from test_torch_qr_core import VALUE_SHAPES

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


_OVERLAPPING = [((1, 2), 2), ((2, 3), 2), ((3, 4), 2), ((1, 2), 2)]
_DISJOINT = [((1, 2), 2), ((4, 5), 2), ((7, 8), 2), ((10, 11), 2)]
_MIXED_EIGHT = [((0, 1), 2), ((2, 3), 2), ((1, 2), 2), ((4, 5), 2),
                ((3, 4), 2), ((0, 1), 2), ((2, 3), 2), ((1, 2), 2)]
_KRON_BETWEEN = [((0, 1), 2), ((1, 5, 6, 17, 18), 4), ((2, 3), 2)]

# seven 2-leg gates on 2^24 elements whose widest tile (8192 complex
# per batch element) outgrows one block's shared memory: two passes
_OVER_BUDGET = [((0, 1), 2), ((2, 3), 2), ((14, 15), 2), ((16, 17), 2),
                ((18, 19), 2), ((20, 21), 2), ((22, 23), 2)]


@pytest.mark.parametrize(
    "n,gates,passes",
    [
        (19, [((0, 1), 2)], 1),                   # grid dims
        (19, [((15, 16), 2), ((3, 9), 2)], 1),    # lane + mixed
        (19, [((10, 11, 12), 5)], 1),     # K=8 -> N=32 (grows)
        (19, [((0, 1, 2, 3, 4), 3)], 1),  # K=32 -> N=8 (shrinks)
        (19, [((0, 1, 2, 3, 4, 5), 3)], 1),  # K=64: generic
        (19, [((1, 2), 2)] * 8, 1),       # a full 8-gate chain
        # the stride-1 leg touched, as in t27 chain 6
        (19, [((15, 18), 2), ((16, 17), 2), ((17, 18), 2), ((1, 2), 2),
              ((14, 18), 2)], 1),
        (24, _OVER_BUDGET, 2),                  # over the budget
        # single gates of each (K, N) of the m20 plan, in registers up to
        # 16 x 16 ((8, 32), (32, 8) above and (16, 32) item by item), and
        # of 2 x 1 and 2 x 2
        (19, [((1,), 0)], 1),
        (19, [((1,), 1)], 1),
        (19, [((1, 2), 2)], 1),
        (19, [((1, 2), 3)], 1),
        (19, [((1, 2, 3), 2)], 1),
        (19, [((1, 2, 3), 3)], 1),
        (19, [((1, 2, 3), 4)], 1),
        (19, [((1, 2, 3, 4), 4)], 1),
        (19, [((1, 2, 3, 4), 5)], 1),
        # runs of register groups: overlapping legs (one group), disjoint
        # (two groups: a boundary inside the pass, the last writing out),
        # eight gates in three groups, growing and shrinking gates
        (19, _OVERLAPPING, 1),
        (19, _DISJOINT, 1),
        (19, _MIXED_EIGHT, 1),
        (19, [((1, 2), 3), ((6, 7), 2), ((0, 1, 2), 2)], 1),
        # a K = 32, N = 16 gate (K * N = 512, as fuse_gates makes them)
        # item by item between two register groups
        (19, _KRON_BETWEEN, 1),
        # the last group's outputs on out's innermost legs, stored to out
        # a stride apart
        (19, [((0, 1), 2), ((16, 17), 2), ((17, 18), 2)], 1),
        # K = 2 and 4 item by item: contracted and created bits two apart
        (19, [((1,), 3)], 1),
        (19, [((1, 2), 4)], 1),
    ],
)
def test_gate_chain_kernel_matches_plain(cuda, n, gates, passes):
    spec, x, ys = _chain(n, gates, seed=len(gates))
    assert len(chain_tile_plan(spec)) == passes
    xt = torch.from_numpy(x).to(cuda)
    yt = [torch.from_numpy(y).to(cuda) for y in ys]
    before = run_chain_cuda.launches
    got = run_chain(spec, xt, yt)
    assert run_chain_cuda.launches - before == passes
    ref = run_chain_plain(spec, xt, yt)
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("batched", ["x", "gates", "both"])
@pytest.mark.parametrize(
    "n,gates,passes",
    [
        (19, [((15, 16), 2), ((3, 9), 2)], 1),
        (19, [((0, 1, 2, 3, 4), 3)], 1),
        (24, _OVER_BUDGET, 2),
        (19, _DISJOINT, 1),
        (19, _KRON_BETWEEN, 1),
    ],
)
def test_batched_gate_chain_kernel_matches_plain(cuda, n, gates, passes,
                                                 batched):
    """The slice leg: x ``(S, 2 * numel)``, gates ``(S, 2, K, N)`` or
    both, one launch per pass for the whole batch, against the plain
    version on the same batch and on each slice."""
    spec, x, ys = _chain(n, gates, seed=len(gates))
    S = 3
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n)
    xt = torch.from_numpy(x).to(cuda)
    yt = [torch.from_numpy(y).to(cuda) for y in ys]
    if batched in ("x", "both"):
        xt = torch.randn((S,) + tuple(xt.shape), generator=gen, device=cuda)
    if batched in ("gates", "both"):
        yt = [torch.randn((S,) + tuple(y.shape), generator=gen, device=cuda)
              for y in yt]
    before = run_chain_cuda.launches
    got = run_chain(spec, xt, yt)
    assert run_chain_cuda.launches - before == passes
    ref = run_chain_plain(spec, xt, yt)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (S, 2 * spec.gate_strides[-1].numel_out)
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= 1e-5 * scale
    for s in range(S):
        one = run_chain_plain(
            spec, xt[s] if xt.dim() == 2 else xt,
            [y[s] if y.dim() == 4 else y for y in yt],
        )
        assert (got[s] - one).abs().max().item() <= 1e-5 * scale


_M20_CHAINS = {}


def _m20_chains():
    """The in-place chains of the committed Sycamore-53 m=20 t28 plan,
    built through the port (instance, absorption, plan, step plan)."""
    if not _M20_CHAINS:
        from pathlib import Path

        from cotengra_tpu_torch import (
            absorb_simple_tensors,
            load_tree,
            rand_circuit_tn,
        )
        from cotengra_tpu_torch.ops.grouped_plan import plan_grouped
        from cotengra_tpu_torch.ops.lowering import (
            extract_contractions,
            sliced_input_legs,
        )

        inputs, output, _, _, arrays = rand_circuit_tn(53, 20, seed=42)
        inputs, arrays = absorb_simple_tensors(
            inputs, arrays, output, max_rank=2, max_absorb_size=2**12
        )
        size_dict = {
            ix: int(d) for t, a in zip(inputs, arrays)
            for ix, d in zip(t, a.shape)
        }
        plan = Path(__file__).resolve().parent.parent / "plans" / (
            "sycamore53_m20_t28.json"
        )
        tree = load_tree(str(plan), inputs, output, size_dict)
        orders = [sliced_input_legs(tree, i) for i in range(tree.N)]
        plans = plan_grouped(
            extract_contractions(tree), tree.size_dict, orders,
            gate_mode="inplace",
        )[0]
        _M20_CHAINS["recs"] = [rec for k, rec in plans if k == "inplace"]
    return _M20_CHAINS["recs"]


def _kn(rec):
    return [(K, N) for _, _, K, N in rec.ys]


@pytest.mark.parametrize(
    "which", ["two-pass", "eight gates in one pass", "(16,32) gate"]
)
def test_gate_chain_kernel_on_m20_chains(cuda, which):
    """m=20 t28 chains at full size that no m=10 path runs: the chain
    whose tile outgrows one pass, the eight-gate chain with the most
    register groups in one pass, and the largest one that opens with a
    (16, 32) gate."""
    recs = _m20_chains()
    two = [r for r in recs if len(chain_tile_plan(r.spec)) == 2]
    assert len(two) == 1
    if which == "(16,32) gate":
        rec = max(
            (r for r in recs if (16, 32) in _kn(r)),
            key=lambda r: r.spec.gate_strides[0].numel_in,
        )
    elif which == "two-pass":
        rec = two[0]
    else:
        rec = max(
            (r for r in recs if len(r.ys) == 8),
            key=lambda r: (len(chain_tile_plan(r.spec)[0].groups),
                           r.spec.gate_strides[0].numel_in),
        )
    passes = len(chain_tile_plan(rec.spec))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(len(_kn(rec)))
    n_in = rec.spec.gate_strides[0].numel_in
    x = torch.randn(2 * n_in, generator=gen, device=cuda)
    ys = [torch.randn((2, K, N), generator=gen, device=cuda)
          for K, N in _kn(rec)]
    before = run_chain_cuda.launches
    got = run_chain(rec.spec, x, ys)
    assert run_chain_cuda.launches - before == passes
    ref = run_chain_plain(rec.spec, x, ys)
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= 1e-5 * scale


def test_gate_chain_kernel_short_last_batch_tile(cuda, monkeypatch):
    """A batch tile of 3 elements over a power-of-two batch: the last
    tile holds fewer, and each group's items stop at them. (The planner
    picks powers of two that divide the batch; the argument block is
    changed here.)"""
    from cotengra_tpu_torch.ops import gate_chains

    spec, x, ys = _chain(19, [((0, 1), 2), ((2, 3), 2), ((1, 2), 2)],
                         seed=5)
    make = gate_chains._pass_kernel_args

    def short(ps):
        meta, tables = make(ps)
        assert meta[5] % 3 != 0
        meta[1:3] = [3, 2]  # batch tile 3, two ring stages
        kn = [(np.prod([d[0] for d in g.kdims]),
               np.prod([d[0] for d in g.ndims])) for g in ps.tile]
        assert gate_chains._pass_smem_bytes(
            ps.tile[0].numel_in, meta[4], meta[16], kn, len(tables), 3, 2
        ) <= gate_chains.SMEM_BUDGET
        return meta, tables

    monkeypatch.setattr(gate_chains, "_pass_kernel_args", short)
    xt = torch.from_numpy(x).to(cuda)
    yt = [torch.from_numpy(y).to(cuda) for y in ys]
    got = run_chain(spec, xt, yt)
    ref = run_chain_plain(spec, xt, yt)
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= 1e-5 * scale


def test_gate_chain_counts_register_and_item_gates(cuda):
    """Two 4 x 4 gates in register groups and a 32 x 16 gate item by item
    between them: one launch, three groups, counted by the wrapper and
    ``GATE_COUNTS`` and on its ``kernel.launch`` span."""
    from cotengra_tpu_torch import tracing
    from cotengra_tpu_torch.ops import gate_chains

    counts = gate_chains.GATE_COUNTS
    spec, x, ys = _chain(19, _KRON_BETWEEN, seed=6)
    xt = torch.from_numpy(x).to(cuda)
    yt = [torch.from_numpy(y).to(cuda) for y in ys]
    before = (run_chain_cuda.launches, counts["reg_gates"],
              counts["item_gates"])
    with tracing.record():
        run_chain_cuda(spec, xt, yt)
    after = (run_chain_cuda.launches, counts["reg_gates"],
             counts["item_gates"])
    assert [b - a for a, b in zip(before, after)] == [1, 2, 1]
    (rec,) = [r for r in tracing.records() if r.name == "kernel.launch"]
    assert (rec.attrs["reg_gates"], rec.attrs["item_gates"],
            rec.attrs["groups"]) == (2, 1, 3)


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


@pytest.mark.parametrize(
    "B,M,K,N",
    [
        (1, 4096, 256, 4096),    # lattice shapes, one output tile wave
        (1, 256, 65536, 256),    # split K
        (1, 1, 65536, 1),        # the final dot, split K
        (3, 130, 17, 129),       # ragged tiles, K and N not multiples of 4
        (2, 0, 8, 5),            # empty output
        (1, 3, 0, 5),            # empty K: zeros
        (2, 300, 30, 70),        # K % 4 != 0: zero-padded to 32
        (1, 1048576, 256, 256),  # the lattice's most frequent step
        (1, 65536, 4096, 4096),  # the lattice's largest step
    ],
)
def test_bmm_absmax_kernel_matches_plain(cuda, B, M, K, N):
    rng = np.random.default_rng(M + K + N)
    x = torch.from_numpy(
        rng.random((B, M, K), dtype=np.float32)
    ).to(cuda)
    y = torch.from_numpy(
        rng.random((B, K, N), dtype=np.float32)
    ).to(cuda)
    _check_kernel_vs_plain(x, y)


def _check_kernel_vs_plain(x, y):
    B, M, K = x.shape
    N = y.shape[2]
    before = bmm_absmax_cuda.launches
    out, amax = bmm_absmax(x, y)
    assert bmm_absmax_cuda.launches - before == 1
    if out.numel() == 0:
        assert tuple(out.shape) == (B, M, N) and float(amax) == 0.0
        return
    ref, ref_amax = bmm_absmax_plain(x, y)
    torch.cuda.synchronize()
    scale = float(ref_amax)
    assert (out - ref).abs().max().item() <= 1e-5 * max(scale, 1e-30)
    assert abs(float(amax) - scale) <= 1e-5 * max(scale, 1e-30)
    assert float(amax) == out.abs().max().item()
    return out, amax


@pytest.mark.parametrize("layout", ["transposed view", "contiguous"])
def test_bmm_absmax_kernel_takes_y_either_way(cuda, layout):
    """y as the transpose of a contiguous (B, N, K) (what the pairwise
    contraction hands over) or as a contiguous (B, K, N) (one transposing
    copy in the wrapper): the same result."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.random((2, 700, 96), dtype=np.float32)).to(cuda)
    yt = torch.from_numpy(rng.random((2, 300, 96), dtype=np.float32)).to(cuda)
    y = yt.transpose(1, 2)
    if layout == "contiguous":
        y = y.contiguous()
    assert y.transpose(1, 2).is_contiguous() == (layout != "contiguous")
    out, amax = _check_kernel_vs_plain(x, y)
    ref, ref_amax = bmm_absmax(x, yt.transpose(1, 2))
    assert torch.equal(out, ref) and float(amax) == float(ref_amax)


@pytest.mark.parametrize("y_kind", ["tf32-exact", "random"])
def test_bmm_absmax_kernel_keeps_inf_and_nan(cuda, y_kind):
    """inf * finite stays inf, inf * -inf is -inf, NaN propagates, as in
    float32; the other entries agree with the plain version."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.random((1, 200, 64), dtype=np.float32)).to(cuda)
    if y_kind == "tf32-exact":
        y = torch.ones(1, 64, 130, device=cuda)  # small parts are all 0
    else:
        y = torch.from_numpy(
            rng.random((1, 64, 130), dtype=np.float32)
        ).to(cuda)
    x[0, 5, 7] = float("inf")
    x[0, 6, 3] = -float("inf")
    y[0, 3, 11] = float("inf")        # row 6, column 11: -inf * inf
    y[0, 20, 40] = -float("inf")      # column 40: -inf from every row
    out, amax = bmm_absmax(x, y)
    ref, _ = bmm_absmax_plain(x, y)
    torch.cuda.synchronize()
    assert torch.isinf(out[0, 5, 0]) and out[0, 6, 11] == -float("inf")
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    assert torch.equal(out == float("inf"), ref == float("inf"))
    assert torch.equal(out == -float("inf"), ref == -float("inf"))
    fin = torch.isfinite(ref)
    assert fin.sum() > 0
    scale = ref[fin].abs().max().item()
    assert (out[fin] - ref[fin]).abs().max().item() <= 1e-5 * scale
    # rows with inf at k = 7 meet the -inf of column 40: NaN, as in float32
    assert torch.isnan(amax).item() and torch.isnan(ref[0, 5, 40]).item()
    y[0, 20, 40] = 1.0
    out, amax = bmm_absmax(x, y)
    assert not torch.isnan(out).any().item() and float(amax) == float("inf")
    x[0, 9, 1] = float("nan")
    out, amax = bmm_absmax(x, y)
    assert torch.isnan(out[0, 9]).all() and torch.isnan(amax).item()


def test_bmm_absmax_kernel_propagates_nan_and_rejects(cuda):
    x = torch.ones(1, 64, 64, device=cuda)
    x[0, 5, 7] = float("nan")
    _, amax = bmm_absmax(x, torch.ones(1, 64, 64, device=cuda))
    assert torch.isnan(amax).item()
    with pytest.raises(ValueError):
        bmm_absmax(x.double(), x.double())
    with pytest.raises(ValueError):
        bmm_absmax(x.transpose(1, 2), x)
    with pytest.raises(ValueError):
        bmm_absmax(x, x.cpu())


def test_einsum_lattice_launches_the_kernel(cuda):
    """The front end without ``device=`` runs on the card: the stripped
    4x4 bond-16 lattice through ``einsum(..., implementation="pallas")``
    launches ``bmm_absmax`` and matches the CPU run of the same call
    (the kernel's plain version) in float32."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.utils.eqs import inputs_output_to_eq

    inputs, output, shapes, _ = ctt.lattice_equation([4, 4], d_min=16)
    rng = np.random.default_rng(7)
    arrays = [rng.uniform(size=s).astype(np.float32) for s in shapes]
    eq = inputs_output_to_eq(inputs, output)
    kw = dict(optimize="greedy", strip_exponent=True, implementation="pallas")
    before = bmm_absmax_cuda.launches
    m, e = ctt.einsum(eq, *arrays, **kw)
    torch.cuda.synchronize()
    assert m.device == cuda and m.dtype == torch.float32
    assert bmm_absmax_cuda.launches > before
    mc, ec = ctt.einsum(eq, *arrays, device="cpu", **kw)
    log10 = np.log10(abs(m.item())) + e.item()
    log10_cpu = np.log10(abs(mc.item())) + ec.item()
    assert np.isfinite(log10) and abs(log10 - log10_cpu) <= 1e-4


def test_mixed_lattice_on_the_card(cuda):
    """A complex input among real ones on the kernel route: the stripped
    4x4 bond-16 lattice with input 0 times exp(i pi/3) keeps its real x
    real steps on ``bmm_absmax`` (launches > 0), promotes the rest, and
    equals the exact value (the real lattice's times the phase, both
    on the card) in float32."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.utils.eqs import inputs_output_to_eq

    inputs, output, shapes, _ = ctt.lattice_equation([4, 4], d_min=16)
    rng = np.random.default_rng(7)
    arrays = [rng.uniform(size=s).astype(np.float32) for s in shapes]
    phase = np.exp(1j * np.pi / 3)
    mixed = [(arrays[0] * phase).astype(np.complex64), *arrays[1:]]
    eq = inputs_output_to_eq(inputs, output)
    kw = dict(optimize="greedy", strip_exponent=True, implementation="pallas")
    mr, er = ctt.einsum(eq, *arrays, **kw)
    before = bmm_absmax_cuda.launches
    m, e = ctt.einsum(eq, *mixed, **kw)
    torch.cuda.synchronize()
    assert m.device == cuda and m.dtype == torch.complex64
    assert bmm_absmax_cuda.launches > before
    got = complex(m.item()) * 10 ** (e.item() - er.item())
    exp = mr.item() * phase
    assert abs(got - exp) <= 1e-4 * abs(exp)


def test_contract_compressed_on_the_card(cuda):
    """The compressed contraction of a 6x6 bond-4 lattice, planned by the
    ``"greedy-compressed"`` preset, on the card by default: float64 in,
    float64 out, equal to the ``device="cpu"`` run at rtol 1e-9 (cuSOLVER
    against LAPACK QR and SVD), stripped and unstripped."""
    import cotengra_tpu_torch as ctt

    inputs, output, shapes, size_dict = ctt.lattice_equation([6, 6], d_min=4)
    rng = np.random.default_rng(0)
    arrays = [np.ones(s) + 0.05 * rng.normal(size=s) for s in shapes]
    tree = ctt.array_contract_tree(
        inputs, output, size_dict=size_dict, optimize="greedy-compressed"
    )
    assert tree.total_write(chi=16) < tree.total_write_exact()  # truncates
    got = tree.contract_compressed(arrays, chi=16)
    torch.cuda.synchronize()
    assert got.device == cuda and got.dtype == torch.float64
    want = tree.contract_compressed(arrays, chi=16, device="cpu")
    assert want.device.type == "cpu"
    assert abs(got.item() - want.item()) <= 1e-9 * abs(want.item())
    m, e = tree.contract_compressed(arrays, chi=16, strip_exponent=True)
    assert m.device == cuda and e.dtype == torch.float64
    assert abs(
        np.log10(abs(m.item())) + e.item() - np.log10(abs(want.item()))
    ) <= 1e-5


# every core size the 16x16 bond-4 lattice at chi=32 truncates
SVD_CORE_SHAPES = [(1, 1), (32, 32), (64, 64), (128, 128), (256, 32),
                   (256, 128), (256, 256), (512, 512), (1024, 1024)]
# float64: the kernel's threshold 8 sqrt(L) u against the library's
# rounding; float32: its threshold, ~1.5e-5 at L = 1024
SVD_TOL = {torch.float64: 1e-11, torch.float32: 1e-4}
# columns whose singular value passes this share of the largest are held
# to orthonormality (below it the kernel stops at M's rounding level)
SVD_LIVE = {torch.float64: 1e-6, torch.float32: 1e-2}


def _card_core(shape, kind, dtype, device, seed=0):
    """A core on the card: Gaussian; of rank min(m, n) // 4; all zero; with
    exactly repeated singular values (4, 2, 1 in groups of a multiple of 8,
    the rest 0.5); or graded, singular values 1 .. 1e-8 geometrically."""
    m, n = shape
    p = min(m, n)
    gen = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    if kind == "random":
        M = torch.randn(shape, generator=gen, dtype=f64)
    elif kind == "rank-deficient":
        r = max(1, p // 4)
        M = (torch.randn((m, r), generator=gen, dtype=f64)
             @ torch.randn((r, n), generator=gen, dtype=f64))
    elif kind == "zero":
        M = torch.zeros(shape, dtype=f64)
    elif kind == "graded":
        qa = torch.linalg.qr(torch.randn((m, p), generator=gen, dtype=f64))[0]
        qb = torch.linalg.qr(torch.randn((n, p), generator=gen, dtype=f64))[0]
        M = (qa * torch.logspace(0, -8, p, dtype=f64)) @ qb.T
    else:
        qa = torch.linalg.qr(torch.randn((m, p), generator=gen, dtype=f64))[0]
        qb = torch.linalg.qr(torch.randn((n, p), generator=gen, dtype=f64))[0]
        third = max(1, (p // 24) * 8)
        s = torch.full((p,), 0.5, dtype=f64)
        for g, v in enumerate((4.0, 2.0, 1.0)):
            s[g * third:(g + 1) * third] = v
        M = (qa * s) @ qb.T
    return M.to(dtype).to(device).contiguous()


def _check_topk(M, k, U, s, V):
    """The kernel's top-k against the library's singular values: s to
    tolerance over the largest, the truncation's Frobenius error at the
    optimum (Eckart-Young: whichever vectors a degenerate group takes),
    and the live columns of U and V orthonormal. Never U or V alone."""
    tol = SVD_TOL[M.dtype]
    Md = M.double()
    ref = torch.linalg.svdvals(Md)
    top = float(ref[0])
    scale = max(float(torch.linalg.norm(Md)), 1e-300)
    assert s.dtype == M.dtype and torch.all(s[:-1] >= s[1:])
    assert float((s.double() - ref[:k]).abs().max()) <= tol * max(top, 1e-300)
    resid = float(torch.linalg.norm(Md - (U.double() * s.double()) @ V.double().T))
    opt = float(torch.sqrt((ref[k:] ** 2).sum()))
    assert abs(resid - opt) <= tol * scale
    live = s.double() > SVD_LIVE[M.dtype] * top
    if live.any():
        for X in (U, V):
            Xl = X.double()[:, live]
            eye = torch.eye(Xl.shape[1], dtype=torch.float64, device=M.device)
            assert float((Xl.T @ Xl - eye).abs().max()) <= 1e3 * tol


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("kind", ["random", "rank-deficient", "graded"])
@pytest.mark.parametrize("shape", SVD_CORE_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_svd_core_kernel_matches_plain(cuda, shape, kind, dtype):
    """The truncation-core kernel at every core size of the 16x16 lattice's
    plan, against the library (``svd_topk_plain``'s singular values), its
    wide transpose too, converged under the sweep cap: the launch says so,
    and the count of launches that hit the cap does not move."""
    for M in (_card_core(shape, kind, dtype, cuda),
              _card_core(shape[::-1], kind, dtype, cuda, seed=1)):
        k = min(32, *M.shape)
        before = svd_topk_cuda.launches
        capped = unconverged(cuda)
        U, s, V = svd_topk(M, k)
        torch.cuda.synchronize()
        assert svd_topk_cuda.launches == before + 1
        sweeps, converged = svd_topk_cuda.ctl[2:4].tolist()
        assert sweeps >= 1 and converged == 1
        assert unconverged(cuda) == capped
        _check_topk(M, k, U, s, V)
        # the library in M's dtype errs too: float32 gesvdj by ~1.5e-4 of
        # the largest at 1024 x 1024
        _, s_lib, _ = svd_topk_plain(M, k)
        tol = 10 * SVD_TOL[M.dtype]
        assert float((s - s_lib).abs().max()) <= tol * max(
            float(s_lib[0]), 1e-300)


@pytest.mark.parametrize("kind", ["zero", "degenerate"])
def test_svd_core_kernel_on_zero_and_degenerate_cores(cuda, kind):
    """An all-zero core gives zero singular values and a zero truncation;
    exactly repeated singular values, cut inside a group, the library's
    values and the optimal error."""
    for shape in ((64, 64), (256, 128), (128, 256)):
        M = _card_core(shape, kind, torch.float64, cuda)
        capped = unconverged(cuda)
        U, s, V = svd_topk_cuda(M, 32)
        torch.cuda.synchronize()
        assert svd_topk_cuda.ctl[3].item() == 1
        assert unconverged(cuda) == capped
        _check_topk(M, 32, U, s, V)
        if kind == "zero":
            assert float(s.abs().max()) == 0.0
            assert torch.all(torch.isfinite(U)) and torch.all(torch.isfinite(V))


def test_svd_core_kernel_above_the_plan(cuda):
    """A core wider than any the plan truncates (1100 x 1500), for
    correctness alone."""
    M = _card_core((1100, 1500), "random", torch.float64, cuda)
    capped = unconverged(cuda)
    U, s, V = svd_topk_cuda(M, 32)
    torch.cuda.synchronize()
    assert svd_topk_cuda.ctl[3].item() == 1 and unconverged(cuda) == capped
    _check_topk(M, 32, U, s, V)


def test_contract_compressed_makes_no_host_sync(cuda):
    """The 6x6 bond-4 lattice's compressed contraction with its inputs on
    the card: no synchronising call in the whole contraction
    (``set_sync_debug_mode("error")`` raises at the first), one kernel
    launch a truncation, and the value of the CPU run."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.ops import compressed

    inputs, output, shapes, size_dict = ctt.lattice_equation([6, 6], d_min=4)
    rng = np.random.default_rng(0)
    arrays = [np.ones(s) + 0.05 * rng.normal(size=s) for s in shapes]
    tree = ctt.array_contract_tree(
        inputs, output, size_dict=size_dict, optimize="greedy-compressed"
    )
    tensors = [torch.as_tensor(a, device=cuda) for a in arrays]
    tree.contract_compressed(tensors, chi=16)  # builds the kernels
    torch.cuda.synchronize()
    launches = svd_topk_cuda.launches
    truncations = compressed.COUNTS["truncations"]
    capped = unconverged(cuda)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tree.contract_compressed(tensors, chi=16)
        m, e = tree.contract_compressed(tensors, chi=16, strip_exponent=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    gained = compressed.COUNTS["truncations"] - truncations
    assert gained > 0 and svd_topk_cuda.launches - launches == gained
    assert unconverged(cuda) == capped
    want = tree.contract_compressed(arrays, chi=16, device="cpu").item()
    assert abs(got.item() - want) <= 1e-9 * abs(want)
    assert abs(np.log10(abs(m.item())) + e.item() - np.log10(abs(want))) <= 1e-9


# every QR operand shape of a value of the 16x16 bond-4 lattice at chi=32
QR_VALUE_SHAPES = sorted(VALUE_SHAPES)
# against LAPACK on the CPU in float64, over ||A|| (R) and ||Q C|| (Q C)
QR_TOL = {torch.float64: 1e-12, torch.float32: 2e-5}


def _qr_against_lapack(A, R, X, C, s):
    """R and ``X = Q [C sqrt(s); 0]`` from the kernel against LAPACK's QR
    of ``A`` on the CPU in float64, row by row up to the sign of R's
    diagonal (``A`` Gaussian: full rank). LAPACK takes every core of the
    host for it."""
    import os

    Ad = A.double().cpu()
    threads = torch.get_num_threads()
    torch.set_num_threads(os.cpu_count() or 1)
    try:
        Q_l, R_l = torch.linalg.qr(Ad)
    finally:
        torch.set_num_threads(threads)
    Rd, Xd = R.double().cpu(), X.double().cpu()
    d = torch.diagonal(Rd) * torch.diagonal(R_l)
    d = torch.where(d < 0, -1.0, 1.0).double()
    r_err = float(torch.linalg.norm(d[:, None] * Rd - R_l)) / float(
        torch.linalg.norm(Ad))
    want = Q_l @ (d[:, None] * C.double().cpu() * torch.sqrt(
        s.double().cpu())[None, :])
    x_err = float(torch.linalg.norm(Xd - want)) / float(torch.linalg.norm(want))
    return r_err, x_err


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("shape", QR_VALUE_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_qr_core_kernel_on_the_plans_shapes(cuda, shape, dtype):
    """The QR kernel on each operand shape of a value, both dtypes, beside
    a (chi, n) partner on the same bond, one factor and one apply launch,
    R and Q C of both sides held to LAPACK on the CPU (the card's library
    is the less accurate side, as for the SVD)."""
    gen = torch.Generator().manual_seed(sum(shape))
    k = min(shape)
    chi = min(k, 32)
    partner = (chi, shape[1])
    A = torch.randn(shape, generator=gen, dtype=torch.float64).to(dtype)
    B = torch.randn(partner, generator=gen, dtype=torch.float64).to(dtype)
    C = torch.randn((k, chi), generator=gen, dtype=torch.float64).to(dtype)
    D = torch.randn((min(partner), chi), generator=gen,
                    dtype=torch.float64).to(dtype)
    s = (torch.rand(chi, generator=gen, dtype=torch.float64) + 0.5).to(dtype)
    A, B, C, D, s = (x.to(cuda) for x in (A, B, C, D, s))
    launches = (qr_factor_cuda.launches, qr_apply_cuda.launches)
    R, Rb, factors = qr_factor_cuda(A, B)
    X, Xb = qr_apply_cuda(factors, C, D, s)
    torch.cuda.synchronize()
    assert R.shape == (k, shape[1]) and X.shape == (shape[0], chi)
    assert Rb.shape == (min(partner), shape[1]) and Xb.shape == (chi, chi)
    assert (qr_factor_cuda.launches, qr_apply_cuda.launches) == (
        launches[0] + 1, launches[1] + 1)
    assert R.dtype == dtype and X.dtype == dtype
    assert torch.equal(R, torch.triu(R))
    for M, R_, X_, C_ in ((A, R, X, C), (B, Rb, Xb, D)):
        r_err, x_err = _qr_against_lapack(M, R_, X_, C_, s)
        assert r_err <= QR_TOL[dtype] and x_err <= QR_TOL[dtype], (
            M.shape, r_err, x_err)


def test_qr_core_factors_both_sides_in_one_launch(cuda):
    """A truncation's two sides in one factor and one apply launch, each
    side as LAPACK gives it; a tall side beside a square one, and two wide
    ones."""
    gen = torch.Generator().manual_seed(7)
    for sa, sb in (((65536, 256), (256, 256)), ((32, 512), (32, 512)),
                   ((2048, 64), (64, 64))):
        A = torch.randn(sa, generator=gen, dtype=torch.float64)
        B = torch.randn(sb, generator=gen, dtype=torch.float64)
        chi = min(32, *sa, *sb)
        U = torch.randn((min(sa), chi), generator=gen, dtype=torch.float64)
        V = torch.randn((min(sb), chi), generator=gen, dtype=torch.float64)
        s = torch.rand(chi, generator=gen, dtype=torch.float64) + 0.5
        A, B, U, V, s = (x.to(cuda) for x in (A, B, U, V, s))
        launches = (qr_factor_cuda.launches, qr_apply_cuda.launches)
        Ra, Rb, factors = qr_factor_cuda(A, B)
        Xa, Xb = qr_apply_cuda(factors, U, V, s)
        torch.cuda.synchronize()
        assert (qr_factor_cuda.launches, qr_apply_cuda.launches) == (
            launches[0] + 1, launches[1] + 1)
        for M, R, X, C in ((A, Ra, Xa, U), (B, Rb, Xb, V)):
            errs = _qr_against_lapack(M, R, X, C, s)
            assert max(errs) <= QR_TOL[torch.float64], (M.shape, errs)


def test_contract_compressed_takes_the_qr_kernel(cuda):
    """The 6x6 bond-4 lattice's compressed contraction on the card: both
    sides of every truncation through the QR kernel (two operands a
    truncation, one factor and one apply launch), no library QR, no
    synchronising call (``set_sync_debug_mode("error")``), and the value
    of the CPU run, whose truncations take the library."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.ops import compressed

    inputs, output, shapes, size_dict = ctt.lattice_equation([6, 6], d_min=4)
    rng = np.random.default_rng(0)
    arrays = [np.ones(s) + 0.05 * rng.normal(size=s) for s in shapes]
    tree = ctt.array_contract_tree(
        inputs, output, size_dict=size_dict, optimize="greedy-compressed"
    )
    tensors = [torch.as_tensor(a, device=cuda) for a in arrays]
    tree.contract_compressed(tensors, chi=16)  # builds the kernels
    torch.cuda.synchronize()
    before = dict(compressed.COUNTS)
    launches = (qr_factor_cuda.launches, qr_apply_cuda.launches)
    library = []
    real_qr = torch.linalg.qr

    def counted(*args, **kwargs):
        library.append(1)
        return real_qr(*args, **kwargs)

    torch.linalg.qr = counted
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tree.contract_compressed(tensors, chi=16)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.linalg.qr = real_qr
    grown = {k: compressed.COUNTS[k] - before[k] for k in before}
    cuts = grown["truncations"]
    assert cuts > 0 and not library
    assert grown == {"truncations": cuts, "qr_kernel": 2 * cuts,
                     "qr_library": 0}
    assert (qr_factor_cuda.launches, qr_apply_cuda.launches) == (
        launches[0] + cuts, launches[1] + cuts)
    want = tree.contract_compressed(arrays, chi=16, device="cpu").item()
    assert abs(got.item() - want) <= 1e-9 * abs(want)


def test_port_planned_circuit_through_the_chain_kernel(cuda):
    """A circuit sliced and reconfigured by the port itself (greedy,
    then ``slice_and_reconfigure`` to 2^20) runs its in-place chains
    through the kernel on the card, and its amplitude matches the CPU
    run of the same tree (the kernel's plain version) in float32."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.ops.grouped_plan import plan_grouped
    from cotengra_tpu_torch.ops.lowering import (
        extract_contractions,
        sliced_input_legs,
    )

    inputs, output, _, _, arrays = ctt.rand_circuit_tn(40, 10, seed=5)
    inputs, arrays = ctt.absorb_simple_tensors(
        inputs, arrays, output, max_rank=2, max_absorb_size=2**12
    )
    size_dict = {
        ix: int(d) for t, a in zip(inputs, arrays) for ix, d in zip(t, a.shape)
    }
    tree = ctt.ContractionTree.from_path(
        inputs, output, size_dict, ssa_path=ctt.optimize_greedy(
            inputs, output, size_dict, use_ssa=True, seed=2,
            temperature=0.01,
        ),
    )
    tree.slice_and_reconfigure_(2**20, temperature=0)
    assert tree.multiplicity > 1 and tree.max_size() <= 2**20
    ir = extract_contractions(tree)
    orders = [sliced_input_legs(tree, i) for i in range(tree.N)]
    plans, *_ = plan_grouped(ir, tree.size_dict, orders, gate_mode="inplace")
    assert any(kind == "inplace" for kind, _ in plans)
    before = run_chain_cuda.launches
    got = complex(ctt.contract_tree(tree, arrays, device=cuda).item())
    torch.cuda.synchronize()
    assert run_chain_cuda.launches > before
    want = complex(ctt.contract_tree(tree, arrays, device="cpu").item())
    assert abs(got - want) <= 1e-5 * abs(want)


def test_permute_copy_beyond_the_copy_dims_limit(cuda):
    """A block transpose of 26 binary blocks, more than a CUDA copy takes
    in one go (a port-planned Sycamore-53 m=10 tree reached it), made in
    parts on the card, equals the CPU's whole copy."""
    from cotengra_tpu_torch.ops.grouped import MAX_COPY_DIMS, permute_copy

    n = MAX_COPY_DIMS + 1
    x = torch.randn((2,) * n, generator=torch.Generator().manual_seed(0))
    perm = tuple(reversed(range(n)))
    xc = x.to(cuda)
    with pytest.raises(RuntimeError, match="too many"):
        xc.permute(perm).contiguous()
    got = permute_copy(xc, perm)
    assert got.is_contiguous()
    assert torch.equal(got.cpu(), x.permute(perm).contiguous())


_GLOO_RANK = """
import sys
sys.path.insert(0, {root!r})
import numpy as np
import torch
import cotengra_tpu_torch as ctt
from cotengra_tpu_torch.ops.gate_chains import run_chain_cuda
from cotengra_tpu_torch.parallel import mesh as pmesh

rank = {rank}
assert pmesh.maybe_init_distributed(
    init_method={store!r}, world_size=2, rank=rank, device="cuda:0",
    backend="gloo", timeout=120,
)
mesh = pmesh.get_default_mesh(2)
assert mesh.device == torch.device("cuda", 0), mesh
inputs, output, _, _, arrays = ctt.rand_circuit_tn(20, 8, seed=0)
inputs, arrays = ctt.absorb_simple_tensors(
    inputs, arrays, output, max_rank=2, max_absorb_size=2**12
)
size_dict = {{
    ix: int(d) for t, a in zip(inputs, arrays) for ix, d in zip(t, a.shape)
}}
tree = ctt.array_contract_tree(inputs, output, size_dict=size_dict,
                               optimize="greedy")
if rank == 0:
    tree.slice_(target_slices=5)
tree = pmesh.broadcast_tree(tree)
assert tree.multiplicity >= 5
before = run_chain_cuda.launches
got = complex(pmesh.contract_sharded(tree, arrays, mesh=mesh).item())
torch.cuda.synchronize()
want = complex(ctt.contract_tree(tree, arrays, device="cpu").item())
assert abs(got - want) <= 1e-5 * abs(want), (got, want)
m, e = pmesh.contract_sharded(tree, arrays, mesh=mesh, strip_exponent=True)
stripped = complex(m.item()) * 10.0 ** e.item()
assert abs(stripped - want) <= 1e-5 * abs(want), (stripped, want)
print("RANK_OK", rank, tree.multiplicity,
      run_chain_cuda.launches - before, flush=True)
torch.distributed.destroy_process_group()
"""


def test_two_gloo_ranks_on_one_card(cuda, tmp_path):
    """Two ranks on one card join a gloo group (NCCL refuses two ranks
    on one GPU), share rank 0's tree (``broadcast_tree``) and sum the
    slices of a circuit amplitude, plain and stripped, through the
    grouped executor on the card: every rank holds the CPU's value."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    store = f"file://{tmp_path / 'store'}"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c",
             _GLOO_RANK.format(root=root, rank=r, store=store)],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for r in range(2)
    ]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert f"RANK_OK {r}" in out, out


def _gate_chain_tree(n_ax=17, n_gates=12, seed=3):
    """A rank-``n_ax`` state absorbing 1- and 2-leg gates one after
    another (the window tests' instance), as the port's tree, with two
    gate legs sliced; complex128 arrays."""
    import cotengra_tpu_torch as ctt

    rng = np.random.default_rng(seed)
    live = [f"x{i}" for i in range(n_ax)]
    inputs = [tuple(live)]
    arrays = [rng.standard_normal((2,) * n_ax)
              + 1j * rng.standard_normal((2,) * n_ax)]
    for g in range(n_gates):
        nq = 1 + g % 2
        pos = sorted(rng.choice(len(live), size=nq, replace=False))
        c = tuple(live[p] for p in pos)
        ny = tuple(f"n{g}_{j}" for j in range(nq))
        inputs.append(c + ny)
        arrays.append(rng.standard_normal((2,) * 2 * nq)
                      + 1j * rng.standard_normal((2,) * 2 * nq))
        for p, ix in zip(pos, ny):
            live[p] = ix
    size_dict = {ix: 2 for t in inputs for ix in t}
    n = len(inputs)
    tree = ctt.ContractionTree.from_path(
        inputs, tuple(live), size_dict,
        ssa_path=[(0, 1)] + [(n + k - 2, k) for k in range(2, n)],
    )
    for ix in (inputs[1][0], inputs[2][0]):
        tree.remove_ind_(ix)
    return tree, arrays


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("mode", ["scan", "vmap"])
def test_window_contractor_on_the_card(cuda, mode, fuse):
    """``gate_mode="window"`` on CUDA tensors runs its window steps on
    the card, launches no chain kernel, and equals the CPU run of the
    same contractor in float64 (rtol 1e-10) and float32 (rtol 1e-5)."""
    import cotengra_tpu_torch as ctt

    tree, arrays = _gate_chain_tree()
    for dtype, rtol in [(torch.float64, 1e-10), (torch.float32, 1e-5)]:
        out = {}
        for dev in (cuda, torch.device("cpu")):
            fn = ctt.make_grouped_contractor(
                tree, dev, dtype, gate_mode="window", fuse_gates=fuse,
                slice_batch=4, slice_batch_mode=mode,
            )
            assert any(k == "window" for k, _ in fn.plans)
            before = run_chain_cuda.launches
            res = fn(ctt.to_plane_tensors(arrays, dev, dtype), range(4))
            if dev.type == "cuda":
                torch.cuda.synchronize()
                assert res.device == cuda
                assert run_chain_cuda.launches == before
            out[dev.type] = res.sum(0).cpu().numpy()
        scale = np.abs(out["cpu"]).max()
        assert np.abs(out["cuda"] - out["cpu"]).max() <= rtol * scale


# -- captured CUDA graphs (the staged contractors, autojit) -------------------

_T27 = {}


def _t27(cuda):
    """The committed Sycamore-53 m=10 t27 tree (4 slices, 13 chains a
    slice) and its inputs as float32 planes on the card."""
    if not _T27:
        from pathlib import Path

        import cotengra_tpu_torch as ctt

        inputs, output, _, _, arrays = ctt.rand_circuit_tn(53, 10, seed=42)
        inputs, arrays = ctt.absorb_simple_tensors(
            inputs, arrays, output, max_rank=2, max_absorb_size=2**12
        )
        size_dict = {
            ix: int(d) for t, a in zip(inputs, arrays)
            for ix, d in zip(t, a.shape)
        }
        plan = Path(__file__).resolve().parent.parent / "plans" / (
            "sycamore53_m10_t27.json"
        )
        _T27["tree"] = ctt.load_tree(str(plan), inputs, output, size_dict)
        _T27["arrays"] = arrays
    import cotengra_tpu_torch as ctt

    planes = ctt.to_plane_tensors(_T27["arrays"], cuda, torch.float32)
    return _T27["tree"], planes


def _equal(a, b):
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def _same_call(got, want):
    """Equal planes bit for bit; stripped, equal mantissas and exponents
    within 1e-6 relative: the staged steps add the float32 log10
    exponents of ~150 steps in plan order, the eager batch adds the
    slice-invariant steps' first."""
    if not isinstance(want, tuple):
        return torch.equal(got, want)
    e_got, e_want = got[1].double(), want[1].double()
    scale = max(1.0, e_want.abs().max().item())
    return torch.equal(got[0], want[0]) and bool(
        ((e_got - e_want).abs() <= 1e-6 * scale).all()
    )


@pytest.mark.parametrize("strip", [False, True])
@pytest.mark.parametrize("mode", ["scan", "vmap"])
def test_staged_replays_equal_the_eager_contractor(cuda, mode, strip):
    """The staged contractor's replays give the eager contractor's
    per-slice planes bit for bit: the same kernels on the same inputs in
    the same order (stripped: ``_same_call``). Its replays follow the
    slice ids
    of each call (0..3, then 3, 2, 1, 0, then 1, 1, 1, 1): a slice read
    on the host at capture would repeat. A replayed call makes no
    Python step call and replays one graph per stage."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.ops.grouped import (
        make_grouped_staged_contractor,
    )
    from cotengra_tpu_torch.tracing import STEP_CALLS

    tree, planes = _t27(cuda)
    fn = make_grouped_staged_contractor(
        tree, stage_size=12, device=cuda, slice_batch=4,
        slice_batch_mode=mode, strip_exponent=strip,
    )
    eager = ctt.make_grouped_contractor(
        tree, cuda, torch.float32, slice_batch=4, slice_batch_mode=mode,
        strip_exponent=strip,
    )
    assert fn.precompile(planes, [0, 1, 2, 3]) == len(fn.bounds) - 1
    for ids in ([0, 1, 2, 3], [3, 2, 1, 0], [1, 1, 1, 1]):
        steps = sum(STEP_CALLS.values())
        replays = fn.graphs[4].replays
        got = fn(planes, ids)
        assert sum(STEP_CALLS.values()) == steps
        assert fn.graphs[4].replays - replays == len(fn.bounds) - 1
        assert _same_call(got, eager(planes, ids))
    # the static input buffers themselves: no copy
    for buf, p in zip(fn.inputs, planes):
        buf.copy_(p)
    assert _same_call(fn(fn.inputs, [2, 0, 1, 3]),
                      eager(planes, [2, 0, 1, 3]))


def test_whole_call_graphs_equal_eager(cuda):
    """``autojit=True``: the stripped 4x4 bond-16 lattice through the
    kernel route as one graph (``make_full_contractor``,
    ``contract_tree``), the direct route's ``make_staged_contractor`` in
    3 stages, equal to eager bit for bit, on new inputs too."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.ops.executor import make_staged_contractor

    inputs, output, shapes, size_dict = ctt.lattice_equation([4, 4],
                                                             d_min=16)
    tree = ctt.array_contract_tree(inputs, output, size_dict=size_dict,
                                   optimize="greedy")
    tree.slice_(target_slices=4)
    rng = np.random.default_rng(7)
    kw = dict(strip_exponent=True, implementation="pallas")
    fn = ctt.make_full_contractor(tree, cuda, autojit=True, **kw)
    eager = ctt.make_full_contractor(tree, cuda, **kw)
    staged = make_staged_contractor(tree, num_stages=3, device=cuda,
                                    strip_exponent=True)
    core = ctt.make_contractor(tree, cuda, strip_exponent=True)
    for _ in range(2):
        arrays = [rng.uniform(size=s).astype(np.float32) for s in shapes]
        tensors = ctt.to_tensors(arrays, cuda, torch.float32)
        before = bmm_absmax_cuda.launches
        assert _equal(fn(*tensors), eager(*tensors))
        assert bmm_absmax_cuda.launches > before  # eager's; replays tick none
        assert _equal(
            ctt.contract_tree(tree, arrays, autojit=True, **kw),
            eager(*tensors),
        )
        one = ctt.slice_arrays(tree, tensors, 1)
        assert _equal(staged(*one), core(*one))
    assert len(staged.graphs) == 1


def test_full_contractor_batches_in_one_graph(cuda):
    """``make_full_contractor(..., slice_batch=4, autojit=True)`` on t27
    (the grouped route, ``"vmap"`` on the card): the batch's digits are
    copied to the card at the first call (the warm-up, before the
    capture) and its inputs gathered by them inside the one graph;
    equal to eager bit for bit."""
    import cotengra_tpu_torch as ctt

    tree, _ = _t27(cuda)
    tensors = ctt.to_tensors(_T27["arrays"], cuda, torch.float32)
    fn = ctt.make_full_contractor(tree, cuda, slice_batch=4, autojit=True)
    eager = ctt.make_full_contractor(tree, cuda, slice_batch=4)
    for _ in range(2):
        assert torch.equal(fn(*tensors), eager(*tensors))
    (captured, _), = fn.graphs.values()
    assert captured.replays == 2 and len(captured.graphs) == 1


def test_gather_input_on_the_card(cuda):
    """``gather_input`` on the card: host digits (copied once, pinned and
    non-blocking) and the same digits on the card gather the views that
    ``_select_input`` takes row by row, on the t27 planes."""
    import numpy as np

    from cotengra_tpu_torch.ops import slices

    tree, planes = _t27(cuda)
    meta = slices._slice_meta(tree)
    axes = slices._sliced_axes_per_input(tree)
    digits = slices._ids_to_digits([3, 0, 2, 2], meta)
    on_card = slices.device_digits(digits, cuda)
    assert on_card.device == cuda and np.array_equal(on_card.cpu(), digits)
    varying = [i for i, a in enumerate(axes)
               if any(meta[ix][2] is None for _, ix in a)]
    assert varying
    for i in varying:
        host = slices.gather_input(planes[i], axes[i], meta, digits, 1)
        assert torch.equal(
            host, slices.gather_input(planes[i], axes[i], meta, on_card, 1)
        )
        for r, row in enumerate(digits):
            assert torch.equal(
                host[r], slices._select_input(planes[i], axes[i], meta, row, 1)
            )


def test_staged_window_on_the_card(cuda):
    """``gate_mode="window"`` through the staged contractor (its index
    arrays copied to the card at plan time) equals the eager window
    contractor bit for bit; ``precompile`` returns None, as the
    reference's, and the first call captures."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.ops.grouped import (
        make_grouped_staged_contractor,
    )

    tree, arrays = _gate_chain_tree()
    planes = ctt.to_plane_tensors(arrays, cuda, torch.float32)
    for mode in ("scan", "vmap"):
        fn = make_grouped_staged_contractor(
            tree, stage_size=4, device=cuda, slice_batch=4,
            slice_batch_mode=mode, gate_mode="window",
        )
        eager = ctt.make_grouped_contractor(
            tree, cuda, torch.float32, slice_batch=4, slice_batch_mode=mode,
            gate_mode="window",
        )
        assert fn.precompile(planes, range(4)) is None and not fn.graphs
        for ids in ([0, 1, 2, 3], [3, 3, 0, 1]):
            assert _equal(fn(planes, ids), eager(planes, ids))
        assert fn.graphs


def test_traced_slicer_in_a_graph(cuda):
    """``make_traced_slicer`` captured in a CUDA graph: each replay reads
    the id the 0-d tensor then holds (the host's slicing of that id)."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.ops.executor import make_traced_slicer

    tree, planes = _t27(cuda)
    tensors = [p[0].contiguous() for p in planes]
    slicer = make_traced_slicer(tree)
    sid = torch.zeros((), dtype=torch.int64, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        slicer(tensors, sid)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = slicer(tensors, sid)
    for i in (3, 1, 2, 0):
        sid.fill_(i)
        graph.replay()
        for got, want in zip(out, ctt.slice_arrays(tree, tensors, i)):
            assert torch.equal(got, want)


def test_a_capture_that_fails_raises(cuda, monkeypatch):
    """A step that syncs with the host (``.item()``) cannot be captured:
    the staged contractor and ``autojit`` raise ``CaptureError`` naming
    the step, and nothing reruns eagerly. (A failed capture leaves
    torch's CUDA generator in capture mode: the inputs are drawn
    first.)"""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.ops import executor, grouped
    from cotengra_tpu_torch.ops.capture import CaptureError

    tree, planes = _t27(cuda)
    inputs, output, shapes, size_dict = ctt.lattice_equation([3, 3],
                                                             d_min=4)
    small = ctt.array_contract_tree(inputs, output, size_dict=size_dict,
                                    optimize="greedy")
    tensors = [torch.rand(s, device=cuda) for s in shapes]
    real = grouped.apply_pairwise

    def syncing(x, *args):
        out = real(x, *args)
        out.abs().max().item()
        return out

    monkeypatch.setattr(grouped, "apply_pairwise", syncing)
    fn = grouped.make_grouped_staged_contractor(
        tree, device=cuda, slice_batch=4, slice_batch_mode="vmap",
    )
    with pytest.raises(CaptureError, match="plan step"):
        fn(planes, range(4))
    assert torch.cuda.current_stream() == torch.cuda.default_stream()

    monkeypatch.setattr(executor, "apply_pairwise", syncing)
    full = ctt.make_full_contractor(small, cuda, autojit=True)
    with pytest.raises(CaptureError, match="IR step"):
        full(*tensors)


_M10 = {}


def _m10_amplitudes(n_sets=4, seed=2**31 + 25):
    """The benchmark's ``sycamore-like-6x9-m10``: one seeded circuit,
    ``n_sets`` bitstrings (host complex64 arrays), and a fresh tree of
    its committed m=10 t27 plan (a contractor of its own)."""
    import io
    import json
    from pathlib import Path

    import cotengra_tpu_torch as ctt
    from tnbench.networks import sycamore_bitstrings

    root = Path(__file__).resolve().parent.parent
    if not _M10:
        conf = json.loads(
            (root / "tnbench" / "configs" / "sycamore-like-6x9-m10.json").read_text()
        )
        _M10["conf"] = conf
        _M10["net"] = sycamore_bitstrings.make_sets(conf["network"], seed, n_sets)
    inputs, output, size_dict, sets = _M10["net"]
    tree = ctt.load_tree(io.StringIO(json.dumps(_M10["conf"]["plan"])),
                         inputs, output, size_dict)
    return tree, sets


def test_m10_replays_follow_the_bitstring(cuda):
    """``contract_tree(..., autojit=True)`` on the m=10 amplitudes: the
    first call captures one graph, every call replays it once, and a
    replay with a new bitstring returns that bitstring's amplitude, equal
    to an eager call within float32 rounding of the slices' sum (the
    same kernels on the same inputs: 1e-5 of the amplitude leaves room
    for the order of the plane split's copies), and not the captured
    call's (bitstrings' amplitudes differ by far more)."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch.ops.capture import COUNTS

    tree, sets = _m10_amplitudes()
    captures = COUNTS["captures"]
    got = [complex(ctt.contract_tree(tree, a, autojit=True)) for a in sets]
    got.append(complex(ctt.contract_tree(tree, sets[0], autojit=True)))
    (fn,) = [f for k, f in tree.contraction_cores.items() if k[-1] is True]
    ((graphs, _),) = fn.graphs.values()
    assert len(graphs.graphs) == 1 and graphs.replays == len(sets) + 1
    assert COUNTS["captures"] == captures + 1
    want = [complex(ctt.contract_tree(tree, a)) for a in sets]
    for g, w in zip(got, want + want[:1]):
        assert abs(g - w) <= 1e-5 * abs(w), (g, w)
    for i in range(len(want)):
        for j in range(i + 1, len(want)):
            assert abs(want[i] - want[j]) > 1e-2 * max(abs(want[i]), abs(want[j]))


def test_m10_capture_spans_and_kernel_record(cuda):
    """Under ``tracing.record()``: ``capture.capture`` once for the one
    graph (at the first call), ``capture.load`` and ``capture.replay``
    once a call, no ``kernel.launch`` in a replayed call; the graph's
    kernel record holds the chain launches of an eager call of the same
    plan, in order, with the same shapes and grouped alike by the span
    they were launched in (a ``run_chain_cuda`` call's passes share
    one), and each ``capture.replay`` carries it."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch import tracing

    tree, sets = _m10_amplitudes()
    ctt.contract_tree(tree, sets[0])  # eager: the kernels' build and tables
    with tracing.record():
        ctt.contract_tree(tree, sets[1])
    launches = [r for r in tracing.records() if r.name == "kernel.launch"]
    assert {r.attrs["kernel"] for r in launches} == {"gate_chain"}
    with tracing.record():
        for a in sets:
            ctt.contract_tree(tree, a, autojit=True)
    recs = tracing.records()
    names = collections.Counter(r.name for r in recs)
    assert names["capture.capture"] == 1
    assert names["capture.load"] == names["capture.replay"] == len(sets)
    assert names["entry"] == len(sets)
    entries = [r.index for r in recs if r.name == "entry"]
    captured_in = next(r.entry for r in recs if r.name == "capture.capture")
    assert captured_in == entries[0]
    assert not any(r.name == "kernel.launch" and r.entry != entries[0] for r in recs)
    (fn,) = [f for k, f in tree.contraction_cores.items() if k[-1] is True]
    ((graphs, _),) = fn.graphs.values()
    (record,) = graphs.kernels
    assert [(k, shapes) for k, _, shapes in record] == [
        (r.attrs["kernel"], r.attrs["shapes"]) for r in launches
    ]

    def groups(parents):
        return [len(list(g)) for _, g in itertools.groupby(parents)]

    assert groups(p for _, p, _ in record) == groups(r.parent for r in launches)
    for r in recs:
        if r.name == "capture.replay":
            assert r.attrs["graphs"] == 1 and r.attrs["kernels"] == (record,)
        if r.name == "capture.load":
            assert r.attrs["tensors"] == len(sets[0])
            assert r.attrs["bytes"] == sum(a.nbytes for a in sets[0])


@pytest.mark.parametrize("mode", ["scan", "vmap"])
def test_launch_spans_match_the_wrappers(cuda, mode):
    """One ``kernel.launch`` span per launch that each wrapper counts,
    numbered as it counts them, with the operand shapes that the
    benchmark's ``Recorder`` logs for the same calls (a chain's passes
    composed: the first pass's x, the last's out, every pass's gates)."""
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch import tracing
    from test_torch_tracing import _gate_tree, _stripped_tree
    from tnbench.trace import Recorder

    tree, arrays = _gate_tree()
    planes = ctt.to_plane_tensors(arrays, cuda)
    fn = ctt.make_grouped_contractor(tree, cuda, slice_batch=4,
                                     slice_batch_mode=mode)
    stripped, sarrays = _stripped_tree()
    calls = [
        lambda: fn(planes, [0, 1, 2, 3]),
        lambda: ctt.contract_tree(stripped, sarrays, device=cuda,
                                  strip_exponent=True,
                                  implementation="pallas"),
    ]
    for call in calls:  # warm: the kernels' build and tables
        call()
    rec = Recorder()
    with rec, tracing.record():
        before = rec.launches()
        for call in calls:
            call()
        after = rec.launches()
    torch.cuda.synchronize()
    launches = [r for r in tracing.records() if r.name == "kernel.launch"]
    for kernel in ("gate_chain", "bmm_absmax"):
        mine = [r for r in launches if r.attrs["kernel"] == kernel]
        assert after[kernel] > before[kernel]
        assert [r.attrs["seq"] for r in mine] == list(
            range(before[kernel], after[kernel])
        )
    chains = {}
    for r in launches:
        if r.attrs["kernel"] == "gate_chain":
            chains.setdefault(r.parent, []).append(r.attrs["shapes"])
    composed = [
        (passes[0][0], passes[-1][1], [g for p in passes for g in p[2]])
        for passes in chains.values()
    ]
    assert composed == rec.log["gate_chain"]
    assert [
        r.attrs["shapes"] for r in launches if r.attrs["kernel"] == "bmm_absmax"
    ] == rec.log["bmm_absmax"]
