"""The CUDA kernels (gate chain, matmul with fused |max|) against their
plain PyTorch versions, on the card. Skipped without one; run on a GPU
machine with

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: the suite's conftest configures JAX, which a GPU
machine need not have).
"""

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
    "which", ["first two-pass", "second two-pass", "(16,32) gate"]
)
def test_gate_chain_kernel_on_m20_chains(cuda, which):
    """m=20 t28 chains at full size that no m=10 path runs: the two
    chains whose tile outgrows one pass, and the largest one that opens
    with a (16, 32) gate."""
    recs = _m20_chains()
    two = [r for r in recs if len(chain_tile_plan(r.spec)) == 2]
    assert len(two) == 2
    if which == "(16,32) gate":
        rec = max(
            (r for r in recs if (16, 32) in _kn(r)),
            key=lambda r: r.spec.gate_strides[0].numel_in,
        )
    else:
        rec = two[which.startswith("second")]
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
    assert m.device == cuda and e.dtype == torch.float32
    assert abs(
        np.log10(abs(m.item())) + e.item() - np.log10(abs(want.item()))
    ) <= 1e-5


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
