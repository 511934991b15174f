"""The PyTorch port stands without JAX and never picks a device on its
own."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import cotengra_tpu_torch as ctt
from cotengra_tpu_torch.ops.gate_chains import (
    build_chain_spec,
    run_chain,
    run_chain_cuda,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = textwrap.dedent(
    """
    import sys

    class _BlockJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib"):
                raise ImportError("jax is blocked in this test")
            return None

    sys.meta_path.insert(0, _BlockJax())
    sys.path.insert(0, {root!r})

    import numpy as np
    import torch

    torch.set_num_threads(1)

    import cotengra_tpu_torch as ctt
    from cotengra_tpu import ContractionTree, optimize_greedy
    from cotengra_tpu.models.circuits import rand_circuit_tn
    from cotengra_tpu.utils import inds_to_eq

    inputs, output, _, _, arrays = rand_circuit_tn(12, 4, seed=3)
    inputs, arrays = ctt.absorb_simple_tensors(inputs, arrays, output)
    size_dict = {{
        ix: int(d) for t, a in zip(inputs, arrays) for ix, d in zip(t, a.shape)
    }}
    path = optimize_greedy(inputs, output, size_dict)
    tree = ContractionTree.from_path(inputs, output, size_dict, path=path)
    tree.remove_ind(next(iter(inputs[0])), inplace=True)
    arrays = [np.asarray(a, np.complex128) for a in arrays]
    got = ctt.contract_tree(
        tree, arrays, device="cpu", plane_dtype=torch.float64
    ).item()
    ref = complex(np.einsum(
        inds_to_eq(inputs, output), *arrays, optimize="greedy"
    ))
    assert abs(got - ref) <= 1e-10 * abs(ref), (got, ref)

    import chip_smoke  # imported, not run

    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
    assert not bad, bad
    print("NO_JAX_OK", tree.multiplicity)
    """
)


def test_port_runs_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX.format(root=ROOT)],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NO_JAX_OK 2" in proc.stdout


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_cuda_without_card_raises(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.to_plane_tensors([np.ones(2, np.complex64)], "cuda",
                             torch.float32)


def test_contract_tree_cuda_without_card_raises(no_card):
    from cotengra_tpu import ContractionTree

    inputs = [("a", "b"), ("b", "c")]
    tree = ContractionTree.from_path(
        inputs, ("a", "c"), {"a": 2, "b": 2, "c": 2}, path=[(0, 1)]
    )
    arrays = [np.eye(2, dtype=np.complex64)] * 2
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.contract_tree(tree, arrays, device="cuda")


@pytest.mark.parametrize("device", [None, "meta"])
def test_device_must_be_explicit_and_supported(device):
    with pytest.raises(ValueError):
        ctt.resolve_device(device)


def test_plane_dtype_checked():
    with pytest.raises(ValueError):
        ctt.to_plane_tensors([np.ones(2)], "cpu", torch.float16)


def test_gate_chain_wrapper_never_falls_back():
    order0 = tuple(f"a{k}" for k in range(14))
    sizes = {ix: 2 for ix in order0 + ("b0", "b1")}
    spec, _, _ = build_chain_spec(order0, sizes, [(("a0", "a1"), ("b0", "b1"))])
    x = torch.zeros(2 * 2**14, device="meta")
    ys = [torch.zeros(2, 4, 4, device="meta")]
    with pytest.raises(ValueError):
        run_chain(spec, x, ys)
    # the kernel wrapper refuses CPU tensors instead of computing them
    with pytest.raises(ValueError):
        run_chain_cuda(spec, torch.zeros(2 * 2**14), [torch.zeros(2, 4, 4)])


def test_kernel_build_stays_inside_the_checkout(monkeypatch, tmp_path):
    from cotengra_tpu_torch.ops import _build

    assert _build.build_dir() == (
        _build._ROOT / "build" / "cotengra_tpu_torch"
    )
    # an installed copy (no repository root around it) has nowhere to build
    monkeypatch.setattr(_build, "_ROOT", tmp_path)
    with pytest.raises(RuntimeError, match="not inside a checkout"):
        _build.library_path()
