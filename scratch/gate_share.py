#!/usr/bin/env python3
"""The share of chain gates that run in register groups, per call of the
benchmark's two circuit cells, on one card:

    python scratch/gate_share.py

Builds the cells' calls as their traffic files do (``m20-slices``:
``make_grouped_contractor(tree, "cuda", slice_batch=11)`` on 11 ids;
``m20-slice-tasks``: ``contract_slice`` on one id, raw inputs on the
card) on the program's Sycamore-like m=20 network and plan, and reads
``run_chain_cuda.launches``, ``gate_chains.GATE_COUNTS`` and the
``kernel.launch`` spans of one warm call.
"""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def counted(call):
    from cotengra_tpu_torch import tracing
    from cotengra_tpu_torch.ops.gate_chains import GATE_COUNTS, run_chain_cuda

    call()  # warm: build, tables
    torch.cuda.synchronize()
    before = (run_chain_cuda.launches, GATE_COUNTS["reg_gates"],
              GATE_COUNTS["item_gates"])
    with tracing.record():
        call()
    torch.cuda.synchronize()
    after = (run_chain_cuda.launches, GATE_COUNTS["reg_gates"],
             GATE_COUNTS["item_gates"])
    launches, reg, item = (b - a for a, b in zip(before, after))
    spans = [r.attrs for r in tracing.records()
             if r.name == "kernel.launch" and r.attrs["kernel"] == "gate_chain"]
    assert len(spans) == launches
    assert sum(s["reg_gates"] for s in spans) == reg
    assert sum(s["item_gates"] for s in spans) == item
    return {"launches": launches, "reg_gates": reg, "item_gates": item,
            "groups": sum(s["groups"] for s in spans),
            "reg_share": reg / (reg + item)}


def main():
    import cotengra_tpu_torch as ctt

    dev = ctt.resolve_device("cuda")
    print(cs._smi_line(), flush=True)
    tree, arrays, _ = cs._load_instance(cs.M20)
    planes = ctt.to_plane_tensors(arrays, dev)
    fn = ctt.make_grouped_contractor(tree, dev, slice_batch=11)
    ids = list(range(11))
    print("m20-slices", fn.mode, counted(lambda: fn(planes, ids)),
          flush=True)
    del fn, planes
    torch.cuda.empty_cache()
    tensors = ctt.to_tensors(arrays, dev)
    print("m20-slice-tasks", counted(
        lambda: ctt.contract_slice(tree, tensors, 5, device=dev)),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
