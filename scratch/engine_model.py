#!/usr/bin/env python3
"""The cost model's view of the opt-in gate engines on the committed
Sycamore plans, without a card (``ops/simulate.py`` with its
``H100_CONSTANTS``):

    python scratch/engine_model.py

Per plan (m10-t27, m20-t28): the window steps' GEMM flops a slice, the
modelled device seconds of the window steps and operator builds a
slice, how many builds are slice-invariant, the per-slice live peak,
the largest W2 and the largest window steps (form, S_in, S_out, M),
and the modelled warm seconds of t27 (all 4 slices) and m20 (slices
0..3) slice by slice and in batched calls of 4, with each gate engine;
then the fused steps' modelled device seconds a t27 slice and the
warm seconds with and without fusion (one scan call of 4 slices).
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from cotengra_tpu_torch.ops import grouped_plan, lowering  # noqa: E402
from cotengra_tpu_torch.ops.simulate import (  # noqa: E402
    H100_CONSTANTS,
    _price_step,
    simulate_grouped,
    step_records,
)
from cotengra_tpu_torch.utils.misc import prod  # noqa: E402


def main():
    for name in (cs.T27, cs.M20):
        tree = cs._load_instance(name)[0]
        recs = step_records(tree, gate_mode="window")
        steps = [(k, t, inv) for k, _, t, _, inv in recs["steps"]
                 if k in ("window", "w2build")]
        flops = sum(t["dot"][0] for k, t, _ in steps if k == "window")
        secs = {"window": 0.0, "w2build": 0.0}
        for k, t, _ in steps:
            secs[k] += sum(_price_step(t, H100_CONSTANTS))
        inv = sum(1 for k, _, i in steps if k == "w2build" and i)
        builds = sum(1 for k, _, _ in steps if k == "w2build")
        print(f"{name}: window GEMM flops a slice {flops:.3e}; device s a "
              f"slice {secs}; builds once a call {inv} of {builds}; "
              f"slice peak {recs['slice_bytes'] / 2**30:.2f} GiB")
        ir = lowering.extract_contractions(tree)
        orders = [lowering.sliced_input_legs(tree, i) for i in range(tree.N)]
        plans = grouped_plan.plan_grouped(ir, tree.size_dict, orders,
                                          gate_mode="window")[0]
        ws = [(i.form, i.S_in, i.S_out, prod(i.out_shape) // i.S_out)
              for k, i in plans if k == "window"]
        print(f"  largest W2 {max(16 * a * b for _, a, b, _ in ws)} bytes; "
              f"largest steps {sorted(ws, key=lambda w: -w[1] * w[2] * w[3])[:6]}")
        nsl = None if name == cs.T27 else cs.M20_WINDOW_SLICES
        for kw in (dict(gate_mode="window"),
                   dict(gate_mode="window", slice_batch=4,
                        slice_batch_mode="scan"),
                   dict(gate_mode="window", slice_batch=4,
                        slice_batch_mode="vmap"),
                   dict(),
                   dict(slice_batch=4, slice_batch_mode="vmap")):
            print(f"  {kw}: {simulate_grouped(tree, nslices=nsl, **kw):.4f} s")
    tree = cs._load_instance(cs.T27)[0]
    for gate_mode in ("inplace", None):
        recs = step_records(tree, gate_mode=gate_mode, fuse_gates=True)
        fused = sum(sum(_price_step(t, H100_CONSTANTS))
                    for k, _, t, _, _ in recs["steps"] if k == "fusedchain")
        warm = [simulate_grouped(tree, gate_mode=gate_mode, fuse_gates=f,
                                 slice_batch=4, slice_batch_mode="scan")
                for f in (True, False)]
        print(f"fused t27 {gate_mode}: fused steps' device s a slice "
              f"{fused:.5f}; warm fused {warm[0]:.4f} s, unfused "
              f"{warm[1]:.4f} s")


if __name__ == "__main__":
    main()
