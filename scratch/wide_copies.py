"""How wide the grouped executor's copies get on port-planned m10 trees.

Plans Sycamore-53 m=10 with the port's hyper-optimizer as
``chip_smoke.py`` phase 17 does (16 trials, 2^27, unseeded noise, so
each tree differs), traces the grouped contractor of each tree on meta
tensors (no data, no card), and prints the plan's widest block
transpose (its view's dims, the plane axis included) and the widest
copy the traced ops made. A CUDA copy takes at most 25 dims
(``grouped.MAX_COPY_DIMS``); ``permute_copy`` splits wider ones.

    python scratch/wide_copies.py [trees]     # default 3; ~2 min a tree
"""

import sys
import time
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from cotengra_tpu_torch.ops import grouped  # noqa: E402
from cotengra_tpu_torch.ops.lowering import sliced_input_legs  # noqa: E402


class _WidestCopy(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.dims = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.copy_, torch.ops.aten.clone):
            self.dims = max(
                [self.dims]
                + [a.dim() for a in args if isinstance(a, torch.Tensor)]
            )
        return func(*args, **(kwargs or {}))


def widths(tree):
    """(widest block-transpose view, widest traced copy) of ``tree``."""
    grouped.resolve_device = torch.device
    grouped.run_chain = lambda spec, x, ys: x.new_empty(
        2 * spec.gate_strides[-1].numel_out
    )
    fn = grouped.make_grouped_contractor(tree, "meta", torch.float32)
    widest = 0
    for kind, info in fn.plans:
        if kind == "pair":
            plans = [info.x_plan, info.y_plan]
        elif kind == "inplace":
            plans = [y[1] for y in info.ys]
        else:
            plans = []
        for p in plans:
            if p is not None:
                widest = max(widest, len(p[0]) + 1)
    mode = _WidestCopy()
    with mode:
        fn(*(
            torch.empty(
                (2,) + tuple(tree.size_dict[ix]
                             for ix in sliced_input_legs(tree, i)),
                device="meta",
            )
            for i in range(tree.N)
        ))
    return widest, mode.dims


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    committed, _, _ = chip_smoke._load_instance(chip_smoke.T27)
    print(f"{chip_smoke.T27}: widest view, copy {widths(committed)}",
          flush=True)
    for rep in range(n):
        t0 = time.perf_counter()
        tree, _, _ = chip_smoke._hyper_plan(
            committed, chip_smoke.HYPER_M10_TARGET
        )
        print(
            f"tree {rep}: planned in {time.perf_counter() - t0:.1f}s, "
            f"{chip_smoke._plan_stats(tree)}; widest view, copy "
            f"{widths(tree)}",
            flush=True,
        )


if __name__ == "__main__":
    main()
