"""The t27 front-end timing check of ``chip_smoke.py`` (phase 14:
``array_contract`` with the loaded tree against ``make_full_contractor``
with the same options, best of N passes in turns, held to 1.1x), made
many times in one process on the card, the way it was made before
(best of 5, no collection between passes) and the way it is made now
(best of 21, ``gc.collect()`` before each pass), in turns. Prints each ratio and how
many of them exceed the limit.

    python scratch/front_end_passes.py [repeats]
"""
import contextlib
import gc
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as cs  # noqa: E402
import cotengra_tpu_torch as ctt  # noqa: E402

reps = int(sys.argv[1]) if len(sys.argv) > 1 else 20
dev = ctt.resolve_device("cuda")
cs.phase_device()
cs.phase_build()
tree, arrays, refs = cs._load_instance(cs.T27)
n = tree.multiplicity
tensors = ctt.to_tensors(arrays, dev, torch.float32)
direct = ctt.make_full_contractor(tree, dev, slice_batch=n)
calls = {
    "front end": lambda: ctt.array_contract(
        tensors, tree.inputs, (), optimize=tree, slice_batch=n
    ),
    "make_full_contractor": lambda: direct(*tensors),
}


@contextlib.contextmanager
def no_collect():
    """``_in_turns`` as it was before: no collection between passes."""
    real = cs.gc.collect
    cs.gc.collect = lambda: None
    try:
        yield
    finally:
        cs.gc.collect = real


ways = {
    "best of 5, no gc (before)": (cs.FRONT_END_PASSES, no_collect),
    f"best of {cs.T27_FRONT_END_PASSES}, gc (now)": (
        cs.T27_FRONT_END_PASSES, contextlib.nullcontext),
}
ratios = {k: [] for k in ways}
for rep in range(reps):
    order = list(ways) if rep % 2 == 0 else list(reversed(ways))
    for way in order:
        passes, ctx = ways[way]
        gc.collect()
        with ctx():
            times = cs._in_turns("front end t27", calls,
                                 lambda r: complex(r.item()), passes)
        best = {k: min(ts) for k, ts in times.items()}
        ratios[way].append(best["front end"] / best["make_full_contractor"])
        print(f"# repeat {rep} {way}: ratio {ratios[way][-1]:.4f} "
              f"(front end {best['front end']:.4f} s, direct "
              f"{best['make_full_contractor']:.4f} s)", flush=True)
for way, rs in ratios.items():
    rs = np.array(rs)
    print(f"PASSES {way}: {len(rs)} repeats, ratio min {rs.min():.4f} "
          f"median {np.median(rs):.4f} max {rs.max():.4f} std "
          f"{rs.std():.4f}; over {cs.FRONT_END_OVERHEAD}: "
          f"{int((rs > cs.FRONT_END_OVERHEAD).sum())}", flush=True)
