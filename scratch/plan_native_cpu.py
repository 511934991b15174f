"""Host planning seconds of the port with and without its native library,
on whatever CPU runs it (no card needed).

    python scratch/plan_native_cpu.py [cache|search|timing ...]

``cache``: slice-and-reconfigure (2^27, temperature 0) of one seeded
native greedy Sycamore-53 m=10 tree, with the native optimal DP's
answers kept per contraction (an LRU cache, as the pure-Python DP has
in ``basic._optimal_ssa_path``) and without, in turns;
``search``: ``chip_smoke.py``'s four 16-trial searches (m10 to 2^27 and
the 7x7 lattice to 2^28, greedy + labels and the default methods);
``timing``: ``chip_smoke.py::phase_plan_timing`` (pure Python against
native, in turns); ``spread``: the two m10 searches once more, one line
each with the tree's log10 flops against ``chip_smoke.py``'s bound (the
searches are unseeded: run it many times, in parallel processes, to see
how their trees spread). Default: ``cache``, ``search``, ``timing``.
"""

import functools
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import cotengra_tpu_torch as ctt  # noqa: E402
from cotengra_tpu_torch.pathfinders import basic  # noqa: E402


def cache():
    t27, _, _ = cs._load_instance(cs.T27)
    ssa = ctt.optimize_greedy(
        t27.inputs, t27.output, t27.size_dict, use_ssa=True,
        temperature=0.1, seed=3,
    )
    tree = ctt.ContractionTree.from_path(
        t27.inputs, t27.output, t27.size_dict, ssa_path=ssa
    )
    native_dp = basic.optimize_optimal

    @functools.lru_cache(maxsize=2**14)
    def kept(inputs, output, sizes, **kw):
        return native_dp(inputs, output, dict(sizes), **kw)

    def cached_dp(inputs, output, size_dict, **kw):
        inputs = tuple(map(tuple, inputs))
        sizes = tuple(sorted(
            (ix, size_dict[ix]) for term in inputs for ix in term
        ))
        return list(kept(inputs, tuple(output), sizes, **kw))

    for mode in ("kept", "not kept", "not kept", "kept"):
        kept.cache_clear()
        if mode == "kept":
            basic.optimize_optimal = cached_dp
        try:
            t0 = time.perf_counter()
            out = tree.slice_and_reconfigure(2**27, temperature=0)
            secs = time.perf_counter() - t0
        finally:
            basic.optimize_optimal = native_dp
        print(f"cache: native DP answers {mode}: {secs:.3f}s "
              f"({cs._plan_stats(out)})", flush=True)


def search():
    for name, methods in (("m10", cs.HYPER_LABELS), ("m10", None),
                          ("lattice7x7", cs.HYPER_LABELS),
                          ("lattice7x7", None)):
        if name == "m10":
            committed, _, _ = cs._load_instance(cs.T27)
            target = cs.HYPER_M10_TARGET
        else:
            committed, _, _ = cs._load_lattice()
            target = cs.HYPER_LATTICE_TARGET
        tree, plan_s, trials, note = cs._hyper_plan(
            committed, target, methods
        )
        print(f"search {name}: {plan_s:.1f}s, {trials} trials; {note}: "
              f"{cs._plan_stats(tree)}", flush=True)


def spread():
    committed, _, _ = cs._load_instance(cs.T27)
    bound = committed.total_flops(log=10) + cs.HYPER_FLOPS_SLACK
    for methods in (None, cs.HYPER_LABELS):
        tree, plan_s, _, note = cs._hyper_plan(
            committed, cs.HYPER_M10_TARGET, methods
        )
        flops = tree.total_flops(log=10)
        print(f"spread m10 {note}: log10 flops {flops:.3f} "
              f"({'over' if flops > bound else 'within'} the bound "
              f"{bound:.3f}), slices {tree.multiplicity}, {plan_s:.1f}s",
              flush=True)


if __name__ == "__main__":
    for what in sys.argv[1:] or ["cache", "search", "timing"]:
        if what == "timing":
            cs.phase_plan_timing()
        else:
            {"cache": cache, "search": search, "spread": spread}[what]()
