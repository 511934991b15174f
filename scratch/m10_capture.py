"""The m10-amplitudes cell's work outside the harness, on the card:
``contract_tree`` on the m=10 circuit's bitstrings eager and under
``autojit`` (one captured CUDA graph a call), in turns.

    python scratch/m10_capture.py [calls=10] [rounds=3] [seed=2147483673]

Prints, per side, the amplitudes of 16 bitstrings (captured against
eager), the seconds of each call (host pull included) in rounds of
``calls`` calls a side, the peak memory each side allocates, the graph
count, replays and capture seconds, and the captured call's spans
(``tracing.record()``): ms a call in ``inputs.upload``, ``capture.load``
and ``capture.replay``. Last line: one JSON object.
"""

import collections
import io
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main():
    args = dict(a.split("=") for a in sys.argv[1:])
    calls = int(args.get("calls", 10))
    rounds = int(args.get("rounds", 3))
    seed = int(args.get("seed", 2**31 + 25))
    import cotengra_tpu_torch as ctt
    from cotengra_tpu_torch import tracing
    from cotengra_tpu_torch.ops.capture import COUNTS
    from tnbench.networks import sycamore_bitstrings

    conf = json.loads((ROOT / "tnbench" / "configs" / "sycamore-like-6x9-m10.json").read_text())
    inputs, output, size_dict, sets = sycamore_bitstrings.make_sets(conf["network"], seed, 16)
    trees = {
        side: ctt.load_tree(io.StringIO(json.dumps(conf["plan"])), inputs, output, size_dict)
        for side in ("eager", "captured")
    }
    jit = {"eager": False, "captured": True}

    def call(side, k):
        return complex(ctt.contract_tree(trees[side], sets[k % 16], autojit=jit[side]))

    peak = {}
    amps = {}
    for side in ("eager", "captured"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        amps[side] = [call(side, k) for k in range(16)]
        first = time.perf_counter() - t0
        peak[side] = torch.cuda.max_memory_allocated() / 2**30
        print(f"# {side}: 16 calls (the first builds{' and captures' if jit[side] else ''}) "
              f"{first:.3f} s, peak {peak[side]:.3f} GiB", flush=True)
    rel = max(abs(c - e) / abs(e) for c, e in zip(amps["captured"], amps["eager"]))
    spread = min(abs(a - b) / max(abs(a), abs(b))
                 for i, a in enumerate(amps["eager"]) for b in amps["eager"][i + 1:])
    print(f"# amplitudes: captured vs eager, largest relative difference {rel:.3e}; "
          f"least relative difference between two bitstrings {spread:.3e}", flush=True)
    times = {"eager": [], "captured": []}
    k = 0
    for _ in range(rounds):
        for side in ("eager", "captured", "captured", "eager"):
            t0 = time.perf_counter()
            for _ in range(calls):
                call(side, k)
                k += 1
            times[side].append((time.perf_counter() - t0) / calls)
    for side, ts in times.items():
        print(f"# {side}: s a call " + " ".join(f"{t:.5f}" for t in ts)
              + f" (median {statistics.median(ts):.5f})", flush=True)
    fn = next(f for key, f in trees["captured"].contraction_cores.items() if key[-1] is True)
    ((graphs, _),) = fn.graphs.values()
    with tracing.record():
        for _ in range(calls):
            call("captured", k)
            k += 1
    recs = tracing.records()
    own = tracing.self_ns(recs)
    ms = {}
    for name in ("entry", "inputs.upload", "capture.load", "capture.replay"):
        ms[name] = sum(own[r.index] for r in recs if r.name == name) / calls / 1e6
    print("# captured spans, self ms a call: " + ", ".join(f"{n} {v:.3f}" for n, v in ms.items()),
          flush=True)
    record = collections.Counter(kernel for log in graphs.kernels for kernel, _, _ in log)
    print(json.dumps({
        "m10_capture": True, "rel_captured_vs_eager": rel, "least_bitstring_diff": spread,
        "s_a_call": {s: statistics.median(ts) for s, ts in times.items()},
        "captured_over_eager": statistics.median(times["captured"]) / statistics.median(times["eager"]),
        "peak_gib": peak, "graphs": len(graphs.graphs), "replays": graphs.replays,
        "capture_s": graphs.capture_s, "counts": COUNTS, "record_launches": record,
        "span_ms": ms,
        "card": torch.cuda.get_device_name(0),
    }), flush=True)


if __name__ == "__main__":
    main()
