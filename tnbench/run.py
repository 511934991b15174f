"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 tnbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. One process: load, warm up, run the cell's
closed loop for ``--seconds``, (``--trace 1``) profile a few more calls,
judge the window's calls against the plain reference, and print one
JSON object as the last line of standard output, the compared numbers
beside their limits as the last lines of standard error. With
``--trace 0`` the metrics are the cell's end-to-end ones, with
``--trace 1`` its per-layer ones.

It exits with a code other than 0 and prints no result where there is
no CUDA card, or fewer than the cell asks for, where the program cannot
be imported, or where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _fail(msg, code):
    print(f"tnbench: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from tnbench import harness

    try:
        cell = harness.resolve_cell(ROOT, args.workload)
    except (KeyError, OSError, ValueError) as exc:
        _fail(f"cannot resolve workload {args.workload!r}: {exc}", 2)
    marks = [("interpreter", time.perf_counter())]
    import torch

    marks.append(("torch_import", time.perf_counter()))
    if not torch.cuda.is_available():
        _fail("no CUDA device: the benchmark runs on the card only", 3)
    if torch.cuda.device_count() < cell.chips:
        _fail(f"{cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} visible", 3)
    torch.cuda.init()
    marks.append(("cuda_init", time.perf_counter()))
    try:
        import cotengra_tpu_torch  # noqa: F401
    except ImportError as exc:
        _fail(f"the program cannot be imported: {exc}", 2)
    marks.append(("program_import", time.perf_counter()))
    process = {}
    last = T_START
    for name, t in marks:
        process[name] = t - last
        last = t

    seed = args.seed % 2**63
    result = harness.run_cell(
        ROOT, args.workload, seed, args.seconds, bool(args.trace), "cuda", T_START,
        process,
    )
    loaded = harness.forbidden_loaded()
    if loaded:
        _fail(f"forbidden modules loaded in the benchmark's process: {loaded}", 4)
    result["device"] = dict(harness.device_info(cell.chips), **result["device"])
    check = result.pop("check")
    for c in check.values():
        if not math.isfinite(c["value"]):
            c["value"] = str(c["value"])
    result["check"] = check
    for name, c in check.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r} ({c['calls']} calls compared)",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
