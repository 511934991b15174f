"""Time variants of the fused gate-chain kernel on chains of the m=10
t27 or m=20 t28 plan, on one GPU:

    python scratch/chain_variants/probe.py [--m20 ci,ci,...] [variant ...]
    python scratch/chain_variants/probe.py [--t27 ci,ci,...] [variant ...]

Each variant is ``cotengra_tpu_torch/csrc/gate_chain.cu`` with textual
edits and module constants of ``ops/gate_chains.py`` (``VARIANTS``),
built with nvcc into its own library under ``build/chain_variants/``
and timed with CUDA events through the port's own wrapper, in turns.
Variants that skip work give wrong results on purpose: they split the
kernel's time into its phases. The others are checked against the
plain version.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from cotengra_tpu_torch.ops import _build  # noqa: E402
from cotengra_tpu_torch.ops import gate_chains  # noqa: E402

SRC = ROOT / "cotengra_tpu_torch" / "csrc" / "gate_chain.cu"
OUT = ROOT / "build" / "chain_variants"
CHAINS = tuple(range(3, 13))
REG_GATES = "reg_gate_any<B>(st, sy + g.yoff, g.kb, g.nb, g.p);"


def LB(threads, blocks):
    """Edits: launch bounds (threads, blocks per SM), always that many
    threads a block."""
    return [("__launch_bounds__(MAX_THREADS)",
             f"__launch_bounds__({threads}, {blocks})"),
            ("2 * smem <= SMEM_LIMIT ? MAX_THREADS / 2 : MAX_THREADS",
             str(threads))]


NO_K24 = [("    case 2:\n      apply_gate_nb<2, TO_OUT>", "    case -2:\n"
           "      apply_gate_nb<2, TO_OUT>"),
          ("    case 4:\n      apply_gate_nb<4, TO_OUT>", "    case -4:\n"
           "      apply_gate_nb<4, TO_OUT>")]


# each variant: (source edits, module constants of gate_chains to set)
VARIANTS = {
    "base": ([], {}),
    # the same again: the noise between two builds of one source
    "base_again": ([], {}),
    # phases: the register groups' loads and stores alone (wrong results;
    # timing only)
    "no_reg_gates": ([(REG_GATES, "if (0) " + REG_GATES)], {}),
    "no_loads": ([("      issue_load(a, x, slots + (ka % S)",
                   "      if (0) issue_load(a, x, slots + (ka % S)"),
                  ("      issue_load(a, x, slots + k * PS",
                   "      if (0) issue_load(a, x, slots + k * PS")], {}),
    # the last group's stores to out left out
    "no_stores": ([("        d[so] = st[v].x;\n        d[out_plane + so] = st[v].y;",
                    "        if (so < 0) { d[so] = st[v].x;\n        d[out_plane + so] = st[v].y; }")], {}),
    # neither loads nor groups: the tile loop, its barriers and offsets
    "no_work": ([("      issue_load(a, x, slots + (ka % S)",
                    "      if (0) issue_load(a, x, slots + (ka % S)"),
                   ("      issue_load(a, x, slots + k * PS",
                    "      if (0) issue_load(a, x, slots + k * PS"),
                   ("      run_group(a, a.grp[j]",
                    "      if (0) run_group(a, a.grp[j]")], {}),
    # register groups of at most 8 or 4 values a thread, or none (every
    # gate item by item, the kernel's earlier path)
    "rb3": ([], {"REG_BITS": 3}),
    "rb2": ([], {"REG_BITS": 2}),
    "rb0": ([], {"REG_BITS": 0}),
    # two work buffers for the tiles between groups, the ring slot never
    # reused
    "two_work": ([], {"_work_buffers": lambda t_in, groups: dict(
        t_work=max([g.io.numel_out for g in groups[:-1]] or [0]),
        n_work=min(2, len(groups) - 1))}),
    # ring depth, batch tile, occupancy
    "stages2": ([], {"RING_STAGES": 2}),
    "tile1024": ([], {"TILE_ELEMS": 1024}),
    "tile4096": ([], {"TILE_ELEMS": 4096}),
    # tiles widened to longer contiguous runs of x and out
    "coalesce64": ([], {"COALESCE_FLOATS": 64}),
    "coalesce128": ([], {"COALESCE_FLOATS": 128}),
    # no widening beyond COALESCE_FLOATS, or on to longer runs
    "wide32": ([], {"WIDE_FLOATS": 32}),
    "wide64": ([], {"WIDE_FLOATS": 64}),
    "wide256": ([], {"WIDE_FLOATS": 256}),
    # the per-item path without its K = 2 and 4 specialisations
    "no_k24": (NO_K24, {}),
    "lb512x2": (LB(512, 2), {}),
    "lb256x3": (LB(256, 3), {}),
}
CHECKED = {n for n in VARIANTS if not n.startswith("no_")}


def build(name, edits):
    text = SRC.read_text()
    for old, new in edits:
        if old not in text:
            raise ValueError(f"{name}: {old!r} not in the source")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / f"{name}.cu"
    src.write_text(text)
    lib = OUT / f"lib{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
           "-o", str(lib), str(src)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def load(path):
    lib = ctypes.CDLL(str(path))
    fn = lib.ctg_gate_chain_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def main():
    args = sys.argv[1:]
    plan, chains = "sycamore53_m10_t27", CHAINS
    if args[:1] in (["--m20"], ["--t27"]):
        if args[0] == "--m20":
            plan = "sycamore53_m20_t28"
        chains = tuple(int(c) for c in args[1].split(","))
        args = args[2:]
    names = args or list(VARIANTS)
    jobs = {n: build(n, VARIANTS[n][0]) for n in names}
    libs = {}
    for n, (path, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{n}: nvcc failed\n{out}")
        # the kernel's registers, stack and spills (ptxas -v)
        lines = out.splitlines()
        for at in [i for i, ln in enumerate(lines)
                   if "Compiling entry function" in ln]:
            print(f"{n}: " + " | ".join(
                ln.split(":", 1)[-1].strip() for ln in lines[at:at + 4]
                if "Compiling" in ln or "stack" in ln or "Used" in ln),
                flush=True)
        libs[n] = load(path)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    tree, _, _ = chip_smoke._load_instance(plan)
    recs = chip_smoke._chain_recs(tree)
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
    totals = dict.fromkeys(names, 0.0)
    defaults = {k: getattr(gate_chains, k)
                for n in names for k in VARIANTS[n][1]}
    for ci in chains:
        spec = recs[ci].spec
        kn = [(K, N) for _, _, K, N in recs[ci].ys]
        x, ys = chip_smoke._chain_inputs_on_card(gen, spec, kn, dev)
        plain = gate_chains.run_chain_plain(spec, x, ys)
        bound = chip_smoke._chain_bound(spec, kn)[0]
        reps = 3 if x.numel() >= 2**28 else 10
        row = []
        for n in names + names[::-1]:  # in turns
            _build.load_library = lambda n=n: libs[n]
            for k, v in {**defaults, **VARIANTS[n][1]}.items():
                setattr(gate_chains, k, v)
            spec._tiles.clear()
            got = gate_chains.run_chain_cuda(spec, x, ys)
            torch.cuda.synchronize()
            if n in CHECKED:
                err = (got - plain).abs().max().item()
                if not err <= 1e-5 * plain.abs().max().item():
                    raise AssertionError(f"{n} chain {ci}: error {err}")
            del got
            ms = chip_smoke._cuda_ms(
                lambda: gate_chains.run_chain_cuda(spec, x, ys), reps)
            row.append((n, ms))
            totals[n] += ms / 2
        mean = {n: sum(ms for m, ms in row if m == n) / 2 for n in names}
        print(f"chain {ci} {kn} bound {bound:.3f} ms: " + ", ".join(
            f"{n} {ms:.3f}" for n, ms in mean.items()), flush=True)
        del x, ys, plain
        torch.cuda.empty_cache()
    print("summed: " + ", ".join(
        f"{n} {ms:.3f}" for n, ms in totals.items()), flush=True)


if __name__ == "__main__":
    main()
