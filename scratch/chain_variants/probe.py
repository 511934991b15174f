"""Time variants of the fused gate-chain kernel on chains of the m=10
t27 plan, on one GPU:

    python scratch/chain_variants/probe.py [variant ...]

Each variant is ``cotengra_tpu_torch/csrc/gate_chain.cu`` with textual
edits (``VARIANTS``), built with nvcc into its own library under
``build/chain_variants/`` and timed with CUDA events through the
port's own wrapper. Variants that skip work (all gates but the last, the
loads) give wrong results on purpose: they split the kernel's time
into its phases. The others are checked against the plain version.
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
GATE_LOOP = "for (int j = 0; j + 1 < a.ngates; ++j) {"
ITEM_LOOP = "  for (int i = threadIdx.x; i < total; i += blockDim.x) {\n    const int eb"


def LB(threads, blocks):
    """Edits: launch bounds (threads, blocks per SM), always that many
    threads a block."""
    return [("__launch_bounds__(MAX_THREADS)",
             f"__launch_bounds__({threads}, {blocks})"),
            ("2 * smem <= SMEM_LIMIT ? MAX_THREADS / 2 : MAX_THREADS",
             str(threads))]


# each variant: (source edits, module constants of gate_chains to set)
VARIANTS = {
    "base": ([], {}),
    # phases: drop one (wrong results; timing only). Without gates the
    # last gate still runs: it stores out
    "no_gates": ([(GATE_LOOP, GATE_LOOP.replace("j + 1 < a.ngates", "j < 0"))],
                 {}),
    "no_loads": ([("      issue_load(a, x, slots + (ka % S)",
                   "      if (0) issue_load(a, x, slots + (ka % S)"),
                  ("      issue_load(a, x, slots + k * PS",
                   "      if (0) issue_load(a, x, slots + k * PS")], {}),
    # tuning candidates (checked against the plain version)
    "unroll2": ([(ITEM_LOOP, "#pragma unroll 2\n" + ITEM_LOOP)], {}),
    "stages2": ([], {"RING_STAGES": 2}),
    "tile1024": ([], {"TILE_ELEMS": 1024}),
    "tile4096": ([], {"TILE_ELEMS": 4096}),
    # occupancy: registers capped by the launch bounds, threads fixed
    "lb512x2": (LB(512, 2), {}),
    "lb256x3": (LB(256, 3), {}),
    "lb256x4_s2": (LB(256, 4), {"RING_STAGES": 2}),
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
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
           str(src)]
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
    names = sys.argv[1:] or list(VARIANTS)
    jobs = {n: build(n, VARIANTS[n][0]) for n in names}
    libs = {}
    for n, (path, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{n}: nvcc failed\n{out}")
        libs[n] = load(path)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    tree, _, _ = chip_smoke._load_instance("sycamore53_m10_t27")
    recs = chip_smoke._chain_recs(tree)
    rng = np.random.default_rng(chip_smoke.SEED)
    totals = dict.fromkeys(names, 0.0)
    for ci in CHAINS:
        spec = recs[ci].spec
        kn = [(K, N) for _, _, K, N in recs[ci].ys]
        x, ys = chip_smoke._chain_inputs(rng, spec, kn, dev)
        plain = gate_chains.run_chain_plain(spec, x, ys)
        bound = chip_smoke._chain_bound(spec, kn)[0]
        row = []
        defaults = {k: getattr(gate_chains, k)
                    for n in names for k in VARIANTS[n][1]}
        for n in names:
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
            ms = chip_smoke._cuda_ms(
                lambda: gate_chains.run_chain_cuda(spec, x, ys), 10)
            row.append(f"{n} {ms:.3f}")
            totals[n] += ms
        print(f"chain {ci} {kn} bound {bound:.3f} ms: " + ", ".join(row),
              flush=True)
        del x, ys, plain
    print(f"chains {CHAINS[0]}-{CHAINS[-1]} summed: " + ", ".join(
        f"{n} {ms:.3f}" for n, ms in totals.items()), flush=True)


if __name__ == "__main__":
    main()
