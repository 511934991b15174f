#!/usr/bin/env python3
"""Run ``cotengra_tpu_torch/csrc/gate_chain.cu`` on the CPU, without a
card, against ``run_chain_plain``:

    python scratch/chain_cpu/run.py [--asan]

The kernel's source is compiled with g++ against the CUDA stubs beside
this script (``cuda_runtime.h``: ``__device__`` and the like empty,
``threadIdx`` a global), its launches rewritten to a loop over the
grid's blocks, each run by one thread, and ``cp.async`` to a plain copy;
so the index maths, the argument block and its checks run as on the
card, barriers and races aside. The chains: single gates of every m=20
shape, runs of register groups, a kron gate item by item, K = 2 and 4
item by item, a last group that stores to out a stride apart, a short
last batch tile, the slice leg, and the small t27 and m20
chains. ``--asan`` builds with AddressSanitizer (python is then run with
libasan preloaded, as this script does for itself).
"""

import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
OUT = ROOT / "build" / "chain_cpu"


def build(asan):
    src = (ROOT / "cotengra_tpu_torch" / "csrc" / "gate_chain.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>",
                      '#include "cuda_runtime.h"\n#include <math.h>')
    src = re.sub(r'asm volatile\("cp\.async\.ca\.shared\.global.*?\);',
                 "*smem_dst = *src; (void)s;", src, flags=re.S)
    src = re.sub(r"asm volatile\((.*?)\);", ";", src, flags=re.S)
    src = src.replace(
        "extern __shared__ __align__(16) unsigned char smem_raw[];",
        "static unsigned char smem_raw[262144] "
        "__attribute__((aligned(16)));")

    def launch(m):
        return ("{ gridDim = blocks; blockDim = dim3(1);"
                " for (unsigned by = 0; by < blocks.y; ++by)"
                " for (unsigned bx = 0; bx < blocks.x; ++bx) {"
                " blockIdx.x = bx; blockIdx.y = by; threadIdx.x = 0;"
                " gate_chain_kernel(x, out, tables, a);"
                " } }")

    src = re.sub(r"gate_chain_kernel<<<.*?>>>"
                 r"\(\s*x, out, tables, a\);", launch, src, flags=re.S)
    OUT.mkdir(parents=True, exist_ok=True)
    cpp = OUT / "gate_chain_cpu.cpp"
    cpp.write_text(src)
    lib = OUT / ("libgate_chain_cpu_asan.so" if asan else
                 "libgate_chain_cpu.so")
    cmd = ["g++", "-std=c++17", "-O1", "-g", "-shared", "-fPIC",
           f"-I{HERE}", "-o", str(lib), str(cpp)]
    if asan:
        cmd.insert(1, "-fsanitize=address")
    subprocess.run(cmd, check=True)
    return lib


def main():
    asan = "--asan" in sys.argv[1:]
    if asan and "libasan" not in os.environ.get("LD_PRELOAD", ""):
        libasan = subprocess.run(["gcc", "-print-file-name=libasan.so"],
                                 capture_output=True, text=True,
                                 check=True).stdout.strip()
        env = dict(os.environ, LD_PRELOAD=libasan,
                   ASAN_OPTIONS="detect_leaks=0")
        return subprocess.run([sys.executable, *sys.argv], env=env).returncode
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import torch

    import chip_smoke as cs
    from cotengra_tpu_torch.ops import gate_chains as gc
    from cotengra_tpu_torch.utils.misc import prod
    from test_torch_chains import _gates

    fn = ctypes.CDLL(str(build(asan))).ctg_gate_chain_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_void_p]

    def run(spec, x, ys):
        nslice = gc._slices_of(x, ys)
        lead = () if nslice is None else (nslice,)
        for ps in gc.chain_tile_plan(spec):
            meta, tables = gc._pass_kernel_args(ps)
            tables = torch.from_numpy(tables)
            first, stop = ps.gates
            for j, y in enumerate(ys[first:stop]):
                at = gc._META_Y + gc._META_GATE * j
                meta[at] = y.data_ptr()
                if y.dim() == 4:
                    meta[at + gc._META_Y_SLICE] = y.stride(0)
            out = torch.full(lead + (2 * ps.io.numel_out,), float("nan"))
            if nslice is not None:
                meta[gc._META_SLICES:gc._META_SLICES + 3] = [
                    nslice, x.stride(0) if x.dim() == 2 else 0,
                    out.stride(0)]
            m = (ctypes.c_int64 * len(meta))(*meta)
            rc = fn(x.data_ptr(), out.data_ptr(), tables.data_ptr(), m,
                    len(meta), None)
            if rc != 0:
                raise RuntimeError(f"the argument block was refused ({rc})")
            x = out
        return x

    def check(name, spec, kn, seed, nslice=None, batched=()):
        g = torch.Generator().manual_seed(seed)
        n = spec.gate_strides[0].numel_in
        x = torch.randn(((nslice,) if "x" in batched else ()) + (2 * n,),
                        generator=g)
        ys = [torch.randn(((nslice,) if "y" in batched else ())
                          + (2, K, N), generator=g) for K, N in kn]
        got = run(spec, x, ys)
        ref = gc.run_chain_plain(spec, x.double(), [y.double() for y in ys])
        err = ((got.double() - ref).abs().max() / ref.abs().max()).item()
        print(f"{name}: relative error {err:.2e}, (register gates, item "
              f"gates, groups) a pass "
              f"{[gc.group_counts(ps) for ps in gc.chain_tile_plan(spec)]}",
              flush=True)
        if not err < 1e-5:
            raise AssertionError(name)

    def synthetic(n, picks):
        order0, sizes, gates = _gates(n, picks)
        spec, why, c_orders = gc.build_chain_spec(order0, sizes, gates)
        if spec is None:
            raise ValueError(why)
        return spec, [(prod(sizes[i] for i in c), prod(sizes[i] for i in ny))
                      for c, ny in c_orders]

    cases = {
        "(2,1)": [((1,), 0)], "(2,2)": [((1,), 1)], "(4,4)": [((1, 2), 2)],
        "(4,8)": [((1, 2), 3)], "(8,4)": [((1, 2, 3), 2)],
        "(8,8)": [((1, 2, 3), 3)], "(8,16)": [((1, 2, 3), 4)],
        "(16,16)": [((1, 2, 3, 4), 4)], "(16,32)": [((1, 2, 3, 4), 5)],
        "(8,32)": [((10, 11, 12), 5)], "(32,8)": [((0, 1, 2, 3, 4), 3)],
        "overlapping": [((1, 2), 2), ((2, 3), 2), ((3, 4), 2), ((1, 2), 2)],
        "disjoint": [((1, 2), 2), ((4, 5), 2), ((7, 8), 2), ((10, 11), 2)],
        "eight gates": [((0, 1), 2), ((2, 3), 2), ((1, 2), 2), ((4, 5), 2),
                        ((3, 4), 2), ((0, 1), 2), ((2, 3), 2), ((1, 2), 2)],
        "kron between": [((0, 1), 2), ((1, 5, 6, 17, 18), 4), ((2, 3), 2)],
        "grow, shrink": [((1, 2), 3), ((6, 7), 2), ((0, 1, 2), 2)],
        "strided last group": [((0, 1), 2), ((16, 17), 2), ((17, 18), 2)],
        "(2,8) item by item": [((1,), 3)],
        "(4,16) item by item": [((1, 2), 4)],
    }
    for name, picks in cases.items():
        spec, kn = synthetic(19, picks)
        check(name, spec, kn, 1)
        if name in ("disjoint", "kron between"):
            for b in (("x",), ("y",), ("x", "y")):
                check(f"{name}, slices {'+'.join(b)}", spec, kn, 2,
                      nslice=3, batched=b)
    # a batch tile of 3 over a power-of-two batch: the last one short
    spec, kn = synthetic(19, [((0, 1), 2), ((2, 3), 2), ((1, 2), 2)])
    make = gc._pass_kernel_args

    def short(ps):
        meta, tables = make(ps)
        meta[1:3] = [3, 2]
        return meta, tables

    gc._pass_kernel_args = short
    check("short last batch tile", spec, kn, 4)
    gc._pass_kernel_args = make
    for plan, chains in ((cs.T27, (0, 1, 2)),
                         (cs.M20, (0, 1, 2, 3, 4, 5, 6, 34, 35, 36, 37))):
        tree, _, _ = cs._load_instance(plan)
        recs = cs._chain_recs(tree)
        for ci in chains:
            check(f"{plan} chain {ci}", recs[ci].spec,
                  [(K, N) for _, _, K, N in recs[ci].ys], ci)
    print("all chains equal the plain version", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
