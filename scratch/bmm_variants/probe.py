"""Build variants of the bmm_absmax kernel and time them on the 7x7
lattice's large shapes, on one CUDA card:

    python scratch/bmm_variants/probe.py [variant ...]

Variants (all from cotengra_tpu_torch/csrc/bmm_absmax.cu unless named):

- ``current``: the kernel as it is (yt split by a pre-pass, x in
  registers);
- ``first_layout``: ``first_layout.cu`` beside this script, the
  kernel's first layout (the consumers split x and yt in shared memory
  between their wgmma batches);
- ``producer_split``: ``producer_split.cu`` beside this script, the
  second (x in registers, yt split inside the kernel by the producer
  warpgroup, once per row tile);
- ``cvt``: the split rounds with ``cvt.rna.tf32.f32`` instead of an
  integer add and mask;
- ``noacc``: the products go straight into the running sum (no
  per-stage accumulator), which shows the tensor cores' own rounding.

All take the same arguments from ``bmm_absmax_cuda`` (the earlier two
use the workspace's start for their split-K partials).

Each is built with nvcc into ``build/bmm_variants/`` and checked against
``torch.bmm`` on uniform [0, 1) inputs: relative error (max|kernel -
bmm| / max|bmm|), absmax == max|out|, kernel ms (best of two runs of
5-20 launches, CUDA events) and TFLOP/s.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from cotengra_tpu_torch.ops import _build  # noqa: E402
from cotengra_tpu_torch.ops.bmm_absmax import (  # noqa: E402
    bmm_absmax_cuda,
    bmm_absmax_plain,
)

SHAPES = [
    (1, 65536, 4096, 4096),
    (1, 1048576, 256, 256),
    (1, 256, 65536, 256),
    (1, 4096, 256, 4096),
    (1, 65536, 256, 4096),
]


def _patch(src, old, new):
    if old not in src:
        raise RuntimeError(f"variant patch does not apply: {old[:60]!r}")
    return src.replace(old, new)


def variant_source(name):
    if name in ("first_layout", "producer_split"):
        return (Path(__file__).parent / f"{name}.cu").read_text()
    src = (_build._SRC_DIR / "bmm_absmax.cu").read_text()
    if name == "current":
        return src
    if name == "cvt":
        src = _patch(
            src, "  const uint32_t h = (u + 0x1000u) & 0xffffe000u;\n",
            '  uint32_t h;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(h) : '
            '"f"(a));\n',
        )
        return _patch(
            src,
            "    small = __uint_as_float(\n"
            "        (__float_as_uint(a - big) + 0x1000u) & 0xffffe000u);\n",
            "    uint32_t l;\n"
            '    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(l) : "f"(a - big));\n'
            "    small = __uint_as_float(l);\n",
        )
    if name == "noacc":
        src = _patch(src, "  float acc[64], part[64];\n",
                     "  float part[64];\n  float (&acc)[64] = part;\n")
        src = _patch(src, "smem_desc(yb + off), kk > 0);",
                     "smem_desc(yb + off), 1);")
        return _patch(src, "    for (int r = 0; r < 64; ++r) acc[r] += part[r];\n",
                      "    for (int r = 0; r < 0; ++r) acc[r] += part[r];\n")
    raise ValueError(f"unknown variant {name!r}")


def build(name):
    out = ROOT / "build" / "bmm_variants"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"{name}.so"
    cu.write_text(variant_source(name))
    nvcc = _build._nvcc()
    proc = subprocess.run(
        [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(so),
         str(cu), *_build._driver_link_flags(nvcc)],
        capture_output=True, text=True,
    )
    regs = [
        line.strip() for line in (proc.stdout + proc.stderr).splitlines()
        if "registers" in line or "spill" in line
    ]
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    print(f"# {name}: built; ptxas: {' | '.join(regs)}", flush=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.ctg_bmm_absmax_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 4 + [
        ctypes.c_int, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _ms(fn, reps):
    best = None
    for _ in range(2):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        t = s.elapsed_time(e) / reps
        best = t if best is None else min(best, t)
    return best


def main(names):
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA device", flush=True)
        return 1
    names = names or [
        "current", "first_layout", "producer_split", "cvt", "noacc"
    ]
    libs = {n: build(n) for n in names}
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    for B, M, K, N in SHAPES:
        x = torch.rand(B, M, K, device=dev, generator=gen)
        y = torch.rand(B, N, K, device=dev, generator=gen).transpose(1, 2)
        ref, ref_amax = bmm_absmax_plain(x, y)
        for name, lib in libs.items():
            _build.load_library = lambda lib=lib: lib
            out, amax = bmm_absmax_cuda(x, y)
            torch.cuda.synchronize()
            rel = ((out - ref).abs().max() / ref_amax).item()
            exact = amax.item() == out.abs().max().item()
            del out
            ms = _ms(lambda: bmm_absmax_cuda(x, y),
                     5 if M * K * N > 2**34 else 20)
            print(
                f"{name} {(B, M, K, N)} relerr {rel:.3e} absmax==max|out| "
                f"{exact} {ms:.3f} ms {2 * B * M * K * N / ms / 1e9:.1f} "
                "TFLOP/s", flush=True,
            )
        del x, y, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
