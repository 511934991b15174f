// Batched float32 matmul with a fused max|out|, for exponent stripping.
//
// Replaces the TPU kernel cotengra_tpu/ops/pallas_bmm.py::bmm_absmax (body
// _mm_absmax_kernel). It computes what that kernel computes:
//
//   out[b] = x[b] @ y[b]        x: (B, M, K) row-major, y given as
//                               yt = y^T: (B, N, K) row-major
//   absmax = max |out|          over every b, m, n
//
// with absmax taken from the accumulators in the epilogue, so stripping the
// exponent of a contraction step needs no second pass over the output.
//
// What bounds it on an H100: arithmetic. The lattice's large steps
// ((65536, 4096, 4096) carries most of its work) do 2*M*N*K flops on
// 4*(M*K + K*N + M*N) bytes, far above the card's balance point. Float32
// FMA peaks at 67 TFLOP/s; the tensor cores run TF32 at 495. The design
// takes the tensor cores at float32 accuracy with the 3xTF32 split:
//
//   a = big + small,  big = tf32(a), small = tf32(a - big)
//   a*b ~ big_a*big_b + big_a*small_b + small_a*big_b
//
// tf32() rounds to nearest, ties away from zero: cvt.rna.tf32.f32's result,
// computed with an integer add and mask (cheaper than the conversion
// instruction; PERF.md). The dropped small*small term is ~2^-22 relative
// per product. Three TF32 products cost 3/495 of a float32 FMA's 1/67: a
// ceiling of ~165 TFLOP/s.
//
// Where the split happens is the design. wgmma takes B only from shared
// memory, so yt's two parts must sit there; splitting them inside the
// kernel repeats the work for every row tile and competes with wgmma for
// shared-memory bandwidth (on (65536, 4096, 4096) two such layouts, kept in
// scratch/bmm_variants, ran at 72 and 81 TFLOP/s; this one at ~117). So:
//   - a pre-pass (presplit_kernel) splits yt once into yt_big and yt_small
//     in the workspace: 3 N K floats moved, nothing next to the product;
//   - x, the large operand, is split in registers: each consumer reads its
//     rows from the swizzled TMA tile straight into wgmma's A fragments.
//
// Block layout (384 threads, one block per SM):
//   - producer warpgroup (40 registers a thread, the consumers 232): one
//     thread issues TMA loads (cp.async.bulk.tensor) of the x, yt_big and
//     yt_small tiles (128 rows x 32 k, float32, 128-byte swizzle) into a
//     ring of STAGES stages, each guarded by a full and an empty mbarrier.
//     TMA's out-of-range fill gives zeros past the M, N and K edges, so no
//     masking and no padding copies (the TPU kernel padded to
//     256-multiples).
//   - consumer warpgroups 1 and 2 each own 64 output rows by 128 columns.
//     Per stage they issue 12 wgmma m64n128k8 TF32, A (x's parts) from
//     registers and B (yt's parts) from shared memory: 3 products x 4
//     k-steps, into a stage accumulator. While those run they load and
//     split the next stage's x.
//   - Accuracy: the tensor cores add in their own rounding, which on
//     all-positive data (the lattice's) biases long sums (4.9e-5 of the
//     result at K = 4096, measured). So each stage's 12 products go into a
//     fresh accumulator that is then added to the running one in ordinary
//     float32 (round to nearest): 64 + 64 registers.
//   - Non-finite inputs: where big is inf or NaN, big = +-1 and small =
//     the value. Then each non-finite element reaches the sum through one
//     cross term against the other side's finite big (+-1 where that is
//     non-finite too), so inf * finite stays inf, inf * inf keeps its sign
//     and NaN propagates; with small = 0 instead, inf * (a TF32-exact
//     value) would give inf * 0 = NaN.
//
// Split K: where the output tiles are too few to fill the card (the
// (256, 65536, 256) and (1, 65536, 1) steps of the 7x7 lattice), the host
// splits K into chunks of whole k tiles; each block writes its partial
// tile to a workspace, and a second kernel sums the partials, writes out
// and takes max|out| from those sums.
//
// The |max| reduction: each consumer thread folds |acc| of its in-range
// outputs; warp shuffles, then shared memory across the 8 consumer warps,
// then one atomicMax on the float's bit pattern into a device scalar zeroed
// on the stream first. For non-negative floats the integer order is the
// float order, and a NaN (sign cleared by fabsf) sorts above inf, so a NaN
// propagates as jnp.max does.
//
// TMA needs K % 4 == 0 (16-byte row strides) and 16-byte aligned bases; the
// host wrapper (ops/bmm_absmax.py) zero-pads K up to a multiple of 4.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int BM = 128, BN = 128;
constexpr int BK = 32;                  // 32 floats = one 128-byte swizzle row
constexpr int STAGES = 4;               // TMA ring depth
constexpr int NTHREADS = 384;           // producer + 2 consumer warpgroups
// registers a thread after setmaxnreg. The block starts with 168 a thread
// (65536 / 384, in steps of 8); setmaxnreg.inc waits until the producer has
// given back enough, so the two must fit in what the block holds
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <=
                  NTHREADS * (65536 / NTHREADS / 8 * 8),
              "setmaxnreg would wait forever");
constexpr int TILE_BYTES = BM * BK * 4;         // 16 KiB, x and yt alike
constexpr int HALF_BYTES = TILE_BYTES / 2;      // one consumer's 64 rows
constexpr int STAGE_BYTES = 3 * TILE_BYTES;     // x, yt's big, yt's small
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 /* alignment */ + 256;
constexpr int PRESPLIT_THREADS = 256;
constexpr int REDUCE_THREADS = 256;

static_assert(BN == BM, "x and yt tiles share one box shape");

// max of two non-negative values where a NaN wins
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// 3-D tile load (k, row, batch) of a tensor map into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k, int row,
                                         int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k),
      "r"(row), "r"(batch)
      : "memory");
}

// the 256 consumer threads only (the producer warpgroup never joins)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (the TMA box layout). Tile bases are 1024-aligned; a
// k-step of 8 floats advances the start address by 32 bytes.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}

#define ACC8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= A(64 x 8, registers) @ B(8 x 128, smem, K-major), TF32 in, f32
// out; accumulate == 0 overwrites d. Thread (warp w, lane l) of the
// warpgroup holds A rows 16 w + l / 4 (a[0], a[2]) and 16 w + l / 4 + 8
// (a[1], a[3]), at k = l % 4 (a[0], a[1]) and l % 4 + 4 (a[2], a[3]).
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4], uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
        ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// keep the compiler from moving register accesses across wgmma boundaries
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// a -> (big, small). tf32 rounding adds half a tf32 ulp (bit 12) to the
// magnitude and clears the 13 low bits. Where a is not finite, or rounds to
// inf, big = +-1 and small = a (a NaN made quiet, so that the tensor
// cores, which read the top 19 bits, still see a NaN); see the header.
__device__ __forceinline__ void split_tf32(float a, float& big, float& small) {
  const uint32_t u = __float_as_uint(a);
  const uint32_t h = (u + 0x1000u) & 0xffffe000u;
  if ((u & 0x7f800000u) != 0x7f800000u && (h & 0x7f800000u) != 0x7f800000u) {
    big = __uint_as_float(h);
    small = __uint_as_float(
        (__float_as_uint(a - big) + 0x1000u) & 0xffffe000u);
  } else {
    big = __uint_as_float((u & 0x80000000u) | 0x3f800000u);
    small = __uint_as_float(
        (u & 0x7fffffffu) > 0x7f800000u ? u | 0x00400000u : u);
  }
}

// yt -> (big, small), elementwise over n4 float4s
__global__ void __launch_bounds__(PRESPLIT_THREADS)
    presplit_kernel(const float4* __restrict__ src, float4* __restrict__ hi,
                    float4* __restrict__ lo, int64_t n4) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float4 v = src[i];
    float4 b, s;
    split_tf32(v.x, b.x, s.x);
    split_tf32(v.y, b.y, s.y);
    split_tf32(v.z, b.z, s.z);
    split_tf32(v.w, b.w, s.w);
    hi[i] = b;
    lo[i] = s;
  }
}

// The 8-deep k step kk of a 64-row slice of the swizzled x tile, as the
// A fragments of this thread, split: big into hi, small into lo. Row r, byte
// c of a 128-byte TMA row sits at r * 128 + ((c / 16) ^ (r % 8)) * 16 +
// c % 16; the slice starts on an 8-row boundary, so r % 8 = l / 4.
__device__ __forceinline__ void load_a(const uint8_t* x64, int t, int kk,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int g = (t & 31) >> 2;
  const uint8_t* row = x64 + (16 * (t >> 5) + g) * 128 + 4 * (t & 3);
  const int c0 = ((2 * kk) ^ g) * 16, c1 = ((2 * kk + 1) ^ g) * 16;
  const float v[4] = {*reinterpret_cast<const float*>(row + c0),
                      *reinterpret_cast<const float*>(row + 8 * 128 + c0),
                      *reinterpret_cast<const float*>(row + c1),
                      *reinterpret_cast<const float*>(row + 8 * 128 + c1)};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float b, s;
    split_tf32(v[j], b, s);
    hi[j] = __float_as_uint(b);
    lo[j] = __float_as_uint(s);
  }
}

// SPLIT: write partial tiles to the workspace, no absmax
template <bool SPLIT>
__global__ void __launch_bounds__(NTHREADS, 1)
    bmm_absmax_kernel(const __grid_constant__ CUtensorMap x_map,
                      const __grid_constant__ CUtensorMap yb_map,
                      const __grid_constant__ CUtensorMap ys_map,
                      float* __restrict__ out, float* __restrict__ amax,
                      int B, int M, int N, int splits, int k_tiles,
                      int tiles_per_split) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // [stage s: x tile | yt big tile | yt small tile] x STAGES, then the
  // barriers and the per-warp maxima
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  float* warp_max = reinterpret_cast<float*>(empty + STAGES);

  const int b = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int kt0 = split * tiles_per_split;
  const int nk = min(tiles_per_split, k_tiles - kt0);  // >= 1 (host)

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer warpgroup: few registers; one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], ((i / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], STAGE_BYTES);
        uint8_t* st = smem + s * STAGE_BYTES;
        const int k = (kt0 + i) * BK;
        tma_load(st, &x_map, &full[s], k, m0, b);
        tma_load(st + TILE_BYTES, &yb_map, &full[s], k, n0, b);
        tma_load(st + 2 * TILE_BYTES, &ys_map, &full[s], k, n0, b);
      }
    }
    return;
  }

  // consumers: rows [64 cw, 64 cw + 64) of the tile, all 128 columns
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int cw = wg - 1;
  const int t = threadIdx.x & 127;     // thread within the warpgroup
  float acc[64], part[64];
#pragma unroll
  for (int r = 0; r < 64; ++r) acc[r] = part[r] = 0.f;
  // x fragments of the stage in the tensor cores and of the next one
  uint32_t a_hi[BK / 8][4], a_lo[BK / 8][4];
  uint32_t n_hi[BK / 8][4] = {}, n_lo[BK / 8][4] = {};
  auto load_stage = [&](int i, uint32_t (&hi)[BK / 8][4],
                        uint32_t (&lo)[BK / 8][4]) {
    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
    const uint8_t* x64 = smem + (i % STAGES) * STAGE_BYTES + cw * HALF_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) load_a(x64, t, kk, hi[kk], lo[kk]);
  };

  load_stage(0, a_hi, a_lo);
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    const uint8_t* yb = smem + s * STAGE_BYTES + TILE_BYTES;
    const uint8_t* ys = yb + TILE_BYTES;
    fence_acc(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const int off = kk * 32;
      wgmma_tf32(part, a_hi[kk], smem_desc(yb + off), kk > 0);
      wgmma_tf32(part, a_hi[kk], smem_desc(ys + off), 1);
      wgmma_tf32(part, a_lo[kk], smem_desc(yb + off), 1);
    }
    wgmma_commit();
    // the next stage's x fragments load while the tensor cores work
    if (i + 1 < nk) load_stage(i + 1, n_hi, n_lo);
    wgmma_wait_all();
    fence_acc(part);
#pragma unroll
    for (int r = 0; r < 64; ++r) acc[r] += part[r];
    if (t == 0) mbar_arrive(&empty[s]);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a_hi[kk][j] = n_hi[kk][j];
        a_lo[kk][j] = n_lo[kk][j];
      }
  }

  // epilogue: accumulator r of thread (warp w, lane l) is row
  // 16 w + l / 4 + 8 ((r / 2) % 2), column 8 (r / 4) + 2 (l % 4) + r % 2
  const int warp = t >> 5, lane = t & 31;
  const int row0 = m0 + 64 * cw + 16 * warp + (lane >> 2);
  const int col0 = n0 + 2 * (lane & 3);
  float* dst = out + (SPLIT ? ((int64_t)split * B + b) : (int64_t)b) *
                         (int64_t)M * N;
  const bool pairs = (N % 2) == 0;
  float local_max = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      const int col = col0 + 8 * j;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (row >= M || col >= N) continue;
      float* p = dst + (int64_t)row * N + col;
      if (pairs) {
        *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        local_max = nan_max(local_max, nan_max(fabsf(v0), fabsf(v1)));
      } else {
        p[0] = v0;
        local_max = nan_max(local_max, fabsf(v0));
        if (col + 1 < N) {
          p[1] = v1;
          local_max = nan_max(local_max, fabsf(v1));
        }
      }
    }
  }
  if (SPLIT) return;
  for (int off = 16; off > 0; off >>= 1)
    local_max = nan_max(local_max, __shfl_xor_sync(0xffffffffu, local_max, off));
  if (lane == 0) warp_max[cw * 4 + warp] = local_max;
  consumer_sync();
  if (cw == 0 && t == 0) {
    float v = warp_max[0];
    for (int w = 1; w < 8; ++w) v = nan_max(v, warp_max[w]);
    atomicMax(reinterpret_cast<int*>(amax), __float_as_int(v));
  }
}

// out[i] = sum over splits of ws[s][i], and max|out| into *amax
__global__ void __launch_bounds__(REDUCE_THREADS)
    splitk_reduce_absmax_kernel(const float* __restrict__ ws,
                                float* __restrict__ out,
                                float* __restrict__ amax, int64_t total,
                                int splits) {
  __shared__ float warp_max[REDUCE_THREADS / 32];
  float local_max = 0.f;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += ws[p * total + i];
    out[i] = s;
    local_max = nan_max(local_max, fabsf(s));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    local_max = nan_max(local_max, __shfl_xor_sync(0xffffffffu, local_max, off));
  if (lane == 0) warp_max[warp] = local_max;
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = warp_max[0];
    for (int w = 1; w < REDUCE_THREADS / 32; ++w) v = nan_max(v, warp_max[w]);
    atomicMax(reinterpret_cast<int*>(amax), __float_as_int(v));
  }
}

// (B, rows, K) row-major float32 as a 3-D map (k, row, batch), 128 x 32 box
CUresult make_map(CUtensorMap* map, const float* p, int64_t B, int64_t rows,
                  int64_t K) {
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)K * 4,
                                 (cuuint64_t)(rows * K * 4)};
  const cuuint32_t box[3] = {BK, BM, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(p), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The kernel's dynamic shared memory limit, raised once per device and
// kernel: not stream work, which a CUDA graph capture in the global mode
// may refuse; every capture follows an eager warm-up that sets it.
constexpr int MAX_DEVICES = 64;
std::mutex smem_mutex;
bool smem_set[2][MAX_DEVICES];

template <bool SPLIT>
cudaError_t raise_smem_limit() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(smem_mutex);
  if (smem_set[SPLIT][dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(bmm_absmax_kernel<SPLIT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err == cudaSuccess) smem_set[SPLIT][dev] = true;
  return err;
}

template <bool SPLIT>
cudaError_t launch_main(const CUtensorMap& xm, const CUtensorMap& ybm,
                        const CUtensorMap& ysm, float* dst, float* amax,
                        int64_t B, int64_t M, int64_t N, int splits,
                        int k_tiles, int tiles_per_split, cudaStream_t s) {
  cudaError_t err = raise_smem_limit<SPLIT>();
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM),
            (unsigned)(B * splits));
  bmm_absmax_kernel<SPLIT><<<grid, NTHREADS, SMEM_BYTES, s>>>(
      xm, ybm, ysm, dst, amax, (int)B, (int)M, (int)N, splits, k_tiles,
      tiles_per_split);
  return cudaGetLastError();
}

}  // namespace

// x (B, M, K) and yt (B, N, K) contiguous float32 on the device, K a
// positive multiple of 4, both 16-byte aligned; out (B, M, N) contiguous;
// amax one float on the device; ws holds 2 B N K floats (yt's big and small
// parts) and then, when splits > 1, the (splits, B, M, N) partial tiles. K
// is cut into chunks of k_chunk (a multiple of 32), splits of them.
// Returns a cudaError_t, or a CUresult + 100000 if a tensor map is refused
// (0 on success); nothing is synchronised.
extern "C" int ctg_bmm_absmax_f32(const float* x, const float* yt, float* out,
                                  float* amax, float* ws, int64_t B, int64_t M,
                                  int64_t K, int64_t N, int splits,
                                  int64_t k_chunk, void* stream) {
  if (B < 0 || M < 0 || N < 0 || K < 4 || K % 4 != 0 || splits < 1 ||
      k_chunk < BK || k_chunk % BK != 0 ||
      (int64_t)(splits - 1) * k_chunk >= K || (int64_t)splits * k_chunk < K ||
      (uintptr_t)x % 16 != 0 || (uintptr_t)yt % 16 != 0 ||
      (uintptr_t)ws % 16 != 0 || (uintptr_t)out % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if ((M + BM - 1) / BM > 65535 || B * splits > 65535 ||
      (N + BN - 1) / BN > 2147483647 || M > 2147483647 || N > 2147483647 ||
      K > 2147483647 || B > 2147483647)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || M == 0 || N == 0) return 0;
  if (ws == nullptr) return (int)cudaErrorInvalidValue;
  // yt's split, once for every row tile that reads it
  const int64_t ny = B * N * K;
  float* yb = ws;
  float* ys = ws + ny;
  int64_t blocks = (ny / 4 + PRESPLIT_THREADS - 1) / PRESPLIT_THREADS;
  if (blocks > 8192) blocks = 8192;
  presplit_kernel<<<(unsigned)blocks, PRESPLIT_THREADS, 0, s>>>(
      reinterpret_cast<const float4*>(yt), reinterpret_cast<float4*>(yb),
      reinterpret_cast<float4*>(ys), ny / 4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // The maps are encoded on the host and passed by value: a CUDA graph
  // that captures this launch keeps the pointers seen at capture, which
  // is right because the graph's memory pool keeps those addresses for
  // every replay.
  CUtensorMap xm, ybm, ysm;
  CUresult cr = make_map(&xm, x, B, M, K);
  if (cr == CUDA_SUCCESS) cr = make_map(&ybm, yb, B, N, K);
  if (cr == CUDA_SUCCESS) cr = make_map(&ysm, ys, B, N, K);
  if (cr != CUDA_SUCCESS) return 100000 + (int)cr;
  const int k_tiles = (int)((K + BK - 1) / BK);
  const int tiles_per_split = (int)(k_chunk / BK);
  if (splits == 1)
    return (int)launch_main<false>(xm, ybm, ysm, out, amax, B, M, N, 1,
                                   k_tiles, tiles_per_split, s);
  float* partials = ws + 2 * ny;
  err = launch_main<true>(xm, ybm, ysm, partials, amax, B, M, N, splits,
                          k_tiles, tiles_per_split, s);
  if (err != cudaSuccess) return (int)err;
  const int64_t total = B * M * N;
  blocks = (total + REDUCE_THREADS - 1) / REDUCE_THREADS;
  if (blocks > 4096) blocks = 4096;
  splitk_reduce_absmax_kernel<<<(unsigned)blocks, REDUCE_THREADS, 0, s>>>(
      partials, out, amax, total, splits);
  return (int)cudaGetLastError();
}
