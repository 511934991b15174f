// Batched float32 matmul with a fused max|out|, for exponent stripping.
//
// Replaces the TPU kernel cotengra_tpu/ops/pallas_bmm.py::bmm_absmax (body
// _mm_absmax_kernel). It computes what that kernel computes:
//
//   out[b] = x[b] @ y[b]        x: (B, M, K), y: (B, K, N), row-major
//   absmax = max |out|          over every b, m, n
//
// with absmax taken from the accumulators in the epilogue, so stripping the
// exponent of a contraction step needs no second pass over the output.
//
// Design: the classic shared-memory SGEMM. A block of 256 threads owns a
// 128 x 128 output tile and walks K in steps of 8, staging the x and y tiles
// through two shared-memory buffers (the next tile is loaded into registers
// while the current one is multiplied). Each thread keeps an 8 x 8 register
// tile of accumulators: rows {4ty..4ty+3, 64+4ty..64+4ty+3} and the same
// pattern over columns, so its shared-memory reads are float4s from
// neighbouring addresses. Arithmetic is float32 FMA throughout: no tensor
// cores, since wgmma on float32 data would be TF32, and the port runs true
// float32. Rows, columns and K need not be multiples of the tile: loads out
// of range read 0 and stores are masked, so no padding copies are made
// (the TPU kernel padded to 256-multiples). blockIdx.z runs over B times
// the K splits.
//
// Split K: where the output tiles are too few to fill the card (the
// (256, 65536, 256) and (1, 65536, 1) steps of the 7x7 lattice), the host
// splits K into chunks; each block writes its partial tile to a workspace,
// and a second kernel sums the partials, writes out and takes max|out| from
// those sums.
//
// The |max| reduction: each thread folds |acc| of its in-range outputs, the
// block reduces with warp shuffles and then shared memory, and one thread
// per block does an atomicMax on the float's bit pattern into a device
// scalar zeroed on the stream first. For non-negative floats the integer
// order is the float order, and a NaN (sign cleared by fabsf) sorts above
// inf, so a NaN propagates as jnp.max does.
//
// What bounds it on an H100: on the large steps (65536 x 4096 x 4096 carries
// most of the lattice's work) the FP32 FMA rate, 67 TFLOP/s published; a
// 128 x 128 tile does 16 FMAs per byte it loads, above the card's 20 flop/B
// balance point. On the small steps, launches and bandwidth. Making it fast
// (wgmma with TMA on a 3xTF32 split, a persistent schedule, fusing the
// division by absmax into the next step's loads) is later work.
//
// Index arithmetic is 64-bit: M * N reaches 2^28 and M * K 2^36.

#include <cuda_runtime.h>
#include <stdint.h>

#define BM 128
#define BN 128
#define BK 8
#define NTHREADS 256
#define REDUCE_THREADS 256

// max of two non-negative values where a NaN wins
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// block-wide nan_max of v, then one atomicMax into *amax
__device__ __forceinline__ void block_absmax(float v, float* amax) {
  __shared__ float warp_max[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    v = lane < nwarps ? warp_max[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1)
      v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) atomicMax(reinterpret_cast<int*>(amax), __float_as_int(v));
  }
}

// row (or column) within the tile of a thread's i-th register row
__device__ __forceinline__ int tile_index(int t, int i) {
  return (i < 4) ? 4 * t + i : 64 + 4 * t + (i - 4);
}

// VEC_K: K % 4 == 0 (float4 loads of x); VEC_N: N % 4 == 0 (float4 loads
// of y and stores of out). SPLIT: write partial tiles, no absmax.
template <bool VEC_K, bool VEC_N, bool SPLIT>
__global__ void __launch_bounds__(NTHREADS, 2)
    bmm_absmax_kernel(const float* __restrict__ x,
                      const float* __restrict__ y, float* __restrict__ out,
                      float* __restrict__ amax, int64_t B, int64_t M,
                      int64_t K, int64_t N, int splits, int64_t k_chunk) {
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int64_t b = blockIdx.z / splits;
  const int64_t split = blockIdx.z % splits;
  const int64_t row0 = (int64_t)blockIdx.y * BM;
  const int64_t col0 = (int64_t)blockIdx.x * BN;
  const int64_t k_begin = split * k_chunk;
  const int64_t k_end = (k_begin + k_chunk < K) ? k_begin + k_chunk : K;

  x += b * M * K;
  y += b * K * N;

  // loaders: x tile (BM x BK) as 4 consecutive k of one row per thread,
  // y tile (BK x BN) as 4 consecutive columns of one k-row per thread
  const int a_row = tid >> 1, a_k = (tid & 1) * 4;
  const int b_k = tid >> 5, b_col = (tid & 31) * 4;
  const int64_t a_grow = row0 + a_row;
  const int64_t b_gcol = col0 + b_col;

  float a_reg[4], b_reg[4];

  auto load_global = [&](int64_t k0) {
    const int64_t ka = k0 + a_k;
    if (VEC_K && a_grow < M && ka + 3 < k_end) {
      float4 v = *reinterpret_cast<const float4*>(x + a_grow * K + ka);
      a_reg[0] = v.x; a_reg[1] = v.y; a_reg[2] = v.z; a_reg[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a_reg[j] = (a_grow < M && ka + j < k_end) ? x[a_grow * K + ka + j]
                                                  : 0.f;
    }
    const int64_t kb = k0 + b_k;
    if (VEC_N && kb < k_end && b_gcol + 3 < N) {
      float4 v = *reinterpret_cast<const float4*>(y + kb * N + b_gcol);
      b_reg[0] = v.x; b_reg[1] = v.y; b_reg[2] = v.z; b_reg[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b_reg[j] = (kb < k_end && b_gcol + j < N) ? y[kb * N + b_gcol + j]
                                                  : 0.f;
    }
  };

  auto store_shared = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 4; ++j) As[buf][a_k + j][a_row] = a_reg[j];
    *reinterpret_cast<float4*>(&Bs[buf][b_k][b_col]) =
        make_float4(b_reg[0], b_reg[1], b_reg[2], b_reg[3]);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (k_begin < k_end) {
    load_global(k_begin);
    store_shared(0);
    __syncthreads();
    int buf = 0;
    for (int64_t k0 = k_begin; k0 < k_end; k0 += BK) {
      const bool has_next = k0 + BK < k_end;
      if (has_next) load_global(k0 + BK);
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a_frag[8], b_frag[8];
        const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][4 * ty]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[buf][kk][64 + 4 * ty]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][4 * tx]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + 4 * tx]);
        a_frag[0] = a0.x; a_frag[1] = a0.y; a_frag[2] = a0.z; a_frag[3] = a0.w;
        a_frag[4] = a1.x; a_frag[5] = a1.y; a_frag[6] = a1.z; a_frag[7] = a1.w;
        b_frag[0] = b0.x; b_frag[1] = b0.y; b_frag[2] = b0.z; b_frag[3] = b0.w;
        b_frag[4] = b1.x; b_frag[5] = b1.y; b_frag[6] = b1.z; b_frag[7] = b1.w;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(a_frag[i], b_frag[j], acc[i][j]);
      }
      if (has_next) store_shared(buf ^ 1);
      __syncthreads();
      buf ^= 1;
    }
  }

  // epilogue: masked stores (of the partial tile when K is split) and,
  // unsplit, the |max| of the in-range accumulators
  float* dst = out + (SPLIT ? (split * B + b) : b) * M * N;
  float local_max = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t row = row0 + tile_index(ty, i);
    if (row >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t col = col0 + tile_index(tx, 4 * h);
      float* p = dst + row * N + col;
      if (VEC_N && col + 3 < N) {
        *reinterpret_cast<float4*>(p) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          local_max = nan_max(local_max, fabsf(acc[i][4 * h + j]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (col + j < N) {
            p[j] = acc[i][4 * h + j];
            local_max = nan_max(local_max, fabsf(acc[i][4 * h + j]));
          }
        }
      }
    }
  }
  if (!SPLIT) block_absmax(local_max, amax);
}

// out[i] = sum over splits of ws[s][i], and max|out| into *amax
__global__ void __launch_bounds__(REDUCE_THREADS)
    splitk_reduce_absmax_kernel(const float* __restrict__ ws,
                                float* __restrict__ out,
                                float* __restrict__ amax, int64_t total,
                                int splits) {
  float local_max = 0.f;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += ws[p * total + i];
    out[i] = s;
    local_max = nan_max(local_max, fabsf(s));
  }
  block_absmax(local_max, amax);
}

template <bool SPLIT>
static void launch_main(const float* x, const float* y, float* dst,
                        float* amax, int64_t B, int64_t M, int64_t K,
                        int64_t N, int splits, int64_t k_chunk,
                        cudaStream_t s) {
  dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM),
            (unsigned)(B * splits));
  const bool vk = (K % 4 == 0) && ((uintptr_t)x % 16 == 0);
  const bool vn = (N % 4 == 0) && ((uintptr_t)y % 16 == 0) &&
                  ((uintptr_t)dst % 16 == 0);
  if (vk && vn)
    bmm_absmax_kernel<true, true, SPLIT><<<grid, NTHREADS, 0, s>>>(
        x, y, dst, amax, B, M, K, N, splits, k_chunk);
  else if (vk)
    bmm_absmax_kernel<true, false, SPLIT><<<grid, NTHREADS, 0, s>>>(
        x, y, dst, amax, B, M, K, N, splits, k_chunk);
  else if (vn)
    bmm_absmax_kernel<false, true, SPLIT><<<grid, NTHREADS, 0, s>>>(
        x, y, dst, amax, B, M, K, N, splits, k_chunk);
  else
    bmm_absmax_kernel<false, false, SPLIT><<<grid, NTHREADS, 0, s>>>(
        x, y, dst, amax, B, M, K, N, splits, k_chunk);
}

// x (B, M, K), y (B, K, N), out (B, M, N) contiguous float32 on the device;
// amax one float on the device; ws (splits, B, M, N) when splits > 1, else
// unused. K is cut into chunks of k_chunk (a multiple of 8), splits of them.
// Returns a cudaError_t (0 on success); nothing is synchronised.
extern "C" int ctg_bmm_absmax_f32(const float* x, const float* y, float* out,
                                  float* amax, float* ws, int64_t B, int64_t M,
                                  int64_t K, int64_t N, int splits,
                                  int64_t k_chunk, void* stream) {
  if (B < 0 || M < 0 || K < 0 || N < 0 || splits < 1 || k_chunk < BK ||
      k_chunk % BK != 0 || (int64_t)(splits - 1) * k_chunk >= (K > 0 ? K : 1) ||
      (int64_t)splits * k_chunk < K || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((M + BM - 1) / BM > 65535 || B * splits > 65535 ||
      (N + BN - 1) / BN > 2147483647)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(amax, 0, sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || M == 0 || N == 0) return 0;
  if (splits == 1) {
    launch_main<false>(x, y, out, amax, B, M, K, N, 1, k_chunk, s);
    return (int)cudaGetLastError();
  }
  launch_main<true>(x, y, ws, amax, B, M, K, N, splits, k_chunk, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = B * M * N;
  int64_t blocks = (total + REDUCE_THREADS - 1) / REDUCE_THREADS;
  if (blocks > 4096) blocks = 4096;
  splitk_reduce_absmax_kernel<<<(unsigned)blocks, REDUCE_THREADS, 0, s>>>(
      ws, out, amax, total, splits);
  return (int)cudaGetLastError();
}
