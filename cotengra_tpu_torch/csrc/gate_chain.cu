// In-place gate chain, one gate per launch, on split-complex float32 planes.
//
// Replaces the TPU kernel cotengra_tpu/ops/pallas_gates.py::_build_pallas_fn
// (driven by run_chain there). That kernel views the flat planes as
// (2, above..., R2, C) (8,128)-tiles and reaches gate axes inside a tile
// with rolls, masks and coefficient fields; none of that is needed here.
// This kernel indexes every gate axis by its stride:
//
//   out[b, n] = sum_k y[k, n] * x[b, k]          (complex, planes apart)
//
// where b runs over the untouched legs (merged into runs that are
// contiguous in both x and out), k over the gate's contracted legs and n
// over its new legs. The host side (ops/gate_chains.py::gate_strides)
// builds the stride tables from each gate's recorded input and output
// leg order; a chain is one launch per gate.
//
// What bounds it on an H100: bytes. A gate reads 2*numel_in*4 B and
// writes 2*numel_out*4 B; per batch element that is 8*K*N flops for
// 8*(K+N) bytes, at most 8 flop/B on the m=10 plans (K, N <= 32), below
// the ~20 flop/B at which the card's fp32 units would limit instead.
// The design keeps each x element read once per gate: a thread
// owns one b, loads its K complex inputs into registers (unrolled for
// K <= 32), keeps y in shared memory, and writes its N outputs;
// neighbouring threads take neighbouring b, so the innermost untouched
// run gives coalesced reads and writes. The TPU kernel's point - fusing
// the whole chain into one read and one write of x - is the first
// performance change to make here, once a benchmark exists.
//
// Index arithmetic: offsets are 64-bit (the m=20 plans reach 2^30 plane
// elements); the batch counter is unravelled in 32-bit, which the host
// guarantees by rejecting gates with 2^32 or more batch elements.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_BATCH_DIMS 24
#define MAX_GATE_AXES 16
#define MAX_GATE_COMBOS 512

struct GateArgs {
  int nb, nk, nn, K, N;
  int64_t n_batch, in_plane, out_plane;
  uint32_t b_size[MAX_BATCH_DIMS];
  int64_t b_in[MAX_BATCH_DIMS];
  int64_t b_out[MAX_BATCH_DIMS];
  int64_t k_size[MAX_GATE_AXES], k_stride[MAX_GATE_AXES];
  int64_t n_size[MAX_GATE_AXES], n_stride[MAX_GATE_AXES];
};

// offset of flat index i over row-major axes (sizes, strides)
__device__ __forceinline__ int64_t axes_offset(int i, int naxes,
                                               const int64_t* sizes,
                                               const int64_t* strides) {
  int64_t off = 0;
  for (int d = naxes - 1; d >= 0; --d) {
    int64_t s = sizes[d];
    off += (i % s) * strides[d];
    i /= s;
  }
  return off;
}

// KMAX > 0: x values held in registers (K <= KMAX);
// KMAX == 0: any K up to MAX_GATE_COMBOS, x re-read from memory per n.
template <int KMAX>
__global__ void __launch_bounds__(256)
gate_apply_kernel(const float* __restrict__ x, float* __restrict__ out,
                  const float* __restrict__ y, const GateArgs a) {
  __shared__ float s_yr[MAX_GATE_COMBOS];
  __shared__ float s_yi[MAX_GATE_COMBOS];
  __shared__ int64_t s_koff[MAX_GATE_COMBOS];
  __shared__ int64_t s_noff[MAX_GATE_COMBOS];
  const int K = a.K, N = a.N, KN = a.K * a.N;
  for (int i = threadIdx.x; i < KN; i += blockDim.x) {
    s_yr[i] = y[i];
    s_yi[i] = y[KN + i];
  }
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    s_koff[k] = axes_offset(k, a.nk, a.k_size, a.k_stride);
  for (int n = threadIdx.x; n < N; n += blockDim.x)
    s_noff[n] = axes_offset(n, a.nn, a.n_size, a.n_stride);
  __syncthreads();

  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       b < a.n_batch; b += step) {
    uint32_t rem = (uint32_t)b;
    int64_t in_off = 0, out_off = 0;
    for (int d = a.nb - 1; d >= 0; --d) {
      uint32_t s = a.b_size[d];
      uint32_t q = rem / s;
      uint32_t c = rem - q * s;
      rem = q;
      in_off += (int64_t)c * a.b_in[d];
      out_off += (int64_t)c * a.b_out[d];
    }
    const float* xr_base = x + in_off;
    const float* xi_base = x + a.in_plane + in_off;
    float* or_base = out + out_off;
    float* oi_base = out + a.out_plane + out_off;
    if constexpr (KMAX > 0) {
      float xr[KMAX], xi[KMAX];
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        if (k < K) {
          xr[k] = __ldg(xr_base + s_koff[k]);
          xi[k] = __ldg(xi_base + s_koff[k]);
        }
      }
      for (int n = 0; n < N; ++n) {
        float accr = 0.f, acci = 0.f;
#pragma unroll
        for (int k = 0; k < KMAX; ++k) {
          if (k < K) {
            const float yr = s_yr[k * N + n], yi = s_yi[k * N + n];
            accr = fmaf(yr, xr[k], fmaf(-yi, xi[k], accr));
            acci = fmaf(yr, xi[k], fmaf(yi, xr[k], acci));
          }
        }
        or_base[s_noff[n]] = accr;
        oi_base[s_noff[n]] = acci;
      }
    } else {
      for (int n = 0; n < N; ++n) {
        float accr = 0.f, acci = 0.f;
        for (int k = 0; k < K; ++k) {
          const float vr = __ldg(xr_base + s_koff[k]);
          const float vi = __ldg(xi_base + s_koff[k]);
          const float yr = s_yr[k * N + n], yi = s_yi[k * N + n];
          accr = fmaf(yr, vr, fmaf(-yi, vi, accr));
          acci = fmaf(yr, vi, fmaf(yi, vr, acci));
        }
        or_base[s_noff[n]] = accr;
        oi_base[s_noff[n]] = acci;
      }
    }
  }
}

template <int KMAX>
static void launch(const float* x, float* out, const float* y,
                   const GateArgs& a, cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (a.n_batch + threads - 1) / threads;
  // grid-stride loop beyond ~16 blocks per SM of an H100
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  gate_apply_kernel<KMAX><<<(unsigned)blocks, threads, 0, stream>>>(
      x, out, y, a);
}

// meta (host memory, int64): nb, nk, nn, n_batch, numel_in, numel_out,
// then (size, in_stride, out_stride) per batch run, (size, stride) per
// contracted axis (x strides), (size, stride) per new axis (out strides).
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an argument block the kernel cannot take.
extern "C" int ctg_gate_apply_f32(const float* x, float* out,
                                  const float* y, const int64_t* meta,
                                  int meta_len, void* stream) {
  if (meta_len < 6) return (int)cudaErrorInvalidValue;
  GateArgs a;
  a.nb = (int)meta[0];
  a.nk = (int)meta[1];
  a.nn = (int)meta[2];
  a.n_batch = meta[3];
  a.in_plane = meta[4];
  a.out_plane = meta[5];
  if (a.nb < 0 || a.nb > MAX_BATCH_DIMS || a.nk < 0 ||
      a.nk > MAX_GATE_AXES || a.nn < 0 || a.nn > MAX_GATE_AXES ||
      meta_len != 6 + 3 * a.nb + 2 * a.nk + 2 * a.nn ||
      a.n_batch < 0 || a.n_batch >= ((int64_t)1 << 32))
    return (int)cudaErrorInvalidValue;
  const int64_t* p = meta + 6;
  for (int d = 0; d < a.nb; ++d, p += 3) {
    a.b_size[d] = (uint32_t)p[0];
    a.b_in[d] = p[1];
    a.b_out[d] = p[2];
  }
  int64_t K = 1, N = 1;
  for (int d = 0; d < a.nk; ++d, p += 2) {
    a.k_size[d] = p[0];
    a.k_stride[d] = p[1];
    K *= p[0];
  }
  for (int d = 0; d < a.nn; ++d, p += 2) {
    a.n_size[d] = p[0];
    a.n_stride[d] = p[1];
    N *= p[0];
  }
  if (K < 1 || N < 1 || K * N > MAX_GATE_COMBOS)
    return (int)cudaErrorInvalidValue;
  a.K = (int)K;
  a.N = (int)N;
  if (a.n_batch == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (K <= 4)
    launch<4>(x, out, y, a, s);
  else if (K <= 8)
    launch<8>(x, out, y, a, s);
  else if (K <= 16)
    launch<16>(x, out, y, a, s);
  else if (K <= 32)
    launch<32>(x, out, y, a, s);
  else
    launch<0>(x, out, y, a, s);
  return (int)cudaGetLastError();
}
