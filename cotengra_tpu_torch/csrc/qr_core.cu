// Householder QR of the two sides of a truncated bond, and the product of
// each side's Q with its small factor, without forming Q: the QR work of
// the compressed contraction (ops/compressed.py, _compress_pair_core), in
// two launches a truncation with no host round trip.
//
// Replaces no TPU kernel: the JAX package leaves this QR to XLA
// (jnp.linalg.qr in cotengra_tpu/ops/compressed.py). It was added because
// the library QR (cuSOLVER's geqrf and orgqr, under torch.linalg.qr) waits
// on the host until the card is idle for its wide operands (a wait that
// torch's sync debug mode does not report), forms each Q explicitly (half
// the flops and an m x k buffer, only to multiply it at once by a k x chi
// factor), and ran at ~35x the factorization's bound on this plan's shapes.
// The library's route without Q formed (torch.geqrf, then torch.ormqr of
// [C; 0]) keeps the wait, which is geqrf's: behind a 200 ms spin its geqrf
// of a (131072, 1024) operand returns after ~225 ms, and a value's
// truncations take as long as torch.linalg.qr's (H100, scratch/
// qr_core_probe.py async and value).
//
//   factor: A (m, n) row-major, float32 or float64, k = min(m, n):
//     W (m, n): R on and above the diagonal, the reflectors' tails below;
//     R (k, n): R, zero below the diagonal;
//     Tm (ceil(k / kB), kB, kB), float64: each panel's compact-WY factor.
//   apply: C (k, chi), s (chi): X (m, chi) = Q [C diag(sqrt(s)); 0].
// Both launches take the two sides of one truncation at once: the grid's
// first nblk[0] blocks work on side 0, the rest on side 1, each side with a
// barrier of its own, so a small side does not wait for a large one.
//
// Algorithm: blocked right-looking Householder QR (LAPACK's geqrf with
// dlarfg's reflector, so R is LAPACK's to rounding), panels of kB = 32
// columns. Each block of a side owns a contiguous range of rows for the
// whole launch and writes no other rows until the end. A panel is factored
// column by column; each block keeps its first kPanelRows rows of the
// panel in shared memory (the rest it reads from L2) and a warp takes a
// row at a time, a lane a column. A pass over the block's rows applies
// column j's reflector and takes column j + 1's sums in the same sweep
// (its squared norm below the diagonal, its products with the panel's
// later columns, the diagonal row): every lane recomputes the next
// column's entry itself, rounded exactly as the lane that stores it, so
// the sums match the stored column bit for bit (on columns past the
// operand's numerical rank the update cancels to rounding, and a sum taken
// from other bits would build a reflector that is not orthogonal). The
// blocks add their sums into one of kCopies copies of a slot (float64
// atomics), one barrier, every block reads the copies and forms the
// reflector: one barrier a column. Then Z = Y^T [Y | A_trailing] over each
// block's rows (FP64 tensor-core products, mma.sync m8n8k4, on chunks of Y
// and strips of A staged in shared memory), summed across the side's
// blocks in block order (two barriers), T from Y^T Y and the taus
// (LAPACK's dlarft), and each block updates its rows: A -= Y (T^T Z).
// apply runs the panels backwards: X -= Y (T (Y^T X)). The operand is
// scaled by a power of two to max |A| in [1, 2) first, so no square
// overflows; R is scaled back exactly. Every sum and product is in float64
// (float32 operands are stored as float32 and computed in float64
// registers): orthogonal transformations only, no Gram matrix of A, no
// reduced precision.
//
// What bounds it on an H100: the factorization's 2 m n^2 - 2 n^3 / 3 flops
// at the 67 TFLOP/s FP64 tensor rate, or its bytes at 3.35 TB/s; for the
// plan's operands 9.1 ms a value of 72 truncations, most of it the one
// (131072, 1024) and the five (262144, 256) operands. The kernel runs far
// above that bound, held by latency: a barrier and a pass over the panel's
// rows for every column (1-15 us a column: the pass's dependent loads and
// the barrier's round trips through L2), and the trailing matrix read
// twice and written once a panel, now near the HBM rate. The design keeps
// those few: one barrier a column, the panel in shared memory where it
// fits, loads issued in batches ahead of their stores, the column sums
// spread over copies so that 132 blocks do not queue on one address,
// panels of 32 columns so the trailing matrix is swept k / 32 times, the
// tensor cores for both trailing products, the sides of a truncation in
// one launch, and no host round trip: the launch is cooperative (every
// block resident) and decides everything on the card. What would take it
// further: a TSQR of the tall panels (a block's rows factored in shared
// memory alone, the blocks' R factors combined in a tree) in place of a
// barrier a column, and the next panel's Z taken in the same sweep as
// this panel's update.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kB = 32;             // columns a panel: reflectors a (Y, T)
constexpr int kChunk = 64;         // rows of a trailing chunk
constexpr int kZStrip = 256;       // columns of a strip of Z = Y^T M
constexpr int kStrip = 128;        // columns of a strip of M -= Y W
constexpr int kTld = kB + 1;       // a row of T or G, padded
// padded rows of staged tiles, so a warp's fragment loads meet no bank
// twice: Y for Z = Y^T M, Y for M -= Y W, a strip of M, a strip of W
constexpr int kZYld = kB + 8;
constexpr int kUYld = kB + 4;
constexpr int kZMld = kZStrip + 8;
constexpr int kMld = kStrip + 8;
constexpr int kSlots = 2 * kB + 1; // a column's partial sums
// copies of a column's sums that a side's blocks add to in turn, so that
// fewer blocks contend for one address
constexpr int kCopies = 8;
constexpr int kPanelRows = 832;    // a block's panel rows in shared memory
// shared memory, in doubles: the column sums' scratch and T, then one
// region that holds the panel's rows while it is factored, and the
// trailing phase's tiles (Y and a strip of M, or Y and a strip of W; G)
constexpr int kSmall = kWarps * kSlots + kSlots + 2 * kB + 8 + kB * kTld;
constexpr int kZTile = kChunk * kZYld + kChunk * kZMld;
constexpr int kUTile = kChunk * kUYld + kB * kMld;
constexpr int kMax2(int a, int b) { return a > b ? a : b; }
constexpr int kBig = kMax2(kPanelRows * kB, kMax2(kZTile, kUTile));
constexpr size_t kSmemBytes = (size_t)(kSmall + kBig) * 8;
static_assert(kSmemBytes <= 232448, "shared memory past a block's 227 KB");

struct Side {
  const void* A;   // factor: (m, n) input
  void* W;         // (m, n) the factors
  void* R;         // factor: (k, n) output
  double* Tm;      // panels x kB x kB
  double* acc;     // factor: 3 x kCopies x kSlots column sums, max |A| (zeroed)
  double* pz;      // nblk x kB x n (factor) or kB x chi (apply) partial sums
  double* Z;       // kB x n (factor) or kB x chi (apply), summed
  unsigned int* bar;  // the barrier's arrivals (zeroed)
  const void* C;   // apply: (k, chi)
  const void* s;   // apply: (chi)
  void* X;         // apply: (m, chi) output
  int64_t m, n, k;
  int nblk;
};

// the grid's first side[0].nblk blocks take side 0, the rest side 1
struct Params {
  Side side[2];
  int64_t chi;
};

__device__ __forceinline__ void dmma(double& d0, double& d1, double a,
                                     double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

__device__ __forceinline__ void red_release(unsigned int* p, unsigned int v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every block of the side arrives before any leaves; writes before it are
// visible to reads after it (reads of other blocks' data go through L2).
// The counter only grows: barrier e (epoch, counted by every block alike)
// is passed when it reads nblk e, one release-add and a poll a block. A
// block that waits ~10 s traps, so a fault ends the launch with an error
// instead of holding the card.
__device__ void side_sync(unsigned int* bar, int nblk, unsigned int& epoch) {
  ++epoch;
  __syncthreads();
  if (nblk > 1 && threadIdx.x == 0) {
    red_release(bar, 1u);
    const unsigned int target = epoch * (unsigned int)nblk;
    unsigned int spins = 0;
    while (ld_acquire(bar) < target)
      if (++spins == (1u << 30)) __trap();
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ double ld(const T* p) {
  return (double)*p;
}

// Rows [l0, l1) of a pass, kBatch at a time a warp (row l at P + l ld,
// rows counted from rlo), lane l on column c0 + l. Each lane reads its own
// entry and, broadcast, the pivot column's and the next column's, and
// computes its update and the next column's entry itself: no shuffles.
template <typename T, typename TP, int kBatch>
__device__ __forceinline__ void pass_rows(
    TP* P, int64_t ld, int l0, int l1, int64_t rlo, int i, int bw,
    int64_t j, int64_t jq, double beta, double scal, double wl, double wq,
    double& nrm, double& dot, double& top) {
  const int lane = threadIdx.x & 31, q = i + 1;
  const int warp = threadIdx.x >> 5;
  // rows relative to the diagonal rows of columns j and j + 1
  const int dj = (int)(j - rlo), dq = (int)(jq - rlo);
  for (int lb = l0 + warp * kBatch; lb < l1; lb += kWarps * kBatch) {
    double x[kBatch], xi[kBatch], xq[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int l = lb + u;
      const bool ok = l < l1;
      const TP* row = P + (int64_t)(ok ? l : l0) * ld;
      x[u] = (ok && lane < bw && lane >= i) ? (double)row[lane] : 0.0;
      xi[u] = (ok && i >= 0) ? (double)row[i] : 0.0;
      xq[u] = (ok && q < bw) ? (double)row[q] : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int l = lb + u;
      if (l >= l1) break;
      // each lane's y_q must be bit for bit the one lane q stores: on
      // columns past the rank the update cancels to rounding, so every
      // product and sum is rounded explicitly, alike in all lanes
      double y = x[u], yq = xq[u];
      if (i >= 0) {
        if (l == dj) {
          // v_j = 1: the diagonal row takes w; its pivot becomes beta
          y = lane == i ? beta : __dsub_rn(x[u], wl);
          yq = __dsub_rn(xq[u], wq);
        } else {
          const double v = __dmul_rn(xi[u], scal);
          y = lane == i ? v : __fma_rn(-v, wl, x[u]);
          yq = __fma_rn(-v, wq, xq[u]);
        }
        y = (double)(T)y;
        yq = (double)(T)yq;
        if (lane >= i && lane < bw) P[(int64_t)l * ld + lane] = (TP)y;
      }
      if (q < bw) {
        if (l > dq) {
          nrm += yq * yq;
          if (lane > q) dot += yq * y;
        } else if (l == dq && lane >= q) {
          top = y;
        }
      }
    }
  }
}

// One pass of the block's warps over its rows [rlo, hi) of the panel
// columns c0 .. c0 + bw: the first ns rows in shared memory (Ps, kB doubles
// a row), the rest in W. Where i >= 0, the reflector of column j = c0 + i
// (beta, scal, w in shared memory) is applied first; then, where i + 1 <
// bw, the sums of column q = i + 1 are taken from the updated rows: its
// squared norm below the diagonal (slot 0), its products with the later
// columns there (1 + l), and the diagonal row (1 + kB + l): stored to out
// (shared memory, a side of one block) or added to it (global, the side's
// sums).
template <typename T>
__device__ void column_pass(T* W, int64_t n, int64_t rlo, int64_t hi,
                            double* Ps, int64_t ns, int64_t c0, int i, int bw,
                            double beta, double scal, const double* w,
                            double* red, double* out, bool add) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = i + 1;
  const int64_t j = c0 + i, jq = c0 + q, rows = hi - rlo;
  double nrm = 0.0, dot = 0.0, top = 0.0;
  const double wl = (i >= 0 && lane > i && lane < bw) ? w[lane] : 0.0;
  const double wq = (i >= 0 && q < bw) ? w[q] : 0.0;
  const int64_t first = (i >= 0 ? j : c0) - rlo;
  const int64_t l0 = first > 0 ? first : 0;
  pass_rows<T, double, 4>(Ps, kB, (int)l0, (int)ns, rlo, i, bw, j, jq, beta,
                          scal, wl, wq, nrm, dot, top);
  pass_rows<T, T, 8>(W + rlo * n + c0, n, (int)(l0 > ns ? l0 : ns), (int)rows,
                     rlo, i, bw, j, jq, beta, scal, wl, wq, nrm, dot, top);
  if (q >= bw) return;
  red[warp * kSlots + 1 + lane] = dot;
  red[warp * kSlots + 1 + kB + lane] = top;
  if (lane == 0) red[warp * kSlots] = nrm;
  __syncthreads();
  if (threadIdx.x < kSlots) {
    double s = 0.0;
    for (int u = 0; u < kWarps; ++u) s += red[u * kSlots + threadIdx.x];
    if (add) {
      atomicAdd(out + threadIdx.x, s);
    } else {
      out[threadIdx.x] = s;
    }
  }
  __syncthreads();
}

// The first ns rows from rlo of the panel columns c0 .. c0 + bw between W
// and Ps (to Ps where load, else back to W).
template <typename T>
__device__ void panel_copy(T* W, int64_t n, int64_t rlo, int64_t ns,
                           int64_t c0, int bw, double* Ps, bool load) {
  constexpr int kPer = 8;  // loads in flight before their stores
  for (int64_t e0 = 0; e0 < ns * kB; e0 += kPer * kThreads) {
    double v[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int64_t e = e0 + threadIdx.x + u * kThreads;
      const bool ok = e < ns * kB && (int)(e % kB) < bw;
      v[u] = 0.0;
      if (ok) v[u] = load ? ld(W + (rlo + e / kB) * n + c0 + e % kB) : Ps[e];
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int64_t e = e0 + threadIdx.x + u * kThreads;
      if (e >= ns * kB || (int)(e % kB) >= bw) continue;
      if (load) Ps[e] = v[u];
      else W[(rlo + e / kB) * n + c0 + e % kB] = (T)v[u];
    }
  }
}

// Rows [rb, rb + kChunk) of Y (the panel at c0 of width bw: unit diagonal,
// the reflectors' tails below it, zero above and past bw) into Ys, ldy
// doubles a row; zero past hi.
template <typename T>
__device__ void stage_y(const T* W, int64_t n, int64_t c0, int bw,
                        int64_t rb, int64_t hi, double* Ys, int ldy) {
  // every load before any store: the stores go through a generic pointer
  // the compiler cannot tell from W
  constexpr int kPer = kChunk * kB / kThreads;
  double y[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = threadIdx.x + u * kThreads, rr = e / kB, c = e % kB;
    const int64_t r = rb + rr, col = c0 + c;
    y[u] = 0.0;
    if (r < hi && c < bw)
      y[u] = r > col ? ld(W + r * n + col) : (r == col ? 1.0 : 0.0);
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = threadIdx.x + u * kThreads;
    Ys[(e / kB) * ldy + e % kB] = y[u];
  }
}

// The block's partial Z = Y^T [Y | M[:, coff .. coff + nz - ny]] over its
// rows [lo, hi), kB x nz, into out (row i at out + i nz). By strips of
// kZStrip columns and chunks of kChunk rows staged in shared memory (Ys, Ms);
// warp w sums the 2 x 4 tiles of 8 x 8 at m-tiles 2 (w & 1) + {0, 1} and
// n-tiles 4 (w >> 1) + {0..3} of the strip.
template <typename T, typename TM>
__device__ void partial_z(const T* W, int64_t n, int64_t c0, int bw,
                          int64_t lo, int64_t hi, int ny, const TM* M,
                          int64_t ldm, int64_t coff, int nz, double* Ys,
                          double* Ms, double* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lr = lane & 3, lc = lane >> 2;
  const int mp = warp & 1, nq = warp >> 1;
  for (int s0 = 0; s0 < nz; s0 += kZStrip) {
    const int sw = nz - s0 < kZStrip ? nz - s0 : kZStrip;
    const bool busy = 32 * nq < sw;
    double acc[2][4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;
    for (int64_t rb = lo; rb < hi; rb += kChunk) {
      const int nrows = hi - rb < kChunk ? (int)(hi - rb) : kChunk;
      __syncthreads();
      stage_y(W, n, c0, bw, rb, hi, Ys, kZYld);
      // the strip's rows, kMPer loads in flight before their stores
      constexpr int kMPer = 16;
      for (int e0 = 0; e0 < kChunk * kZStrip; e0 += kMPer * kThreads) {
        double v[kMPer];
#pragma unroll
        for (int u = 0; u < kMPer; ++u) {
          const int e = e0 + threadIdx.x + u * kThreads;
          const int rr = e / kZStrip, cc = e % kZStrip;
          const int64_t r = rb + rr;
          const int col = s0 + cc;
          v[u] = 0.0;
          if (rr < nrows && cc < sw) {
            if (col < ny)
              v[u] = r > c0 + col ? ld(W + r * n + c0 + col)
                                  : (r == c0 + col ? 1.0 : 0.0);
            else
              v[u] = ld(M + r * ldm + coff + col - ny);
          }
        }
#pragma unroll
        for (int u = 0; u < kMPer; ++u) {
          const int e = e0 + threadIdx.x + u * kThreads;
          Ms[(e / kZStrip) * kZMld + e % kZStrip] = v[u];
        }
      }
      __syncthreads();
      if (busy) {
        for (int kk = 0; kk < nrows; kk += 4) {
          const double* yr = Ys + (kk + lr) * kZYld + 16 * mp + lc;
          const double* mr = Ms + (kk + lr) * kZMld + 32 * nq + lc;
          const double a0 = yr[0], a1 = yr[8];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const double b = mr[8 * j];
            dmma(acc[0][j][0], acc[0][j][1], a0, b);
            dmma(acc[1][j][0], acc[1][j][1], a1, b);
          }
        }
      }
    }
    if (busy) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cc = 32 * nq + 8 * j + 2 * lr + e;
            if (cc < sw)
              out[(16 * mp + 8 * i + lc) * nz + s0 + cc] = acc[i][j][e];
          }
    }
  }
}

// Z (kB x nz, every block's partial at pz + b kB nz) summed over the
// side's blocks into Zs, by the side's threads.
__device__ void reduce_z(const double* pz, int nz, int nblk, int g,
                         double* Zs) {
  const int64_t count = (int64_t)kB * nz;
  for (int64_t e = (int64_t)g * kThreads + threadIdx.x; e < count;
       e += (int64_t)nblk * kThreads) {
    // eight loads in flight, summed in block order
    double s = 0.0;
    int b = 0;
    for (; b + 8 <= nblk; b += 8) {
      double v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = __ldcg(pz + (b + u) * count + e);
#pragma unroll
      for (int u = 0; u < 8; ++u) s += v[u];
    }
    for (; b < nblk; ++b) s += __ldcg(pz + b * count + e);
    Zs[e] = s;
  }
}

// T (upper triangular, kB x kB, zero past bw) of the panel's reflectors
// from G = Y^T Y (Z's first bw columns, row stride nz) and the taus: T_ii =
// tau_i, T[0:i, i] = -tau_i T[0:i, 0:i] G[0:i, i] (LAPACK's dlarft).
__device__ void build_t(const double* Z, int nz, int bw, const double* tau,
                        double* Gs, double* Ts) {
  for (int e = threadIdx.x; e < kB * kB; e += kThreads) {
    const int a = e / kB, b = e % kB;
    Gs[a * kTld + b] = (a < bw && b < bw) ? __ldcg(Z + a * nz + b) : 0.0;
    Ts[a * kTld + b] = (a == b && a < bw) ? tau[a] : 0.0;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int l = threadIdx.x;
    for (int i = 1; i < bw; ++i) {
      // T[l][q] is 0 for q < l and for q >= i (not yet built), q != l
      double s = 0.0;
#pragma unroll
      for (int q = 0; q < kB; ++q)
        if (q < i) s += Ts[l * kTld + q] * Gs[q * kTld + i];
      __syncwarp();
      if (l < i) Ts[l * kTld + i] = -tau[i] * s;
      __syncwarp();
    }
  }
  __syncthreads();
}

// The block's rows [lo, hi) of M[:, coff .. coff + nt] -= Y (op(T) Z[:, zoff
// ..]), op(T) = T^T (trans, Q^T from the left) or T (Q from the left). By
// strips of kStrip columns: op(T) Z's strip into Wp, then chunks of kChunk
// rows of Y staged in Ys; warp w updates the 2 x 4 tiles at m-tiles
// 2 (w & 3) + {0, 1} of the chunk and n-tiles 4 (w >> 2) + {0..3}.
template <typename T, typename TM>
__device__ void update(const T* W, int64_t n, int64_t c0, int bw,
                       int64_t lo, int64_t hi, TM* M, int64_t ldm,
                       int64_t coff, int nt, const double* Z, int nz,
                       int zoff, const double* Ts, bool trans, double* Ys,
                       double* Wp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lr = lane & 3, lc = lane >> 2;
  const int mq = warp & 3, nq = warp >> 2;
  for (int s0 = 0; s0 < nt; s0 += kStrip) {
    const int sw = nt - s0 < kStrip ? nt - s0 : kStrip;
    __syncthreads();
    {
      // Wp = op(T) Z[:, strip]: warp w, m-tile w & 3, n-tiles 4 (w >> 2) ..
      double c[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j][0] = c[j][1] = 0.0;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int zr = 4 * kk + lr, ti = 8 * mq + lc;
        const double a = trans ? Ts[zr * kTld + ti] : Ts[ti * kTld + zr];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cc = 32 * nq + 8 * j + lc;
          const double b = (zr < bw && cc < sw)
                               ? __ldcg(Z + (int64_t)zr * nz + zoff + s0 + cc)
                               : 0.0;
          dmma(c[j][0], c[j][1], a, b);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        double* o = Wp + (8 * mq + lc) * kMld + 32 * nq + 8 * j + 2 * lr;
        o[0] = c[j][0];
        o[1] = c[j][1];
      }
    }
    const bool busy = 32 * nq < sw;
    for (int64_t rb = lo; rb < hi; rb += kChunk) {
      const int nrows = hi - rb < kChunk ? (int)(hi - rb) : kChunk;
      __syncthreads();
      stage_y(W, n, c0, bw, rb, hi, Ys, kUYld);
      __syncthreads();
      if (!busy || 16 * mq >= nrows) continue;
      double c[2][4][2];
      TM* p[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rr = 16 * mq + 8 * i + lc;
        p[i] = M + (rb + rr) * ldm + coff + s0 + 32 * nq + 2 * lr;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cc = 32 * nq + 8 * j + 2 * lr + e;
            c[i][j][e] = (rr < nrows && cc < sw) ? ld(p[i] + 8 * j + e) : 0.0;
          }
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const double a0 = -Ys[(16 * mq + lc) * kUYld + 4 * kk + lr];
        const double a1 = -Ys[(16 * mq + 8 + lc) * kUYld + 4 * kk + lr];
        const double* wr = Wp + (4 * kk + lr) * kMld + 32 * nq + lc;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const double b = wr[8 * j];
          dmma(c[0][j][0], c[0][j][1], a0, b);
          dmma(c[1][j][0], c[1][j][1], a1, b);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rr = 16 * mq + 8 * i + lc;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cc = 32 * nq + 8 * j + 2 * lr + e;
            if (rr < nrows && cc < sw) p[i][8 * j + e] = (TM)c[i][j][e];
          }
      }
    }
  }
}

// out[e] = f(e) for e in [e0, e1) by stride, kPer loads in flight before
// their stores (the compiler cannot tell the pointers apart).
template <int kPer, typename F, typename G>
__device__ __forceinline__ void batched(int64_t e0, int64_t e1, int64_t stride,
                                        F load, G store) {
  for (int64_t b = e0; b < e1; b += kPer * stride) {
    double v[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int64_t e = b + u * stride;
      v[u] = e < e1 ? load(e) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int64_t e = b + u * stride;
      if (e < e1) store(e, v[u]);
    }
  }
}

struct Smem {
  double *red, *col, *w, *tau, *misc, *Ts, *Ps, *Ys, *Ms, *Gs;
};

__device__ Smem carve(double* smem) {
  Smem s;
  s.red = smem;
  s.col = s.red + kWarps * kSlots;
  s.w = s.col + kSlots;
  s.tau = s.w + kB;
  s.misc = s.tau + kB;  // 8 doubles
  s.Ts = s.misc + 8;
  s.Ps = s.Ts + kB * kTld;  // the panel; or Y and a strip; or G
  s.Ys = s.Ps;
  s.Ms = s.Ys + kChunk * kZYld;
  s.Gs = s.Ps;
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) qr_factor_kernel(Params P) {
  extern __shared__ double smem[];
  const Smem sm = carve(smem);
  const int side = blockIdx.x < P.side[0].nblk ? 0 : 1;
  const int g = blockIdx.x - (side ? P.side[0].nblk : 0);
  const Side& S = P.side[side];
  const int64_t m = S.m, n = S.n, k = S.k;
  const int nblk = S.nblk;
  const int64_t lo = (int64_t)g * m / nblk, hi = (int64_t)(g + 1) * m / nblk;
  const T* A = static_cast<const T*>(S.A);
  T* W = static_cast<T*>(S.W);
  const int tid = threadIdx.x, lane = tid & 31;
  unsigned int epoch = 0;

  // max |A| over the side (slot 1 of the column sums), then W = sc A with
  // sc a power of two putting max |sc A| in [1, 2)
  double amax = 0.0;
#pragma unroll 8
  for (int64_t e = lo * n + tid; e < hi * n; e += kThreads)
    amax = fmax(amax, fabs(ld(A + e)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmax(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (lane == 0) sm.red[tid >> 5] = amax;
  __syncthreads();
  // a non-negative double orders as its bits
  unsigned long long* amax_bits =
      reinterpret_cast<unsigned long long*>(S.acc + 3 * kCopies * kSlots);
  if (tid == 0) {
    double v = 0.0;
    for (int u = 0; u < kWarps; ++u) v = fmax(v, sm.red[u]);
    atomicMax(amax_bits, (unsigned long long)__double_as_longlong(v));
  }
  side_sync(S.bar, nblk, epoch);
  if (tid == 0) {
    const double v = __longlong_as_double(
        (long long)*(volatile unsigned long long*)amax_bits);
    sm.misc[0] = (v > 0.0 && v <= DBL_MAX) ? scalbn(1.0, -ilogb(v)) : 1.0;
  }
  __syncthreads();
  const double sc = sm.misc[0];
  batched<8>(lo * n + tid, hi * n, kThreads,
             [&](int64_t e) { return sc * ld(A + e); },
             [&](int64_t e, double v) { W[e] = (T)v; });
  __syncthreads();

  // column j's sums gather in slot j % 3 of S.acc (a side of several
  // blocks; block g adds to copy g % kCopies of it): added during the pass
  // over column j - 1, read after the next barrier, zeroed by block 0 at
  // column j + 1 for column j + 3
  const bool one = nblk == 1;
  double* const mine = S.acc + (g % kCopies) * kSlots;
  for (int64_t c0 = 0; c0 < k; c0 += kB) {
    const int bw = k - c0 < kB ? (int)(k - c0) : kB;
    const int64_t rlo = lo > c0 ? lo : c0;
    const int64_t rows = hi > rlo ? hi - rlo : 0;
    const int64_t ns = rows < kPanelRows ? rows : kPanelRows;
    // the panel, a column a barrier, its first rows in shared memory
    panel_copy(W, n, rlo, ns, c0, bw, sm.Ps, true);
    __syncthreads();
    // a side of one block sums its columns in shared memory alone
    column_pass(W, n, rlo, hi, sm.Ps, ns, c0, -1, bw, 0.0, 0.0, sm.w, sm.red,
                one ? sm.col : mine + (c0 % 3) * kCopies * kSlots, !one);
    for (int i = 0; i < bw; ++i) {
      const int64_t j = c0 + i;
      if (!one) {
        side_sync(S.bar, nblk, epoch);
        if (tid < kSlots) {
          const double* slot = S.acc + (j % 3) * kCopies * kSlots + tid;
          double v[kCopies];
#pragma unroll
          for (int c = 0; c < kCopies; ++c) v[c] = __ldcg(slot + c * kSlots);
          double sum = 0.0;
#pragma unroll
          for (int c = 0; c < kCopies; ++c) sum += v[c];
          sm.col[tid] = sum;
        }
        __syncthreads();
        if (g == 0)
          for (int e = tid; e < kCopies * kSlots; e += kThreads)
            S.acc[((j + 2) % 3) * kCopies * kSlots + e] = 0.0;
      }
      if (tid == 0) {
        // dlarfg: H (alpha; x) = (beta; 0), v = (1; x / (alpha - beta))
        const double alpha = sm.col[1 + kB + i], xn2 = sm.col[0];
        double beta = alpha, tau = 0.0, scal = 0.0;
        if (xn2 != 0.0) {
          beta = -copysign(sqrt(alpha * alpha + xn2), alpha);
          tau = (beta - alpha) / beta;
          scal = 1.0 / (alpha - beta);
        }
        sm.misc[1] = beta;
        sm.misc[2] = scal;
        sm.tau[i] = tau;
      }
      __syncthreads();
      if (tid > i && tid < bw)
        sm.w[tid] = sm.tau[i] * (sm.col[1 + kB + tid] + sm.misc[2] * sm.col[1 + tid]);
      __syncthreads();
      column_pass(W, n, rlo, hi, sm.Ps, ns, c0, i, bw, sm.misc[1],
                  sm.misc[2], sm.w, sm.red,
                  one ? sm.col : mine + ((j + 1) % 3) * kCopies * kSlots, !one);
    }
    __syncthreads();
    panel_copy(W, n, rlo, ns, c0, bw, sm.Ps, false);
    // Z = Y^T [Y | W[:, c0 + bw ..]] over the side, then T and the update
    const int nt = (int)(n - c0 - bw), nz = bw + nt;
    partial_z(W, n, c0, bw, rlo, hi, bw, W, n, c0 + bw, nz, sm.Ys, sm.Ms,
              S.pz + (int64_t)g * kB * nz);
    __syncthreads();
    side_sync(S.bar, nblk, epoch);
    reduce_z(S.pz, nz, nblk, g, S.Z);
    side_sync(S.bar, nblk, epoch);
    build_t(S.Z, nz, bw, sm.tau, sm.Gs, sm.Ts);
    if (g == 0)
      for (int e = tid; e < kB * kB; e += kThreads)
        S.Tm[(c0 / kB) * kB * kB + e] = sm.Ts[(e / kB) * kTld + e % kB];
    if (nt > 0)
      update(W, n, c0, bw, rlo, hi, W, n, c0 + bw, nt, S.Z, nz, bw, sm.Ts,
             true, sm.Ys, sm.Ys + kChunk * kUYld);
    __syncthreads();
  }
  // R = W / sc on and above the diagonal of its first k rows
  side_sync(S.bar, nblk, epoch);
  T* R = static_cast<T*>(S.R);
  const double inv = 1.0 / sc;
  batched<8>((int64_t)g * kThreads + tid, k * n, (int64_t)nblk * kThreads,
             [&](int64_t e) {
               return e % n >= e / n ? inv * (double)__ldcg(W + e) : 0.0;
             },
             [&](int64_t e, double v) { R[e] = (T)v; });
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) qr_apply_kernel(Params P) {
  extern __shared__ double smem[];
  const Smem sm = carve(smem);
  const int side = blockIdx.x < P.side[0].nblk ? 0 : 1;
  const int g = blockIdx.x - (side ? P.side[0].nblk : 0);
  const Side& S = P.side[side];
  const int64_t m = S.m, n = S.n, k = S.k, chi = P.chi;
  const int nblk = S.nblk;
  const int64_t lo = (int64_t)g * m / nblk, hi = (int64_t)(g + 1) * m / nblk;
  const T* W = static_cast<const T*>(S.W);
  const T* C = static_cast<const T*>(S.C);
  const T* sv = static_cast<const T*>(S.s);
  T* X = static_cast<T*>(S.X);
  const int tid = threadIdx.x;
  unsigned int epoch = 0;

  // X = [C diag(sqrt(s)); 0] on the block's rows
  batched<8>(lo * chi + tid, hi * chi, kThreads,
             [&](int64_t e) {
               return e / chi < k ? ld(C + e) * sqrt(ld(sv + e % chi)) : 0.0;
             },
             [&](int64_t e, double v) { X[e] = (T)v; });
  const int np = (int)((k + kB - 1) / kB);
  for (int p = np - 1; p >= 0; --p) {
    const int64_t c0 = (int64_t)p * kB;
    const int bw = k - c0 < kB ? (int)(k - c0) : kB;
    const int64_t rlo = lo > c0 ? lo : c0;
    for (int e = tid; e < kB * kB; e += kThreads)
      sm.Ts[(e / kB) * kTld + e % kB] = S.Tm[(int64_t)p * kB * kB + e];
    partial_z(W, n, c0, bw, rlo, hi, 0, X, chi, 0, (int)chi, sm.Ys, sm.Ms,
              S.pz + (int64_t)g * kB * chi);
    side_sync(S.bar, nblk, epoch);
    reduce_z(S.pz, (int)chi, nblk, g, S.Z);
    side_sync(S.bar, nblk, epoch);
    update(W, n, c0, bw, rlo, hi, X, chi, 0, (int)chi, S.Z, (int)chi, 0,
           sm.Ts, false, sm.Ys, sm.Ys + kChunk * kUYld);
    __syncthreads();
  }
}

// resident blocks of either kernel on the current device, found once
int resident_blocks(int& out) {
  static int resident[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidValue;
  if (resident[dev] == 0) {
    const void* kernels[4] = {(const void*)qr_factor_kernel<float>,
                              (const void*)qr_factor_kernel<double>,
                              (const void*)qr_apply_kernel<float>,
                              (const void*)qr_apply_kernel<double>};
    int n_sm = 0, least = 1 << 30;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    for (const void* kern : kernels) {
      err = cudaFuncSetAttribute(kern,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)kSmemBytes);
      if (err != cudaSuccess) return (int)err;
      int per_sm = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                          kThreads, kSmemBytes);
      if (err != cudaSuccess) return (int)err;
      if (per_sm < least) least = per_sm;
    }
    resident[dev] = least * n_sm;
  }
  out = resident[dev];
  return 0;
}

int check_sides(const Params& P) {
  for (int s = 0; s < 2; ++s) {
    const Side& S = P.side[s];
    if (S.m < 1 || S.n < 1 || S.k != (S.m < S.n ? S.m : S.n) || S.nblk < 1 ||
        S.nblk > S.m || S.n > 2147483647 / kB ||
        S.m > ((int64_t)1 << 40) / S.n)
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

int launch(const void* kern, Params& P, cudaStream_t stream) {
  int resident = 0;
  int err = resident_blocks(resident);
  if (err != 0) return err;
  const int64_t grid = (int64_t)P.side[0].nblk + P.side[1].nblk;
  err = check_sides(P);
  if (err != 0) return err;
  if (grid > resident) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&P};
  return (int)cudaLaunchCooperativeKernel(kern, dim3((unsigned)grid),
                                          dim3(kThreads), args, kSmemBytes,
                                          stream);
}

void fill_side(Side& S, const int64_t* dims, void* const* ptrs) {
  S.m = dims[0];
  S.n = dims[1];
  S.k = dims[2];
  S.nblk = (int)dims[3];
  S.A = ptrs[0];
  S.W = ptrs[1];
  S.R = ptrs[2];
  S.Tm = static_cast<double*>(ptrs[3]);
  S.acc = static_cast<double*>(ptrs[4]);
  S.pz = static_cast<double*>(ptrs[5]);
  S.Z = static_cast<double*>(ptrs[6]);
  S.bar = static_cast<unsigned int*>(ptrs[7]);
  S.C = ptrs[8];
  S.s = ptrs[9];
  S.X = ptrs[10];
}

}  // namespace

// Blocks the device holds at once for either kernel (one a multiprocessor
// at most): the most that nblk of the two sides may add up to.
extern "C" int ctg_qr_core_blocks() {
  int out = 0;
  const int err = resident_blocks(out);
  return err != 0 ? -err : out;
}

// Factor (phase 0) or apply (phase 1), both sides of a truncation in one
// cooperative launch on `stream`. dtype: 0 float32, 1 float64. dims: per
// side (m, n, k, nblk); ptrs: per side 11 device pointers (A, W, R, Tm,
// acc, pz, Z, bar, C, s, X; those a phase does not use may be null), the
// barrier words and acc (3 x 8 x 65 + 1 doubles) zeroed. Returns a CUDA error code, 0 on success.
extern "C" int ctg_qr_core(int phase, int dtype, const int64_t* dims,
                           void* const* ptrs, int64_t chi, void* stream) {
  Params P;
  fill_side(P.side[0], dims, ptrs);
  fill_side(P.side[1], dims + 4, ptrs + 11);
  P.chi = chi;
  if (phase == 1 && (chi < 1 || chi > 2147483647 / kB))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* kern = nullptr;
  if (phase == 0)
    kern = dtype == 0 ? (const void*)qr_factor_kernel<float>
                      : (const void*)qr_factor_kernel<double>;
  else if (phase == 1)
    kern = dtype == 0 ? (const void*)qr_apply_kernel<float>
                      : (const void*)qr_apply_kernel<double>;
  if (kern == nullptr || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  return launch(kern, P, s);
}
