// Top-k singular value decomposition of a small dense real matrix: the
// truncation core of the compressed contraction (ops/compressed.py,
// _compress_pair_core), in one launch with no host round trip.
//
// Replaces no TPU kernel: the JAX package takes this SVD from XLA
// (jnp.linalg.svd in cotengra_tpu/ops/compressed.py). It was added because
// the library SVD (cuSOLVER's Jacobi, under torch.linalg.svd) reads its
// convergence and info words back on the host, two synchronisations a call,
// so the host waited for the card at every truncation; and it spends ~630
// small launches on one 128 x 128 core.
//
//   M: (m, n) row-major, float32 or float64; 1 <= k <= min(m, n)
//   U: (m, k), S: (k), V: (n, k) row-major, s descending, M ~ U diag(S) V^T
//
// Algorithm: block one-sided (Hestenes) Jacobi. The p = min(m, n) columns
// of W (M, or M^T where m < n) are rotated until they are mutually
// orthogonal, W V = U diag(s); V, the product of the rotations, stays
// orthogonal to rounding, and the singular values are the column norms.
// The columns are cut into blocks of at most 16; a step pairs the blocks in
// parallel round-robin (circle) order, each pair on one thread block:
//   1. G = X^T X, the Gram of the pair's nc <= 32 columns X (L rows), by
//      FP64 tensor-core products (mma.sync m8n8k4) read from L2;
//   2. cyclic Jacobi on G in shared memory, nc - 1 rounds a sweep of nc / 2
//      disjoint rotations each, one barrier a round, accumulating J;
//   3. X <- X J and V_pair <- V_pair J, again by mma.sync.
// A step ends at a grid barrier (the launch is cooperative, so every block
// is resident). A sweep is nb - 1 steps; the kernel stops after the first
// sweep in which no pair needed a rotation, or at a cap of kMaxSweeps, and
// leaves the sweep count in a device word; a launch that reaches the cap
// unconverged adds 1 to a word that outlives it (``unconverged``), which
// the caller reads where it already waits for the card. Two columns count as orthogonal where
// |g_ab| <= tol sqrt(g_aa g_bb) (relative) or |g_ab| <= tol^2 ||M||_F^2
// (absolute: the truncation cores are nearly rank-deficient, and columns at
// the level of M's rounding never settle under a relative rule alone), tol
// = kTolScale sqrt(L) u. Then the k largest column norms are ranked on the card and
// their columns written out. The Gram is taken of M scaled by a power of two
// to max |M| in [1, 2), so no square overflows; the scaling changes no
// rotation.
//
// What bounds it on an H100: latency, not bytes or operations. The plan's
// cores are 32..1024 columns wide and converge in 1-16 sweeps; a sweep is
// ~6 L p^2 flops (6.4 GFLOP at 1024, 0.1 ms at the 67 TFLOP/s FP64 tensor
// rate) on data that stays in the 50 MB L2 (W and V: 16 MiB at 1024). The
// time goes to the chain of dependent rotations in step 2 (nc - 1 rounds a
// step, each a square root, two reciprocals and a barrier: ~0.9k cycles) and
// to the grid barrier and the L2 round trips of steps 1 and 3. The design
// keeps those few: 32-column pairs (few steps); a round's rotations for the
// next round computed by warp 0 straight from the current Gram while the
// other warps rotate it, so a round takes one barrier; reciprocals and
// square roots from float seeds and two Newton steps; padded shared-memory
// rows; pairs that need no rotation skip step 3; no host round trip. Float32
// inputs are rotated in FP64 registers and stored as float32.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 32;  // columns of a block pair
constexpr int kBlock = kMaxCols / 2;  // columns a block, at most
// Jacobi sweeps on a pair's Gram a step, at most: a core of one pair (p <=
// 32) converges inside the step, wider ones take one Gram sweep a visit
constexpr int kInnerOnePair = 30;
constexpr int kInner = 1;
// sweeps over the whole core, at most: the plan's cores take 1-16; graded
// cores (singular values 1 .. 1e-8 / 1e-14, float64) 31-40 / 40-54 at 256
// to 1024 columns; float32 cores at most 23
constexpr int kMaxSweeps = 64;
// the orthogonality threshold tol = kTolScale sqrt(L) u
constexpr double kTolScale = 8.0;
constexpr int kTiles = 10;    // 8 x 8 Gram tiles on and above the diagonal
constexpr int kLd = kMaxCols + 1;  // leading dimension of G and J (padded)
constexpr size_t kSmemDoubles =
    (size_t)kWarps * kTiles * 64 + 3 * kMaxCols * kLd + 8 * kMaxCols;
constexpr size_t kSmemBytes = kSmemDoubles * 8 + (kMaxCols + 8) * 4 +
                               (kMaxCols - 1) * (kMaxCols + kMaxCols) +
                               (kMaxCols - 1) * (kMaxCols / 2) * 8;

struct Ctl {
  unsigned int count;         // grid barrier: arrivals
  unsigned int gen;           // grid barrier: generation
  int sweeps;                 // sweeps run
  int converged;              // 1 when the last sweep rotated nothing
  int last_rot;               // 1 + the last sweep that rotated
  int pad;
  unsigned long long absmax;  // the bits of max |M| (a non-negative double)
  double f2;                  // ||sc M||_F^2
};

template <typename T>
struct Params {
  const T* M;
  T* U;
  T* S;
  T* V;
  T* W;          // p columns of L, column c at W + c L
  T* R;          // the rotations: p x p, column c at R + c p
  double* norms; // p
  int* sel;      // k
  int* mod;      // a block's last step that rotated it (steps count from 1)
  int* ok;       // a pair's last step that found it orthogonal, by (step, q)
  Ctl* ctl;
  int* unconverged;  // launches that reached kMaxSweeps unconverged
  int64_t L, p, k;
  int trans;     // W's columns are M's rows (m < n)
  int nreal;     // column blocks
  int inner;     // Jacobi sweeps on a pair's Gram, at most, a step
  double tol;
};

__device__ __forceinline__ void dmma(double& d0, double& d1, double a,
                                     double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Every block of the (cooperative, all-resident) grid arrives before any
// leaves; writes before it are visible to reads after it.
__device__ void grid_sync(Ctl* ctl) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = &ctl->gen;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(&ctl->count, 1u) == gridDim.x - 1) {
      atomicExch(&ctl->count, 0u);
      __threadfence();
      atomicAdd(&ctl->gen, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// Round r (of n - 1) of the circle method on n (even) players: pair q.
__device__ __forceinline__ void circle_pair(int r, int q, int n, int& a,
                                            int& b) {
  if (q == 0) {
    a = r;
    b = n - 1;
  } else {
    a = (r + q) % (n - 1);
    b = (r - q + n - 1) % (n - 1);
  }
}

// 1 / x and 1 / sqrt(x) in double from float seeds, two Newton steps each
// (the seed's 2^-23 squares twice, past double's 2^-53); x > 0 and inside
// float's range.
__device__ __forceinline__ double rcp_d(double x) {
  double r = (double)__frcp_rn((float)x);
  r = r * (2.0 - x * r);
  return r * (2.0 - x * r);
}

__device__ __forceinline__ double rsqrt_d(double x) {
  double y = (double)rsqrtf((float)x);
  y = y * (1.5 - 0.5 * x * y * y);
  return y * (1.5 - 0.5 * x * y * y);
}

// The rotation [a', b'] = [a, b] [[c, s], [-s, c]] that makes columns a and
// b orthogonal (t = s / c), where they are not yet: g_ab^2 > tol2 g_aa g_bb
// (relative) and g_ab^2 > floor2 (absolute: two columns at the level of
// M's rounding, |w| <= tol ||M||_F, count as orthogonal). With d = g_bb -
// g_aa, t = sign(d) 2 g_ab / (|d| + sqrt(d^2 + 4 g_ab^2)), the smaller root
// of t^2 + 2 t d / (2 g_ab) - 1 = 0, taken on d and 2 g_ab scaled by a
// power of two to about 1, so the float seeds stay in range.
__device__ __forceinline__ bool rotation(double al, double be, double ga,
                                         double tol2, double floor2,
                                         double& c, double& s, double& t) {
  const double g2 = ga * ga;
  if (!(g2 > tol2 * al * be && g2 > floor2)) return false;
  const double d = be - al, g = 2.0 * ga;
  const double m = fmax(fabs(d), fabs(g));
  // 2^-e for m in [2^e, 2^(e+1))
  const double sc = __longlong_as_double(
      (2046ll - ((__double_as_longlong(m) >> 52) & 2047)) << 52);
  const double ds = d * sc, gs = g * sc;
  const double w = ds * ds + gs * gs;
  t = gs * rcp_d(fabs(ds) + w * rsqrt_d(w));
  if (d < 0.0) t = -t;
  c = rsqrt_d(1.0 + t * t);
  s = c * t;
  return true;
}

__device__ __forceinline__ void tile_ij(int t, int& bi, int& bj) {
  if (t < 4) {
    bi = 0;
    bj = t;
  } else if (t < 7) {
    bi = 1;
    bj = t - 3;
  } else if (t < 9) {
    bi = 2;
    bj = t - 5;
  } else {
    bi = 3;
    bj = 3;
  }
}

// G = (sc X)^T (sc X) for the pair's columns gc[0..nc) of W (each L long),
// zero past nc up to 8 nb8; J = I.
template <typename T>
__device__ void gram(const T* W, int64_t L, const int* gc, int nc, int nb8,
                     double sc, double* part, double* G, double* J) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lr = lane & 3, lc = lane >> 2;
  const T* cp[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int c = 8 * b + lc;
    cp[b] = c < nc ? W + (int64_t)gc[c] * L : nullptr;
  }
  double acc[kTiles][2];
#pragma unroll
  for (int t = 0; t < kTiles; ++t) acc[t][0] = acc[t][1] = 0.0;
  // four chunks of 4 rows an iteration, their loads issued together
  for (int64_t r0 = 4 * (int64_t)warp; r0 < L; r0 += 16 * kWarps) {
    double f[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int64_t r = r0 + 4 * kWarps * u + lr;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        f[u][b] = (cp[b] != nullptr && r < L)
                      ? sc * (double)__ldcg(cp[b] + r) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      int t = 0;
#pragma unroll
      for (int bi = 0; bi < 4; ++bi)
#pragma unroll
        for (int bj = bi; bj < 4; ++bj) {
          if (bj < nb8) dmma(acc[t][0], acc[t][1], f[u][bi], f[u][bj]);
          ++t;
        }
    }
  }
#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    double* o = part + (warp * kTiles + t) * 64 + lc * 8 + 2 * lr;
    o[0] = acc[t][0];
    o[1] = acc[t][1];
  }
  for (int e = threadIdx.x; e < kMaxCols * kLd; e += kThreads)
    J[e] = (e / kLd == e % kLd) ? 1.0 : 0.0;
  __syncthreads();
  for (int e = threadIdx.x; e < kTiles * 64; e += kThreads) {
    const int t = e >> 6, i = (e >> 3) & 7, j = e & 7;
    int bi, bj;
    tile_ij(t, bi, bj);
    if (bj >= nb8 || (bi == bj && i > j)) continue;
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += part[(w * kTiles + t) * 64 + i * 8 + j];
    const int gi = 8 * bi + i, gj = 8 * bj + j;
    G[gi * kLd + gj] = s;
    G[gj * kLd + gi] = s;
  }
  __syncthreads();
}

// The circle method's tables for n2 (even) columns: pr[r np + q] = a | b <<
// 8, round r's pair q; pos[r kMaxCols + x] = q | (x is its first) << 5,
// column x's pair in round r; nx[r np + q] = for the next round's pair q
// (round 0 after the last), each column's (x, its partner in round r, pos)
// in bytes: the indices one lane reads to rotate it, in one load.
__device__ void pair_tables(int n2, unsigned short* pr, unsigned char* pos,
                            uint2* nx) {
  const int np = n2 / 2, nr = n2 - 1;
  for (int e = threadIdx.x; e < nr * np; e += kThreads) {
    const int r = e / np, q = e % np;
    int a, b;
    circle_pair(r, q, n2, a, b);
    pr[e] = (unsigned short)(a | (b << 8));
    pos[r * kMaxCols + a] = (unsigned char)(q | 32);
    pos[r * kMaxCols + b] = (unsigned char)q;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nr * np; e += kThreads) {
    const int r = e / np, q = e % np, r1 = r + 1 == nr ? 0 : r + 1;
    const unsigned ab = pr[r1 * np + q];
    unsigned side[2];
    for (int h = 0; h < 2; ++h) {
      const unsigned x = h ? ab >> 8 : ab & 255;
      const unsigned pq = pos[r * kMaxCols + x];
      const unsigned pair = pr[r * np + (pq & 31)];
      const unsigned xp = (pq >> 5) ? pair >> 8 : pair & 255;
      side[h] = x | (xp << 8) | (pq << 16);
    }
    nx[e] = make_uint2(side[0] | ((side[1] & 255) << 24), side[1] >> 8);
  }
}

// Row x of G after round r's rotation of x's pair (q, x its first or not),
// as coefficients of rows x and its partner xp: (c, -s) where x is the
// first, else (c, s); and the new g_xx.
struct Side {
  int x, xp;
  double u1, u2, dnew;
};

__device__ __forceinline__ Side side(const double* Gc, const double* R,
                                     unsigned x, unsigned xp, unsigned pq) {
  const int q = pq & 31;
  const bool first = pq >> 5;
  Side o;
  o.x = x;
  o.xp = xp;
  const double c = R[4 * q], s = R[4 * q + 1], t = R[4 * q + 2];
  o.u1 = c;
  o.u2 = first ? -s : s;
  const double gxx = Gc[x * kLd + x], gxp = Gc[x * kLd + xp];
  o.dnew = first ? gxx - t * gxp : gxx + t * gxp;
  return o;
}

// Cyclic Jacobi on the Gram G (n2 = nc rounded up to even; G is zero past
// nc), at most `inner` sweeps of n2 - 1 rounds, accumulating the rotations
// into J. A round takes one barrier. In it, lane q of warp 0 computes the
// next round's rotation of pair q straight from this round's G and
// rotations, while the other threads rotate G's 2 x 2 blocks (pair q1's
// rows by pair q2's columns, q1 <= q2) from one G buffer into the other,
// and J's rows. The rotations sit in two buffers of (c, s, t, on) a pair.
// flag[0] is 0 on entry; flag[s & 1] marks a rotation in sweep s. Returns
// 1 if anything was rotated.
__device__ int inner_jacobi(double* Gbuf, double* J, double* rotbuf,
                            const unsigned short* pr, const uint2* nx,
                            int nc, int inner,
                            double tol2, double floor2, int* flag) {
  const int n2 = nc + (nc & 1), np = n2 / 2, nr = n2 - 1;
  const int nblk = np * (np + 1) / 2, nj = nc * np;
  const int tid = threadIdx.x, workers = kThreads - 32;
  // a thread of warps 1.. takes a block (q1 <= q2) or rows of J
  int q1 = -1, q2 = -1, jq[2] = {-1, -1}, jrow[2] = {0, 0};
  const int w = tid - 32;
  if (w >= 0 && w < nblk) {
    int rem = w;
    q1 = 0;
    while (rem >= np - q1) {
      rem -= np - q1;
      ++q1;
    }
    q2 = q1 + rem;
  } else if (w >= nblk) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = w - nblk + u * (workers - nblk);
      if (j < nj) {
        jq[u] = j / nc;
        jrow[u] = j % nc;
      }
    }
  }
  // round 0's rotations, from the Gram
  if (tid < np) {
    const int a = pr[tid] & 255, b = pr[tid] >> 8;
    double c = 1.0, sn = 0.0, t = 0.0;
    const bool on = rotation(Gbuf[a * kLd + a], Gbuf[b * kLd + b],
                             Gbuf[a * kLd + b], tol2, floor2, c, sn, t);
    double* o = rotbuf + 4 * tid;
    o[0] = c;
    o[1] = sn;
    o[2] = t;
    o[3] = on ? 1.0 : 0.0;
    if (on) flag[0] = 1;
  }
  if (tid == 0) flag[1] = 0;
  __syncthreads();
  int cur = 0, any = 0;
  for (int it = 0; it < inner; ++it) {
    for (int r = 0; r < nr; ++r) {
      const double* Gc = Gbuf + (cur & 1) * kMaxCols * kLd;
      double* Gn = Gbuf + ((cur & 1) ^ 1) * kMaxCols * kLd;
      const double* R = rotbuf + (cur & 1) * 4 * kMaxCols;
      double* Rn = rotbuf + ((cur & 1) ^ 1) * 4 * kMaxCols;
      const unsigned short* prr = pr + r * np;
      if (tid < 32) {
        if (tid < np) {
          // the next round's pair tid, from this round's G and rotations
          const uint2 e = nx[r * np + tid];
          const Side A = side(Gc, R, e.x & 255, (e.x >> 8) & 255,
                              (e.x >> 16) & 255);
          const Side B = side(Gc, R, e.x >> 24, e.y & 255, (e.y >> 8) & 255);
          const double gab =
              A.u1 * (B.u1 * Gc[A.x * kLd + B.x] + B.u2 * Gc[A.x * kLd + B.xp]) +
              A.u2 * (B.u1 * Gc[A.xp * kLd + B.x] + B.u2 * Gc[A.xp * kLd + B.xp]);
          double c = 1.0, sn = 0.0, t = 0.0;
          const bool on = rotation(A.dnew, B.dnew, gab, tol2, floor2, c, sn, t);
          double* o = Rn + 4 * tid;
          o[0] = c;
          o[1] = sn;
          o[2] = t;
          o[3] = on ? 1.0 : 0.0;
          if (on) flag[(r + 1 == nr ? it + 1 : it) & 1] = 1;
        }
      } else if (q1 >= 0) {
        const int a1 = prr[q1] & 255, b1 = prr[q1] >> 8;
        const int a2 = prr[q2] & 255, b2 = prr[q2] >> 8;
        const double c1 = R[4 * q1], s1 = R[4 * q1 + 1];
        double naa, nab, nba, nbb;  // rows (a1, b1) x columns (a2, b2)
        if (q1 == q2) {
          const double g = Gc[a1 * kLd + b1], t1 = R[4 * q1 + 2];
          naa = Gc[a1 * kLd + a1] - t1 * g;
          nbb = Gc[b1 * kLd + b1] + t1 * g;
          nab = nba = R[4 * q1 + 3] != 0.0 ? 0.0 : g;
        } else {
          const double c2 = R[4 * q2], s2 = R[4 * q2 + 1];
          const double gaa = Gc[a1 * kLd + a2], gab = Gc[a1 * kLd + b2];
          const double gba = Gc[b1 * kLd + a2], gbb = Gc[b1 * kLd + b2];
          // rows (a1, b1) by R1^T, then columns (a2, b2) by R2
          const double xa = c1 * gaa - s1 * gba, xb = c1 * gab - s1 * gbb;
          const double ya = s1 * gaa + c1 * gba, yb = s1 * gab + c1 * gbb;
          naa = c2 * xa - s2 * xb;
          nab = s2 * xa + c2 * xb;
          nba = c2 * ya - s2 * yb;
          nbb = s2 * ya + c2 * yb;
        }
        Gn[a1 * kLd + a2] = naa;
        Gn[a2 * kLd + a1] = naa;
        Gn[a1 * kLd + b2] = nab;
        Gn[b2 * kLd + a1] = nab;
        Gn[b1 * kLd + a2] = nba;
        Gn[a2 * kLd + b1] = nba;
        Gn[b1 * kLd + b2] = nbb;
        Gn[b2 * kLd + b1] = nbb;
      } else {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int q = jq[u];
          if (q < 0 || R[4 * q + 3] == 0.0) continue;
          const int a = prr[q] & 255, b = prr[q] >> 8;
          const double c = R[4 * q], sn = R[4 * q + 1];
          double* row = J + jrow[u] * kLd;
          const double ja = row[a], jb = row[b];
          row[a] = c * ja - sn * jb;
          row[b] = sn * ja + c * jb;
        }
      }
      ++cur;
      __syncthreads();
    }
    const int rotated = flag[it & 1];
    __syncthreads();
    if (!rotated) break;
    any = 1;
    if (tid == 0) flag[it & 1] = 0;  // for sweep it + 2
  }
  // the Gram is rebuilt at the next step: only J is kept
  return any;
}

// The pair's columns gc[0..nc) of W (L rows) and of R (p rows) <- themselves
// times J, by chunks of 8 rows, one warp a chunk, two chunks an iteration
// with all their loads issued before the products.
template <typename T>
__device__ void apply_j(T* W, int64_t L, T* R, int64_t p, const int* gc,
                        int nc, int nb8, const double* J) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lr = lane & 3, lc = lane >> 2;
  const int64_t nw = (L + 7) / 8, nchunks = nw + (p + 7) / 8;
  for (int64_t ch0 = warp; ch0 < nchunks; ch0 += 2 * kWarps) {
    double a[2][8];
    T* base[2];
    int64_t ld[2], rows[2], ra[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int64_t ch = ch0 + u * kWarps;
      const bool inW = ch < nw;
      base[u] = inW ? W : R;
      ld[u] = inW ? L : p;
      rows[u] = ch < nchunks ? ld[u] : 0;
      ra[u] = 8 * (inW ? ch : ch - nw) + lc;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int c = 4 * kk + lr;
        a[u][kk] = (c < nc && ra[u] < rows[u])
                       ? (double)__ldcg(base[u] + (int64_t)gc[c] * ld[u] + ra[u])
                       : 0.0;
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      double acc[4][2];
#pragma unroll
      for (int jb = 0; jb < 4; ++jb) acc[jb][0] = acc[jb][1] = 0.0;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (4 * kk >= 8 * nb8) break;
#pragma unroll
        for (int jb = 0; jb < 4; ++jb)
          if (jb < nb8)
            dmma(acc[jb][0], acc[jb][1], a[u][kk],
                 J[(4 * kk + lr) * kLd + 8 * jb + lc]);
      }
      if (ra[u] < rows[u]) {
#pragma unroll
        for (int jb = 0; jb < 4; ++jb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * jb + 2 * lr + e;
            if (jb < nb8 && c < nc)
              base[u][(int64_t)gc[c] * ld[u] + ra[u]] = (T)acc[jb][e];
          }
      }
    }
  }
}

__device__ __forceinline__ double rank_key(double v) {
  return v == v ? v : -1.0;  // NaN ranks last
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) svd_core_kernel(Params<T> P) {
  extern __shared__ double smem[];
  double* part = smem;
  double* Gbuf = part + kWarps * kTiles * 64;
  double* J = Gbuf + 2 * kMaxCols * kLd;
  double* rot = J + kMaxCols * kLd;  // two rounds' (c, s, t, on) a pair
  int* gc = reinterpret_cast<int*>(rot + 8 * kMaxCols);
  // the Gram sweeps' flags, nc, the tables' n2, whether the pair is settled
  int* sflags = gc + kMaxCols;
  unsigned short* pr = reinterpret_cast<unsigned short*>(sflags + 8);
  unsigned char* pos =
      reinterpret_cast<unsigned char*>(pr + (kMaxCols - 1) * (kMaxCols / 2));
  uint2* nx = reinterpret_cast<uint2*>(pos + (kMaxCols - 1) * kMaxCols);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t L = P.L, p = P.p;
  const int64_t gtid = (int64_t)blockIdx.x * kThreads + tid;
  const int64_t gstride = (int64_t)gridDim.x * kThreads;
  Ctl* ctl = P.ctl;
  if (tid == 0) sflags[3] = 0;  // no pair tables yet

  // W from M (transposed where W's columns are M's columns), R = I, max|M|
  double amax = 0.0;
  if (P.trans) {
    for (int64_t e = gtid; e < p * L; e += gstride) {
      const T x = P.M[e];
      P.W[e] = x;
      amax = fmax(amax, fabs((double)x));
    }
  } else {
    T* tile = reinterpret_cast<T*>(part);  // 32 x 33
    const int64_t tr = (L + 31) / 32, tcn = (p + 31) / 32;
    for (int64_t t = blockIdx.x; t < tr * tcn; t += gridDim.x) {
      const int64_t r0 = (t / tcn) * 32, c0 = (t % tcn) * 32;
      for (int i = tid; i < 1024; i += kThreads) {
        const int rr = i >> 5, cc = i & 31;
        const int64_t r = r0 + rr, c = c0 + cc;
        const T x = (r < L && c < p) ? P.M[r * p + c] : T(0);
        tile[rr * 33 + cc] = x;
        amax = fmax(amax, fabs((double)x));
      }
      __syncthreads();
      for (int i = tid; i < 1024; i += kThreads) {
        const int cc = i >> 5, rr = i & 31;
        const int64_t r = r0 + rr, c = c0 + cc;
        if (r < L && c < p) P.W[c * L + r] = tile[rr * 33 + cc];
      }
      __syncthreads();
    }
  }
  for (int64_t e = gtid; e < p * p; e += gstride)
    P.R[e] = (e / p == e % p) ? T(1) : T(0);
  const int nreal = P.nreal, nb = nreal + (nreal & 1), npairs = nb / 2;
  for (int64_t e = gtid; e < nb; e += gstride) P.mod[e] = 0;
  for (int64_t e = gtid; e < (int64_t)(nb - 1) * npairs; e += gstride)
    P.ok[e] = 0;
  amax = warp_max(amax);
  if (lane == 0)
    atomicMax(&ctl->absmax, (unsigned long long)__double_as_longlong(amax));
  grid_sync(ctl);
  const double mx = __longlong_as_double(
      (long long)*(volatile unsigned long long*)&ctl->absmax);
  const double sc = (mx > 0.0 && mx <= DBL_MAX) ? scalbn(1.0, -ilogb(mx)) : 1.0;
  double f2 = 0.0;
  for (int64_t e = gtid; e < p * L; e += gstride) {
    const double x = sc * (double)__ldcg(P.W + e);
    f2 += x * x;
  }
  f2 = warp_sum(f2);
  if (lane == 0) atomicAdd(&ctl->f2, f2);
  grid_sync(ctl);
  const double tol2 = P.tol * P.tol;
  const double floor1 = tol2 * *(volatile double*)&ctl->f2;
  const double floor2 = floor1 * floor1;

  // the sweeps. A pair found orthogonal at a step, neither of whose blocks
  // has been rotated since, is settled: its Gram would be the same, and the
  // step skips it.
  int sweep = 0, converged = 0;
  for (; sweep < kMaxSweeps; ++sweep) {
    for (int step = 0; step < nb - 1; ++step) {
      const int g = sweep * (nb - 1) + step + 1;
      for (int q = blockIdx.x; q < npairs; q += gridDim.x) {
        int bi, bj;
        circle_pair(step, q, nb, bi, bj);
        int* ok = P.ok + step * npairs + q;
        if (tid == 0) {
          const int mi = *(volatile int*)(P.mod + bi);
          const int mj = *(volatile int*)(P.mod + bj);
          sflags[4] = *(volatile int*)ok > (mi > mj ? mi : mj);
          int nc = 0;
          const int blocks[2] = {bi, bj};
          for (int h = 0; h < 2; ++h) {
            const int b = blocks[h];
            if (b >= nreal) continue;
            const int64_t c0 = (int64_t)b * p / nreal;
            const int64_t c1 = (int64_t)(b + 1) * p / nreal;
            for (int64_t c = c0; c < c1; ++c) gc[nc++] = (int)c;
          }
          sflags[2] = nc;
        }
        __syncthreads();
        const int nc = sflags[2], nb8 = (nc + 7) / 8;
        if (nc >= 2 && !sflags[4]) {
          gram<T>(P.W, L, gc, nc, nb8, sc, part, Gbuf, J);
          // the tables of the last pair's n2 stay
          const int n2 = nc + (nc & 1);
          const bool rebuild = n2 != sflags[3];
          __syncthreads();
          if (rebuild) {
            pair_tables(n2, pr, pos, nx);
            if (tid == 0) sflags[3] = n2;
          }
          if (tid == 0) sflags[0] = 0;
          __syncthreads();
          if (inner_jacobi(Gbuf, J, rot, pr, nx, nc, P.inner, tol2, floor2,
                           sflags)) {
            apply_j<T>(P.W, L, P.R, p, gc, nc, nb8, J);
            if (tid == 0) {
              atomicMax(&ctl->last_rot, sweep + 1);
              P.mod[bi] = g;
              P.mod[bj] = g;
            }
          } else if (tid == 0) {
            *ok = g;
          }
        }
        __syncthreads();
      }
      grid_sync(ctl);
    }
    if (*(volatile int*)&ctl->last_rot <= sweep) {
      converged = 1;
      ++sweep;
      break;
    }
  }

  // singular values: the column norms
  for (int64_t c = (int64_t)blockIdx.x * kWarps + warp; c < p;
       c += (int64_t)gridDim.x * kWarps) {
    double s2 = 0.0;
    for (int64_t r = lane; r < L; r += 32) {
      const double x = sc * (double)__ldcg(P.W + c * L + r);
      s2 += x * x;
    }
    s2 = warp_sum(s2);
    if (lane == 0) P.norms[c] = sqrt(s2) / sc;
  }
  grid_sync(ctl);
  // the k largest, in descending order (ties by column)
  for (int64_t c = gtid; c < p; c += gstride) {
    const double kc = rank_key(__ldcg(P.norms + c));
    int64_t rank = 0;
    for (int64_t i = 0; i < p; ++i) {
      const double ki = rank_key(__ldcg(P.norms + i));
      rank += (ki > kc) || (ki == kc && i < c);
    }
    if (rank < P.k) P.sel[rank] = (int)c;
  }
  grid_sync(ctl);
  const int64_t k = P.k;
  for (int64_t j = gtid; j < k; j += gstride)
    P.S[j] = (T)__ldcg(P.norms + __ldcg(P.sel + j));
  // the columns of W over their norms are one side's singular vectors, the
  // rotations' columns the other's
  T* Wside = P.trans ? P.V : P.U;
  T* Rside = P.trans ? P.U : P.V;
  for (int64_t e = gtid; e < L * k; e += gstride) {
    const int64_t r = e / k, j = e % k;
    const int c = __ldcg(P.sel + j);
    const double s = __ldcg(P.norms + c);
    Wside[e] = s > 0.0 ? (T)((double)__ldcg(P.W + c * L + r) / s) : T(0);
  }
  for (int64_t e = gtid; e < p * k; e += gstride) {
    const int64_t r = e / k, j = e % k;
    Rside[e] = __ldcg(P.R + (int64_t)__ldcg(P.sel + j) * p + r);
  }
  if (blockIdx.x == 0 && tid == 0) {
    ctl->sweeps = sweep;
    ctl->converged = converged;
    if (!converged) atomicAdd(P.unconverged, 1);
  }
}

int64_t align256(int64_t b) { return (b + 255) / 256 * 256; }

// The workspace's parts, in bytes from its start.
struct Layout {
  int64_t w, r, norms, sel, mod, ok, total;
};

Layout layout(int64_t m, int64_t n, int64_t k, int64_t elem) {
  const int64_t p = m < n ? m : n, L = m < n ? n : m;
  const int64_t nb = (p + kBlock - 1) / kBlock + 1;  // blocks, padded to even
  Layout o;
  o.w = 0;
  o.r = align256(p * L * elem);
  o.norms = o.r + align256(p * p * elem);
  o.sel = o.norms + align256(p * 8);
  o.mod = o.sel + align256(k * 4);
  o.ok = o.mod + align256(nb * 4);
  o.total = o.ok + align256(nb * nb / 2 * 4);
  return o;
}

template <typename T>
int launch(const void* M, int64_t m, int64_t n, int64_t k, void* U, void* S,
           void* V, void* work, void* ctl, void* unconverged,
           cudaStream_t stream) {
  if (m < 1 || n < 1 || k < 1 || k > (m < n ? m : n) ||
      (m < n ? m : n) > 2147483647 || m * n > ((int64_t)1 << 40))
    return (int)cudaErrorInvalidValue;
  const Layout lay = layout(m, n, k, sizeof(T));
  char* base = static_cast<char*>(work);
  Params<T> P;
  P.M = static_cast<const T*>(M);
  P.U = static_cast<T*>(U);
  P.S = static_cast<T*>(S);
  P.V = static_cast<T*>(V);
  P.W = reinterpret_cast<T*>(base + lay.w);
  P.R = reinterpret_cast<T*>(base + lay.r);
  P.norms = reinterpret_cast<double*>(base + lay.norms);
  P.sel = reinterpret_cast<int*>(base + lay.sel);
  P.mod = reinterpret_cast<int*>(base + lay.mod);
  P.ok = reinterpret_cast<int*>(base + lay.ok);
  P.ctl = static_cast<Ctl*>(ctl);
  P.unconverged = static_cast<int*>(unconverged);
  P.trans = m < n;
  P.p = P.trans ? m : n;
  P.L = P.trans ? n : m;
  P.k = k;
  P.nreal = (int)((P.p + kBlock - 1) / kBlock);
  P.inner = P.p <= 2 * kBlock ? kInnerOnePair : kInner;
  // the unit roundoff of T
  P.tol = kTolScale * sqrt((double)P.L) *
          ldexp(1.0, sizeof(T) == 4 ? -24 : -53);
  // resident blocks a device, found at its first launch
  static int resident[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidValue;
  if (resident[dev] == 0) {
    int n_sm = 0, per_sm = 0;
    err = cudaFuncSetAttribute(svd_core_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, svd_core_kernel<T>, kThreads, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    resident[dev] = per_sm * n_sm;
  }
  const int npairs = (P.nreal + (P.nreal & 1)) / 2;
  int64_t grid = resident[dev];
  if (grid > npairs) grid = npairs;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel((const void*)svd_core_kernel<T>,
                                    dim3((unsigned)grid), dim3(kThreads), args,
                                    kSmemBytes, stream);
  return (int)err;
}

}  // namespace

// Bytes of workspace a (m, n) core with k kept triplets needs, elements of
// elem bytes.
extern "C" int64_t ctg_svd_core_workspace(int64_t m, int64_t n, int64_t k,
                                          int64_t elem) {
  return layout(m, n, k, elem).total;
}

// The k largest singular triplets of M, in one cooperative launch on
// `stream`. dtype: 0 float32, 1 float64. ctl: 32 zeroed bytes on the device;
// the kernel leaves the sweeps it ran at ctl + 8 (int32) and 1 at ctl + 12
// where the last of them rotated nothing. unconverged: an int32 on the
// device, kept across launches, to which a launch that reaches kMaxSweeps
// unconverged adds 1.
extern "C" int ctg_svd_core(int dtype, const void* M, int64_t m, int64_t n,
                            int64_t k, void* U, void* S, void* V, void* work,
                            void* ctl, void* unconverged, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(M, m, n, k, U, S, V, work, ctl, unconverged, s);
  if (dtype == 1)
    return launch<double>(M, m, n, k, U, S, V, work, ctl, unconverged, s);
  return (int)cudaErrorInvalidValue;
}
