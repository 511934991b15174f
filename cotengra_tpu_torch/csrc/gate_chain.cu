// In-place gate chain on split-complex float32 planes, one launch per
// pass: a run of the chain's gates applied to tiles of x held in shared
// memory, so each pass reads x from HBM once and writes out once.
//
// Replaces the TPU kernel cotengra_tpu/ops/pallas_gates.py::_build_pallas_fn
// (driven by run_chain there), which loads one (seg, C-block) tile of x
// into VMEM, applies every gate of the chain to it and stores it once.
// Each gate computes
//
//   out[b, n] = sum_k y[k, n] * x[b, k]          (complex, planes apart)
//
// over its contracted legs k and new legs n. A pass's *tile* is the set
// of legs that any of its gates contracts or creates, widened by x's and
// out's innermost untouched legs until it covers 32 contiguous floats
// of both (one 128-byte line per warp access); the remaining untouched
// legs are the batch. The host (ops/gate_chains.py::chain_tile_plan)
// cuts the chain into passes, lays each tile out in x's leg order of the
// moment (the order changes from gate to gate, as x's does), cuts each
// pass's gates into groups and hands over index tables: the x offset of
// each input tile position (gather) and, per group, the offsets of the
// tile's legs that the group leaves alone, in the tiles before and after
// it - for the pass's last group, after it means in out. Each index
// space is stored as two short tables, offset(i) = hi[i / L] + lo[i % L].
//
// Register groups. A group is a run of consecutive gates whose legs,
// with every leg made and contracted between them, take at most
// MAX_REG_BITS bits a thread at once. Each thread takes one position of
// the legs the group leaves, for one batch element, computes its offsets
// once, loads the group's 2^B values (B <= 4, one bit a slot) into
// registers, applies every gate of the group there and stores the
// results once: one shared-memory round trip and one __syncthreads() a
// group, not a gate. The host lays the slots out so that each gate finds
// its contracted bits in consecutive slots p..p+kb-1 (its y rows and
// columns permuted to that order as the block loads y) and leaves its
// new bits in p..p+nb-1, so every register index is known at compile
// time (reg_gate<B, kb, nb, p>). A gate whose legs take more than four
// bits, whose contracted and created bits differ by more than one, or
// whose legs are not powers of two, runs alone item by item
// (apply_gate): a work item is one position of its other legs and up
// to 8 of its outputs.
//
// What bounds it on an H100: neither bytes nor flops alone. On the
// m=20 plan every chain does at most 12 flop/B (most 4-8), below the
// ~20 flop/B where the card's fp32 units would limit; summed over a
// slice the chains need 9.2 ms at the HBM rate and 2.8 ms of fp32 FMAs
// at 67 TFLOP/s. So nothing here spends effort on tensor cores (whose
// TF32 would also cost accuracy, and wgmma wants 64-row tiles that a
// K, N <= 32 gate does not fill). Register groups take the instructions
// around the FMAs out of the gate loop (per output item three divisions,
// six table reads and a round trip through shared memory per gate
// before); what is left is the gather's 4-byte cp.async and per-element
// index maths, and FMAs that overlap the memory traffic only as far as
// a block's warps allow (PERF.md). Persistent blocks (one or two per SM)
// walk over batch tiles: a batch tile is batch_tile batch elements x the
// whole tile of legs. Its x planes are gathered into shared memory with
// cp.async in a ring of up to 4 batch tiles (the host picks the depth
// that keeps the most bytes in flight), while the block computes an
// earlier one. The groups run from buffer to buffer in shared memory;
// the last group writes its outputs straight to out, in the output's
// leg order, so stores overlap the arithmetic. Neighbouring threads
// take neighbouring tile positions, which the tile's innermost 32 floats
// make neighbouring addresses in x and out. TMA does not fit: a tile's
// legs are scattered through x with up to ~21 distinct strides, which no
// 5-D box describes, and a gather of 128-byte runs is what cp.async does
// well.
//
// Shared memory per block (the host's _pass_smem_bytes counts the same):
// every gate's y (K*N complex each, at most 8 x 512), the ring slots of
// the input tile and the work buffers of the tiles between groups
// (complex pairs, per batch element): one, which takes every other such
// tile while the ring slot of the tile, free once the first group has
// read it, takes the rest, where the slot holds them; else two. Then the
// batch offsets (int64, x and out, ring depth + 2 tiles) and the int32
// index tables; at most 227 KB (requested above 48 KB with
// cudaFuncSetAttribute). Blocks of 256 threads where two share an SM,
// else 512.
//
// Index arithmetic: HBM offsets are 64-bit (the m=20 plans reach 2^30
// plane elements); counters are 32-bit, divided by precomputed
// multiplicative inverses (the host rejects x or out of 2^31 elements
// or more per slice).
//
// Slice leg: one launch runs the pass for a whole batch of slices (the
// grouped executor's "vmap" mode). The slice is the grid's y dimension:
// block (bx, s) walks the tiles of slice s only, from x + s * x_slice
// to out + s * out_slice (64-bit slice offsets, added once to the base
// pointers, so every counter stays 32-bit within a slice: m=20 at 16
// slices holds 2^33 floats in one batched x). A gate whose y differs
// by slice (it reads a sliced index) takes a y slice stride: the block
// loads y + s * y_slice into shared memory, so such a chain is still
// one launch per pass for the batch, never one per slice. A stride of
// 0 shares x or a gate across the batch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#define MAX_PASS_GATES 8
#define MAX_BATCH_DIMS 24
#define MAX_GATE_COMBOS 512
#define MAX_THREADS 512
#define MAX_STAGES 4
#define SMEM_LIMIT 232448
#define MAX_REG_BITS 4
#define META_HEAD 17
#define META_GATE 11
#define META_GROUP (12 + 2 * MAX_REG_BITS)
#define MAX_SLICES 65535

// n / d for 0 <= n < 2^32 and 1 <= d < 2^31 by one multiply-high
// (Granlund & Montgomery, "Division by invariant integers using
// multiplication", fig. 4.1)
struct FastDiv {
  uint32_t d, m;
  int s1, s2;
};

static FastDiv make_div(uint32_t d) {
  FastDiv f;
  int l = 0;
  while ((1ull << l) < d) ++l;  // ceil(log2 d)
  f.d = d;
  f.m = (uint32_t)(((((1ull << l) - d)) << 32) / d + 1);
  f.s1 = l < 1 ? l : 1;
  f.s2 = l > 1 ? l - 1 : 0;
  return f;
}

__device__ __forceinline__ uint32_t fdiv(uint32_t n, const FastDiv& f) {
  const uint32_t t = __umulhi(n, f.m);
  return (t + ((n - t) >> f.s1)) >> f.s2;
}

struct ChainGate {
  const float* y;            // (2, K, N) on the device
  int64_t y_slice;           // floats from one slice's y to the next's
  int K, N, tin, tout;       // tile sizes before and after the gate
  int koff, noff;            // table positions: y's K and N legs, or in a
                             // register group perm_k and perm_n
  int kb, nb, p;             // register group: the gate's field
  int reg;                   // 1 in a register group
  int yoff;                  // this gate's y (float2) in shared memory
};

// gates first..stop-1 of the pass between two trips through shared
// memory: in registers (slots >= 0) or one gate item by item (slots -1)
struct ChainGroup {
  int slots, first, stop, tin, tout;  // tile sizes before and after it
  int oin_hi, oin_lo, oout_hi, oout_lo;  // the tile's legs it leaves
  int empty_in, empty_out;   // slots empty before and after, as bits
  int sin[MAX_REG_BITS], sout[MAX_REG_BITS];  // each slot's stride
  FastDiv O, L;              // positions of the legs it leaves; len(lo)
};

struct PassArgs {
  int ngates, ngroups, E, S, nb, twork, nwork, table_len, kn_len;
  int g_hi, g_lo;
  int64_t n_tiles, in_plane, out_plane;
  int64_t x_slice, out_slice;  // floats between slices (0: shared x)
  uint32_t n_batch;
  FastDiv tin, gL, Ediv;
  FastDiv b_size[MAX_BATCH_DIMS];
  int64_t b_in[MAX_BATCH_DIMS], b_out[MAX_BATCH_DIMS];
  ChainGate g[MAX_PASS_GATES];
  ChainGroup grp[MAX_PASS_GATES];
};

__device__ __forceinline__ void cp_async4(float* smem_dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` (0..MAX_STAGES-2) groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// batch elements of tile `tile` that exist (the last tile may be short)
__device__ __forceinline__ int tile_count(const PassArgs& a, int64_t tile) {
  const int64_t left = (int64_t)a.n_batch - tile * a.E;
  return left < a.E ? (int)left : a.E;
}

// x and out offsets of each batch element of `tile` into boff[0..E),
// boff[E..2E)
__device__ void batch_offsets(const PassArgs& a, int64_t tile,
                              int64_t* boff) {
  const int ev = tile_count(a, tile);
  for (int e = threadIdx.x; e < ev; e += blockDim.x) {
    uint32_t rem = (uint32_t)(tile * a.E + e);
    int64_t oi = 0, oo = 0;
    for (int d = a.nb - 1; d >= 0; --d) {
      const uint32_t q = fdiv(rem, a.b_size[d]);
      const uint32_t c = rem - q * a.b_size[d].d;
      rem = q;
      oi += (int64_t)c * a.b_in[d];
      oo += (int64_t)c * a.b_out[d];
    }
    boff[e] = oi;
    boff[a.E + e] = oo;
  }
}

// start the gather of tile `tile` (x offsets in boff) into the ring slot
// dst, complex pairs [E][tin]
__device__ void issue_load(const PassArgs& a, const float* __restrict__ x,
                           float2* dst, const int64_t* boff, const int* tab,
                           int ev) {
  const int tin = (int)a.tin.d, L = (int)a.gL.d;
  const int g_hi = a.g_hi, g_lo = a.g_lo;
  const int64_t in_plane = a.in_plane;
  const int total = ev * tin;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int e = (int)fdiv(i, a.tin);
    const int t = i - e * tin;
    const int q = (int)fdiv(t, a.gL);
    const float* src = x + boff[e] + tab[g_hi + q] + tab[g_lo + t - q * L];
    cp_async4(&dst[i].x, src);
    cp_async4(&dst[i].y, src + in_plane);
  }
}

// The per-item path: one gate (group G) from src to dst inside shared
// memory (complex pairs) or, for the pass's last group (TO_OUT), from
// src to out: there the output offsets are out's, from the batch
// element's offset bout[e]. A work item is one position o of the tile's
// other legs of one batch element, and NB of the gate's N outputs there:
// KN > 0 holds the K inputs in registers (K == KN) and runs 2 * NB
// independent sums; KN == 0 takes any K, one output at a time. Items run
// o fastest, so the lanes of a warp read and write neighbouring
// positions (neighbouring addresses of out where its innermost legs are
// the tile's).
template <int KN, int NB, bool TO_OUT>
__device__ void apply_gate(const ChainGate& g, const ChainGroup& G,
                           const float2* src,
                           float2* dst, float* __restrict__ out,
                           const int64_t* bout, int64_t out_plane,
                           const float2* sy, const int* tab, int ev,
                           const FastDiv& Ediv) {
  const int K = KN > 0 ? KN : g.K;
  const int N = g.N, O = (int)G.O.d, L = (int)G.L.d, E = (int)Ediv.d;
  const int tin = g.tin, tout = g.tout;
  const float2* y = sy + g.yoff;
  const int* koff = tab + g.koff;
  const int* noff = tab + g.noff;
  const int* oin_hi = tab + G.oin_hi;
  const int* oin_lo = tab + G.oin_lo;
  const int* oout_hi = tab + G.oout_hi;
  const int* oout_lo = tab + G.oout_lo;
  // y's K-leg offsets are the same for every item: held in registers
  int ko[KN > 0 ? KN : 1];
  if constexpr (KN > 0) {
#pragma unroll
    for (int k = 0; k < KN; ++k) ko[k] = koff[k];
  }
  const int total = E * O * (N / NB);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int eb = (int)fdiv(i, G.O);
    const int o = i - eb * O;
    const int nb = (int)fdiv(eb, Ediv);
    const int e = eb - nb * E;
    if (e >= ev) continue;
    const int q = (int)fdiv(o, G.L);
    const int r = o - q * L;
    const float2* s = src + e * tin + oin_hi[q] + oin_lo[r];
    const int n0 = nb * NB;
    float ar[NB], ai[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) ar[j] = ai[j] = 0.f;
    if constexpr (KN > 0) {
      float2 xv[KN];
#pragma unroll
      for (int k = 0; k < KN; ++k) xv[k] = s[ko[k]];
#pragma unroll
      for (int k = 0; k < KN; ++k) {
        float2 v[NB];
        if constexpr (NB % 2 == 0) {
          // y rows start 16-byte aligned: N is even and each gate's y
          // begins on an even pair
          const float4* y4 = reinterpret_cast<const float4*>(y + k * N + n0);
#pragma unroll
          for (int j = 0; j < NB / 2; ++j) {
            const float4 w = y4[j];
            v[2 * j] = make_float2(w.x, w.y);
            v[2 * j + 1] = make_float2(w.z, w.w);
          }
        } else {
          v[0] = y[k * N + n0];
        }
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          ar[j] = fmaf(v[j].x, xv[k].x, fmaf(-v[j].y, xv[k].y, ar[j]));
          ai[j] = fmaf(v[j].x, xv[k].y, fmaf(v[j].y, xv[k].x, ai[j]));
        }
      }
    } else {
      for (int k = 0; k < K; ++k) {
        const float2 xk = s[koff[k]];
        const float2 v = y[k * N + n0];
        ar[0] = fmaf(v.x, xk.x, fmaf(-v.y, xk.y, ar[0]));
        ai[0] = fmaf(v.x, xk.y, fmaf(v.y, xk.x, ai[0]));
      }
    }
    if constexpr (TO_OUT) {
      float* d = out + bout[e] + oout_hi[q] + oout_lo[r];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int no = noff[n0 + j];
        d[no] = ar[j];
        d[out_plane + no] = ai[j];
      }
    } else {
      float2* d = dst + e * tout + oout_hi[q] + oout_lo[r];
#pragma unroll
      for (int j = 0; j < NB; ++j) d[noff[n0 + j]] = make_float2(ar[j], ai[j]);
    }
  }
}

// NB outputs an item: 8 where K >= 8, else 4 where N allows (registers:
// K inputs and 2 * NB sums)
template <int KN, bool TO_OUT>
__device__ void apply_gate_nb(const ChainGate& g, const ChainGroup& G,
                              const float2* src,
                              float2* dst, float* out, const int64_t* bout,
                              int64_t out_plane, const float2* sy,
                              const int* tab, int ev, const FastDiv& Ediv) {
  if (KN >= 8 && g.N % 8 == 0)
    apply_gate<KN, 8, TO_OUT>(g, G, src, dst, out, bout, out_plane, sy, tab, ev,
                              Ediv);
  else if (g.N % 4 == 0)
    apply_gate<KN, 4, TO_OUT>(g, G, src, dst, out, bout, out_plane, sy, tab, ev,
                              Ediv);
  else if (g.N % 2 == 0)
    apply_gate<KN, 2, TO_OUT>(g, G, src, dst, out, bout, out_plane, sy, tab, ev,
                              Ediv);
  else
    apply_gate<KN, 1, TO_OUT>(g, G, src, dst, out, bout, out_plane, sy, tab, ev,
                              Ediv);
}

template <bool TO_OUT>
__device__ void apply_any_gate(const ChainGate& g, const ChainGroup& G,
                               const float2* src,
                               float2* dst, float* out, const int64_t* bout,
                               int64_t out_plane, const float2* sy,
                               const int* tab, int ev, const FastDiv& Ediv) {
  switch (g.K) {
    case 2:
      apply_gate_nb<2, TO_OUT>(g, G, src, dst, out, bout, out_plane, sy, tab,
                               ev, Ediv);
      break;
    case 4:
      apply_gate_nb<4, TO_OUT>(g, G, src, dst, out, bout, out_plane, sy, tab,
                               ev, Ediv);
      break;
    case 8:
      apply_gate_nb<8, TO_OUT>(g, G, src, dst, out, bout, out_plane, sy, tab,
                               ev, Ediv);
      break;
    case 16:
      apply_gate_nb<16, TO_OUT>(g, G, src, dst, out, bout, out_plane, sy, tab,
                                ev, Ediv);
      break;
    case 32:
      apply_gate_nb<32, TO_OUT>(g, G, src, dst, out, bout, out_plane, sy, tab,
                                ev, Ediv);
      break;
    default:
      apply_gate<0, 1, TO_OUT>(g, G, src, dst, out, bout, out_plane, sy, tab,
                               ev, Ediv);
  }
}

// A register group: each thread holds the 2^B values of its group's
// legs at one position of the tile's other legs (one slot a bit, slot 0
// lowest: st[v] is the value where slot b reads bit b of v), applies
// every gate of the group to them in registers and stores them once.
// Every index below is known at compile time, so the state stays in
// registers; the host lays the slots out so that each gate finds its
// contracted bits in consecutive slots p..p+kb-1 and leaves its new bits
// in p..p+nb-1 (its y loaded into shared memory with rows and columns
// permuted to that order), and slots outside every gate's bits empty
// where it creates more than it contracts.

// y's row of N values from yk into v: 16-byte loads where N is even
// (each gate's y starts on an even pair, so every row is aligned)
template <int N>
__device__ __forceinline__ void y_row(float2 (&v)[N], const float2* yk) {
  if constexpr (N == 1) {
    v[0] = yk[0];
  } else {
#pragma unroll
    for (int n = 0; n < N; n += 2) {
      const float4 w = *reinterpret_cast<const float4*>(yk + n);
      v[n] = make_float2(w.x, w.y);
      v[n + 1] = make_float2(w.z, w.w);
    }
  }
}

// st[h][n][l] = sum_k y[k][n] st[h][k][l] over the field of MB slots
// from slot P: K = 2^KB inputs, N = 2^NB outputs, MB = max(KB, NB); the
// field's values beyond K before the gate and beyond N after it are
// empty
template <int B, int KB, int NB, int P>
__device__ __forceinline__ void reg_gate(float2 (&st)[1 << B],
                                         const float2* __restrict__ y) {
  constexpr int K = 1 << KB, N = 1 << NB;
  constexpr int MB = KB > NB ? KB : NB, M = 1 << MB;
  constexpr int LO = 1 << P, H = 1 << (B - MB - P);
#pragma unroll
  for (int h = 0; h < H; ++h) {
#pragma unroll
    for (int l = 0; l < LO; ++l) {
      float2 acc[N];
#pragma unroll
      for (int n = 0; n < N; ++n) acc[n] = make_float2(0.f, 0.f);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float2 xk = st[(h * M + k) * LO + l];
        float2 v[N];
        y_row<N>(v, y + k * N);
#pragma unroll
        for (int n = 0; n < N; ++n) {
          acc[n].x = fmaf(v[n].x, xk.x, fmaf(-v[n].y, xk.y, acc[n].x));
          acc[n].y = fmaf(v[n].x, xk.y, fmaf(v[n].y, xk.x, acc[n].y));
        }
      }
#pragma unroll
      for (int n = 0; n < N; ++n) st[(h * M + n) * LO + l] = acc[n];
    }
  }
}

// the gates a register group takes: kb and nb at most one apart (the
// host sends the others item by item)
#define REG_CASE(KB, NB, P)                                   \
  case ((KB) * (MAX_REG_BITS + 1) + (NB)) * (MAX_REG_BITS + 1) + (P): \
    if constexpr (((KB) > (NB) ? (KB) : (NB)) + (P) <= B)     \
      reg_gate<B, KB, NB, P>(st, y);                          \
    break;
#define REG_PAIR(KB, NB)                                      \
  REG_CASE(KB, NB, 0) REG_CASE(KB, NB, 1) REG_CASE(KB, NB, 2) \
  REG_CASE(KB, NB, 3) REG_CASE(KB, NB, 4)

template <int B>
__device__ __forceinline__ void reg_gate_any(float2 (&st)[1 << B],
                                             const float2* y, int kb, int nb,
                                             int p) {
  static_assert(MAX_REG_BITS == 4, "the cases below cover 4 slots");
  switch ((kb * (MAX_REG_BITS + 1) + nb) * (MAX_REG_BITS + 1) + p) {
    REG_PAIR(0, 0) REG_PAIR(0, 1) REG_PAIR(1, 0) REG_PAIR(1, 1)
    REG_PAIR(1, 2) REG_PAIR(2, 1) REG_PAIR(2, 2) REG_PAIR(2, 3)
    REG_PAIR(3, 2) REG_PAIR(3, 3) REG_PAIR(3, 4) REG_PAIR(4, 3)
    REG_PAIR(4, 4)
  }
}
#undef REG_PAIR
#undef REG_CASE

// offset of state index v: the strides of its set slots
template <int B>
__device__ __forceinline__ int slot_offset(const int (&st)[MAX_REG_BITS],
                                           int v) {
  int off = 0;
#pragma unroll
  for (int b = 0; b < B; ++b)
    if (v >> b & 1) off += st[b];
  return off;
}

// group G from src (a ring slot or a work buffer) to dst or, for the
// pass's last group (to_out), to out. An item is one position o of the
// legs G leaves, of one batch element; items run o fastest, as in
// apply_gate.
template <int B>
__device__ __forceinline__ void run_reg_group(const PassArgs& a,
                                              const ChainGroup& G,
                              const float2* src, float2* dst,
                              float* __restrict__ out, const int64_t* bout,
                              const float2* sy, const int* tab, int ev,
                              bool to_out) {
  constexpr int S = 1 << B;
  int sin[MAX_REG_BITS], sout[MAX_REG_BITS];
#pragma unroll
  for (int b = 0; b < MAX_REG_BITS; ++b) {
    sin[b] = G.sin[b];
    sout[b] = G.sout[b];
  }
  const int empty_in = G.empty_in, empty_out = G.empty_out;
  const int O = (int)G.O.d, L = (int)G.L.d;
  const int* oin_hi = tab + G.oin_hi;
  const int* oin_lo = tab + G.oin_lo;
  const int* oout_hi = tab + G.oout_hi;
  const int* oout_lo = tab + G.oout_lo;
  const int64_t out_plane = a.out_plane;
  const int total = ev * O;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int e = (int)fdiv(i, G.O);
    const int o = i - e * O;
    const int q = (int)fdiv(o, G.L);
    const int r = o - q * L;
    const float2* s = src + e * G.tin + oin_hi[q] + oin_lo[r];
    float2 st[S];
#pragma unroll
    for (int v = 0; v < S; ++v)
      st[v] = (v & empty_in) ? make_float2(0.f, 0.f)
                             : s[slot_offset<B>(sin, v)];
    for (int j = G.first; j < G.stop; ++j) {
      const ChainGate& g = a.g[j];
      reg_gate_any<B>(st, sy + g.yoff, g.kb, g.nb, g.p);
    }
    const int oo = oout_hi[q] + oout_lo[r];
    if (to_out) {
      float* d = out + bout[e] + oo;
#pragma unroll
      for (int v = 0; v < S; ++v) {
        if (v & empty_out) continue;
        const int so = slot_offset<B>(sout, v);
        d[so] = st[v].x;
        d[out_plane + so] = st[v].y;
      }
    } else {
      float2* d = dst + e * G.tout + oo;
#pragma unroll
      for (int v = 0; v < S; ++v)
        if (!(v & empty_out)) d[slot_offset<B>(sout, v)] = st[v];
    }
  }
}

// one group: in registers, or a single gate on the per-item path
__device__ __forceinline__ void run_group(const PassArgs& a,
                                          const ChainGroup& G,
                                          const float2* src, float2* dst,
                                          float* __restrict__ out,
                                          const int64_t* bout,
                                          const float2* sy, const int* tab,
                                          int ev, bool to_out) {
  switch (G.slots) {
    case 0:
      run_reg_group<0>(a, G, src, dst, out, bout, sy, tab, ev, to_out);
      break;
    case 1:
      run_reg_group<1>(a, G, src, dst, out, bout, sy, tab, ev, to_out);
      break;
    case 2:
      run_reg_group<2>(a, G, src, dst, out, bout, sy, tab, ev, to_out);
      break;
    case 3:
      run_reg_group<3>(a, G, src, dst, out, bout, sy, tab, ev, to_out);
      break;
    case 4:
      run_reg_group<4>(a, G, src, dst, out, bout, sy, tab, ev, to_out);
      break;
    default:
      if (to_out)
        apply_any_gate<true>(a.g[G.first], G, src, nullptr, out, bout,
                             a.out_plane, sy, tab, ev, a.Ediv);
      else
        apply_any_gate<false>(a.g[G.first], G, src, dst, nullptr, nullptr, 0,
                              sy, tab, ev, a.Ediv);
  }
}

// Shared memory: every gate's y as (re, im) pairs (each gate's from an
// even pair: 16-byte aligned rows where N is even), S ring slots of the
// input tile [E][tin] and nwork work buffers [E][twork] (the tiles
// between groups) of complex pairs, batch offsets [S + 2][x, out][E]
// (int64), the index tables.
// Tiles: this block takes tiles blockIdx.x + k * gridDim.x, k = 0, 1, ...;
// tile k loads into slot k % S with its offsets in entry k % (S + 2).
// Slices: block (bx, s) takes slice s = blockIdx.y.
__global__ void __launch_bounds__(MAX_THREADS)
gate_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                  const int* __restrict__ tables,
                  const __grid_constant__ PassArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int64_t slice = blockIdx.y;
  x += slice * a.x_slice;
  out += slice * a.out_slice;
  const int S = a.S, E = a.E;
  const int PS = E * (int)a.tin.d, PW = E * a.twork;  // buffer sizes
  float2* const sy = reinterpret_cast<float2*>(smem_raw);
  float2* const slots = sy + a.kn_len;
  float2* const work = slots + S * PS;
  int64_t* const boff = reinterpret_cast<int64_t*>(work + a.nwork * PW);
  int* const tab = reinterpret_cast<int*>(boff + 2 * (S + 2) * E);

  for (int i = threadIdx.x; i < a.table_len; i += blockDim.x)
    tab[i] = tables[i];
  for (int j = 0; j < a.ngates; ++j) {
    const ChainGate& g = a.g[j];
    const int kn = g.K * g.N;
    const float* gy = g.y + slice * g.y_slice;
    for (int i = threadIdx.x; i < kn; i += blockDim.x) {
      // a register group's y in its field's order: row perm_k[k],
      // column perm_n[n]
      int at = i;
      if (g.reg) {
        const int k = i / g.N;
        at = tables[g.koff + k] * g.N + tables[g.noff + i - k * g.N];
      }
      sy[g.yoff + i] = make_float2(gy[at], gy[kn + at]);
    }
  }

  const int64_t step = gridDim.x;
  const int64_t first = blockIdx.x;
  for (int k = 0; k < S; ++k) {
    const int64_t t = first + k * step;
    if (t < a.n_tiles) batch_offsets(a, t, boff + k * 2 * E);
  }
  __syncthreads();
  for (int k = 0; k < S - 1; ++k) {
    const int64_t t = first + k * step;
    if (t < a.n_tiles)
      issue_load(a, x, slots + k * PS, boff + k * 2 * E, tab,
                 tile_count(a, t));
    cp_async_commit();
  }
  for (int64_t i = 0;; ++i) {
    const int64_t tile = first + i * step;
    if (tile >= a.n_tiles) break;
    // tile i has landed once at most S - 2 later groups are pending; the
    // barrier also ends every read of tile i - 1 (its last gate may read
    // its ring slot), so that slot takes tile i + S - 1 after it
    cp_async_wait(S - 2);
    __syncthreads();
    const int64_t ka = i + S - 1, kb = i + S;
    if (first + ka * step < a.n_tiles)
      issue_load(a, x, slots + (ka % S) * PS, boff + (ka % (S + 2)) * 2 * E,
                 tab, tile_count(a, first + ka * step));
    cp_async_commit();
    // offsets of tile i + S, read after the next iteration's barrier; its
    // entry was last read by tile i - 2
    if (first + kb * step < a.n_tiles)
      batch_offsets(a, first + kb * step, boff + (kb % (S + 2)) * 2 * E);

    const int ev = tile_count(a, tile);
    const float2* src = slots + (i % S) * PS;
    float2* dst = work;
    const int64_t* bout = boff + ((i % (S + 2)) * 2 + 1) * E;
    // the tile's ring slot takes every other intermediate tile where
    // there is one work buffer: only the first group reads the tile, and
    // the slot takes a new tile after the next iteration's barrier
    float2* const other = a.nwork == 1 ? slots + (i % S) * PS : work + PW;
    for (int j = 0;; ++j) {
      // the last group writes out; what it reads is overwritten only
      // after the next iteration's barrier
      const bool last = j + 1 == a.ngroups;
      run_group(a, a.grp[j], src, dst, out, bout, sy, tab, ev, last);
      if (last) break;
      __syncthreads();
      src = dst;
      dst = (dst == work) ? other : work;
    }
  }
}

static bool in_table(int64_t pos, int64_t len, int64_t table_len) {
  return pos >= 0 && len >= 0 && pos + len <= table_len;
}

// What a launch asks of the runtime, asked once per device and kept:
// the kernel's dynamic shared memory limit (raised to the most any
// launch has needed), the SM count, and the resident blocks per SM of
// each (threads, shared memory) seen. None of these is stream work, and
// a CUDA graph capture in the global mode may refuse such calls; every
// capture follows an eager warm-up of the same launches, which fills
// this cache, so a captured launch makes none of them.
namespace {
constexpr int MAX_DEVICES = 64;
constexpr int OCC_SLOTS = 256;
struct Occupancy {
  int dev, threads;
  int64_t smem;
  int per_sm;
};
std::mutex config_mutex;
int64_t smem_set[MAX_DEVICES];
int sm_count[MAX_DEVICES];
Occupancy occupancy[OCC_SLOTS];
int n_occupancy = 0;

cudaError_t launch_config(int threads, int64_t smem, int* per_sm, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(config_mutex);
  if (sm_count[dev] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = sm_count[dev];
  if (smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(gate_chain_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    smem_set[dev] = smem;
  }
  for (int i = 0; i < n_occupancy; ++i) {
    const Occupancy& o = occupancy[i];
    if (o.dev == dev && o.threads == threads && o.smem == smem) {
      *per_sm = o.per_sm;
      return cudaSuccess;
    }
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, gate_chain_kernel, threads, (size_t)smem);
  if (err != cudaSuccess) return err;
  if (n_occupancy < OCC_SLOTS)
    occupancy[n_occupancy++] = Occupancy{dev, threads, smem, *per_sm};
  return cudaSuccess;
}
}  // namespace

// meta (host memory, int64), as ops/gate_chains.py::_pass_kernel_args
// writes it: a header (gates, batch tile, ring stages, batch runs, work
// buffer tile, batch count, x and out elements per plane, table length,
// then hi position, lo position and len(lo) of the gather, then slices,
// x and out slice strides, then groups and work buffers); per gate (y
// pointer, K, N, tile in, tile out, koff, noff, y slice stride, then kb,
// nb and p of its field in a register group);
// per group (slots or -1 on the per-item path, first and stop gate, tile
// in, tile out, oin hi, oin lo, oout hi, oout lo, len(lo) of oin and
// oout, empty slots before and after, MAX_REG_BITS slot strides before
// and as many after); per batch run (size, x stride, out stride).
// tables: the int32 index tables on the device.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for an argument block the kernel cannot take.
extern "C" int ctg_gate_chain_f32(const float* x, float* out,
                                  const int* tables, const int64_t* meta,
                                  int meta_len, void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (meta_len < META_HEAD) return bad;
  PassArgs a = {};
  a.ngates = (int)meta[0];
  a.E = (int)meta[1];
  a.S = (int)meta[2];
  a.nb = (int)meta[3];
  a.twork = (int)meta[4];
  const int64_t n_batch = meta[5];
  a.in_plane = meta[6];
  a.out_plane = meta[7];
  a.table_len = (int)meta[8];
  const int64_t nslice = meta[12];
  a.x_slice = meta[13];
  a.out_slice = meta[14];
  a.ngroups = (int)meta[15];
  a.nwork = (int)meta[16];
  if (a.ngates < 1 || a.ngates > MAX_PASS_GATES || a.nb < 0 ||
      a.nb > MAX_BATCH_DIMS || a.ngroups < 1 || a.ngroups > a.ngates ||
      meta_len != META_HEAD + META_GATE * a.ngates +
                      META_GROUP * a.ngroups + 3 * a.nb ||
      a.E < 1 || a.S < 2 || a.S > MAX_STAGES || a.twork < 0 ||
      meta[4] >= ((int64_t)1 << 24) || n_batch < 0 || a.in_plane < 0 ||
      a.out_plane < 0 || a.in_plane >= ((int64_t)1 << 31) ||
      a.out_plane >= ((int64_t)1 << 31) || meta[8] < 0 ||
      meta[8] >= ((int64_t)1 << 24) || nslice < 1 || nslice > MAX_SLICES ||
      a.x_slice < 0 || a.out_slice < 0 ||
      (nslice > 1 && a.out_slice < 2 * a.out_plane))
    return bad;
  if (a.nwork < 0 || a.nwork > 2 || (a.ngroups > 1) != (a.nwork > 0))
    return bad;
  a.n_batch = (uint32_t)n_batch;
  a.n_tiles = (n_batch + a.E - 1) / a.E;

  const int64_t* p = meta + META_HEAD;
  int kn_len = 0;
  for (int j = 0; j < a.ngates; ++j, p += META_GATE) {
    ChainGate& g = a.g[j];
    g.y = reinterpret_cast<const float*>(p[0]);
    g.y_slice = p[7];
    const int64_t K = p[1], N = p[2], tin = p[3], tout = p[4];
    if (K < 1 || N < 1 || K * N > MAX_GATE_COMBOS || tin < 1 || tout < 1 ||
        tin >= ((int64_t)1 << 24) || tout >= ((int64_t)1 << 24) ||
        tin % K || tin / K * N != tout || g.y == nullptr || g.y_slice < 0 ||
        !in_table(p[5], K, a.table_len) || !in_table(p[6], N, a.table_len) ||
        p[8] < 0 || p[9] < 0 || p[10] < 0 || p[8] > MAX_REG_BITS ||
        p[9] > MAX_REG_BITS || p[10] > MAX_REG_BITS)
      return bad;
    if (j > 0 && a.g[j - 1].tout != tin) return bad;
    g.K = (int)K;
    g.N = (int)N;
    g.tin = (int)tin;
    g.tout = (int)tout;
    g.koff = (int)p[5];
    g.noff = (int)p[6];
    g.kb = (int)p[8];
    g.nb = (int)p[9];
    g.p = (int)p[10];
    g.yoff = kn_len;
    kn_len += (int)((K * N + 1) / 2 * 2);
  }
  for (int j = 0; j < a.ngroups; ++j, p += META_GROUP) {
    ChainGroup& G = a.grp[j];
    G.slots = (int)p[0];
    G.first = (int)p[1];
    G.stop = (int)p[2];
    const int64_t tin = p[3], tout = p[4], L = p[9];
    // groups cover the gates in order, each with its gates' tiles; the
    // tiles between them go to the work buffers in turns, or (one work
    // buffer) to it and to the ring slot of the tile in turns
    const int64_t room = a.nwork == 1 && j % 2 ? a.g[0].tin : a.twork;
    if (p[1] != (j == 0 ? 0 : a.grp[j - 1].stop) || p[2] <= p[1] ||
        p[2] > a.ngates || (j + 1 == a.ngroups && p[2] != a.ngates) ||
        p[0] < -1 || p[0] > MAX_REG_BITS ||
        tin != a.g[G.first].tin || tout != a.g[G.stop - 1].tout ||
        (j + 1 < a.ngroups && tout > room))
      return bad;
    G.tin = (int)tin;
    G.tout = (int)tout;
    int64_t O = 0;
    if (G.slots < 0) {
      // one gate, item by item
      if (G.stop != G.first + 1) return bad;
      O = tin / a.g[G.first].K;
    } else {
      const int full = (1 << G.slots) - 1;
      G.empty_in = (int)p[10];
      G.empty_out = (int)p[11];
      if (p[10] < 0 || p[11] < 0 || p[10] > full || p[11] > full)
        return bad;
      const int held_in = __builtin_popcount(full & ~G.empty_in);
      const int held_out = __builtin_popcount(full & ~G.empty_out);
      O = tin >> held_in;
      if (tin != O << held_in || tout != O << held_out) return bad;
      for (int b = 0; b < MAX_REG_BITS; ++b) {
        const int64_t si = p[12 + b], so = p[12 + MAX_REG_BITS + b];
        if (si < 0 || so < 0 || si >= ((int64_t)1 << 31) ||
            so >= ((int64_t)1 << 31))
          return bad;
        G.sin[b] = (int)si;
        G.sout[b] = (int)so;
      }
      for (int k = G.first; k < G.stop; ++k) {
        ChainGate& g = a.g[k];
        const int mb = g.kb > g.nb ? g.kb : g.nb;
        if (g.K != 1 << g.kb || g.N != 1 << g.nb || g.p + mb > G.slots ||
            g.kb - g.nb > 1 || g.nb - g.kb > 1)
          return bad;
        g.reg = 1;
      }
    }
    if (L < 1 || O < 1 || O % L || !in_table(p[5], O / L, a.table_len) ||
        !in_table(p[6], L, a.table_len) ||
        !in_table(p[7], O / L, a.table_len) ||
        !in_table(p[8], L, a.table_len))
      return bad;
    G.oin_hi = (int)p[5];
    G.oin_lo = (int)p[6];
    G.oout_hi = (int)p[7];
    G.oout_lo = (int)p[8];
    G.O = make_div((uint32_t)O);
    G.L = make_div((uint32_t)L);
  }
  a.kn_len = kn_len;
  const int tin = a.g[0].tin, tout = a.g[a.ngates - 1].tout;
  const int64_t gL = meta[11];
  if (gL < 1 || tin % gL || !in_table(meta[9], tin / gL, a.table_len) ||
      !in_table(meta[10], gL, a.table_len))
    return bad;
  a.g_hi = (int)meta[9];
  a.g_lo = (int)meta[10];
  a.tin = make_div((uint32_t)tin);
  a.gL = make_div((uint32_t)gL);
  a.Ediv = make_div((uint32_t)a.E);

  int64_t batch = 1;
  for (int d = 0; d < a.nb; ++d, p += 3) {
    if (p[0] < 1 || p[0] >= ((int64_t)1 << 31)) return bad;
    a.b_size[d] = make_div((uint32_t)p[0]);
    a.b_in[d] = p[1];
    a.b_out[d] = p[2];
    batch *= p[0];
  }
  if (batch != n_batch || n_batch * tin != a.in_plane ||
      n_batch * tout != a.out_plane)
    return bad;
  if (n_batch == 0) return 0;

  const int64_t smem = 8 * (int64_t)a.E *
                           (a.S * (int64_t)tin + a.nwork * (int64_t)a.twork) +
                       16 * (int64_t)a.E * (a.S + 2) + 8 * (int64_t)kn_len +
                       4 * (int64_t)a.table_len;
  if (smem > SMEM_LIMIT) return bad;
  // two blocks of 256 threads share an SM where shared memory allows,
  // else one of 512 (the registers of an SM hold 512 threads either way)
  const int threads = 2 * smem <= SMEM_LIMIT ? MAX_THREADS / 2 : MAX_THREADS;
  int per_sm = 0, sms = 0;
  cudaError_t err = launch_config(threads, smem, &per_sm, &sms);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return bad;
  // the resident blocks shared out over the slices, each slice's
  // blocks walking its tiles; rounded down, so that no block waits for
  // a second wave (16 slices of 17 blocks on 264 resident ones took 1.7x
  // the time of 16 single slices)
  int64_t grid = (int64_t)per_sm * sms / nslice;
  if (grid < 1) grid = 1;
  if (grid > a.n_tiles) grid = a.n_tiles;
  const dim3 blocks((unsigned)grid, (unsigned)nslice);
  gate_chain_kernel<<<blocks, threads, (size_t)smem, (cudaStream_t)stream>>>(
      x, out, tables, a);
  return (int)cudaGetLastError();
}
