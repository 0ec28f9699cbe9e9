// Blocked flash-attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// `_kernel` (via `flash_attention_bhsd`): masked softmax(q k^T / sqrt(hd)) v
// per query row, with GQA (query head h reads kv head h / (H / KV)), causal
// and sliding-window masks, fully masked key tiles skipped, float32
// accumulation, and the input's dtype (float32 or bfloat16) out.  A loop
// inside each block over 64-row key/value tiles takes the place of the TPU
// kernel's sequential `ik` grid axis; the running max, sum and output of an
// online softmax stay in registers.  Rows and columns past the sequence ends
// are masked, so any length works.  hd is a template parameter (32, 64, 80,
// 112, 128).
//
// Bound at the serving path's shape (stablelm-3b prefill, B = 1, H = 32,
// hd = 80, causal): 4 (S (S + 1) / 2) hd H operations, 21.5 GFLOP at
// S = 2048, over 989 TFLOP/s of bf16 tensor-core peak is 21.7 us; q, k, v
// and o once (41.9 MB) over 3.35 TB/s is 12.5 us.  Operations bound it.
//
// bfloat16 (the serving path): one block of three warpgroups per (b, h,
// 128-row query tile), what the four faults of the earlier mma.sync design
// called for:
//
//   * mma.sync m16n8k16 -> wgmma.  Two consumer warpgroups own 64 query rows
//     each.  S = Q K^T is wgmma m64n64k16 with Q and K both read from shared
//     memory, K-major (K is stored [key][d]); O += P V is wgmma m64n{hd}k16
//     with P from registers (the score accumulator's layout is the A
//     operand's, so P never leaves the registers) and V read from shared
//     memory as an MN-major (transposed) B operand.
//   * synchronous loads into static shared memory -> TMA and a ring.  A
//     producer warpgroup (setmaxnreg lowered to 24; one thread issues the
//     copies) loads the Q tile once and keeps K/V tiles of 64 keys in
//     flight in a ring of three stages, each with a full and an empty
//     mbarrier, so copies overlap both consumers' products.  Tensor maps
//     over the strided (B, S, H, hd) views are built on the host per call
//     (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
//     the library needs no -lcuda) and passed as __grid_constant__
//     arguments; their out-of-bounds zero fill covers ragged S.  hd = 80
//     and 112 are not multiples of 64, so every tile is stored as 16-column
//     TMA boxes with the 32-byte swizzle (5 boxes a row at hd = 80, 7 at
//     112), which both wgmma descriptors read (layout type B32).
//   * 4 warps on 64 query rows -> 12 warps on 128 rows: each K/V tile is
//     loaded once for two consumers, and one consumer can use the tensor
//     cores while the other runs its softmax.
//   * P as two bf16 halves stays (P = hi + lo, two P.V products, 1.5x the
//     minimum tensor-core work): P keeps about 16 bits, as the card's
//     element-wise check of the bf16 path needs where outputs cancel.
//
// At hd = 80 the softmax, not the products, sets the pace, so it is kept
// short: the scores leave the tensor cores in float32; in edge tiles only,
// masked ones become -inf; p = 2^(s scale2 - m) is one fma and one ex2;
// O is rescaled only when a row maximum moved, and normalised by one
// reciprocal a row.  Key tiles wholly outside the causal or window band of
// the 128-row tile are never loaded; a consumer skips the products of a
// tile that is masked for all of its 64 rows.  The grid runs the longest
// causal query tiles first.  O is written, bf16, into the consumer's
// (finished) slice of the Q tile in the same swizzled layout and stored by
// TMA, which clips rows past Sq.  The launcher requires 16-byte aligned
// bases and strides (TMA's rule).
//
// float32: CUDA cores, one block of 128 threads (4 warps) per (b, h, 64-row
// query tile).  Thread (ty, tx) = (tid / 8, tid % 8) owns query rows
// ty + 16 i (i < 4), score columns tx + 8 j (j < 8) and output columns
// tx + 8 jj; the eight lanes of a row reduce by warp shuffles.
//
// Training passes an `lse` buffer: each path then also stores its rows'
// natural log-sum-exp, m + log l from the finished online softmax, for the
// backward kernel (flash_attention_bwd.cu) to rebuild P from.  Both kernels
// are templates on whether they store it, and serving's null takes the
// instance without the store, the code serving ran before (a run-time
// null check in one instance slowed it 9% at hd 80).
//
// Every product is an explicit fmaf or wgmma, so the result does not
// depend on the shared -fmad=false build flag (which the bit-exact
// flex_score kernels need); attention is held to a tolerance, not to bits.
#include "hopper.cuh"   // mbarrier, TMA and wgmma wrappers; tensor maps

namespace {

constexpr int BQ = 64;        // float32: query rows per block
constexpr int BK = 64;        // key rows per tile (both paths)
constexpr int THREADS = 128;  // float32: 4 warps
constexpr float NEG = -1e30f;

__device__ __forceinline__ bool attends(int row, int col, int Sk, int causal,
                                        int window) {
  return col < Sk && (!causal || col <= row) &&
         (window <= 0 || col > row - window);
}

// Key tiles [lo, hi) that hold an unmasked column for queries [q0, q0 + bq).
__device__ __forceinline__ int2 key_tiles(int q0, int bq, int Sq, int Sk,
                                          int causal, int window) {
  const int q_last = min(q0 + bq, Sq) - 1;
  const int n_kt = (Sk + BK - 1) / BK;
  const int hi = causal ? min(n_kt, q_last / BK + 1) : n_kt;
  const int lo_col = window > 0 ? q0 - window + 1 : 0;
  return make_int2(lo_col > 0 ? lo_col / BK : 0, hi);
}

// A row's natural log-sum-exp of its scaled scores from its running max m
// (natural units) and sum l; +inf for a row that attends to no key, so
// that the backward's exp(scale s - lse) is 0 there, as its output is.
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m + logf(l) : __int_as_float(0x7f800000);
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

template <int HD>
constexpr int f32_smem_floats() {
  // Q and K padded to HD + 1 (conflict-free column reads), V, and P.
  return BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1);
}

__device__ __forceinline__ float max8(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

template <int HD, bool LSE>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int H, int G, int Sq, int Sk,
              int causal, int window, float scale, Strides qs, Strides ks,
              Strides vs, Strides os) {
  constexpr int LD = HD + 1;
  constexpr int DJ = HD / 8;
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][LD], pre-scaled
  float* Ks = Qs + BQ * LD;     // [BK][LD]
  float* Vs = Ks + BK * LD;     // [BK][HD]
  float* Ps = Vs + BK * HD;     // [BQ][BK + 1]

  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / G;
  const float* qp = q + b * qs.b + h * qs.h;
  const float* kp = k + b * ks.b + kvh * ks.h;
  const float* vp = v + b * vs.b + kvh * vs.h;
  float* op = o + b * os.b + h * os.h;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD, s = q0 + r;
    Qs[r * LD + d] = s < Sq ? __fmul_rn(qp[s * qs.s + d], scale) : 0.f;
  }
  const int2 kt_range = key_tiles(q0, BQ, Sq, Sk, causal, window);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }

  for (int kt = kt_range.x; kt < kt_range.y; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int r = i / HD, d = i % HD, s = k0 + r;
      const bool in = s < Sk;
      Ks[r * LD + d] = in ? kp[s * ks.s + d] : 0.f;
      Vs[r * HD + d] = in ? vp[s * vs.s + d] : 0.f;
    }
    __syncthreads();

    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      bool ok[8];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ok[j] = attends(row, k0 + tx + 8 * j, Sk, causal, window);
        if (ok[j]) mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], max8(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * (BK + 1) + tx + 8 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + sum8(sum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const float vv = Vs[c * HD + tx + 8 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      op[row * os.s + tx + 8 * jj] = __fdiv_rn(acc[i][jj], denom);
    if constexpr (LSE)
      if (tx == 0)
        lse[static_cast<long long>(blockIdx.y) * Sq + row] =
            row_lse(m[i], l[i]);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma, TMA ring, warp specialisation
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BQ = 128;            // query rows per block (two consumers)
constexpr int STAGES = 3;          // K/V ring depth
constexpr int THREADS = 384;       // producer + two consumer warpgroups

// Shared memory, in bytes from a 1024-aligned base.  Each tile is stored as
// hd / 16 boxes of [rows][16] bf16, box after box, each box in the 32-byte
// swizzle (the 16-byte halves of rows 4-7 of every 8 swapped).
template <int HD>
struct Smem {
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;
  static constexpr int Q = 0;
  static constexpr int K = Q + Q_BYTES;
  static constexpr int V = K + STAGES * KV_BYTES;
  static constexpr int BAR = V + STAGES * KV_BYTES;  // full, empty, q
  static constexpr int BYTES = BAR + (2 * STAGES + 1) * 8;
};


__device__ __forceinline__ float max4(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float sum4(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

struct Maps {
  int q, k, v, o;   // Coords permutation of each map
};

template <int HD, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const __grid_constant__ CUtensorMap omap, Maps perm,
               float* __restrict__ lse, int B, int H, int G, int Sq, int Sk,
               int causal, int window, float scale2) {
  using L = Smem<HD>;
  constexpr int NB = HD / BOX;   // boxes a row: k-steps of Q.K^T
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base + L::Q, sK = base + L::K, sV = base + L::V;
  const uint32_t bar_full = base + L::BAR;
  const uint32_t bar_empty = bar_full + 8 * STAGES;
  const uint32_t bar_q = bar_empty + 8 * STAGES;

  // Longest causal query tiles first: the block index runs over the tiles
  // from the last, every (b, h) of a tile before the next.
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x % (B * H);
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / (B * H)) * BQ;
  const int b = bh / H, h = bh % H, kvh = h / G;
  const int2 kr = key_tiles(q0, BQ, Sq, Sk, causal, window);
  const int n_tiles = max(kr.y - kr.x, 0);

  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * 128);   // every consumer thread
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // Producer warpgroup: one thread issues every copy.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      const Coords cq = order(perm.q, q0, h, b);
      mbar_expect_tx(bar_q, L::Q_BYTES);
#pragma unroll
      for (int j = 0; j < NB; ++j)
        tma_load(sQ + j * BQ * ROW_BYTES, &qmap, bar_q, j * BOX, cq.c1, cq.c2,
                 cq.c3);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(bar_empty + 8 * s, (it / STAGES - 1) & 1);
        const int k0 = (kr.x + it) * BK;
        const Coords ck = order(perm.k, k0, kvh, b);
        const Coords cv = order(perm.v, k0, kvh, b);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * L::KV_BYTES);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const uint32_t off = s * L::KV_BYTES + j * BK * ROW_BYTES;
          tma_load(sK + off, &kmap, full, j * BOX, ck.c1, ck.c2, ck.c3);
          tma_load(sV + off, &vmap, full, j * BOX, cv.c1, cv.c2, cv.c3);
        }
      }
    }
  } else {
    // Consumer warpgroups: c owns query rows q0 + 64 c .. q0 + 64 c + 63;
    // warp w of it rows 16 w .. 16 w + 15 of those, as wgmma lays them out.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = tid / 128 - 1, t128 = tid & 127;
    const int warp = t128 >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + 64 * c;
    const int w0 = r0 + 16 * warp;
    const int row[2] = {w0 + g, w0 + g + 8};
    const bool live = r0 < Sq;
    const uint32_t sQc = sQ + 64 * c * ROW_BYTES;

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

    constexpr int SN = BK / 2;     // score accumulators a thread
    static_assert(SN == 32, "S = Q K^T is one wgmma m64n64 per k-step");
    mbar_wait(bar_q, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES;
      const int k0 = (kr.x + it) * BK;
      mbar_wait(bar_full + 8 * s, (it / STAGES) & 1);
      // A tile masked for all of this consumer's rows is only released.
      const bool skip = !live || (causal && k0 > r0 + 63) ||
                        (window > 0 && k0 + BK - 1 <= r0 - window);
      if (!skip) {
        const uint32_t sKs = sK + s * L::KV_BYTES;
        const uint32_t sVs = sV + s * L::KV_BYTES;
        // S = Q K^T: 64 x BK in float32, hd / 16 k-steps of one box each.
        float sc[SN];
#pragma unroll
        for (int i = 0; i < SN; ++i) sc[i] = 0.f;
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < NB; ++j)
          wgmma_ss_n64(sc, desc(sQc + j * BQ * ROW_BYTES, 16, 8 * ROW_BYTES),
                       desc(sKs + j * BK * ROW_BYTES, 16, 8 * ROW_BYTES),
                       j > 0);
        wgmma_commit();
        wgmma_wait0();
        fence_regs(sc);

        // Mask (only where the tile meets an edge of the band or of the
        // sequence) and online softmax over the rows g and g + 8, in log2
        // units: p = 2^(s scale2 - m), the scale folded into one fma.
        // sc[4 n + e] is (row[e >> 1], key k0 + 8 n + 2 t + (e & 1)); it is
        // overwritten with p.
        const bool full = k0 + BK <= Sk && (!causal || k0 + BK - 1 <= w0) &&
                          (window <= 0 || k0 > w0 + 15 - window);
        if (!full)   // masked scores become -inf: 2^-inf = 0
#pragma unroll
          for (int n = 0; n < BK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (!attends(row[e >> 1], k0 + 8 * n + 2 * t + (e & 1), Sk,
                           causal, window))
                sc[4 * n + e] = __int_as_float(0xff800000);   // -inf
        float mx[2] = {NEG, NEG};
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * n + e]);
        float corr[2], sum[2] = {0.f, 0.f}, neg_m[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float raw = max4(mx[r]);
          const float m_new =
              raw == NEG ? m[r] : fmaxf(m[r], __fmul_rn(raw, scale2));
          corr[r] = ex2(m[r] - m_new);
          m[r] = m_new;
          neg_m[r] = -m_new;
        }
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2(fmaf(sc[4 * n + e], scale2, neg_m[e >> 1]));
            sc[4 * n + e] = p;
            sum[e >> 1] += p;
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum4(sum[r]);
        if (corr[0] != 1.f || corr[1] != 1.f)   // the row maxima moved
#pragma unroll
          for (int n = 0; n < HD / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[4 * n + e] *= corr[e >> 1];

        // P as the A operand of P V, hi + lo: k-step kk covers keys 16 kk ..
        // 16 kk + 15, the score n-tiles 2 kk and 2 kk + 1 (the
        // accumulator's layout is the register A operand's).  V is an
        // MN-major B operand: 16-column atoms BK rows (one box) apart, 8-key
        // groups 256 bytes apart.
        uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float p0 = sc[4 * n + 2 * r], p1 = sc[4 * n + 2 * r + 1];
            const uint32_t hi = pack(p0, p1);
            const __nv_bfloat162 h2 =
                *reinterpret_cast<const __nv_bfloat162*>(&hi);
            p_hi[n >> 1][2 * (n & 1) + r] = hi;
            p_lo[n >> 1][2 * (n & 1) + r] =
                pack(p0 - __low2float(h2), p1 - __high2float(h2));
          }
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t dv = desc(sVs + kk * 16 * ROW_BYTES, BK * ROW_BYTES,
                                   8 * ROW_BYTES);
          wgmma_rs<HD>(o, p_hi[kk], dv);
          wgmma_rs<HD>(o, p_lo[kk], dv);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(o);
      }
      mbar_arrive(bar_empty + 8 * s);
    }

    if constexpr (LSE) {
      if (live && t == 0) {
        // m and l are in log2 units: lse = (m + log2 l) ln 2.
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (row[r] < Sq)
            lse[static_cast<long long>(bh) * Sq + row[r]] =
                l[r] > 0.f ? (m[r] + log2f(l[r])) * 0.6931471805599453f
                           : __int_as_float(0x7f800000);
      }
    }
    if (live) {
      // Normalise and write O, bf16, into this consumer's slice of the Q
      // tile (its last reader was this warpgroup's final Q.K^T), in the
      // boxes' swizzled layout; then one thread stores it by TMA.
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float inv = __frcp_rn(fmaxf(l[r], 1e-30f));
        const int lr = 16 * warp + g + 8 * r;   // row in the slice
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          const int col = 8 * (n & 1) + 2 * t;   // in box n / 2
          const uint32_t addr = sQc + (n >> 1) * BQ * ROW_BYTES +
                                lr * ROW_BYTES +
                                (((col >> 3) ^ ((lr >> 2) & 1)) << 4) +
                                (col & 7) * 2;
          const uint32_t v = pack(__fmul_rn(o[4 * n + 2 * r], inv),
                                  __fmul_rn(o[4 * n + 2 * r + 1], inv));
          asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v)
                       : "memory");
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
      if (t128 == 0) {
        const Coords co = order(perm.o, r0, h, b);
#pragma unroll
        for (int j = 0; j < NB; ++j)
          tma_store(&omap, sQc + j * BQ * ROW_BYTES, j * BOX, co.c1, co.c2,
                    co.c3);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
    }
  }
}

}  // namespace wg

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int HD, bool LSE>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int H, int KV, int Sq, int Sk, int causal,
                int window,
                Strides qs, Strides ks, Strides vs, Strides os,
                cudaStream_t stream) {
  CUtensorMap qm, km, vm, om;
  wg::Maps perm;
  if (make_map(&qm, &perm.q, q, B, H, Sq, HD, qs, wg::BQ) ||
      make_map(&km, &perm.k, k, B, KV, Sk, HD, ks, BK) ||
      make_map(&vm, &perm.v, v, B, KV, Sk, HD, vs, BK) ||
      make_map(&om, &perm.o, o, B, H, Sq, HD, os, wg::BQ / 2))
    return -2;
  constexpr int bytes = wg::Smem<HD>::BYTES + 1024;   // + alignment slack
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        wg::flash_fwd_bf16<HD, LSE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int n_qt = (Sq + wg::BQ - 1) / wg::BQ;
  const float scale2 = 1.0f / sqrtf((float)HD) * 1.4426950408889634f;
  wg::flash_fwd_bf16<HD, LSE><<<n_qt * B * H, wg::THREADS, bytes, stream>>>(
      qm, km, vm, om, perm, lse, B, H, H / KV, Sq, Sk, causal, window,
      scale2);
  return (int)cudaGetLastError();
}

template <int HD, bool LSE>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int KV, int Sq, int Sk, int causal,
               int window, Strides qs, Strides ks, Strides vs, Strides os,
               cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  const float scale = 1.0f / sqrtf((float)HD);
  constexpr int bytes = f32_smem_floats<HD>() * (int)sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32<HD, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  flash_fwd_f32<HD, LSE><<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, H / KV,
      Sq, Sk, causal, window, scale, qs, ks, vs, os);
  return (int)cudaGetLastError();
}

// Each kernel is built twice: with the lse store (training) and without
// it, so serving's instance is the code it was before the store existed.
template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           float* lse, int B, int H, int KV, int Sq, int Sk, int causal,
           int window, Strides qs, Strides ks, Strides vs, Strides os,
           cudaStream_t stream) {
  if (dtype == 1)
    return lse ? launch_bf16<HD, true>(q, k, v, o, lse, B, H, KV, Sq, Sk,
                                       causal, window, qs, ks, vs, os, stream)
               : launch_bf16<HD, false>(q, k, v, o, lse, B, H, KV, Sq, Sk,
                                        causal, window, qs, ks, vs, os,
                                        stream);
  return lse ? launch_f32<HD, true>(q, k, v, o, lse, B, H, KV, Sq, Sk, causal,
                                    window, qs, ks, vs, os, stream)
             : launch_f32<HD, false>(q, k, v, o, lse, B, H, KV, Sq, Sk,
                                     causal, window, qs, ks, vs, os, stream);
}

}  // namespace

// q (B, H, Sq, hd), k and v (B, KV, Sk, hd), o (B, H, Sq, hd), each given by
// its (b, h, s) element strides with a unit head-dim stride (and, in
// bfloat16, 16-byte aligned data and strides, as TMA requires).  lse, if not
// null, is a contiguous float32 (B, H, Sq): each row's natural log of the
// sum of exp(scale s) over the keys it attends to (+inf for none), which
// the backward (flash_attention_bwd.cu) reads; with null nothing more is
// written.  dtype 0 is float32, 1 bfloat16.  Returns 0, a CUDA error code,
// -1 for an unsupported hd or dtype, or -2 if a bf16 tensor map could not
// be made.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int KV, int Sq, int Sk, int hd, int causal, int window,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    void* lse, void* stream) {
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return -1;
  switch (hd) {
    case 32:
      return launch<32>(dtype, q, k, v, o, static_cast<float*>(lse), B, H, KV,
                        Sq, Sk, causal, window, qs, ks, vs, os, st);
    case 64:
      return launch<64>(dtype, q, k, v, o, static_cast<float*>(lse), B, H, KV,
                        Sq, Sk, causal, window, qs, ks, vs, os, st);
    case 80:
      return launch<80>(dtype, q, k, v, o, static_cast<float*>(lse), B, H, KV,
                        Sq, Sk, causal, window, qs, ks, vs, os, st);
    case 112:
      return launch<112>(dtype, q, k, v, o, static_cast<float*>(lse), B, H, KV,
                         Sq, Sk, causal, window, qs, ks, vs, os, st);
    case 128:
      return launch<128>(dtype, q, k, v, o, static_cast<float*>(lse), B, H, KV,
                         Sq, Sk, causal, window, qs, ks, vs, os, st);
    default:
      return -1;
  }
}
