// Flash-attention backward for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference has no backward of
// src/repro/kernels/flash_attention/flash_attention.py `_kernel`; its
// `loss` runs inside `no_kernels()` and differentiates the jnp path
// (src/repro/models/model.py:444-446, `layers.chunked_attention`).  The
// port has no plain path on the card, so this is the gradient of the
// forward in flash_attention.cu, behind `ops.FlashAttention`.
//
// From q, k, v, the forward's o and row log-sum-exp lse, and dO:
//   D  = rowsum(dO o)                  (float32, o in its own dtype)
//   P  = exp(scale S - lse), S = q k^T (0 where masked)
//   dV = P^T dO,   dP = dO V^T,   dS = P (dP - D)
//   dQ = scale dS K,   dK = scale dS^T Q
// with dK and dV summed over the G query heads of each kv head.  Masks as
// the forward's: GQA, causal (query 0 with key 0 at Sq != Sk), sliding
// window; rows and keys past the sequence ends are zero-filled and masked.
//
// Three kernels a call and no atomics, so two calls are bit-equal:
//   * bwd_delta: D, a warp a row, its lanes summed by xor shuffles;
//   * dK, dV: a block per (b, kv head, key tile).  It loops over the G
//     query heads in order and, for each, over the query tiles that hold an
//     unmasked pair with its keys (the forward's `key_tiles` turned around),
//     rebuilding S, P and dP from q, dO and lse; dK and dV stay in
//     registers and each element is written once, by one thread;
//   * dQ: a block per (b, h, query tile) over its live key tiles,
//     rebuilding S, P and dP again: two more products a pair than an
//     atomic dQ, for determinism and no float32 scratch of dQ.
// Both grids start with the tiles that have the most causal work.
//
// Bound at stablelm-3b's training shape (B 8, H = KV = 32, S 2048, hd 80,
// causal, bf16): S, dP, dV, dK and dQ are 2 hd flops each a live pair,
// 10 hd in all: 8 x 32 x 2048 x 2049 / 2 x 800 = 430 GFLOP, 0.43 ms at
// 989 TFLOP/s; q, k, v, o, dO, dq, dk and dv once are 0.67 GB, 0.20 ms
// at 3.35 TB/s.  Operations bound it; this design issues 14 hd a pair
// (8 in the dK/dV kernel, 6 in the dQ kernel).
//
// bfloat16: both heavy kernels are built as the forward's bf16 kernel is
// (wgmma, a TMA ring, warp specialisation; the building blocks are in
// hopper.cuh), so that no block-wide barrier or synchronous copy stands
// between one step's products and the next.
//   * dK/dV: three warpgroups a block of 128 keys.  Two consumers own 64
//     keys each; the producer (setmaxnreg lowered to 40) loads K and V once
//     and keeps (Q, dO) tiles of QT queries in flight in a ring of four
//     stages, each with a full and an empty mbarrier: one thread issues the
//     TMA copies, and warps 1-3, a step each in turn, copy the step's lse
//     (in log2 units) and D beside them (three warps, so that a load's
//     latency spans three steps).  S^T = K Q^T and dP^T = V dO^T are wgmma
//     m64nQTk16 with both operands K-major in shared memory; they leave
//     keys on the rows,
//     so P^T and dS^T become the register A operand of dV += P^T dO and
//     dK += dS^T Q (wgmma m64n{hd}k16) in place, with dO and Q read
//     MN-major from the same stage: one copy, two reads.  QT is 64 up to
//     hd 80 and 32 above, where dK and dV take 112 or 128 registers a
//     thread.
//   * dQ: the same three warpgroups a block of 128 query rows.  Q and dO
//     are loaded once, K and V tiles of 64 keys ride the ring; S = Q K^T and
//     dP = dO V^T are ss m64n64k16, dQ += dS K is rs with K read MN-major.
//   * Tensor maps over the strided (B, S, H, hd) views are built on the host
//     once a call for both kernels, with the forward's 16-column boxes in
//     the 32-byte swizzle; their zero fill covers ragged S, and boxes wholly
//     past the end are not loaded (no consumer reads them).
//   * While one consumer runs its element-wise work the other's products
//     use the tensor cores.  Within a consumer, P is computed while dP is
//     still on them (two commit groups, wait for the first), dV is issued
//     before dS is computed, and a step's last products (dK; dQ) run on
//     while the next step's first are issued: the stage they read is
//     released one step late.
//   * The grid takes (b, head) pairs in groups of 8, and within a group
//     the longest causal tiles first, so that the blocks in flight share
//     the tiles they stream through L2.
// S and dP leave the tensor cores in float32; P = 2^(S scale log2e - lse
// log2e) is one fma and one ex2; P and dS are rounded once to bf16 as they
// become A fragments; dK and dQ are scaled once at the store.  A consumer
// skips the products of a step masked for all of its 64 rows.
//
// The element-wise work, not the tensor cores, sets the pace, so it is
// kept short: the mask is applied element by element only where a warp's
// 16 rows meet an edge, in a branch of its own that is uniform across the
// warp; S^T, dP^T, S and dP stay allocated across steps, each step's
// first k-step overwriting them; lse and D are read as float2 pairs.  (On an H100, with the mask's
// compares folded into every element and the scores zeroed each step, a
// call took 1.28x as long at stablelm-3b's training shape.)
//
// float32: the CUDA cores, 4-warp blocks of 64 keys (dK/dV) or 64 query
// rows (dQ), explicit fmaf throughout.
//
// The launcher requires unit head-dim strides and, in bfloat16, 16-byte
// aligned bases and strides of multiples of 8 elements, as TMA does.
#include "hopper.cuh"   // mbarrier, TMA and wgmma wrappers; tensor maps
#include <math_constants.h>

namespace {

constexpr int BK = 64;         // float32: keys of a dK/dV block
constexpr int BQ = 64;         // float32: query rows of a dQ block
constexpr int THREADS = 128;   // float32: 4 warps
constexpr int QF = 32;         // float32 dK/dV: queries a step
constexpr int KF = 32;         // float32 dQ: keys a step
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const float* lse;     // (B, H, Sq), contiguous
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* delta;         // scratch (B, H, Sq), contiguous
  int B, H, KV, Sq, Sk, causal, window;
  float scale;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
};

__device__ __forceinline__ bool attends(int row, int col, int Sq, int Sk,
                                        int causal, int window) {
  return row < Sq && col < Sk && (!causal || col <= row) &&
         (window <= 0 || col > row - window);
}

// Key tiles [lo, hi) of `bk` keys that hold an unmasked column for queries
// [q0, q0 + bq): the forward's `key_tiles`.
__device__ __forceinline__ int2 key_tiles(int q0, int bq, int bk, int Sq,
                                          int Sk, int causal, int window) {
  const int q_last = min(q0 + bq, Sq) - 1;
  const int n_kt = (Sk + bk - 1) / bk;
  const int hi = causal ? min(n_kt, q_last / bk + 1) : n_kt;
  const int lo_col = window > 0 ? q0 - window + 1 : 0;
  return make_int2(lo_col > 0 ? min(lo_col / bk, hi) : 0, hi);
}

// Query tiles [lo, hi) of `bq` rows that hold an unmasked row for keys
// [k0, k0 + bk): causal rows start at k0, window rows end before
// k_last + window.
__device__ __forceinline__ int2 query_tiles(int k0, int bk, int bq, int Sq,
                                            int Sk, int causal, int window) {
  const int n_qt = (Sq + bq - 1) / bq;
  const int k_last = min(k0 + bk, Sk) - 1;
  const int lo = causal ? min(k0 / bq, n_qt) : 0;
  const int hi =
      window > 0 ? min(n_qt, (k_last + window - 1) / bq + 1) : n_qt;
  return make_int2(lo, max(lo, hi));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// D = rowsum(dO o) in float32: a warp a row, 8 rows a block.
template <typename T>
__global__ void __launch_bounds__(256) bwd_delta(const Args a, int hd) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (s >= a.Sq) return;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const T* op = static_cast<const T*>(a.o) + b * a.os.b + h * a.os.h +
                s * a.os.s;
  const T* dp = static_cast<const T*>(a.dout) + b * a.dos.b + h * a.dos.h +
                s * a.dos.s;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32)
    acc = fmaf(to_f(op[d]), to_f(dp[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.delta[static_cast<long long>(blockIdx.y) * a.Sq + s] = acc;
}

// ---------------------------------------------------------------------------
// float32: CUDA cores.  Thread (ty, tx) = (tid / 8, tid % 8).
// ---------------------------------------------------------------------------

template <int HD>
constexpr int dkv_f32_floats() {
  // K, V, Q, dO padded to HD + 1; P^T and dS^T; lse and D.
  return 2 * BK * (HD + 1) + 2 * QF * (HD + 1) + 2 * BK * (QF + 1) + 2 * QF;
}

// A block per (b, kv head, 64-key tile): thread (ty, tx) owns keys
// ty + 16 i (i < 4), queries tx + 8 j (j < 4) of a 32-query step, and the
// dK and dV columns tx + 8 jj.
template <int HD>
__global__ void __launch_bounds__(THREADS) dkv_f32(const Args a) {
  constexpr int LD = HD + 1, DJ = HD / 8, LP = QF + 1;
  extern __shared__ float smem[];
  float* Ks = smem;             // [BK][LD]
  float* Vs = Ks + BK * LD;     // [BK][LD]
  float* Qs = Vs + BK * LD;     // [QF][LD]
  float* Os = Qs + QF * LD;     // dO, [QF][LD]
  float* Ps = Os + QF * LD;     // P^T, [BK][LP]
  float* Ss = Ps + BK * LP;     // dS^T, [BK][LP]
  float* Ls = Ss + BK * LP;     // lse, [QF]
  float* Dl = Ls + QF;          // D, [QF]

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int n_bk = a.B * a.KV;
  const int k0 = (blockIdx.x / n_bk) * BK;
  const int b = (blockIdx.x % n_bk) / a.KV, kvh = blockIdx.x % a.KV;
  const int G = a.H / a.KV;
  const float* kp = static_cast<const float*>(a.k) + b * a.ks.b +
                    kvh * a.ks.h;
  const float* vp = static_cast<const float*>(a.v) + b * a.vs.b +
                    kvh * a.vs.h;
  for (int i = tid; i < BK * HD; i += THREADS) {
    const int r = i / HD, d = i % HD, s = k0 + r;
    const bool in = s < a.Sk;
    Ks[r * LD + d] = in ? kp[s * a.ks.s + d] : 0.f;
    Vs[r * LD + d] = in ? vp[s * a.vs.s + d] : 0.f;
  }

  float dk[4][DJ], dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dk[i][jj] = dv[i][jj] = 0.f;

  const int2 qr = query_tiles(k0, BK, QF, a.Sq, a.Sk, a.causal, a.window);
  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const float* qp = static_cast<const float*>(a.q) + b * a.qs.b +
                      h * a.qs.h;
    const float* op = static_cast<const float*>(a.dout) + b * a.dos.b +
                      h * a.dos.h;
    const long long row0 = (static_cast<long long>(b) * a.H + h) * a.Sq;
    for (int qt = qr.x; qt < qr.y; ++qt) {
      const int q0 = qt * QF;
      __syncthreads();   // the previous step's tiles are no longer read
      for (int i = tid; i < QF * HD; i += THREADS) {
        const int r = i / HD, d = i % HD, s = q0 + r;
        const bool in = s < a.Sq;
        Qs[r * LD + d] = in ? qp[s * a.qs.s + d] : 0.f;
        Os[r * LD + d] = in ? op[s * a.dos.s + d] : 0.f;
      }
      for (int r = tid; r < QF; r += THREADS) {
        const bool in = q0 + r < a.Sq;
        Ls[r] = in ? a.lse[row0 + q0 + r] : CUDART_INF_F;
        Dl[r] = in ? a.delta[row0 + q0 + r] : 0.f;
      }
      __syncthreads();

      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(ty + 16 * i) * LD + d];
          vv[i] = Vs[(ty + 16 * i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = Qs[(tx + 8 * j) * LD + d];
          ov[j] = Os[(tx + 8 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
            dpt[i][j] = fmaf(vv[i], ov[j], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 8 * j;
          const float p = attends(q0 + c, k0 + ty + 16 * i, a.Sq, a.Sk,
                                  a.causal, a.window)
                              ? expf(fmaf(st[i][j], a.scale, -Ls[c]))
                              : 0.f;
          Ps[(ty + 16 * i) * LP + c] = p;
          Ss[(ty + 16 * i) * LP + c] = __fmul_rn(p, dpt[i][j] - Dl[c]);
        }
      __syncthreads();

#pragma unroll 4
      for (int c = 0; c < QF; ++c) {
        float pv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[(ty + 16 * i) * LP + c];
          sv[i] = Ss[(ty + 16 * i) * LP + c];
        }
#pragma unroll
        for (int jj = 0; jj < DJ; ++jj) {
          const float ov = Os[c * LD + tx + 8 * jj];
          const float qv = Qs[c * LD + tx + 8 * jj];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv[i][jj] = fmaf(pv[i], ov, dv[i][jj]);
            dk[i][jj] = fmaf(sv[i], qv, dk[i][jj]);
          }
        }
      }
    }
  }

  float* dkp = static_cast<float*>(a.dk) + b * a.dks.b + kvh * a.dks.h;
  float* dvp = static_cast<float*>(a.dv) + b * a.dvs.b + kvh * a.dvs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k0 + ty + 16 * i;
    if (s >= a.Sk) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      dkp[s * a.dks.s + tx + 8 * jj] = __fmul_rn(dk[i][jj], a.scale);
      dvp[s * a.dvs.s + tx + 8 * jj] = dv[i][jj];
    }
  }
}

template <int HD>
constexpr int dq_f32_floats() {
  // Q, dO, K, V padded to HD + 1; dS; lse and D.
  return 2 * BQ * (HD + 1) + 2 * KF * (HD + 1) + BQ * (KF + 1) + 2 * BQ;
}

// A block per (b, h, 64-row query tile): thread (ty, tx) owns rows
// ty + 16 i (i < 4), keys tx + 8 j (j < 4) of a 32-key step, and the dQ
// columns tx + 8 jj.
template <int HD>
__global__ void __launch_bounds__(THREADS) dq_f32(const Args a) {
  constexpr int LD = HD + 1, DJ = HD / 8, LP = KF + 1;
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][LD]
  float* Os = Qs + BQ * LD;     // dO, [BQ][LD]
  float* Ks = Os + BQ * LD;     // [KF][LD]
  float* Vs = Ks + KF * LD;     // [KF][LD]
  float* Ss = Vs + KF * LD;     // dS, [BQ][LP]
  float* Ls = Ss + BQ * LP;     // lse, [BQ]
  float* Dl = Ls + BQ;          // D, [BQ]

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int n_bh = a.B * a.H, n_qt = (a.Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x % n_bh;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / n_bh) * BQ;
  const int b = bh / a.H, h = bh % a.H, kvh = h / (a.H / a.KV);
  const float* qp = static_cast<const float*>(a.q) + b * a.qs.b + h * a.qs.h;
  const float* op = static_cast<const float*>(a.dout) + b * a.dos.b +
                    h * a.dos.h;
  const float* kp = static_cast<const float*>(a.k) + b * a.ks.b +
                    kvh * a.ks.h;
  const float* vp = static_cast<const float*>(a.v) + b * a.vs.b +
                    kvh * a.vs.h;
  const long long row0 = static_cast<long long>(bh) * a.Sq;
  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD, s = q0 + r;
    const bool in = s < a.Sq;
    Qs[r * LD + d] = in ? qp[s * a.qs.s + d] : 0.f;
    Os[r * LD + d] = in ? op[s * a.dos.s + d] : 0.f;
  }
  for (int r = tid; r < BQ; r += THREADS) {
    const bool in = q0 + r < a.Sq;
    Ls[r] = in ? a.lse[row0 + q0 + r] : CUDART_INF_F;
    Dl[r] = in ? a.delta[row0 + q0 + r] : 0.f;
  }

  float dq[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dq[i][jj] = 0.f;

  const int2 kr = key_tiles(q0, BQ, KF, a.Sq, a.Sk, a.causal, a.window);
  for (int kt = kr.x; kt < kr.y; ++kt) {
    const int k0 = kt * KF;
    __syncthreads();   // the previous step's K, V and dS are no longer read
    for (int i = tid; i < KF * HD; i += THREADS) {
      const int r = i / HD, d = i % HD, s = k0 + r;
      const bool in = s < a.Sk;
      Ks[r * LD + d] = in ? kp[s * a.ks.s + d] : 0.f;
      Vs[r * LD + d] = in ? vp[s * a.vs.s + d] : 0.f;
    }
    __syncthreads();

    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * LD + d];
        ov[i] = Os[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 8 * j) * LD + d];
        vv[j] = Vs[(tx + 8 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = attends(q0 + r, k0 + tx + 8 * j, a.Sq, a.Sk,
                                a.causal, a.window)
                            ? expf(fmaf(sc[i][j], a.scale, -Ls[r]))
                            : 0.f;
        Ss[r * LP + tx + 8 * j] = __fmul_rn(p, dp[i][j] - Dl[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < KF; ++c) {
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = Ss[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const float kv = Ks[c * LD + tx + 8 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][jj] = fmaf(sv[i], kv, dq[i][jj]);
      }
    }
  }

  float* dqp = static_cast<float*>(a.dq) + b * a.dqs.b + h * a.dqs.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= a.Sq) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj)
      dqp[s * a.dqs.s + tx + 8 * jj] = __fmul_rn(dq[i][jj], a.scale);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma, TMA ring, warp specialisation
// ---------------------------------------------------------------------------

namespace wb {

using namespace wg;

constexpr int BKV = 128;       // keys of a dK/dV block (two consumers)
constexpr int BQ = 128;        // query rows of a dQ block (two consumers)
constexpr int KT = 64;         // keys a dQ step; rows of a K or V box
constexpr int CR = 64;         // rows a consumer owns
constexpr int STAGES = 4;      // ring depth
constexpr int GH = 8;          // (b, head) pairs of a group of the grid
constexpr int THREADS = 384;   // producer + two consumer warpgroups

// dK/dV's query step, and the rows of a Q or dO box: 64 up to hd 80, 32
// above (dK and dV hold hd floats a thread, S^T and dP^T QT / 2 each).
template <int HD>
constexpr int QT = HD <= 80 ? 64 : 32;

struct Perm {
  int q, k, v, o;   // Coords permutation of each map (o: dO)
};

// dK/dV's shared memory, in bytes from a 1024-aligned base: K and V
// (128 rows), then the ring's Q, dO, lse (log2 units) and D stages.
template <int HD>
struct DkvSmem {
  static constexpr int KV_BYTES = BKV * HD * 2;
  static constexpr int QS_BYTES = QT<HD> * HD * 2;   // a Q or dO stage
  static constexpr int K = 0;
  static constexpr int V = K + KV_BYTES;
  static constexpr int Q = V + KV_BYTES;
  static constexpr int O = Q + STAGES * QS_BYTES;
  static constexpr int LSE = O + STAGES * QS_BYTES;
  static constexpr int DEL = LSE + STAGES * QT<HD> * 4;
  static constexpr int BAR = DEL + STAGES * QT<HD> * 4;  // full, empty, kv
  static constexpr int BYTES = BAR + (2 * STAGES + 1) * 8;
};

// dQ's: Q and dO (128 rows), then the ring's K and V stages.
template <int HD>
struct DqSmem {
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KS_BYTES = KT * HD * 2;   // a K or V stage
  static constexpr int Q = 0;
  static constexpr int O = Q + Q_BYTES;
  static constexpr int K = O + Q_BYTES;
  static constexpr int V = K + STAGES * KS_BYTES;
  static constexpr int BAR = V + STAGES * KS_BYTES;  // full, empty, q
  static constexpr int BYTES = BAR + (2 * STAGES + 1) * 8;
};

// K-major descriptor of box j of a tile of `rows` rows, from row r0.
__device__ __forceinline__ uint64_t kmaj(uint32_t tile, int rows, int j,
                                         int r0) {
  return desc(tile + (j * rows + r0) * ROW_BYTES, 16, 8 * ROW_BYTES);
}

// MN-major descriptor of k-step kk (rows 16 kk ..) of a tile of `rows`
// rows: 16-column atoms one box apart.
__device__ __forceinline__ uint64_t mnmaj(uint32_t tile, int rows, int kk) {
  return desc(tile + kk * 16 * ROW_BYTES, rows * ROW_BYTES, 8 * ROW_BYTES);
}

// Block i's (tile rank, pair) in a grid of n_pairs (b, head) pairs by
// n_tiles tiles: groups of GH pairs in turn and, within a group, tile rank
// by tile rank, every pair of a rank before the next.  The blocks in flight
// together (about a wave, 132 of them) then stream the tiles of a few heads,
// which stay in L2, and the group's longest causal tiles start first.
__device__ __forceinline__ int2 grid_order(int i, int n_pairs, int n_tiles) {
  const int g = i / (GH * n_tiles);
  const int size = min(GH, n_pairs - g * GH);
  const int local = i - g * GH * n_tiles;
  return make_int2(local / size, g * GH + local % size);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
dkv_wgmma(const __grid_constant__ CUtensorMap qmap,
          const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap,
          const __grid_constant__ CUtensorMap omap, Perm perm,
          const Args a) {
  using L = DkvSmem<HD>;
  constexpr int Q_T = QT<HD>, NB = HD / BOX, SN = Q_T / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gen = smem_raw + (base - raw);   // the same bytes, generic
  const uint32_t sK = base + L::K, sV = base + L::V;
  const uint32_t sQ = base + L::Q, sO = base + L::O;
  float* Ls = reinterpret_cast<float*>(gen + L::LSE);   // [STAGES][QT]
  float* Ds = reinterpret_cast<float*>(gen + L::DEL);   // [STAGES][QT]
  const uint32_t bar_full = base + L::BAR;
  const uint32_t bar_empty = bar_full + 8 * STAGES;
  const uint32_t bar_kv = bar_empty + 8 * STAGES;

  // Key tiles in order within a group of heads: the longest causal first.
  const int2 at = grid_order(blockIdx.x, a.B * a.KV, (a.Sk + BKV - 1) / BKV);
  const int k0 = at.x * BKV;
  const int b = at.y / a.KV, kvh = at.y % a.KV;
  const int G = a.H / a.KV;
  const int2 qr = query_tiles(k0, BKV, Q_T, a.Sq, a.Sk, a.causal, a.window);
  const int nq = qr.y - qr.x, n_it = G * nq;
  // Step it: query head kvh G + it / nq, query tile qr.x + it % nq.

  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1 + 32);   // the copies; lse and D
      mbar_init(bar_empty + 8 * s, 2 * 128);   // every consumer thread
    }
    mbar_init(bar_kv, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // Lowered to 40, not 24: warp 1 computes addresses too.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0 && n_it > 0) {
      // K and V once: 64-row boxes, none wholly past Sk.
      const int halves = a.Sk - k0 > KT ? 2 : 1;
      mbar_expect_tx(bar_kv, halves * 2 * KT * HD * 2);
      for (int r = 0; r < halves; ++r) {
        const Coords ck = order(perm.k, k0 + r * KT, kvh, b);
        const Coords cv = order(perm.v, k0 + r * KT, kvh, b);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const uint32_t off = (j * BKV + r * KT) * ROW_BYTES;
          tma_load(sK + off, &kmap, bar_kv, j * BOX, ck.c1, ck.c2, ck.c3);
          tma_load(sV + off, &vmap, bar_kv, j * BOX, cv.c1, cv.c2, cv.c3);
        }
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(bar_empty + 8 * s, (it / STAGES - 1) & 1);
        const int h = kvh * G + it / nq, q0 = (qr.x + it % nq) * Q_T;
        const Coords cq = order(perm.q, q0, h, b);
        const Coords co = order(perm.o, q0, h, b);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * L::QS_BYTES);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const uint32_t off = s * L::QS_BYTES + j * Q_T * ROW_BYTES;
          tma_load(sQ + off, &qmap, full, j * BOX, cq.c1, cq.c2, cq.c3);
          tma_load(sO + off, &omap, full, j * BOX, co.c1, co.c2, co.c3);
        }
      }
    } else if (tid >= 32) {
      // Warps 1-3, a step each in turn: the step's lse (log2 units; +inf
      // past Sq, so P = 0 there) and D (0 past Sq) beside the copies,
      // loaded before the stage is free, so that three loads are in flight
      // and none waits on a release.
      const int lane = tid & 31;
      for (int it = tid / 32 - 1; it < n_it; it += 3) {
        const int s = it % STAGES;
        const int h = kvh * G + it / nq, q0 = (qr.x + it % nq) * Q_T;
        const long long row0 = (static_cast<long long>(b) * a.H + h) * a.Sq;
        float lv[Q_T / 32], dl[Q_T / 32];
#pragma unroll
        for (int i = 0; i < Q_T / 32; ++i) {
          const int q = q0 + lane + 32 * i;
          lv[i] = q < a.Sq ? a.lse[row0 + q] * LOG2E : CUDART_INF_F;
          dl[i] = q < a.Sq ? a.delta[row0 + q] : 0.f;
        }
        if (it >= STAGES) mbar_wait(bar_empty + 8 * s, (it / STAGES - 1) & 1);
#pragma unroll
        for (int i = 0; i < Q_T / 32; ++i) {
          Ls[s * Q_T + lane + 32 * i] = lv[i];
          Ds[s * Q_T + lane + 32 * i] = dl[i];
        }
        mbar_arrive(bar_full + 8 * s);
      }
    }
  } else {
    // Consumer c owns keys k0 + 64 c .. + 63; warp w of it keys 16 w ..
    // 16 w + 15 of those, as wgmma lays out the rows of S^T.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int c = tid / 128 - 1, t128 = tid & 127;
    const int warp = t128 >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int kc = k0 + CR * c, kw = kc + 16 * warp;
    const bool live = kc < a.Sk;
    const float scale2 = a.scale * LOG2E;

    float dka[HD / 2], dva[HD / 2];
    zero(dka);
    zero(dva);
    // The stage whose release waits for this consumer's last dV and dK
    // products (still in flight while the next step's S^T and dP^T are
    // issued), or -1.
    int owed = -1;
    // S^T and dP^T, each step's first k-step overwriting them.
    float st[SN], dpt[SN];
    zero(st);
    zero(dpt);
    if (n_it > 0) mbar_wait(bar_kv, 0);
    for (int it = 0, qi = 0; it < n_it;
         ++it, qi = qi + 1 == nq ? 0 : qi + 1) {
      const int s = it % STAGES;
      const int q0 = (qr.x + qi) * Q_T;
      mbar_wait(bar_full + 8 * s, (it / STAGES) & 1);
      // A step masked for all of this consumer's keys is only released.
      const bool skip = !live || (a.causal && q0 + Q_T - 1 < kc) ||
                        (a.window > 0 && q0 >= kc + CR - 1 + a.window);
      if (skip) {
        if (owed >= 0) {
          wgmma_wait0();
          fence_regs(dva);
          fence_regs(dka);
          mbar_arrive(bar_empty + 8 * owed);
          owed = -1;
        }
        mbar_arrive(bar_empty + 8 * s);
        continue;
      }
      const uint32_t sQs = sQ + s * L::QS_BYTES;
      const uint32_t sOs = sO + s * L::QS_BYTES;
      const float* Lb = Ls + s * Q_T;
      const float* Db = Ds + s * Q_T;
      // S^T = K Q^T, then dP^T = V dO^T: 64 keys x QT queries each, hd /
      // 16 k-steps of one box, in two commit groups.
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NB; ++j)
        wgmma_ss<Q_T>(st, kmaj(sK, BKV, j, CR * c), kmaj(sQs, Q_T, j, 0),
                      j > 0);
      wgmma_commit();
#pragma unroll
      for (int j = 0; j < NB; ++j)
        wgmma_ss<Q_T>(dpt, kmaj(sV, BKV, j, CR * c), kmaj(sOs, Q_T, j, 0),
                      j > 0);
      wgmma_commit();
      wgmma_wait1();   // the last step's dV, dK and this S^T are done
      fence_regs(st);
      if (owed >= 0) mbar_arrive(bar_empty + 8 * owed);

      // P^T: st[4 n + e] is (key kw + g + 8 (e >> 1), query q0 + 8 n + 2 t
      // + (e & 1)); masks only where this warp's keys meet an edge of the
      // band or of the sequences (a uniform branch: the mask's compares
      // are not paid elsewhere).  As A operands, n-tile n is k-step n / 2,
      // columns 8 (n & 1) of it (the accumulator's layout is the register
      // A operand's).
      const bool full = kw + 15 < a.Sk && (!a.causal || q0 >= kw + 15) &&
                        (a.window <= 0 || q0 + Q_T - 1 < kw + a.window);
      if (full) {
#pragma unroll
        for (int n = 0; n < Q_T / 8; ++n) {
          const float2 l = *reinterpret_cast<const float2*>(Lb + 8 * n + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            st[4 * n + e] =
                ex2(fmaf(st[4 * n + e], scale2, (e & 1) ? -l.y : -l.x));
        }
      } else {
#pragma unroll
        for (int n = 0; n < Q_T / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * n + 2 * t + (e & 1);
            st[4 * n + e] =
                attends(q0 + col, kw + g + 8 * (e >> 1), a.Sq, a.Sk,
                        a.causal, a.window)
                    ? ex2(fmaf(st[4 * n + e], scale2, -Lb[col]))
                    : 0.f;
          }
      }
      uint32_t pa[Q_T / 16][4];
#pragma unroll
      for (int n = 0; n < Q_T / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          pa[n >> 1][2 * (n & 1) + r] = pack(st[4 * n + 2 * r],
                                             st[4 * n + 2 * r + 1]);
      // dV += P^T dO, dO an MN-major B operand of the stage S^T read
      // K-major, while dP^T finishes.
      fence_regs(dva);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Q_T / 16; ++kk)
        wgmma_rs<HD>(dva, pa[kk], mnmaj(sOs, Q_T, kk));
      wgmma_commit();
      wgmma_wait1();   // dP^T is done
      fence_regs(dpt);

      // dS^T = P^T (dP^T - D), then dK += dS^T Q (Q MN-major).
      uint32_t sa[Q_T / 16][4];
#pragma unroll
      for (int n = 0; n < Q_T / 8; ++n) {
        const float2 d = *reinterpret_cast<const float2*>(Db + 8 * n + 2 * t);
#pragma unroll
        for (int r = 0; r < 2; ++r)
          sa[n >> 1][2 * (n & 1) + r] =
              pack(__fmul_rn(st[4 * n + 2 * r], dpt[4 * n + 2 * r] - d.x),
                   __fmul_rn(st[4 * n + 2 * r + 1],
                             dpt[4 * n + 2 * r + 1] - d.y));
      }
      fence_regs(dka);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Q_T / 16; ++kk)
        wgmma_rs<HD>(dka, sa[kk], mnmaj(sQs, Q_T, kk));
      wgmma_commit();
      owed = s;
    }
    wgmma_wait0();
    fence_regs(dva);
    fence_regs(dka);
    if (owed >= 0) mbar_arrive(bar_empty + 8 * owed);

    // dka[4 n + e] is (key kw + g + 8 (e >> 1), column 8 n + 2 t + (e & 1)).
    bf16* dkp = static_cast<bf16*>(a.dk) + b * a.dks.b + kvh * a.dks.h;
    bf16* dvp = static_cast<bf16*>(a.dv) + b * a.dvs.b + kvh * a.dvs.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = kw + g + 8 * r;
      if (key >= a.Sk) continue;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const int col = 8 * n + 2 * t;
        *reinterpret_cast<uint32_t*>(dkp + key * a.dks.s + col) =
            pack(__fmul_rn(dka[4 * n + 2 * r], a.scale),
                 __fmul_rn(dka[4 * n + 2 * r + 1], a.scale));
        *reinterpret_cast<uint32_t*>(dvp + key * a.dvs.s + col) =
            pack(dva[4 * n + 2 * r], dva[4 * n + 2 * r + 1]);
      }
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
dq_wgmma(const __grid_constant__ CUtensorMap qmap,
         const __grid_constant__ CUtensorMap kmap,
         const __grid_constant__ CUtensorMap vmap,
         const __grid_constant__ CUtensorMap omap, Perm perm, const Args a) {
  using L = DqSmem<HD>;
  constexpr int Q_T = QT<HD>, NB = HD / BOX, SN = KT / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base + L::Q, sO = base + L::O;
  const uint32_t sK = base + L::K, sV = base + L::V;
  const uint32_t bar_full = base + L::BAR;
  const uint32_t bar_empty = bar_full + 8 * STAGES;
  const uint32_t bar_q = bar_empty + 8 * STAGES;

  // Query tiles from the last within a group of heads: the longest causal
  // first.
  const int n_qt = (a.Sq + BQ - 1) / BQ;
  const int2 at = grid_order(blockIdx.x, a.B * a.H, n_qt);
  const int bh = at.y;
  const int q0 = (n_qt - 1 - at.x) * BQ;
  const int b = bh / a.H, h = bh % a.H, kvh = h / (a.H / a.KV);
  const int2 kr = key_tiles(q0, BQ, KT, a.Sq, a.Sk, a.causal, a.window);
  const int n_it = max(kr.y - kr.x, 0);

  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * 128);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0 && n_it > 0) {
      // Q and dO once, in boxes of QT rows; none wholly past Sq.
      const int pieces = min(BQ / Q_T, (a.Sq - q0 + Q_T - 1) / Q_T);
      mbar_expect_tx(bar_q, pieces * 2 * Q_T * HD * 2);
      for (int r = 0; r < pieces; ++r) {
        const Coords cq = order(perm.q, q0 + r * Q_T, h, b);
        const Coords co = order(perm.o, q0 + r * Q_T, h, b);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const uint32_t off = (j * BQ + r * Q_T) * ROW_BYTES;
          tma_load(sQ + off, &qmap, bar_q, j * BOX, cq.c1, cq.c2, cq.c3);
          tma_load(sO + off, &omap, bar_q, j * BOX, co.c1, co.c2, co.c3);
        }
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(bar_empty + 8 * s, (it / STAGES - 1) & 1);
        const int k0 = (kr.x + it) * KT;
        const Coords ck = order(perm.k, k0, kvh, b);
        const Coords cv = order(perm.v, k0, kvh, b);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * L::KS_BYTES);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const uint32_t off = s * L::KS_BYTES + j * KT * ROW_BYTES;
          tma_load(sK + off, &kmap, full, j * BOX, ck.c1, ck.c2, ck.c3);
          tma_load(sV + off, &vmap, full, j * BOX, cv.c1, cv.c2, cv.c3);
        }
      }
    }
  } else {
    // Consumer c owns query rows q0 + 64 c .. + 63; warp w of it rows
    // 16 w .. 16 w + 15 of those.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int c = tid / 128 - 1, t128 = tid & 127;
    const int warp = t128 >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + CR * c, w0 = r0 + 16 * warp;
    const int row[2] = {w0 + g, w0 + g + 8};
    const bool live = r0 < a.Sq;
    const float scale2 = a.scale * LOG2E;

    // This thread's rows: lse in log2 units (+inf past Sq), and D.
    float lse2[2], dl[2];
    const long long row0 = static_cast<long long>(bh) * a.Sq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse2[r] = row[r] < a.Sq ? a.lse[row0 + row[r]] * LOG2E : CUDART_INF_F;
      dl[r] = row[r] < a.Sq ? a.delta[row0 + row[r]] : 0.f;
    }

    float dqa[HD / 2];
    zero(dqa);
    int owed = -1;   // the stage the last dQ products still read, or -1
    // S and dP, each step's first k-step overwriting them.
    float sc[SN], dp[SN];
    zero(sc);
    zero(dp);
    if (n_it > 0) mbar_wait(bar_q, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % STAGES;
      const int k0 = (kr.x + it) * KT;
      mbar_wait(bar_full + 8 * s, (it / STAGES) & 1);
      const bool skip = !live || (a.causal && k0 > r0 + CR - 1) ||
                        (a.window > 0 && k0 + KT - 1 <= r0 - a.window);
      if (skip) {
        if (owed >= 0) {
          wgmma_wait0();
          fence_regs(dqa);
          mbar_arrive(bar_empty + 8 * owed);
          owed = -1;
        }
        mbar_arrive(bar_empty + 8 * s);
        continue;
      }
      const uint32_t sKs = sK + s * L::KS_BYTES;
      const uint32_t sVs = sV + s * L::KS_BYTES;
      // S = Q K^T, then dP = dO V^T: 64 rows x 64 keys each.
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NB; ++j)
        wgmma_ss_n64(sc, kmaj(sQ, BQ, j, CR * c), kmaj(sKs, KT, j, 0), j > 0);
      wgmma_commit();
#pragma unroll
      for (int j = 0; j < NB; ++j)
        wgmma_ss_n64(dp, kmaj(sO, BQ, j, CR * c), kmaj(sVs, KT, j, 0), j > 0);
      wgmma_commit();
      wgmma_wait1();   // the last step's dQ and this S are done
      fence_regs(sc);
      if (owed >= 0) mbar_arrive(bar_empty + 8 * owed);

      // P: sc[4 n + e] is (row[e >> 1], key k0 + 8 n + 2 t + (e & 1)).
      const bool full = k0 + KT <= a.Sk && (!a.causal || k0 + KT - 1 <= w0) &&
                        (a.window <= 0 || k0 > w0 + 15 - a.window);
      if (full) {
#pragma unroll
        for (int i = 0; i < SN; ++i)
          sc[i] = ex2(fmaf(sc[i], scale2, -lse2[(i >> 1) & 1]));
      } else {
#pragma unroll
        for (int n = 0; n < KT / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * n + e] =
                attends(row[e >> 1], k0 + 8 * n + 2 * t + (e & 1), a.Sq,
                        a.Sk, a.causal, a.window)
                    ? ex2(fmaf(sc[4 * n + e], scale2, -lse2[e >> 1]))
                    : 0.f;
      }
      wgmma_wait0();
      fence_regs(dp);

      // dS = P (dP - D) as the A operand of dQ += dS K, K read MN-major;
      // its products run on while the next step's are issued.
      uint32_t sa[KT / 16][4];
#pragma unroll
      for (int n = 0; n < KT / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          sa[n >> 1][2 * (n & 1) + r] =
              pack(__fmul_rn(sc[4 * n + 2 * r], dp[4 * n + 2 * r] - dl[r]),
                   __fmul_rn(sc[4 * n + 2 * r + 1],
                             dp[4 * n + 2 * r + 1] - dl[r]));
      fence_regs(dqa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
        wgmma_rs<HD>(dqa, sa[kk], mnmaj(sKs, KT, kk));
      wgmma_commit();
      owed = s;
    }
    wgmma_wait0();
    fence_regs(dqa);
    if (owed >= 0) mbar_arrive(bar_empty + 8 * owed);

    bf16* dqp = static_cast<bf16*>(a.dq) + b * a.dqs.b + h * a.dqs.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= a.Sq) continue;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<uint32_t*>(dqp + row[r] * a.dqs.s + 8 * n +
                                     2 * t) =
            pack(__fmul_rn(dqa[4 * n + 2 * r], a.scale),
                 __fmul_rn(dqa[4 * n + 2 * r + 1], a.scale));
    }
  }
}

}  // namespace wb

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename F>
cudaError_t allow_smem(F* kernel, int bytes, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) configured = true;
  return err;
}

// The bf16 kernels: four tensor maps a call, shared by both (Q and dO in
// boxes of QT rows, K and V of 64).
template <int HD>
int launch_bf16(const Args& a, cudaStream_t st) {
  CUtensorMap qm, km, vm, om;
  wb::Perm perm;
  if (make_map(&qm, &perm.q, a.q, a.B, a.H, a.Sq, HD, a.qs, wb::QT<HD>) ||
      make_map(&km, &perm.k, a.k, a.B, a.KV, a.Sk, HD, a.ks, wb::KT) ||
      make_map(&vm, &perm.v, a.v, a.B, a.KV, a.Sk, HD, a.vs, wb::KT) ||
      make_map(&om, &perm.o, a.dout, a.B, a.H, a.Sq, HD, a.dos, wb::QT<HD>))
    return -2;
  constexpr int kv_bytes = wb::DkvSmem<HD>::BYTES + 1024;   // + alignment
  constexpr int q_bytes = wb::DqSmem<HD>::BYTES + 1024;
  static bool kv_ok = false, q_ok = false;
  cudaError_t err;
  if ((err = allow_smem(wb::dkv_wgmma<HD>, kv_bytes, kv_ok)) != cudaSuccess ||
      (err = allow_smem(wb::dq_wgmma<HD>, q_bytes, q_ok)) != cudaSuccess)
    return (int)err;
  const unsigned kv_blocks = (a.Sk + wb::BKV - 1) / wb::BKV * a.B * a.KV;
  const unsigned q_blocks = (a.Sq + wb::BQ - 1) / wb::BQ * a.B * a.H;
  wb::dkv_wgmma<HD><<<kv_blocks, wb::THREADS, kv_bytes, st>>>(qm, km, vm, om,
                                                              perm, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wb::dq_wgmma<HD><<<q_blocks, wb::THREADS, q_bytes, st>>>(qm, km, vm, om,
                                                           perm, a);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(int dtype, const Args& a, cudaStream_t st) {
  const int n_kt = (a.Sk + BK - 1) / BK, n_qt = (a.Sq + BQ - 1) / BQ;
  const dim3 dgrid((a.Sq + 7) / 8, a.B * a.H);
  cudaError_t err;
  if (dtype == 1) {
    bwd_delta<bf16><<<dgrid, 256, 0, st>>>(a, HD);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    return launch_bf16<HD>(a, st);
  }
  const unsigned kv_blocks = n_kt * a.B * a.KV, q_blocks = n_qt * a.B * a.H;
  bwd_delta<float><<<dgrid, 256, 0, st>>>(a, HD);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  static bool kv_ok = false, q_ok = false;
  constexpr int kv_bytes = dkv_f32_floats<HD>() * 4;
  constexpr int q_bytes = dq_f32_floats<HD>() * 4;
  if ((err = allow_smem(dkv_f32<HD>, kv_bytes, kv_ok)) != cudaSuccess ||
      (err = allow_smem(dq_f32<HD>, q_bytes, q_ok)) != cudaSuccess)
    return (int)err;
  dkv_f32<HD><<<kv_blocks, THREADS, kv_bytes, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dq_f32<HD><<<q_blocks, THREADS, q_bytes, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dout, dq (B, H, Sq, hd); k, v, dk, dv (B, KV, Sk, hd), each given by
// its (b, h, s) element strides with a unit head-dim stride (in bfloat16
// also 16-byte aligned bases and strides); lse the forward's (B, H, Sq)
// float32 log-sum-exp and delta a float32 (B, H, Sq) scratch, both
// contiguous.  dtype 0 is float32, 1 bfloat16.  Writes dq, dk and dv in
// q's dtype.  Returns 0, a CUDA error code, -1 for an unsupported hd or
// dtype, or -2 if a bf16 tensor map could not be made.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, int dtype, int B, int H, int KV, int Sq, int Sk, int hd,
    int causal, int window, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, long long do_sb, long long do_sh, long long do_ss,
    long long dq_sb, long long dq_sh, long long dq_ss, long long dk_sb,
    long long dk_sh, long long dk_ss, long long dv_sb, long long dv_sh,
    long long dv_ss, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = static_cast<const float*>(lse);
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.delta = static_cast<float*>(delta);
  a.B = B;
  a.H = H;
  a.KV = KV;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.window = window;
  a.scale = 1.0f / sqrtf((float)hd);
  a.qs = {q_sb, q_sh, q_ss};
  a.ks = {k_sb, k_sh, k_ss};
  a.vs = {v_sb, v_sh, v_ss};
  a.os = {o_sb, o_sh, o_ss};
  a.dos = {do_sb, do_sh, do_ss};
  a.dqs = {dq_sb, dq_sh, dq_ss};
  a.dks = {dk_sb, dk_sh, dk_ss};
  a.dvs = {dv_sb, dv_sh, dv_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<32>(dtype, a, st);
    case 64:
      return launch<64>(dtype, a, st);
    case 80:
      return launch<80>(dtype, a, st);
    case 112:
      return launch<112>(dtype, a, st);
    case 128:
      return launch<128>(dtype, a, st);
    default:
      return -1;
  }
}
