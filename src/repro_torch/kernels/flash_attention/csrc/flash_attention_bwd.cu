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
//   * dK, dV: a block per (b, kv head, 64-key tile).  It loops over the G
//     query heads in order and, for each, over the query tiles that hold an
//     unmasked pair with its keys (the forward's `key_tiles` turned around),
//     rebuilding S, P and dP from q, dO and lse; dK and dV stay in
//     registers;
//   * dQ: a block per (b, h, 64-row query tile) over its live key tiles,
//     rebuilding S, P and dP again: two more products a pair than an
//     atomic dQ, for determinism and no float32 scratch of dQ.
// Both grids start with the tiles that have the most causal work.
//
// Bound at stablelm-3b's training shape (B 8, H = KV = 32, S 2048, hd 80,
// causal, bf16): S, dP, dV, dK and dQ are 2 hd flops each a live pair,
// 10 hd in all: 8 x 32 x 2048 x 2049 / 2 x 800 = 430 GFLOP, 0.43 ms at
// 989 TFLOP/s; q, k, v, o, dO, dq, dk and dv once are 0.67 GB, 0.20 ms
// at 3.35 TB/s.  Operations bound it; this design issues 14 hd a pair.
//
// bfloat16: every product on the tensor cores, mma.sync m16n8k16 (bf16 in,
// float32 sums), fragments by ldmatrix from shared tiles padded by 8
// columns (conflict-free), filled by cp.async 16 bytes at a time (zeros
// past the ends), the next tile's copies in flight during the current
// one's products.  Each of a dK/dV block's 4 warps owns 16 keys: S^T =
// K Q^T and dP^T = V dO^T come out with keys as rows, so P^T and dS^T are
// already the A operand of dV += P^T dO and dK += dS^T Q, and dO and Q
// are B operands by ldmatrix.trans.  A dQ block's warps own 16 query rows;
// dS is the A operand of dQ += dS K.  P and dS are rounded once to bf16 as
// they enter their products (S and dP leave the tensor cores in float32;
// the products of bf16 inputs are exact).  P = 2^(S scale log2e - lse
// log2e) is one fma and one ex2.  float32: the CUDA cores, the same
// blocks, explicit fmaf throughout.
//
// The launcher requires unit head-dim strides and, in bfloat16, 16-byte
// aligned bases and strides of multiples of 8 elements (cp.async copies
// 16 bytes), as the forward's TMA does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BK = 64;         // keys of a dK/dV block; keys a dQ step (bf16)
constexpr int BQ = 64;         // query rows of a dQ block
constexpr int THREADS = 128;   // 4 warps
constexpr int QF = 32;         // float32 dK/dV: queries a step
constexpr int KF = 32;         // float32 dQ: keys a step
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, h, s;  // in elements; the head-dim stride is 1
};

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
// bfloat16: mma.sync m16n8k16 on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16 x 16, row) . b (16 x 8, col); with g = lane / 4, t = lane % 4:
// a = {(g, 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..)},
// b = {(k 2t.., n g), (k 2t + 8.., n g)},
// d = {(g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 b16 matrices: lane l gives the address of row l % 8 of
// matrix l / 8; register i of lane (g, t) holds (row g; columns 2t, 2t + 1)
// of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same, transposed: register i of lane (g, t) holds (rows 2t, 2t + 1;
// column g) of matrix i.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16 bytes global -> shared, asynchronously; zeros where !valid.
__device__ __forceinline__ void cp16(bf16* dst, const bf16* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x in one instruction (denormal results flush to 0; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows [r0, r0 + n) of a (.., S, HD) bf16 slice at `base` (row stride ss)
// into shared [n][HD + 8]; rows at or past S as zeros.
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base,
                                          long long ss, int r0, int n, int S,
                                          int tid) {
  constexpr int PER = HD / 8, LDS = HD + 8;
  for (int e = tid; e < n * PER; e += THREADS) {
    const int r = e / PER, c = e - r * PER;
    const bool valid = r0 + r < S;
    const bf16* src = valid ? base + (r0 + r) * ss + 8 * c : base;
    cp16(dst + r * LDS + 8 * c, src, valid);
  }
}

// A fragment (rows 16 w.., k-step ks) of a [..][HD + 8] tile.
template <int HD>
__device__ __forceinline__ void a_frag(uint32_t (&r)[4], const bf16* tile,
                                       int row0, int ks, int lane) {
  ldsm_x4(r, tile + (row0 + (lane & 15)) * (HD + 8) + 16 * ks +
                 8 * (lane >> 4));
}

// B fragments of n-tiles 2 np, 2 np + 1 (rows of the tile are n, columns
// k) at k-step ks: {b0, b1} of the first, {b2, b3} of the second.
template <int HD>
__device__ __forceinline__ void b_frag_nk(uint32_t (&r)[4], const bf16* tile,
                                          int np, int ks, int lane) {
  ldsm_x4(r, tile + (16 * np + (lane & 7) + 8 * (lane >> 4)) * (HD + 8) +
                 16 * ks + 8 * ((lane >> 3) & 1));
}

// The same with rows of the tile k and columns n (ldmatrix.trans).
template <int HD>
__device__ __forceinline__ void b_frag_kn(uint32_t (&r)[4], const bf16* tile,
                                          int np, int ks, int lane) {
  ldsm_x4_t(r, tile + (16 * ks + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                          (HD + 8) +
                   16 * np + 8 * (lane >> 4));
}

}  // namespace tc

// dK/dV's query step: 64 at hd <= 80, 32 above (registers: dK and dV hold
// hd floats a thread, S^T and dP^T the step's).
template <int HD>
constexpr int DKV_QT = HD <= 80 ? 64 : 32;

template <int HD>
constexpr int dkv_bf16_bytes() {
  // K, V; Q and dO double-buffered; lse (log2 units) and D double-buffered.
  return (2 * BK + 4 * DKV_QT<HD>) * (HD + 8) * 2 + 4 * DKV_QT<HD> * 4;
}

template <int HD>
__global__ void __launch_bounds__(THREADS) dkv_bf16(const Args a) {
  constexpr int LDS = HD + 8, QT = DKV_QT<HD>, NQ = QT / 8, ND = HD / 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // [BK][LDS]
  bf16* Vs = Ks + BK * LDS;                        // [BK][LDS]
  bf16* Qs = Vs + BK * LDS;                        // [2][QT][LDS]
  bf16* Os = Qs + 2 * QT * LDS;                    // dO, [2][QT][LDS]
  float* Ls = reinterpret_cast<float*>(Os + 2 * QT * LDS);   // [2][QT]
  float* Dl = Ls + 2 * QT;                                     // [2][QT]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_bk = a.B * a.KV;
  const int k0 = (blockIdx.x / n_bk) * BK;
  const int b = (blockIdx.x % n_bk) / a.KV, kvh = blockIdx.x % a.KV;
  const int G = a.H / a.KV;
  const float scale2 = a.scale * LOG2E;
  const int2 qr = query_tiles(k0, BK, QT, a.Sq, a.Sk, a.causal, a.window);
  const int nq = qr.y - qr.x, n_it = G * nq;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* dout = static_cast<const bf16*>(a.dout);

  // Step it: query head kvh G + it / nq, query tile qr.x + it % nq.
  auto issue = [&](int it, int buf) {
    const int h = kvh * G + it / nq, q0 = (qr.x + it % nq) * QT;
    tc::load_rows<HD>(Qs + buf * QT * LDS, q + b * a.qs.b + h * a.qs.h,
                      a.qs.s, q0, QT, a.Sq, tid);
    tc::load_rows<HD>(Os + buf * QT * LDS, dout + b * a.dos.b + h * a.dos.h,
                      a.dos.s, q0, QT, a.Sq, tid);
    const long long row0 = (static_cast<long long>(b) * a.H + h) * a.Sq;
    for (int r = tid; r < QT; r += THREADS) {
      const bool in = q0 + r < a.Sq;
      Ls[buf * QT + r] = in ? a.lse[row0 + q0 + r] * LOG2E : CUDART_INF_F;
      Dl[buf * QT + r] = in ? a.delta[row0 + q0 + r] : 0.f;
    }
  };

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  if (n_it > 0) {
    tc::load_rows<HD>(Ks, static_cast<const bf16*>(a.k) + b * a.ks.b +
                              kvh * a.ks.h,
                      a.ks.s, k0, BK, a.Sk, tid);
    tc::load_rows<HD>(Vs, static_cast<const bf16*>(a.v) + b * a.vs.b +
                              kvh * a.vs.h,
                      a.vs.s, k0, BK, a.Sk, tid);
    issue(0, 0);
    tc::cp_commit();
  }
  const int kw = 16 * warp;   // this warp's keys in the tile
  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) {
      issue(it + 1, buf ^ 1);
      tc::cp_commit();
      tc::cp_wait<1>();
    } else {
      tc::cp_wait<0>();
    }
    __syncthreads();   // this step's tiles (and K, V) are in
    const int q0 = (qr.x + it % nq) * QT;
    const bf16* Qb = Qs + buf * QT * LDS;
    const bf16* Ob = Os + buf * QT * LDS;
    const float* Lb = Ls + buf * QT;
    const float* Db = Dl + buf * QT;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x QT queries.
    float st[NQ][4], dpt[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t ka[4], va[4];
      tc::a_frag<HD>(ka, Ks, kw, ks, lane);
      tc::a_frag<HD>(va, Vs, kw, ks, lane);
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        uint32_t qb[4], ob[4];
        tc::b_frag_nk<HD>(qb, Qb, np, ks, lane);
        tc::b_frag_nk<HD>(ob, Ob, np, ks, lane);
        tc::mma(st[2 * np], ka, qb[0], qb[1]);
        tc::mma(st[2 * np + 1], ka, qb[2], qb[3]);
        tc::mma(dpt[2 * np], va, ob[0], ob[1]);
        tc::mma(dpt[2 * np + 1], va, ob[2], ob[3]);
      }
    }

    // P^T and dS^T (element e of n-tile n: key kw + g + 8 (e >> 1), query
    // 8 n + 2 t + (e & 1)); masks only where the step meets an edge.
    const bool full = k0 + BK <= a.Sk && q0 + QT <= a.Sq &&
                      (!a.causal || q0 >= k0 + BK - 1) &&
                      (a.window <= 0 || q0 + QT - 1 < k0 + a.window);
    uint32_t pa[NQ / 2][4], sa[NQ / 2][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1);
        p[e] = tc::ex2(fmaf(st[n][e], scale2, -Lb[c]));
        if (!full && !attends(q0 + c, k0 + kw + g + 8 * (e >> 1), a.Sq,
                              a.Sk, a.causal, a.window))
          p[e] = 0.f;
        ds[e] = __fmul_rn(p[e], dpt[n][e] - Db[c]);
      }
      // n-tile n is k-step n / 2, columns 8 (n & 1) of it.
      pa[n >> 1][2 * (n & 1)] = tc::pack(p[0], p[1]);
      pa[n >> 1][2 * (n & 1) + 1] = tc::pack(p[2], p[3]);
      sa[n >> 1][2 * (n & 1)] = tc::pack(ds[0], ds[1]);
      sa[n >> 1][2 * (n & 1) + 1] = tc::pack(ds[2], ds[3]);
    }

    // dV += P^T dO and dK += dS^T Q over this step's queries.
#pragma unroll
    for (int kk = 0; kk < NQ / 2; ++kk)
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        uint32_t ob[4], qb[4];
        tc::b_frag_kn<HD>(ob, Ob, np, kk, lane);
        tc::b_frag_kn<HD>(qb, Qb, np, kk, lane);
        tc::mma(dva[2 * np], pa[kk], ob[0], ob[1]);
        tc::mma(dva[2 * np + 1], pa[kk], ob[2], ob[3]);
        tc::mma(dka[2 * np], sa[kk], qb[0], qb[1]);
        tc::mma(dka[2 * np + 1], sa[kk], qb[2], qb[3]);
      }
    __syncthreads();   // the buffer is free for the step after next
  }

  bf16* dkp = static_cast<bf16*>(a.dk) + b * a.dks.b + kvh * a.dks.h;
  bf16* dvp = static_cast<bf16*>(a.dv) + b * a.dvs.b + kvh * a.dvs.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = k0 + kw + g + 8 * r;
    if (s >= a.Sk) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = 8 * n + 2 * t;
      *reinterpret_cast<uint32_t*>(dkp + s * a.dks.s + col) =
          tc::pack(__fmul_rn(dka[n][2 * r], a.scale),
                   __fmul_rn(dka[n][2 * r + 1], a.scale));
      *reinterpret_cast<uint32_t*>(dvp + s * a.dvs.s + col) =
          tc::pack(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

template <int HD>
constexpr int dq_bf16_bytes() {
  // Q and dO; K and V double-buffered.
  return (2 * BQ + 4 * BK) * (HD + 8) * 2;
}

template <int HD>
__global__ void __launch_bounds__(THREADS) dq_bf16(const Args a) {
  constexpr int LDS = HD + 8, NK = BK / 8, ND = HD / 8;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LDS]
  bf16* Os = Qs + BQ * LDS;                        // dO, [BQ][LDS]
  bf16* Ks = Os + BQ * LDS;                        // [2][BK][LDS]
  bf16* Vs = Ks + 2 * BK * LDS;                    // [2][BK][LDS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_bh = a.B * a.H, n_qt = (a.Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x % n_bh;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / n_bh) * BQ;
  const int b = bh / a.H, h = bh % a.H, kvh = h / (a.H / a.KV);
  const float scale2 = a.scale * LOG2E;
  const int2 kr = key_tiles(q0, BQ, BK, a.Sq, a.Sk, a.causal, a.window);
  const int n_it = kr.y - kr.x;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.ks.b + kvh * a.ks.h;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.vs.b + kvh * a.vs.h;
  const int qw = 16 * warp;   // this warp's rows in the tile

  // This thread's rows q0 + qw + g and + 8: lse in log2 units, and D.
  float lse2[2], dl[2];
  const long long row0 = static_cast<long long>(bh) * a.Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = q0 + qw + g + 8 * r;
    lse2[r] = s < a.Sq ? a.lse[row0 + s] * LOG2E : CUDART_INF_F;
    dl[r] = s < a.Sq ? a.delta[row0 + s] : 0.f;
  }

  auto issue = [&](int it, int buf) {
    const int k0 = (kr.x + it) * BK;
    tc::load_rows<HD>(Ks + buf * BK * LDS, kp, a.ks.s, k0, BK, a.Sk, tid);
    tc::load_rows<HD>(Vs + buf * BK * LDS, vp, a.vs.s, k0, BK, a.Sk, tid);
  };

  float dqa[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  if (n_it > 0) {
    tc::load_rows<HD>(Qs, static_cast<const bf16*>(a.q) + b * a.qs.b +
                              h * a.qs.h,
                      a.qs.s, q0, BQ, a.Sq, tid);
    tc::load_rows<HD>(Os, static_cast<const bf16*>(a.dout) + b * a.dos.b +
                              h * a.dos.h,
                      a.dos.s, q0, BQ, a.Sq, tid);
    issue(0, 0);
    tc::cp_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) {
      issue(it + 1, buf ^ 1);
      tc::cp_commit();
      tc::cp_wait<1>();
    } else {
      tc::cp_wait<0>();
    }
    __syncthreads();   // this step's K and V (and Q, dO) are in
    const int k0 = (kr.x + it) * BK;
    const bf16* Kb = Ks + buf * BK * LDS;
    const bf16* Vb = Vs + buf * BK * LDS;

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x BK keys.
    float sc[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t qa[4], oa[4];
      tc::a_frag<HD>(qa, Qs, qw, ks, lane);
      tc::a_frag<HD>(oa, Os, qw, ks, lane);
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t kb[4], vb[4];
        tc::b_frag_nk<HD>(kb, Kb, np, ks, lane);
        tc::b_frag_nk<HD>(vb, Vb, np, ks, lane);
        tc::mma(sc[2 * np], qa, kb[0], kb[1]);
        tc::mma(sc[2 * np + 1], qa, kb[2], kb[3]);
        tc::mma(dp[2 * np], oa, vb[0], vb[1]);
        tc::mma(dp[2 * np + 1], oa, vb[2], vb[3]);
      }
    }

    // dS (element e of n-tile n: row qw + g + 8 (e >> 1), key 8 n + 2 t +
    // (e & 1)) as the A operand of dQ += dS K.
    const bool full = k0 + BK <= a.Sk && q0 + BQ <= a.Sq &&
                      (!a.causal || q0 >= k0 + BK - 1) &&
                      (a.window <= 0 || q0 + BQ - 1 < k0 + a.window);
    uint32_t sa[NK / 2][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = tc::ex2(fmaf(sc[n][e], scale2, -lse2[r]));
        if (!full && !attends(q0 + qw + g + 8 * r, k0 + 8 * n + 2 * t +
                                                       (e & 1),
                              a.Sq, a.Sk, a.causal, a.window))
          p = 0.f;
        ds[e] = __fmul_rn(p, dp[n][e] - dl[r]);
      }
      sa[n >> 1][2 * (n & 1)] = tc::pack(ds[0], ds[1]);
      sa[n >> 1][2 * (n & 1) + 1] = tc::pack(ds[2], ds[3]);
    }
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk)
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        uint32_t kb[4];
        tc::b_frag_kn<HD>(kb, Kb, np, kk, lane);
        tc::mma(dqa[2 * np], sa[kk], kb[0], kb[1]);
        tc::mma(dqa[2 * np + 1], sa[kk], kb[2], kb[3]);
      }
    __syncthreads();   // the buffer is free for the step after next
  }

  bf16* dqp = static_cast<bf16*>(a.dq) + b * a.dqs.b + h * a.dqs.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = q0 + qw + g + 8 * r;
    if (s >= a.Sq) continue;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dqp + s * a.dqs.s + 8 * n + 2 * t) =
          tc::pack(__fmul_rn(dqa[n][2 * r], a.scale),
                   __fmul_rn(dqa[n][2 * r + 1], a.scale));
  }
}

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

template <int HD>
int launch(int dtype, const Args& a, cudaStream_t st) {
  const int n_kt = (a.Sk + BK - 1) / BK, n_qt = (a.Sq + BQ - 1) / BQ;
  const dim3 dgrid((a.Sq + 7) / 8, a.B * a.H);
  const unsigned kv_blocks = n_kt * a.B * a.KV, q_blocks = n_qt * a.B * a.H;
  cudaError_t err;
  if (dtype == 1) {
    bwd_delta<bf16><<<dgrid, 256, 0, st>>>(a, HD);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    static bool kv_ok = false, q_ok = false;
    constexpr int kv_bytes = dkv_bf16_bytes<HD>();
    constexpr int q_bytes = dq_bf16_bytes<HD>();
    if ((err = allow_smem(dkv_bf16<HD>, kv_bytes, kv_ok)) != cudaSuccess ||
        (err = allow_smem(dq_bf16<HD>, q_bytes, q_ok)) != cudaSuccess)
      return (int)err;
    dkv_bf16<HD><<<kv_blocks, THREADS, kv_bytes, st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    dq_bf16<HD><<<q_blocks, THREADS, q_bytes, st>>>(a);
    return (int)cudaGetLastError();
  }
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
// q's dtype.  Returns 0, a CUDA error code, or -1 for an unsupported hd or
// dtype.
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
