// Blocked flash-attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py
// `_kernel` (via `flash_attention_bhsd`): masked softmax(q k^T / sqrt(hd)) v
// per query row, with GQA (query head h reads kv head h / (H / KV)), causal
// and sliding-window masks, fully masked key tiles skipped, float32
// accumulation, and the input's dtype (float32 or bfloat16) out.
//
// Design.  One block of 128 threads (4 warps) owns one (batch, head, 64-row
// query tile); the grid covers every (b, h) cell at once.  A loop inside the
// block over 64-row key/value tiles takes the place of the TPU kernel's
// sequential `ik` grid axis: each tile is loaded once into shared memory,
// scored against the query tile, and folded into an online softmax whose
// running max, sum and output accumulator stay in registers.  Rows and
// columns past the sequence ends are masked, so any length works, and key
// tiles wholly outside the causal or window band are never loaded.  hd is a
// template parameter (32, 64, 80, 112, 128).
//
//   * bfloat16 (the serving path): tensor cores, mma.sync m16n8k16 with
//     float32 accumulation.  Warp w owns query rows 16 w .. 16 w + 15; its
//     q fragments stay in registers; K and V tiles sit row-major in shared
//     memory, V read through ldmatrix.trans.  The scores leave the tensor
//     cores in float32 and are scaled (in log2 units, for exp2f), masked
//     (edge tiles only) and exponentiated there; P goes back in as two bf16
//     halves (P = hi + lo, two products), so P.V keeps about 16 bits of P
//     and the kernel stays as close to the float32 plain version as the
//     float32 path.
//   * float32: CUDA cores.  Thread (ty, tx) = (tid / 8, tid % 8) owns query
//     rows ty + 16 i (i < 4), score columns tx + 8 j (j < 8) and output
//     columns tx + 8 jj; the eight lanes of a row reduce by warp shuffles.
//
// Every product is an explicit fmaf or mma, so the result does not depend on
// the shared -fmad=false build flag (which the bit-exact flex_score kernels
// need); attention is held to a tolerance, not to bits.
//
// Bound at the serving path's shapes (stablelm-3b prefill, B = 1, H = 32,
// hd = 80, causal): 4 (S^2 / 2) hd H operations, 21.5 GFLOP at S = 2048,
// over 989 TFLOP/s of bf16 tensor-core peak is 21.7 us; q, k, v and o once
// (41.9 MB) over 3.35 TB/s is 12.5 us.  Operations bound it.  The bf16 path
// spends 1.5x the minimum tensor-core work (the split P) and issues mma.sync
// with no copy/compute overlap; wgmma tiles, TMA loads and warp
// specialisation are the later work that would approach the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 128;  // 4 warps
constexpr float NEG = -1e30f;

struct Strides {
  long long b, h, s;  // in elements; the head-dim stride is 1
};

__device__ __forceinline__ bool attends(int row, int col, int Sk, int causal,
                                        int window) {
  return col < Sk && (!causal || col <= row) &&
         (window <= 0 || col > row - window);
}

// Key tiles [lo, hi) that hold an unmasked column for queries [q0, q0 + BQ).
__device__ __forceinline__ int2 key_tiles(int q0, int Sq, int Sk, int causal,
                                          int window) {
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int n_kt = (Sk + BK - 1) / BK;
  const int hi = causal ? min(n_kt, q_last / BK + 1) : n_kt;
  const int lo_col = window > 0 ? q0 - window + 1 : 0;
  return make_int2(lo_col > 0 ? lo_col / BK : 0, hi);
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

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int H,
              int G, int Sq, int Sk, int causal, int window, float scale,
              Strides qs, Strides ks, Strides vs, Strides os) {
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
  const int2 kt_range = key_tiles(q0, Sq, Sk, causal, window);

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
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16, float32 accumulation)
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);   // two bf16, 4-byte aligned
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16 x 16, row) . b (16 x 8, col); PTX fragment layouts, with
// g = lane / 4, t = lane % 4: a = {(g, 2t..), (g + 8, 2t..), (g, 2t + 8..),
// (g + 8, 2t + 8..)}, b = {(k 2t.., n g), (k 2t + 8.., n g)},
// d = {(g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float max4(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float sum4(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Four 8 x 8 b16 matrices from shared memory, transposed: lane l gives the
// address of row l % 8 of matrix l / 8, and register i of every lane holds
// (rows 2t, 2t + 1; column g) of matrix i, the B fragment of a row-major
// [k][n] tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, int H,
               int G, int Sq, int Sk, int causal, int window, float scale,
               Strides qs, Strides ks, Strides vs, Strides os) {
  constexpr int KS = HD / 16;   // k-steps of Q.K^T
  constexpr int DN = HD / 8;    // n-tiles of the output
  constexpr int LD = HD + 8;    // padded row: conflict-free fragment reads
  __shared__ __align__(16) bf16 Ks[BK * LD];   // [key][d]
  __shared__ __align__(16) bf16 Vs[BK * LD];   // [key][d]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / G;
  const bf16* qp = q + b * qs.b + h * qs.h;
  const bf16* kp = k + b * ks.b + kvh * ks.h;
  const bf16* vp = v + b * vs.b + kvh * vs.h;
  bf16* op = o + b * os.b + h * os.h;
  const int w0 = q0 + warp * 16;            // the warp's first query row
  const int row[2] = {w0 + g, w0 + g + 8};
  // Scores in log2 units: exp(x * scale) = exp2(x * scale * log2(e)).
  const float scale2 = scale * 1.4426950408889634f;

  uint32_t qa[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row[i & 1], d = 16 * s + 2 * t + ((i & 2) ? 8 : 0);
      qa[s][i] = r < Sq ? ld_pair(qp + r * qs.s + d) : 0u;
    }
  const int2 kt_range = key_tiles(q0, Sq, Sk, causal, window);

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = kt_range.x; kt < kt_range.y; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K and V are no longer read
    for (int i = tid; i < BK * HD / 2; i += THREADS) {
      const int r = i / (HD / 2), d = 2 * (i % (HD / 2)), s = k0 + r;
      const bool in = s < Sk;
      *reinterpret_cast<uint32_t*>(&Ks[r * LD + d]) =
          in ? ld_pair(kp + s * ks.s + d) : 0u;
      *reinterpret_cast<uint32_t*>(&Vs[r * LD + d]) =
          in ? ld_pair(vp + s * vs.s + d) : 0u;
    }
    __syncthreads();

    // S = Q K^T for the warp's 16 rows and the tile's 64 keys.
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
      const bf16* krow = &Ks[(8 * j + g) * LD + 2 * t];
#pragma unroll
      for (int s = 0; s < KS; ++s)
        mma(sc[j], qa[s], ld_pair(krow + 16 * s), ld_pair(krow + 16 * s + 8));
    }

    // Scale, mask (only where the tile meets an edge of the band or of
    // the sequence), online softmax over the rows g and g + 8.
    const bool full = k0 + BK <= Sk && (!causal || k0 + BK - 1 <= w0) &&
                      (window <= 0 || k0 > w0 + 15 - window);
    uint32_t ok = 0xffffffffu;
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] *= scale2;
        if (!full && !attends(row[e >> 1], k0 + 8 * j + 2 * t + (e & 1), Sk,
                              causal, window))
          ok &= ~(1u << (4 * j + e));
        else
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], max4(mx[r]));
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
    // P as A fragments of the P.V product: k-step kk covers keys
    // 16 kk .. 16 kk + 15, the score n-tiles 2 kk and 2 kk + 1.
    uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float p[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * r + c;
          p[c] = (ok >> (4 * j + e)) & 1u ? exp2f(sc[j][e] - m[r]) : 0.f;
          sum[r] += p[c];
        }
        const uint32_t hi = pack(p[0], p[1]);
        const __nv_bfloat162 h2 = *reinterpret_cast<const __nv_bfloat162*>(
            &hi);
        p_hi[j >> 1][2 * (j & 1) + r] = hi;
        p_lo[j >> 1][2 * (j & 1) + r] =
            pack(p[0] - __low2float(h2), p[1] - __high2float(h2));
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum4(sum[r]);
#pragma unroll
    for (int n = 0; n < DN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];

    // O += P V, with P = hi + lo; V's B fragments by ldmatrix.trans, two
    // output n-tiles (16 columns of d) per load.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < DN; n += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, &Vs[(16 * kk + ((lane >> 3) & 1) * 8 +
                                   (lane & 7)) * LD +
                                  8 * n + (lane >> 4) * 8]);
        mma(acc[n], p_hi[kk], vb[0], vb[1]);
        mma(acc[n], p_lo[kk], vb[0], vb[1]);
        mma(acc[n + 1], p_hi[kk], vb[2], vb[3]);
        mma(acc[n + 1], p_lo[kk], vb[2], vb[3]);
      }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < DN; ++n)
      *reinterpret_cast<uint32_t*>(op + row[r] * os.s + 8 * n + 2 * t) =
          pack(__fdiv_rn(acc[n][2 * r], denom),
               __fdiv_rn(acc[n][2 * r + 1], denom));
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int HD>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           int B, int H, int KV, int Sq, int Sk, int causal, int window,
           Strides qs, Strides ks, Strides vs, Strides os,
           cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  const float scale = 1.0f / sqrtf((float)HD);
  if (dtype == 1) {
    flash_fwd_bf16<HD><<<grid, THREADS, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), H, H / KV, Sq,
        Sk, causal, window, scale, qs, ks, vs, os);
    return (int)cudaGetLastError();
  }
  constexpr int bytes = f32_smem_floats<HD>() * (int)sizeof(float);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  flash_fwd_f32<HD><<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, H / KV, Sq,
      Sk, causal, window, scale, qs, ks, vs, os);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, Sq, hd), k and v (B, KV, Sk, hd), o (B, H, Sq, hd), each given by
// its (b, h, s) element strides with a unit head-dim stride (and, in
// bfloat16, even strides on 4-byte-aligned data).  dtype 0 is float32, 1
// bfloat16.  Returns 0, a CUDA error code, or -1 for an unsupported hd or
// dtype.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int KV, int Sq, int Sk, int hd, int causal, int window,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    void* stream) {
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return -1;
  switch (hd) {
    case 32:
      return launch<32>(dtype, q, k, v, o, B, H, KV, Sq, Sk, causal, window,
                        qs, ks, vs, os, st);
    case 64:
      return launch<64>(dtype, q, k, v, o, B, H, KV, Sq, Sk, causal, window,
                        qs, ks, vs, os, st);
    case 80:
      return launch<80>(dtype, q, k, v, o, B, H, KV, Sq, Sk, causal, window,
                        qs, ks, vs, os, st);
    case 112:
      return launch<112>(dtype, q, k, v, o, B, H, KV, Sq, Sk, causal, window,
                         qs, ks, vs, os, st);
    case 128:
      return launch<128>(dtype, q, k, v, o, B, H, KV, Sq, Sk, causal, window,
                         qs, ks, vs, os, st);
    default:
      return -1;
  }
}
