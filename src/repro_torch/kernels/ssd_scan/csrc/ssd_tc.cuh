// Shared pieces of the bf16 SSD scan kernels (ssd_scan.cu, forward, and
// ssd_scan_bwd.cu, backward) for NVIDIA Hopper (sm_90a): the mma.sync and
// cp.async helpers, and pass 1, the chunk-parallel local states on the
// tensor cores, which the forward and the backward launch alike.  Each
// source includes it once.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace tc {

constexpr int T = 64;          // rows of a tile

typedef __nv_bfloat16 bf16;

constexpr int PAD = 8;         // bf16 row padding: conflict-free fragments
constexpr int THREADS1 = 256;  // chunk states: 8 warps

struct Args {
  const bf16* x;
  const bf16* b;
  const bf16* c;
  const float* a;     // (Bt, S, H), contiguous
  const float* dt;    // (Bt, S, H), contiguous
  bf16* y;            // (Bt, S, H, P), contiguous
  float* state;       // (Bt, H, P, N), contiguous, or null
  float* states;      // scratch (Bt, nc, H, P, N)
  float* acum;        // scratch (Bt, nc, H, q_pad)
  long long x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss;
  int H, S, P, N, Q, nc, q_pad;
};

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// (hi, lo) bf16 pairs of two float32 values: hi + lo keeps ~16 bits.
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi,
                                      uint32_t& lo) {
  hi = pack(v0, v1);
  const __nv_bfloat162 h2 = *reinterpret_cast<const __nv_bfloat162*>(&hi);
  lo = pack(v0 - __low2float(h2), v1 - __high2float(h2));
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

// Four 8 x 8 b16 matrices, transposed: lane l gives the address of row
// l % 8 of matrix l / 8; register i of lane (g, t) holds (rows 2t, 2t + 1;
// column g) of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// rows [r0, r0 + T) of a (.., S, cols) bf16 view at `base` (row stride
// `ss`) into shared [T][ld]; rows at or past `rows` (chunk-relative, with
// the chunk starting at `c0`) as zeros.
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* base,
                                          long long ss, int c0, int r0,
                                          int rows, int cols, int tid,
                                          int nthreads) {
  const int per_row = cols / 8;
  for (int e = tid; e < T * per_row; e += nthreads) {
    const int r = e / per_row, ch = e - r * per_row;
    const bool valid = r0 + r < rows;
    const bf16* src =
        valid ? base + (long long)(c0 + r0 + r) * ss + 8 * ch : base;
    cp16(dst + r * ld + 8 * ch, src, valid);
  }
}

// Two 8 x 8 b16 matrices, transposed: lanes 0-15 give the addresses (row
// l % 8 of matrix l / 8); the B fragment of one n-tile.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// 4 bytes global -> shared, asynchronously; zero where !valid.
__device__ __forceinline__ void cp4(float* dst, const float* src,
                                    bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// 2^x in one instruction (denormal results flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float LOG2E = 1.4426950408889634f;

// -- pass 1: chunk states ----------------------------------------------------
//
// Block (c, h, b).  acum = the inclusive scan of a over the chunk (q_pad
// rows, the padding a = 0), to scratch; then, over 64-row key tiles,
// local[p][n] = sum_s (w_s x[s][p]) B[s][n], w_s = exp(acum_last - acum_s)
// dt_s.  (w x)^T is the A operand: x^T by ldmatrix.trans of the [s][p]
// tile, scaled by w in registers and split into hi + lo; B is the B operand
// by ldmatrix.trans of the [s][n] tile.  Warp w owns the m-tile w % (P / 16)
// and the NTW n-tiles from NTW (w / (P / 16)).
//
// `rev` (the backward's state gradients): x is dy, B is C and w_l =
// exp(acum_l), so local[p][n] = sum_l exp(acum_l) dy[l][p] C[l][n]; acum is
// not written again.  The body of the forward's kernel and the backward's.
template <int NTW>
__device__ __forceinline__ void chunk_state_body(const Args& g, int b,
                                                 bool rev) {
  extern __shared__ float smem[];
  __shared__ float warp_sum[THREADS1 / 32];
  const int P = g.P, N = g.N, q_pad = g.q_pad;
  const int LX = P + PAD, LB = N + PAD;
  float* Ac = smem;                                    // [q_pad]
  float* W = Ac + q_pad;                               // [q_pad]
  bf16* Xs = reinterpret_cast<bf16*>(W + q_pad);       // [2][T][LX]
  bf16* Bs = Xs + 2 * T * LX;                          // [2][T][LB]

  const int c = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = c * g.Q, rows = min(g.Q, g.S - c0);
  const long long ao = (long long)b * g.S * g.H + h;
  const bf16* xb = g.x + b * g.x_sb + h * g.x_sh;
  const bf16* bb = g.b + b * g.b_sb;
  const int n_st = (rows + T - 1) / T;

  // The first key tile's loads go out before the scan.
  load_tile(Xs, LX, xb, g.x_ss, c0, 0, rows, P, tid, THREADS1);
  load_tile(Bs, LB, bb, g.b_ss, c0, 0, rows, N, tid, THREADS1);
  cp_commit();

  for (int l = tid; l < q_pad; l += THREADS1) {
    const bool in = l < rows;
    Ac[l] = in ? g.a[ao + (long long)(c0 + l) * g.H] : 0.f;
    W[l] = in ? g.dt[ao + (long long)(c0 + l) * g.H] : 0.f;
  }
  __syncthreads();
  // Inclusive scan of a over the chunk, 256 rows at a time.
  float carry = 0.f;
  for (int base = 0; base < q_pad; base += THREADS1) {
    const int l = base + tid;
    float v = l < q_pad ? Ac[l] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += t;
    }
    if (lane == 31) warp_sum[warp] = v;
    __syncthreads();
    float pre = carry, tot = carry;
#pragma unroll
    for (int w = 0; w < THREADS1 / 32; ++w) {
      if (w < warp) pre += warp_sum[w];
      tot += warp_sum[w];
    }
    if (l < q_pad) Ac[l] = v + pre;
    carry = tot;
    __syncthreads();
  }
  const float a_last = Ac[q_pad - 1];
  float* acum_out = g.acum + (((long long)b * g.nc + c) * g.H + h) * q_pad;
  for (int l = tid; l < q_pad; l += THREADS1) {
    if (rev) {
      W[l] = l < rows ? expf(Ac[l]) : 0.f;
    } else {
      acum_out[l] = Ac[l];
      W[l] = __fmul_rn(expf(a_last - Ac[l]), W[l]);
    }
  }

  const int MT = P / 16, NT = N / 8;
  const int mt = warp % MT, nt0 = (warp / MT) * NTW;
  const int t = lane & 3;
  float acc[NTW][4];
#pragma unroll
  for (int k = 0; k < NTW; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[k][e] = 0.f;

  for (int st = 0; st < n_st; ++st) {
    const int cur = st & 1;
    if (st + 1 < n_st) {
      load_tile(Xs + (cur ^ 1) * T * LX, LX, xb, g.x_ss, c0, (st + 1) * T,
                rows, P, tid, THREADS1);
      load_tile(Bs + (cur ^ 1) * T * LB, LB, bb, g.b_ss, c0, (st + 1) * T,
                rows, N, tid, THREADS1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();   // the tile is in; W is written
    if (nt0 < NT) {
      const bf16* Xc = Xs + cur * T * LX;
      const bf16* Bc = Bs + cur * T * LB;
      const float* w = W + st * T;
#pragma unroll
      for (int ks = 0; ks < T / 16; ++ks) {
        // x^T fragment: registers 0, 1 hold keys 16 ks + 2t, + 1; 2, 3
        // keys 16 ks + 2t + 8, + 9.
        uint32_t xa[4], ahi[4], alo[4];
        const int mi = lane >> 3;
        ldmatrix_x4_trans(xa, Xc + (16 * ks + (lane & 7) + 8 * (mi >> 1)) *
                                       LX + 16 * mt + 8 * (mi & 1));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int s = 16 * ks + 2 * t + ((i & 2) ? 8 : 0);
          const __nv_bfloat162 v =
              *reinterpret_cast<const __nv_bfloat162*>(&xa[i]);
          split(__fmul_rn(w[s], __low2float(v)),
                __fmul_rn(w[s + 1], __high2float(v)), ahi[i], alo[i]);
        }
        const int row = 16 * ks + (lane & 7) + 8 * ((lane >> 3) & 1);
        if constexpr (NTW == 1) {
          uint32_t bf[2];
          ldmatrix_x2_trans(bf, Bc + row * LB + 8 * nt0);
          mma(acc[0], ahi, bf[0], bf[1]);
          mma(acc[0], alo, bf[0], bf[1]);
        } else {
#pragma unroll
          for (int k = 0; k < NTW; k += 2) {
            if (nt0 + k < NT) {
              uint32_t bf[4];
              ldmatrix_x4_trans(bf, Bc + row * LB + 8 * (nt0 + k) +
                                        8 * (lane >> 4));
              mma(acc[k], ahi, bf[0], bf[1]);
              mma(acc[k], alo, bf[0], bf[1]);
              mma(acc[k + 1], ahi, bf[2], bf[3]);
              mma(acc[k + 1], alo, bf[2], bf[3]);
            }
          }
        }
      }
    }
    __syncthreads();   // this stage is free again
  }

  float* out = g.states + (((long long)b * g.nc + c) * g.H + h) * P * N;
  const int gq = lane >> 2;
#pragma unroll
  for (int k = 0; k < NTW; ++k) {
    const int nt = nt0 + k;
    if (nt < NT)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = 16 * mt + gq + 8 * r, n = 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(out + p * N + n) =
            make_float2(acc[k][2 * r], acc[k][2 * r + 1]);
      }
  }
}

// Shared bytes of pass 1.
inline int state_smem(const Args& g) {
  return 2 * g.q_pad * 4 + 2 * T * (g.P + PAD) * 2 + 2 * T * (g.N + PAD) * 2;
}

template <typename F>
cudaError_t allow_smem(F* kernel, int bytes, int& configured) {
  if (bytes <= configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) configured = bytes;
  return err;
}

// Pass 1's n-tiles per warp, ceil((N / 8) / (8 / (P / 16))).
inline int state_ntw(const Args& g) {
  return ((g.N / 8) * (g.P / 16) + 7) / 8;
}

}  // namespace tc
}  // namespace
