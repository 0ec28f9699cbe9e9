// Chunked SSD (Mamba2 state-space duality) scan forward for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py `_kernel`
// (via `ssd_scan_chunked`): per (batch, head), in chunks of Q positions,
//
//   y_l    = sum_{s <= l in the chunk} (C_l . B_s) exp(acum_l - acum_s) dt_s x_s
//          + exp(acum_l) (C_l . state^T)
//   state <- exp(acum_last) state + x^T ((exp(acum_last - acum) dt) (.) B)
//
// with acum the running sum of a = dt A inside the chunk, float32
// accumulation, y in the input's dtype (float32 or bfloat16) and, on
// request, the (P, N) float32 state after the last chunk (the TPU kernel's
// VMEM state scratch).  Heads share one (B, C) group (n_groups = 1).
//
// Design.  One block of 256 threads (16 x 16) owns one (batch, head) cell;
// the grid covers every cell at once.  A loop inside the block over the
// chunks, in order, takes the place of the TPU grid's sequential chunk
// axis, and the (P, N) state stays in shared memory across it.  Per chunk:
//
//   * a and dt of the chunk's rows go to shared memory, and a block scan
//     (warp shuffles, then the warps' totals) makes acum;
//   * a (Q, Q) float32 score block does not fit (256 KB at Q = 256), so the
//     intra-chunk form is tiled: 64-row query tiles against 64-row key
//     tiles, s <= l only (tiles above the diagonal are skipped; on the
//     diagonal the mask is applied before the exp, whose argument is large
//     and positive above it).  The score tile C_i B_j^T goes through shared
//     memory, is scaled by the decay and dt, and is multiplied into x_j;
//     the query tile's y stays in registers (thread (ty, tx) owns rows
//     ty + 16 i and columns tx + 16 p);
//   * the inter-chunk term reads the state before this chunk's update; the
//     last query tile then scales the state and adds x_j^T (w (.) B_j) for
//     each key tile it loads anyway (thread t owns state column t % N).
//
// Rows past the sequence end are loaded as zeros with a = dt = 0 (decay 1,
// no input), so any S works and the final state is the state after the
// last row; rows past S are not written.  Q is any value from 1 to 1024
// (a chunk of Q < 64 is one partly padded tile).  x, B and C are read
// through their (batch, position[, head]) strides with a unit stride along
// P or N, so the model's slices of one xBC tensor come in without copies.
// P is a template parameter (16, 32, 64, 128); N is 8, 16, 32, 64 or 128.
//
// Bound at the serving path's shapes (B = 1, Q = 256, S = 2048): per chunk
// the causal half of C B^T, Q (Q + 1) N operations, once for all heads
// (n_groups = 1), and per head the causal half of the scores times x,
// Q (Q + 1) P, and the two state products, 4 Q N P.  mamba2-370m (H = 32,
// P = 64, N = 128) does 3.29 GFLOP, 6.66 us at the 494.7 TFLOP/s dense
// TF32 peak, against 19.4 MB (x, B, C, a, dt and y once, state out) or
// 5.79 us at 3.35 TB/s: operations bound it.  zamba2-7b (H = 112, P = 64,
// N = 64) does 7.56 GFLOP, 15.3 us, against 62.9 MB or 18.8 us: bytes
// bound it.  This kernel runs the products on the float32 CUDA cores
// (67 TFLOP/s at most), recomputes C B^T for every head, and keeps 32 or
// 112 blocks busy on 132 SMs; tensor cores (wgmma) with TMA loads, a
// chunk-parallel split with a short state-passing pass, and one C B^T per
// chunk are the later work.
//
// Every product is an explicit fmaf or __fmul_rn, so the result does not
// depend on the shared -fmad=false build flag.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 64;          // rows of a query or key tile
constexpr int THREADS = 256;   // 16 x 16
constexpr int MAX_N = 128;
constexpr int MAX_Q = 1024;

struct Args {
  const void* x;
  const void* b;
  const void* c;
  const float* a;    // (Bt, S, H), contiguous
  const float* dt;   // (Bt, S, H), contiguous
  void* y;           // (Bt, S, H, P), contiguous, x's dtype
  float* state;      // (Bt, H, P, N), contiguous, or null
  long long x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss;
  int bf16, H, S, N, Q;
};

__device__ __forceinline__ float load(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

inline int smem_floats(int P, int N, int Q) {
  const int LN = N + 1;
  const int q_pad = (Q + T - 1) / T * T;
  return 2 * T * LN + T * P + T * (T + 1) + P * LN + 2 * q_pad + T;
}

template <int P>
__global__ void __launch_bounds__(THREADS) ssd_fwd(Args g) {
  constexpr int PJ = P / 16;                    // y columns per thread
  constexpr int KS = P * MAX_N / THREADS;       // most state rows per thread
  extern __shared__ float smem[];
  __shared__ float warp_sum[THREADS / 32];
  const int N = g.N, LN = N + 1, Q = g.Q, S = g.S;
  const int nt = (Q + T - 1) / T, q_pad = nt * T;
  float* Cs = smem;                // [T][LN]    C of the query tile
  float* Bs = Cs + T * LN;         // [T][LN]    B of the key tile
  float* Xs = Bs + T * LN;         // [T][P]     x of the key tile
  float* Ss = Xs + T * P;          // [T][T + 1] scores
  float* St = Ss + T * (T + 1);    // [P][LN]    the carried state
  float* Ac = St + P * LN;         // [q_pad]    acum of the chunk
  float* Dt = Ac + q_pad;          // [q_pad]    dt of the chunk
  float* Ws = Dt + q_pad;          // [T]        state-update weights

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / g.H, h = blockIdx.x % g.H;
  const long long xo = b * g.x_sb + h * g.x_sh;
  const long long bo = b * g.b_sb, co = b * g.c_sb;
  const long long ao = (long long)b * S * g.H + h;
  // The state elements this thread updates: column sn, rows sp + k * sk.
  const int sn = tid % N, sp = tid / N, sk = THREADS / N;

  for (int e = tid; e < P * LN; e += THREADS) St[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int rows = min(Q, S - c0);
    __syncthreads();   // the previous chunk no longer reads Ac, Dt, St
    for (int l = tid; l < q_pad; l += THREADS) {
      const bool in = l < rows;
      Ac[l] = in ? g.a[ao + (long long)(c0 + l) * g.H] : 0.f;
      Dt[l] = in ? g.dt[ao + (long long)(c0 + l) * g.H] : 0.f;
    }
    __syncthreads();
    // Inclusive scan of a over the chunk, 256 rows at a time.
    float carry = 0.f;
    for (int base = 0; base < q_pad; base += THREADS) {
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
      for (int w = 0; w < THREADS / 32; ++w) {
        if (w < warp) pre += warp_sum[w];
        tot += warp_sum[w];
      }
      if (l < q_pad) Ac[l] = v + pre;
      carry = tot;
      __syncthreads();
    }
    const float a_last = Ac[q_pad - 1];

    for (int i = 0; i < nt; ++i) {
      const bool last = i == nt - 1;
      for (int e = tid; e < T * N; e += THREADS) {
        const int r = e / N, n = e - r * N, l = i * T + r;
        Cs[r * LN + n] =
            l < rows ? load(g.c, co + (long long)(c0 + l) * g.c_ss + n, g.bf16)
                     : 0.f;
      }
      __syncthreads();

      // The inter-chunk term, from the state before this chunk's update.
      float acc[4][PJ];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int pp = 0; pp < PJ; ++pp) acc[ii][pp] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[PJ];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) cv[ii] = Cs[(ty + 16 * ii) * LN + n];
#pragma unroll
        for (int pp = 0; pp < PJ; ++pp) sv[pp] = St[(tx + 16 * pp) * LN + n];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int pp = 0; pp < PJ; ++pp)
            acc[ii][pp] = fmaf(cv[ii], sv[pp], acc[ii][pp]);
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float d = expf(Ac[i * T + ty + 16 * ii]);
#pragma unroll
        for (int pp = 0; pp < PJ; ++pp) acc[ii][pp] = __fmul_rn(d, acc[ii][pp]);
      }
      if (last) {
        __syncthreads();   // every thread has read the state
        const float d = expf(a_last);
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          const int p = sp + k * sk;
          if (p < P) St[p * LN + sn] = __fmul_rn(d, St[p * LN + sn]);
        }
      }

      for (int j = 0; j <= i; ++j) {
        __syncthreads();   // the previous key tile is no longer read
        for (int e = tid; e < T * N; e += THREADS) {
          const int r = e / N, n = e - r * N, s = j * T + r;
          Bs[r * LN + n] =
              s < rows
                  ? load(g.b, bo + (long long)(c0 + s) * g.b_ss + n, g.bf16)
                  : 0.f;
        }
        for (int e = tid; e < T * P; e += THREADS) {
          const int r = e / P, p = e - r * P, s = j * T + r;
          Xs[e] = s < rows
                      ? load(g.x, xo + (long long)(c0 + s) * g.x_ss + p, g.bf16)
                      : 0.f;
        }
        if (last && tid < T)
          Ws[tid] = __fmul_rn(expf(a_last - Ac[j * T + tid]), Dt[j * T + tid]);
        __syncthreads();

        // Scores of the tile pair: (C_l . B_s) exp(acum_l - acum_s) dt_s.
        float sc[4][4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) sc[ii][jj] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) cv[ii] = Cs[(ty + 16 * ii) * LN + n];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) bv[jj] = Bs[(tx + 16 * jj) * LN + n];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              sc[ii][jj] = fmaf(cv[ii], bv[jj], sc[ii][jj]);
        }
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int l = i * T + ty + 16 * ii, s = j * T + tx + 16 * jj;
            float v = 0.f;
            if (s <= l)   // masked before the exp
              v = __fmul_rn(__fmul_rn(sc[ii][jj], expf(Ac[l] - Ac[s])), Dt[s]);
            Ss[(ty + 16 * ii) * (T + 1) + tx + 16 * jj] = v;
          }
        __syncthreads();

#pragma unroll 4
        for (int s = 0; s < T; ++s) {
          float sv[4], xv[PJ];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) sv[ii] = Ss[(ty + 16 * ii) * (T + 1) + s];
#pragma unroll
          for (int pp = 0; pp < PJ; ++pp) xv[pp] = Xs[s * P + tx + 16 * pp];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int pp = 0; pp < PJ; ++pp)
              acc[ii][pp] = fmaf(sv[ii], xv[pp], acc[ii][pp]);
        }

        if (last) {
          float up[KS];
#pragma unroll
          for (int k = 0; k < KS; ++k) up[k] = 0.f;
#pragma unroll 2
          for (int s = 0; s < T; ++s) {
            const float wb = __fmul_rn(Ws[s], Bs[s * LN + sn]);
#pragma unroll
            for (int k = 0; k < KS; ++k) {
              const int p = sp + k * sk;
              if (p < P) up[k] = fmaf(wb, Xs[s * P + p], up[k]);
            }
          }
#pragma unroll
          for (int k = 0; k < KS; ++k) {
            const int p = sp + k * sk;
            if (p < P) St[p * LN + sn] += up[k];
          }
        }
      }

#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int l = i * T + ty + 16 * ii;
        if (l >= rows) continue;
        const long long yo = (((long long)b * S + c0 + l) * g.H + h) * P;
#pragma unroll
        for (int pp = 0; pp < PJ; ++pp) {
          const int p = tx + 16 * pp;
          if (g.bf16)
            static_cast<__nv_bfloat16*>(g.y)[yo + p] =
                __float2bfloat16_rn(acc[ii][pp]);
          else
            static_cast<float*>(g.y)[yo + p] = acc[ii][pp];
        }
      }
    }
  }

  if (g.state != nullptr) {
    __syncthreads();
    float* out = g.state + ((long long)b * g.H + h) * P * N;
    for (int e = tid; e < P * N; e += THREADS)
      out[e] = St[(e / N) * LN + e % N];
  }
}

template <int P>
int launch(const Args& g, int n_cells, cudaStream_t stream) {
  const int bytes = smem_floats(P, g.N, g.Q) * (int)sizeof(float);
  static int configured = 0;
  if (bytes > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_fwd<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    configured = bytes;
  }
  ssd_fwd<P><<<n_cells, THREADS, bytes, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// x (Bt, S, H, P) with strides (x_sb, x_ss, x_sh) and unit stride along P;
// b and c (Bt, S, N) with strides (sb, ss) and unit stride along N, all of
// one dtype (0 float32, 1 bfloat16); a and dt (Bt, S, H) float32,
// contiguous; y (Bt, S, H, P) contiguous in x's dtype; state (Bt, H, P, N)
// float32 contiguous, or null for no state.  Returns 0, a CUDA error code,
// or -1 for an unsupported dtype, P, N or chunk.
extern "C" int ssd_scan_fwd(const void* x, const void* b, const void* c,
                            const void* a, const void* dt, void* y,
                            void* state, int dtype, int Bt, int S, int H,
                            int P, int N, int Q, long long x_sb,
                            long long x_ss, long long x_sh, long long b_sb,
                            long long b_ss, long long c_sb, long long c_ss,
                            void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  if (N < 8 || N > MAX_N || (N & (N - 1)) != 0) return -1;
  if (Q < 1 || Q > MAX_Q) return -1;
  if (Bt * H == 0) return 0;
  const Args g{x, b, c, static_cast<const float*>(a),
               static_cast<const float*>(dt), y, static_cast<float*>(state),
               x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss, dtype, H, S, N, Q};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 16: return launch<16>(g, Bt * H, st);
    case 32: return launch<32>(g, Bt * H, st);
    case 64: return launch<64>(g, Bt * H, st);
    case 128: return launch<128>(g, Bt * H, st);
    default: return -1;
  }
}
