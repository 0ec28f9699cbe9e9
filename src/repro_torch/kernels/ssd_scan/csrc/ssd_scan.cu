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
// VMEM state scratch).  Heads share one (B, C) group (n_groups = 1).  Rows
// past the sequence end, and the rows that pad a chunk to a multiple of 64,
// count as zeros with a = dt = 0 (decay 1, no input), so any S and any Q
// from 1 to 1024 work and the final state is the state after the last row;
// rows past S are not written.  x, B and C are read through their (batch,
// position[, head]) strides with a unit stride along P or N, so the model's
// slices of one xBC tensor come in without copies.
//
// Bound at the serving path's shapes (B = 1, Q = 256, S = 2048): per chunk
// the causal half of C B^T, Q (Q + 1) N operations, once for all heads
// (n_groups = 1), and per head the causal half of the scores times x,
// Q (Q + 1) P, and the two state products, 4 Q N P.  mamba2-370m (H = 32,
// P = 64, N = 128) does 3.29 GFLOP, 6.66 us at the 494.7 TFLOP/s dense
// TF32 peak, against 19.4 MB (x, B, C, a, dt and y once, state out) or
// 5.79 us at 3.35 TB/s: operations bound it.  zamba2-7b (H = 112, P = 64,
// N = 64) does 7.56 GFLOP, 15.3 us, against 62.9 MB or 18.8 us: bytes
// bound it.
//
// bfloat16 (the serving path): Mamba-2's own chunk-parallel split
// (arXiv:2405.21060 sections 6-7), three kernels on the stream per call,
// what the four faults of the earlier one-block-per-(b, h) design called
// for:
//
//   * 32 (or 112) blocks walking the chunks in order -> chunk-parallel.
//     (1) chunk states, grid (chunk, head, batch): the chunk's cumulative
//     decay (a block scan), written to a small scratch, and its local state
//     (w (.) x)^T B into scratch of shape (Bt, nc, H, P, N);
//     (2) state passing, grid (P N tiles, head, batch): the only sequential
//     part, an element-wise walk over the nc chunks that overwrites each
//     local state with the state carried into its chunk, and writes the
//     final state on request; (3) chunk scan, grid (64-row query tile x
//     chunk x group of g heads, batch), longest query tiles first: 256
//     blocks at mamba2-370m's S = 2048, 896 at zamba2-7b's.
//   * float32 CUDA cores -> tensor cores.  Every product is mma.sync
//     m16n8k16 in bf16 with float32 sums.  Operands that are computed in
//     float32 (w (.) x, the decay-scaled scores and the carried state) go in
//     as hi + lo bf16 pairs, two products each, so they keep about 16 bits
//     as the flash kernel's P does; x, B and C go in as they are.  mma.sync
//     and not wgmma: those operands are made in registers, right after the
//     decay scaling, in the accumulator layout that mma.sync's A fragment
//     shares, and the per-tile products are 16-64 columns wide; wgmma with
//     its warpgroup tiles is left for a later PR.
//   * C B^T once per head -> once per (chunk, query tile, group of g heads):
//     the 64 x 64 tile G = C_i B_j^T is computed once and scaled by each of
//     the g heads' decays (g = 4 at P <= 64; n_groups = 1).  Each half of
//     the block takes half of the heads, so no score is computed twice.
//   * synchronous loads -> cp.async, double-buffered: each key tile's x (for
//     the g heads), B, decays and dt come in while the previous tile is
//     multiplied.  The launcher requires 16-byte aligned bases and strides;
//     N = 8 is zero-padded to the 16 columns of a k-step in shared memory.
//
// float32: CUDA cores, one block of 256 threads (16 x 16) per (batch, head)
// walking the chunks in order with the (P, N) state in shared memory; per
// chunk a block scan of a, 64 x 64 (query, key) tiles below the diagonal
// (masked before the exp on it), the state update folded into the last
// query tile.  Thread (ty, tx) owns rows ty + 16 i and columns tx + 16 p.
//
// Every product is an explicit fmaf, __fmul_rn or mma, so the result does
// not depend on the shared -fmad=false build flag.
#include "ssd_tc.cuh"   // the tensor-core helpers and pass 1

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

// ---------------------------------------------------------------------------
// bfloat16: chunk-parallel on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {   // the helpers and pass 1's body are in ssd_tc.cuh

// -- pass 1: chunk states (the body in ssd_tc.cuh) -------------------------

template <int NTW>
__global__ void __launch_bounds__(THREADS1) chunk_state(Args g) {
  chunk_state_body<NTW>(g, blockIdx.z, false);
}

template <int NTW>
int launch_state(const Args& g, int Bt, cudaStream_t stream) {
  static int configured = 0;
  const int bytes = state_smem(g);
  cudaError_t err = allow_smem(chunk_state<NTW>, bytes, configured);
  if (err != cudaSuccess) return (int)err;
  chunk_state<NTW><<<dim3(g.nc, g.H, Bt), THREADS1, bytes, stream>>>(g);
  return (int)cudaGetLastError();
}

int launch_states(const Args& g, int Bt, cudaStream_t stream) {
  switch (state_ntw(g)) {
    case 1: return launch_state<1>(g, Bt, stream);
    case 2: return launch_state<2>(g, Bt, stream);
    case 4: return launch_state<4>(g, Bt, stream);
    case 8: return launch_state<8>(g, Bt, stream);
    case 16: return launch_state<16>(g, Bt, stream);
    default: return -1;
  }
}

// -- pass 2: state passing -----------------------------------------------------
//
// Block (tile of P N / 4 float4s, h, b); thread e walks the chunks in order:
// s_in[c] = exp(acum_last[c - 1]) s_in[c - 1] + local[c - 1], written over
// local[c]; the state after the last chunk goes to `state` if given.  The
// next chunk's loads are issued before this chunk's update.
constexpr int THREADS2 = 256;

__global__ void __launch_bounds__(THREADS2) state_pass(Args g) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int PN4 = g.P * g.N / 4;
  const int e = blockIdx.x * THREADS2 + threadIdx.x;
  if (e >= PN4) return;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long cell0 = (long long)b * g.nc * g.H + h;
  float4 loc;
  float a_last;
  if (g.nc > 0) {
    loc = reinterpret_cast<const float4*>(g.states + cell0 * g.P * g.N)[e];
    a_last = g.acum[cell0 * g.q_pad + g.q_pad - 1];
  }
  for (int c = 0; c < g.nc; ++c) {
    const long long cell = cell0 + (long long)c * g.H;
    const float4 cur = loc;
    const float d = expf(a_last);
    if (c + 1 < g.nc) {
      loc = reinterpret_cast<const float4*>(
          g.states + (cell + g.H) * g.P * g.N)[e];
      a_last = g.acum[(cell + g.H) * g.q_pad + g.q_pad - 1];
    }
    reinterpret_cast<float4*>(g.states + cell * g.P * g.N)[e] = s;
    s = make_float4(fmaf(d, s.x, cur.x), fmaf(d, s.y, cur.y),
                    fmaf(d, s.z, cur.z), fmaf(d, s.w, cur.w));
  }
  if (g.state != nullptr)
    reinterpret_cast<float4*>(g.state +
                              ((long long)b * g.H + h) * g.P * g.N)[e] = s;
}

// -- pass 3: chunk scan --------------------------------------------------------
//
// Block (query tile i x chunk c x head group, b): y for the 64 query rows
// l0 = 64 i .. of chunk c and the GH heads h0 .. h0 + GH - 1.
//   y = exp(acum_l) (C s_in^T)                      (c > 0)
//     + sum_{j <= i} ((C_i B_j^T) o decay o dt_s) x_j
// with G = C_i B_j^T computed once per key tile for all GH heads.  Warp w
// owns query rows 16 (w % 4) .. + 15; the two halves of the block (w / 4)
// take half of the heads each (GH >= 2), or half of y's P columns (GH = 1),
// so that no score is computed twice.
template <int P, int GH>
struct Scan {
  static constexpr bool SPLIT_HEADS = GH >= 2;
  static constexpr int HALVES = (SPLIT_HEADS || P >= 32) ? 2 : 1;
  static constexpr int HPW = SPLIT_HEADS ? GH / 2 : GH;   // heads a warp
  static constexpr int PW = SPLIT_HEADS ? P : P / HALVES; // y columns a warp
  static constexpr int NPT = PW / 8;                      // their n-tiles
  static constexpr int THREADS = 128 * HALVES;
};

template <int P, int GH>
__global__ void __launch_bounds__(Scan<P, GH>::THREADS)
chunk_scan(Args g, int n_qt, int n_groups) {
  using K = Scan<P, GH>;
  extern __shared__ float smem[];
  const int N = g.N, NP = max(N, 16);
  const int LC = NP + PAD, LX = P + PAD;
  bf16* Cs = reinterpret_cast<bf16*>(smem);   // [T][LC]
  bf16* Bs = Cs + T * LC;                     // [2][T][LC]
  bf16* Xs = Bs + 2 * T * LC;                 // [2][GH][T][LX]
  float* AcQ = reinterpret_cast<float*>(Xs + 2 * GH * T * LX);   // [GH][T]
  float* AcK = AcQ + GH * T;                  // [2][GH][T]
  float* DtK = AcK + 2 * GH * T;              // [2][GH][T]

  const int per_tile = g.nc * n_groups;
  const int i = n_qt - 1 - static_cast<int>(blockIdx.x) / per_tile;
  const int rem = blockIdx.x % per_tile;
  const int c = rem / n_groups, h0 = (rem % n_groups) * GH;
  const int b = blockIdx.y;
  const int c0 = c * g.Q, rows = min(g.Q, g.S - c0), l0 = i * T;
  if (l0 >= rows) return;   // the query tile is all padding

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rw = warp & 3, half = warp >> 2;
  const int hw0 = K::SPLIT_HEADS ? half * K::HPW : 0;   // the warp's heads
  const int pw0 = K::SPLIT_HEADS ? 0 : half * K::PW;    // and columns
  const int gq = lane >> 2, t = lane & 3;
  const bf16* bb = g.b + b * g.b_sb;
  const bf16* cb = g.c + b * g.c_sb;
  const bf16* xb = g.x + b * g.x_sb + h0 * g.x_sh;
  const float* acum = g.acum + ((long long)b * g.nc + c) * g.H * g.q_pad;

  if (N < 16)   // zero the k-step's padding columns, never loaded
    for (int e = tid; e < 3 * T; e += K::THREADS)
      *reinterpret_cast<uint4*>(Cs + e * LC + 8) = make_uint4(0, 0, 0, 0);

  // Key tile j into `stage`: B and the GH heads' x by 16-byte copies, their
  // cumulative decays (scratch rows of 64 floats) and dt (4 bytes each,
  // zero past the chunk's rows).
  const auto load_keys = [&](int j, int stage) {
    load_tile(Bs + stage * T * LC, LC, bb, g.b_ss, c0, j * T, rows, N, tid,
              K::THREADS);
    for (int hh = 0; hh < GH; ++hh)
      load_tile(Xs + (stage * GH + hh) * T * LX, LX, xb + hh * g.x_sh,
                g.x_ss, c0, j * T, rows, P, tid, K::THREADS);
    for (int e = tid; e < GH * T / 4; e += K::THREADS) {
      const int hh = e / (T / 4), r = 4 * (e - hh * (T / 4));
      const uint32_t d = static_cast<uint32_t>(
          __cvta_generic_to_shared(AcK + stage * GH * T + hh * T + r));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(acum + (h0 + hh) * g.q_pad + j * T + r)
                   : "memory");
    }
    for (int e = tid; e < GH * T; e += K::THREADS) {
      const int r = e / GH, hh = e - r * GH, s = j * T + r;
      const bool valid = s < rows;
      cp4(DtK + stage * GH * T + hh * T + r,
          valid ? g.dt + ((long long)b * g.S + c0 + s) * g.H + h0 + hh : g.dt,
          valid);
    }
    cp_commit();
  };

  load_tile(Cs, LC, cb, g.c_ss, c0, l0, rows, N, tid, K::THREADS);
  for (int e = tid; e < GH * T; e += K::THREADS) {
    const int hh = e / T;
    AcQ[e] = acum[(h0 + hh) * g.q_pad + l0 + (e - hh * T)];
  }
  cp_commit();
  load_keys(0, 0);
  cp_wait<1>();
  __syncthreads();

  // C fragments of the warp's rows, as A operands, per k-step over N.
  const auto c_frag = [&](int ks, uint32_t (&a)[4]) {
    const bf16* p = Cs + (16 * rw + gq) * LC + 16 * ks + 2 * t;
    a[0] = ld32(p);
    a[1] = ld32(p + 8 * LC);
    a[2] = ld32(p + 8);
    a[3] = ld32(p + 8 * LC + 8);
  };

  float acc[K::HPW][K::NPT][4];
#pragma unroll
  for (int hh = 0; hh < K::HPW; ++hh)
#pragma unroll
    for (int n = 0; n < K::NPT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[hh][n][e] = 0.f;

  if (c > 0) {
    // The state carried into the chunk, s_in (P, N) float32 from pass 2,
    // as the B operand s_in^T (k = n, n = p), split into hi + lo; each
    // k-step's loads for all of the warp's heads and columns go out
    // together.
    const float* s_in = g.states +
        (((long long)b * g.nc + c) * g.H + h0 + hw0) * P * N;
    for (int ks = 0; ks < NP / 16; ++ks) {
      uint32_t a[4];
      c_frag(ks, a);
      const int k = 16 * ks + 2 * t;
#pragma unroll
      for (int hh = 0; hh < K::HPW; ++hh)
#pragma unroll
        for (int n = 0; n < K::NPT; ++n) {
          const float* sp = s_in + (hh * P + pw0 + 8 * n + gq) * N + k;
          float2 v0 = make_float2(0.f, 0.f), v1 = v0;
          if (k < N) v0 = *reinterpret_cast<const float2*>(sp);
          if (k + 8 < N) v1 = *reinterpret_cast<const float2*>(sp + 8);
          uint32_t hi0, lo0, hi1, lo1;
          split(v0.x, v0.y, hi0, lo0);
          split(v1.x, v1.y, hi1, lo1);
          mma(acc[hh][n], a, hi0, hi1);
          mma(acc[hh][n], a, lo0, lo1);
        }
    }
#pragma unroll
    for (int hh = 0; hh < K::HPW; ++hh)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float d = expf(AcQ[(hw0 + hh) * T + 16 * rw + gq + 8 * r]);
#pragma unroll
        for (int n = 0; n < K::NPT; ++n) {
          acc[hh][n][2 * r] = __fmul_rn(d, acc[hh][n][2 * r]);
          acc[hh][n][2 * r + 1] = __fmul_rn(d, acc[hh][n][2 * r + 1]);
        }
      }
  }

  for (int j = 0; j <= i; ++j) {
    const int cur = j & 1;
    if (j < i) {
      load_keys(j + 1, cur ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    // G = C_i B_j^T for the warp's 16 rows and the tile's 64 keys.
    const bf16* Bc = Bs + cur * T * LC;
    float gs[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) gs[n][e] = 0.f;
    for (int ks = 0; ks < NP / 16; ++ks) {
      uint32_t a[4];
      c_frag(ks, a);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const bf16* p = Bc + (8 * n + gq) * LC + 16 * ks + 2 * t;
        mma(gs[n], a, ld32(p), ld32(p + 8));
      }
    }

    const bool diag = j == i;
#pragma unroll
    for (int hh = 0; hh < K::HPW; ++hh) {
      const int head = hw0 + hh;
      const float* ak = AcK + (cur * GH + head) * T;
      const float* dk = DtK + (cur * GH + head) * T;
      // Scores (G o exp(acum_l - acum_s) o dt_s), masked before the exp on
      // the diagonal tile, as A operands (hi + lo) of the product with x_j:
      // k-step kk covers keys 16 kk .. 16 kk + 15, the n-tiles 2 kk, 2 kk + 1.
      uint32_t s_hi[4][4], s_lo[4][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int lr = 16 * rw + gq + 8 * r;
          const float aq = AcQ[head * T + lr];
          float v[2];
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int s = 8 * n + 2 * t + cc;
            v[cc] = (!diag || s <= lr)
                        ? __fmul_rn(__fmul_rn(gs[n][2 * r + cc],
                                              ex2(__fmul_rn(aq - ak[s],
                                                            LOG2E))),
                                    dk[s])
                        : 0.f;
          }
          split(v[0], v[1], s_hi[n >> 1][2 * (n & 1) + r],
                s_lo[n >> 1][2 * (n & 1) + r]);
        }
      // x_j of the head as the B operand (k = s, n = p), by
      // ldmatrix.trans: two n-tiles (16 columns of y) per load.
      const bf16* Xc = Xs + (cur * GH + head) * T * LX;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int n = 0; n < K::NPT; n += 2) {
          uint32_t xb4[4];
          ldmatrix_x4_trans(xb4, Xc + (16 * kk + ((lane >> 3) & 1) * 8 +
                                       (lane & 7)) * LX +
                                     pw0 + 8 * n + (lane >> 4) * 8);
          mma(acc[hh][n], s_hi[kk], xb4[0], xb4[1]);
          mma(acc[hh][n], s_lo[kk], xb4[0], xb4[1]);
          mma(acc[hh][n + 1], s_hi[kk], xb4[2], xb4[3]);
          mma(acc[hh][n + 1], s_lo[kk], xb4[2], xb4[3]);
        }
    }
    __syncthreads();   // this stage is free for the load after next
  }

#pragma unroll
  for (int hh = 0; hh < K::HPW; ++hh)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int l = l0 + 16 * rw + gq + 8 * r;
      if (l >= rows) continue;
      bf16* yr = g.y + (((long long)b * g.S + c0 + l) * g.H + h0 + hw0 + hh)
                 * P + pw0;
#pragma unroll
      for (int n = 0; n < K::NPT; ++n)
        *reinterpret_cast<uint32_t*>(yr + 8 * n + 2 * t) =
            pack(acc[hh][n][2 * r], acc[hh][n][2 * r + 1]);
    }
}

// Shared bytes of pass 3.
template <int P, int GH>
int scan_smem(const Args& g) {
  const int LC = (g.N < 16 ? 16 : g.N) + PAD;
  return 3 * T * LC * 2 + 2 * GH * T * (P + PAD) * 2 + 5 * GH * T * 4;
}

template <int P, int GH>
int launch_scan(const Args& g, int Bt, cudaStream_t stream) {
  static int configured = 0;
  const int bytes = scan_smem<P, GH>(g);
  cudaError_t err = allow_smem(chunk_scan<P, GH>, bytes, configured);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = g.q_pad / T, n_groups = g.H / GH;
  chunk_scan<P, GH>
      <<<dim3(n_qt * g.nc * n_groups, Bt), Scan<P, GH>::THREADS, bytes,
         stream>>>(g, n_qt, n_groups);
  return (int)cudaGetLastError();
}

template <int P>
int launch_scan_p(const Args& g, int Bt, cudaStream_t stream) {
  // Heads per block: 4 where they fit the registers (P <= 64), fewer where
  // H is not a multiple.
  if constexpr (P <= 64)
    if (g.H % 4 == 0) return launch_scan<P, 4>(g, Bt, stream);
  if (g.H % 2 == 0) return launch_scan<P, 2>(g, Bt, stream);
  return launch_scan<P, 1>(g, Bt, stream);
}

// S = 0: no chunk; pass 2 alone writes the (zero) final state.
int zero_state(const Args& g, int Bt, cudaStream_t stream) {
  if (g.state == nullptr) return 0;
  const int pn4 = g.P * g.N / 4;
  state_pass<<<dim3((pn4 + THREADS2 - 1) / THREADS2, g.H, Bt), THREADS2, 0,
               stream>>>(g);
  return (int)cudaGetLastError();
}

// The three passes on `stream`.
int launch(const Args& g, int Bt, cudaStream_t stream) {
  int err = launch_states(g, Bt, stream);
  if (err) return err;
  const int pn4 = g.P * g.N / 4;
  state_pass<<<dim3((pn4 + THREADS2 - 1) / THREADS2, g.H, Bt), THREADS2, 0,
               stream>>>(g);
  if ((err = (int)cudaGetLastError())) return err;
  switch (g.P) {
    case 16: return launch_scan_p<16>(g, Bt, stream);
    case 32: return launch_scan_p<32>(g, Bt, stream);
    case 64: return launch_scan_p<64>(g, Bt, stream);
    case 128: return launch_scan_p<128>(g, Bt, stream);
    default: return -1;
  }
}

}  // namespace tc

}  // namespace

// x (Bt, S, H, P) with strides (x_sb, x_ss, x_sh) and unit stride along P;
// b and c (Bt, S, N) with strides (sb, ss) and unit stride along N, all of
// one dtype (0 float32, 1 bfloat16); a and dt (Bt, S, H) float32,
// contiguous; y (Bt, S, H, P) contiguous in x's dtype; state (Bt, H, P, N)
// float32 contiguous, or null for no state.  bfloat16 also takes float32
// scratch, contiguous: states (Bt, nc, H, P, N) and acum (Bt, nc, H, q_pad),
// nc = ceil(S / Q) chunks padded to q_pad = 64 ceil(Q / 64) rows, and
// 16-byte aligned x, b, c with strides of multiples of 8 elements; it
// launches three kernels.  Returns 0, a CUDA error code, or -1 for an
// unsupported dtype, P, N or chunk.
extern "C" int ssd_scan_fwd(const void* x, const void* b, const void* c,
                            const void* a, const void* dt, void* y,
                            void* state, int dtype, int Bt, int S, int H,
                            int P, int N, int Q, long long x_sb,
                            long long x_ss, long long x_sh, long long b_sb,
                            long long b_ss, long long c_sb, long long c_ss,
                            void* states, void* acum, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  if (N < 8 || N > MAX_N || (N & (N - 1)) != 0) return -1;
  if (Q < 1 || Q > MAX_Q) return -1;
  if (Bt * H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (P != 16 && P != 32 && P != 64 && P != 128) return -1;
    const int q_pad = (Q + T - 1) / T * T;
    const tc::Args g{static_cast<const tc::bf16*>(x),
                     static_cast<const tc::bf16*>(b),
                     static_cast<const tc::bf16*>(c),
                     static_cast<const float*>(a),
                     static_cast<const float*>(dt),
                     static_cast<tc::bf16*>(y),
                     static_cast<float*>(state),
                     static_cast<float*>(states),
                     static_cast<float*>(acum),
                     x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss,
                     H, S, P, N, Q, (S + Q - 1) / Q, q_pad};
    return S > 0 ? tc::launch(g, Bt, st) : tc::zero_state(g, Bt, st);
  }
  const Args g{x, b, c, static_cast<const float*>(a),
               static_cast<const float*>(dt), y, static_cast<float*>(state),
               x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss, dtype, H, S, N, Q};
  switch (P) {
    case 16: return launch<16>(g, Bt * H, st);
    case 32: return launch<32>(g, Bt * H, st);
    case 64: return launch<64>(g, Bt * H, st);
    case 128: return launch<128>(g, Bt * H, st);
    default: return -1;
  }
}
