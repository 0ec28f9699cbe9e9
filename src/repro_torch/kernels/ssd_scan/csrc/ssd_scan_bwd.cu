// Backward of the chunked SSD (Mamba2) scan for NVIDIA Hopper (sm_90a).
//
// The TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py `_kernel` has no
// backward: the reference differentiates its jnp form (`ssd_chunked`) by
// autodiff instead.  This kernel is the backward of ssd_scan.cu's forward,
// so that training on the card runs through hand-written kernels both
// ways.  It takes the forward's inputs (x, B, C, a, dt) and dy and returns
// dx, dB, dC (in the inputs' dtype), da and ddt (float32).  Per (batch,
// head), in chunks of Q rows (the ragged last chunk zero-padded at dt = a
// = 0), with acum the within-chunk cumulative sum of a, L its last row,
// S_c the state entering chunk c and D_c the gradient of the state leaving
// it (zero after the last chunk):
//
//   D_{c-1} = exp(acum_L) D_c + sum_l exp(acum_l) dy_l C_l^T
//   G = C B^T, M_ls = exp(acum_l - acum_s) for s <= l (masked before the
//   exp), dyx_ls = dy_l . x_s, e_s = exp(acum_L - acum_s):
//   dx_s  = sum_l G M dt_s dy_l + e_s dt_s D B_s
//   ddt_s = sum_l G M dyx + e_s x_s . (D B_s)
//   dB_s  = sum_h [sum_l dyx M dt_s C_l + e_s dt_s x_s^T D]
//   dC_l  = sum_h [sum_s dyx M dt_s B_s + exp(acum_l) dy_l^T S_c]
//   dacum_l = sum_s G M dyx dt_s (row) - sum_l' G M dyx dt_l (column)
//           + exp(acum_l) dy_l . (S_c C_l) - e_l dt_l x_l . (D B_l),
//   da_k  = sum_{l >= k} dacum_l + exp(acum_L) <D, S_c> + sum_s u_s,
//   with u_s = e_s dt_s x_s . (D B_s)
//
// (kernels/ssd_scan/ref.py `ssd_scan_bwd_ref` computes the same formulas in
// plain PyTorch).  Three kernels on the stream:
//
//   1. state_bwd, grid (H, Bt): one block walks the chunks forward,
//      recomputing the states S_c entering them (written to scratch), and
//      then backward, carrying D_c (written to scratch) and <D_c, S_c>.
//      Thread (ty, tx) holds the state elements (ty + 16 a, tx + 16 j) in
//      registers; the chunk's products (w (.) x)^T B and (exp(acum) (.)
//      dy)^T C go over 64-row tiles in shared memory, P / 16 + N / 16
//      shared loads a row for (P / 16) (N / 16) fmas.  Its cumulative
//      decays go to scratch.
//   2. chunk_bwd, grid (64-row tile t x chunk x head, Bt): everything else
//      for the tile's rows: as keys s (query tiles i >= t: dx, ddt, the
//      head's share of dB, the column part of dacum and the state-leaving
//      terms from D_c) and as queries l (key tiles j <= t: the head's share
//      of dC, the row part of dacum and the state-entering terms from S_c).
//      Each tile pair recomputes its G and dyx tiles; the scores W = G M dt
//      and R = dyx M dt go through shared memory into the products.
//   3. finish, grid (blocks, 2): dB and dC summed over the heads in head
//      order, and da by a reverse sum over each chunk's rows.
//
// Determinism: no atomics; every sum runs in a fixed order, so two calls
// on the same inputs give the same bits.  B and C are shared by all heads
// (n_groups = 1), so the per-head shares of dB and dC go to float32
// scratch (Bt, S, H, N) and are summed in kernel 3.
//
// Bound at mamba2-370m's training shape (Bt = 8, S = 2048, Q = 256, H = 32,
// P = 64, N = 128; chip_smoke.py `_ssd_bwd_bound`): per chunk of r rows
// the causal half of C B^T once for all heads, r (r + 1) N operations, and
// per head the causal halves of dy x^T and of the products for dx, dB and
// dC, r (r + 1) (2 P + 2 N), and five (P, N) products over the rows, 10 r P
// N: 95 GFLOP, 0.19 ms at the 494.7 TFLOP/s TF32 peak, against 0.29 GB of
// inputs and gradients or 0.09 ms at 3.35 TB/s: operations bound it.  This
// first design runs every product on the float32 CUDA cores (the forward's
// bf16 path runs on the tensor cores); it recomputes G and dyx for each
// side of a tile pair, and the per-head dB, dC shares cost one float32
// write and read of (Bt, S, H, N) each.  Making it fast is later work.
//
// Every product is an explicit fmaf or __fmul_rn, so the result does not
// depend on the shared -fmad=false build flag.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 64;          // rows of a tile
constexpr int THREADS = 256;   // 16 x 16
constexpr int MAX_N = 128;
constexpr int MAX_Q = 1024;
constexpr int NJ = MAX_N / 16; // most state columns a thread owns

struct Args {
  const void* x;     // (Bt, S, H, P), strides (x_sb, x_ss, x_sh), unit P
  const void* b;     // (Bt, S, N), strides (b_sb, b_ss), unit N
  const void* c;     // (Bt, S, N), strides (c_sb, c_ss), unit N
  const float* a;    // (Bt, S, H), contiguous
  const float* dt;   // (Bt, S, H), contiguous
  const void* dy;    // (Bt, S, H, P), contiguous, x's dtype
  void* dx;          // (Bt, S, H, P), contiguous, x's dtype
  void* db;          // (Bt, S, N), contiguous, x's dtype
  void* dc;          // (Bt, S, N), contiguous, x's dtype
  float* da;         // (Bt, S, H)
  float* ddt;        // (Bt, S, H)
  float* s_in;       // scratch (Bt, nc, H, P, N): the state entering chunk c
  float* d_out;      // scratch (Bt, nc, H, P, N): the gradient leaving it
  float* acum;       // scratch (Bt, nc, H, q_pad)
  float* sd;         // scratch (Bt, nc, H): <D_c, S_c>
  float* db_h;       // scratch (Bt, S, H, N): the heads' shares of dB
  float* dc_h;       // scratch (Bt, S, H, N): the heads' shares of dC
  float* dac;        // scratch (Bt, S, H): dacum
  float* u;          // scratch (Bt, S, H): u_s
  long long x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss;
  int bf16, H, S, N, Q, nc, q_pad, lg_n;
};

__device__ __forceinline__ float load(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store(void* p, long long i, float v,
                                      int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// Inclusive scan of Ac[0 .. q_pad) in place, 256 rows at a time.  Every
// thread of the block calls it.
__device__ void block_scan(float* Ac, int q_pad, float* warp_sum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
}

// Sum of v over the block, in a fixed order; the result in every thread.
__device__ float block_sum(float v, float* warp_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();   // warp_sum is free
  if (lane == 0) warp_sum[warp] = v;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) tot += warp_sum[w];
  return tot;
}

// Sum over the 16 threads of a half warp (the tx of one ty), in a fixed
// order; the result in all 16.
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [r0, r0 + T) of a (.., S, cols) tensor at element offset `base`
// (row stride `ss`, chunk starting at row c0) into shared [T][ld], as
// float32; rows at or past `rows` (chunk-relative) as zeros.
__device__ __forceinline__ void load_rows(float* dst, int ld, const void* src,
                                          long long base, long long ss,
                                          int c0, int r0, int rows, int cols,
                                          int bf16) {
  for (int e = threadIdx.x; e < T * cols; e += THREADS) {
    const int r = e / cols, k = e - r * cols;
    dst[r * ld + k] =
        r0 + r < rows ? load(src, base + (long long)(c0 + r0 + r) * ss + k,
                             bf16)
                      : 0.f;
  }
}

// -- kernel 1: the states and their gradients ---------------------------------

inline int state_smem_floats(int P, int N, int q_pad) {
  return 2 * q_pad + T * (P + 1) + T * (N + 1);
}

// loc[a][j] += sum_s (w_s Ps[s][p]) Ns[s][n] over one 64-row tile, for the
// state elements p = ty + 16 a, n = tx + 16 j that the thread owns.
template <int PJ>
__device__ __forceinline__ void tile_outer(float (&loc)[PJ][NJ],
                                           const float* Ps, int LP,
                                           const float* Ns, int LN,
                                           const float* w, int N) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int s = 0; s < T; ++s) {
    float wp[PJ];
#pragma unroll
    for (int a = 0; a < PJ; ++a) wp[a] = __fmul_rn(w[s], Ps[s * LP + ty + 16 * a]);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (tx + 16 * j < N) {
        const float nv = Ns[s * LN + tx + 16 * j];
#pragma unroll
        for (int a = 0; a < PJ; ++a) loc[a][j] = fmaf(wp[a], nv, loc[a][j]);
      }
  }
}

template <int P>
__global__ void __launch_bounds__(THREADS) state_bwd(Args g) {
  constexpr int PJ = P / 16;   // thread (ty, tx) owns p = ty + 16 a, and
  extern __shared__ float smem[];   // n = tx + 16 j for n < N
  __shared__ float warp_sum[THREADS / 32];
  const int N = g.N, LN = N + 1, LP = P + 1, PN = P * N;
  const int q_pad = g.q_pad, nc = g.nc, H = g.H, S = g.S;
  float* Ac = smem;            // [q_pad] the chunk's acum
  float* Wt = Ac + q_pad;      // [q_pad] per-row weights
  float* Ps = Wt + q_pad;      // [T][LP] x (forward) or dy (backward)
  float* Ns = Ps + T * LP;     // [T][LN] B (forward) or C (backward)

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int h = blockIdx.x, b = blockIdx.y;
  const long long xo = b * g.x_sb + h * g.x_sh;
  const long long dyo = (long long)b * S * H * P + (long long)h * P;
  const long long ao = (long long)b * S * H + h;

  float st[PJ][NJ];
#pragma unroll
  for (int a = 0; a < PJ; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j) st[a][j] = 0.f;

  // Forward: S_c into s_in, acum into scratch.
  for (int c = 0; c < nc; ++c) {
    const int c0 = c * g.Q, rows = min(g.Q, S - c0);
    const long long cell = ((long long)b * nc + c) * H + h;
    float* sin = g.s_in + cell * PN;
#pragma unroll
    for (int a = 0; a < PJ; ++a)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (tx + 16 * j < N) sin[(ty + 16 * a) * N + tx + 16 * j] = st[a][j];
    __syncthreads();   // the previous chunk no longer reads Ac, Wt
    for (int l = tid; l < q_pad; l += THREADS) {
      const bool in = l < rows;
      Ac[l] = in ? g.a[ao + (long long)(c0 + l) * H] : 0.f;
      Wt[l] = in ? g.dt[ao + (long long)(c0 + l) * H] : 0.f;
    }
    __syncthreads();
    block_scan(Ac, q_pad, warp_sum);
    const float a_last = Ac[q_pad - 1];
    float* acum_out = g.acum + cell * q_pad;
    for (int l = tid; l < q_pad; l += THREADS) {
      acum_out[l] = Ac[l];
      Wt[l] = __fmul_rn(expf(a_last - Ac[l]), Wt[l]);
    }
    float loc[PJ][NJ];
#pragma unroll
    for (int a = 0; a < PJ; ++a)
#pragma unroll
      for (int j = 0; j < NJ; ++j) loc[a][j] = 0.f;
    for (int r0 = 0; r0 < rows; r0 += T) {
      __syncthreads();   // Wt is written; the previous tile is read
      load_rows(Ps, LP, g.x, xo, g.x_ss, c0, r0, rows, P, g.bf16);
      load_rows(Ns, LN, g.b, b * g.b_sb, g.b_ss, c0, r0, rows, N, g.bf16);
      __syncthreads();
      tile_outer<PJ>(loc, Ps, LP, Ns, LN, Wt + r0, N);
    }
    const float d = expf(a_last);
#pragma unroll
    for (int a = 0; a < PJ; ++a)
#pragma unroll
      for (int j = 0; j < NJ; ++j) st[a][j] = fmaf(d, st[a][j], loc[a][j]);
  }

  // Backward: D_c into d_out, <D_c, S_c> into sd.
#pragma unroll
  for (int a = 0; a < PJ; ++a)
#pragma unroll
    for (int j = 0; j < NJ; ++j) st[a][j] = 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const int c0 = c * g.Q, rows = min(g.Q, S - c0);
    const long long cell = ((long long)b * nc + c) * H + h;
    float* dst = g.d_out + cell * PN;
    const float* sin = g.s_in + cell * PN;
    float part = 0.f;
#pragma unroll
    for (int a = 0; a < PJ; ++a)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (tx + 16 * j < N) {
          const int e = (ty + 16 * a) * N + tx + 16 * j;
          dst[e] = st[a][j];
          part = fmaf(st[a][j], sin[e], part);
        }
    const float dot = block_sum(part, warp_sum);
    if (tid == 0) g.sd[cell] = dot;
    if (c == 0) break;   // the gradient of the initial state is not needed
    const float* acum_in = g.acum + cell * q_pad;
    for (int l = tid; l < q_pad; l += THREADS) {
      const float v = acum_in[l];
      Ac[l] = v;
      Wt[l] = l < rows ? expf(v) : 0.f;
    }
    float loc[PJ][NJ];
#pragma unroll
    for (int a = 0; a < PJ; ++a)
#pragma unroll
      for (int j = 0; j < NJ; ++j) loc[a][j] = 0.f;
    for (int r0 = 0; r0 < rows; r0 += T) {
      __syncthreads();
      load_rows(Ps, LP, g.dy, dyo, (long long)H * P, c0, r0, rows, P,
                g.bf16);
      load_rows(Ns, LN, g.c, b * g.c_sb, g.c_ss, c0, r0, rows, N, g.bf16);
      __syncthreads();
      tile_outer<PJ>(loc, Ps, LP, Ns, LN, Wt + r0, N);
    }
    const float d = expf(Ac[q_pad - 1]);
#pragma unroll
    for (int a = 0; a < PJ; ++a)
#pragma unroll
      for (int j = 0; j < NJ; ++j) st[a][j] = fmaf(d, st[a][j], loc[a][j]);
    __syncthreads();   // Ac and Wt are read before the next chunk writes
  }
}

// -- kernel 2: the chunk's rows -----------------------------------------------

inline int chunk_smem_floats(int P, int N) {
  return 2 * T * (N + 1) + 2 * T * (P + 1) + 2 * T * (T + 1) + 7 * T;
}

template <int P>
__global__ void __launch_bounds__(THREADS) chunk_bwd(Args g, int nt) {
  constexpr int PJ = P / 16;                 // P columns a thread owns
  constexpr int NPB = (P + T - 1) / T;       // 64-row blocks of the state
  extern __shared__ float smem[];
  const int N = g.N, LN = N + 1, LP = P + 1, LS = T + 1;
  const int H = g.H, S = g.S, nc = g.nc, q_pad = g.q_pad;
  const int nj = (N + 15) / 16;
  float* OwnN = smem;              // [T][LN] B (keys) or C (queries)
  float* OwnP = OwnN + T * LN;     // [T][LP] x (keys) or dy (queries)
  float* OthN = OwnP + T * LP;     // [T][LN] C, B, or 64 rows of D or S
  float* OthP = OthN + T * LN;     // [T][LP] dy (keys) or x (queries)
  float* S1 = OthP + T * LP;       // [T][LS] W = G M dt
  float* S2 = S1 + T * LS;         // [T][LS] R = dyx M dt
  float* AcOwn = S2 + T * LS;      // [T]
  float* DtOwn = AcOwn + T;        // [T]
  float* AcOth = DtOwn + T;        // [T]
  float* DtOth = AcOth + T;        // [T]
  float* ColE = DtOth + T;         // [T] the column sums of G M dyx
  float* ColOff = ColE + T;        // [T] the same without the diagonal
  float* DacCol = ColOff + T;      // [T] the column part of dacum

  const int t = blockIdx.x % nt;
  const int c = (blockIdx.x / nt) % nc;
  const int h = blockIdx.x / (nt * nc);
  const int b = blockIdx.y;
  const int c0 = c * g.Q, rows = min(g.Q, S - c0), r0 = t * T;
  if (r0 >= rows) return;          // the tile is all padding
  const int nt_rows = (rows + T - 1) / T;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long cell = ((long long)b * nc + c) * H + h;
  const float* acum = g.acum + cell * q_pad;
  const float a_last = acum[q_pad - 1];
  const long long xo = b * g.x_sb + h * g.x_sh;
  const long long dyo = (long long)b * S * H * P + (long long)h * P;
  const long long dy_ss = (long long)H * P;
  const long long ao = (long long)b * S * H + h;   // + row * H
  const bool has_d = c + 1 < nc, has_s = c > 0;

  for (int r = tid; r < T; r += THREADS) {
    AcOwn[r] = acum[r0 + r];
    DtOwn[r] = r0 + r < rows ? g.dt[ao + (long long)(c0 + r0 + r) * H] : 0.f;
  }

  // ---- the tile's rows as keys s: query tiles i >= t ----
  load_rows(OwnN, LN, g.b, b * g.b_sb, g.b_ss, c0, r0, rows, N, g.bf16);
  load_rows(OwnP, LP, g.x, xo, g.x_ss, c0, r0, rows, P, g.bf16);
  // The diagonal (s = l) terms of dacum's row and column parts cancel;
  // both leave them out, so they cancel exactly.
  float dxa[4][PJ], dba[4][NJ], colE[4], colOff[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    colE[a] = colOff[a] = 0.f;
#pragma unroll
    for (int j = 0; j < PJ; ++j) dxa[a][j] = 0.f;
#pragma unroll
    for (int k = 0; k < NJ; ++k) dba[a][k] = 0.f;
  }
  for (int i = t; i < nt_rows; ++i) {
    __syncthreads();   // the previous query tile is no longer read
    load_rows(OthN, LN, g.c, b * g.c_sb, g.c_ss, c0, i * T, rows, N, g.bf16);
    load_rows(OthP, LP, g.dy, dyo, dy_ss, c0, i * T, rows, P, g.bf16);
    for (int r = tid; r < T; r += THREADS) AcOth[r] = acum[i * T + r];
    __syncthreads();
    // Scores of the pair, thread (ty, tx): queries l = ty + 16 a (tile i),
    // keys s = tx + 16 bb (tile t).
    float gs[4][4], xs[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) gs[a][bb] = xs[a][bb] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) cv[a] = OthN[(ty + 16 * a) * LN + n];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) bv[bb] = OwnN[(tx + 16 * bb) * LN + n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) gs[a][bb] = fmaf(cv[a], bv[bb], gs[a][bb]);
    }
    for (int p = 0; p < P; ++p) {
      float dv[4], xv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) dv[a] = OthP[(ty + 16 * a) * LP + p];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) xv[bb] = OwnP[(tx + 16 * bb) * LP + p];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) xs[a][bb] = fmaf(dv[a], xv[bb], xs[a][bb]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int ly = ty + 16 * a, sx = tx + 16 * bb;
        const float m = (t * T + sx <= i * T + ly)   // masked before the exp
                            ? expf(AcOth[ly] - AcOwn[sx]) : 0.f;
        const float gm = __fmul_rn(gs[a][bb], m);
        S1[ly * LS + sx] = __fmul_rn(gm, DtOwn[sx]);
        S2[ly * LS + sx] = __fmul_rn(__fmul_rn(xs[a][bb], m), DtOwn[sx]);
        colE[bb] = fmaf(gm, xs[a][bb], colE[bb]);
        if (t * T + sx != i * T + ly)
          colOff[bb] = fmaf(gm, xs[a][bb], colOff[bb]);
      }
    __syncthreads();
    // dx_s[p] += sum_l W[l][s] dy_l[p]; dB_s[n] += sum_l R[l][s] C_l[n];
    // thread (ty, tx): keys s = ty + 16 a, columns tx + 16 j.
    for (int l = 0; l < T; ++l) {
      float wv[4], rv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        wv[a] = S1[l * LS + ty + 16 * a];
        rv[a] = S2[l * LS + ty + 16 * a];
      }
#pragma unroll
      for (int j = 0; j < PJ; ++j) {
        const float dv = OthP[l * LP + tx + 16 * j];
#pragma unroll
        for (int a = 0; a < 4; ++a) dxa[a][j] = fmaf(wv[a], dv, dxa[a][j]);
      }
#pragma unroll
      for (int k = 0; k < NJ; ++k)
        if (k < nj && tx + 16 * k < N) {
          const float cv = OthN[l * LN + tx + 16 * k];
#pragma unroll
          for (int a = 0; a < 4; ++a) dba[a][k] = fmaf(rv[a], cv, dba[a][k]);
        }
    }
  }
  // The column sums of G M dyx over the queries, in ty order.
  __syncthreads();
#pragma unroll
  for (int bb = 0; bb < 4; ++bb) {
    S1[ty * LS + tx + 16 * bb] = colE[bb];
    S2[ty * LS + tx + 16 * bb] = colOff[bb];
  }
  __syncthreads();
  if (tid < T) {
    float v = 0.f, w = 0.f;
    for (int r = 0; r < 16; ++r) {
      v += S1[r * LS + tid];
      w += S2[r * LS + tid];
    }
    ColE[tid] = v;
    ColOff[tid] = w;
  }

  // The state leaving the chunk: V_s = D B_s, xD_s = x_s^T D.
  float wgt[4], xv_part[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int s = ty + 16 * a;
    wgt[a] = __fmul_rn(expf(a_last - AcOwn[s]), DtOwn[s]);
    xv_part[a] = 0.f;
  }
  if (has_d) {
    const float* D = g.d_out + cell * P * N;
#pragma unroll
    for (int pb = 0; pb < NPB; ++pb) {
      const int p0 = pb * T, pr = min(T, P - p0);
      __syncthreads();
      for (int e = tid; e < pr * N; e += THREADS) {
        const int r = e >> g.lg_n, n = e & (N - 1);
        OthN[r * LN + n] = D[(p0 + r) * N + n];
      }
      __syncthreads();
      float V[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) V[a][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float bv[4], dv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) bv[a] = OwnN[(ty + 16 * a) * LN + n];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dv[j] = tx + 16 * j < pr ? OthN[(tx + 16 * j) * LN + n] : 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int j = 0; j < 4; ++j) V[a][j] = fmaf(bv[a], dv[j], V[a][j]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int jj = pb * 4 + j;
          if (jj < PJ) {
            dxa[a][jj] = fmaf(wgt[a], V[a][j], dxa[a][jj]);
            xv_part[a] = fmaf(OwnP[(ty + 16 * a) * LP + p0 + tx + 16 * j],
                              V[a][j], xv_part[a]);
          }
        }
      float xd[4][NJ];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < NJ; ++k) xd[a][k] = 0.f;
      for (int r = 0; r < pr; ++r) {
        float xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) xv[a] = OwnP[(ty + 16 * a) * LP + p0 + r];
#pragma unroll
        for (int k = 0; k < NJ; ++k)
          if (k < nj && tx + 16 * k < N) {
            const float dv = OthN[r * LN + tx + 16 * k];
#pragma unroll
            for (int a = 0; a < 4; ++a) xd[a][k] = fmaf(xv[a], dv, xd[a][k]);
          }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k < NJ; ++k)
          dba[a][k] = fmaf(wgt[a], xd[a][k], dba[a][k]);
    }
  }
  __syncthreads();   // ColE is written
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int s = ty + 16 * a, row = c0 + r0 + s;
    const float xv = half_warp_sum(xv_part[a]);
    if (r0 + s < rows) {
      const long long o = ao + (long long)row * H;
      const float e_s = expf(a_last - AcOwn[s]);
      const float u = __fmul_rn(wgt[a], xv);
      if (tx == 0) {
        g.ddt[o] = fmaf(e_s, xv, ColE[s]);
        g.u[o] = u;
        DacCol[s] = -fmaf(DtOwn[s], ColOff[s], u);
      }
      const long long xo_row = ((long long)(b * S + row) * H + h) * P;
#pragma unroll
      for (int j = 0; j < PJ; ++j)
        store(g.dx, xo_row + tx + 16 * j, dxa[a][j], g.bf16);
      const long long no_row = ((long long)(b * S + row) * H + h) * N;
#pragma unroll
      for (int k = 0; k < NJ; ++k)
        if (k < nj && tx + 16 * k < N) g.db_h[no_row + tx + 16 * k] = dba[a][k];
    }
  }

  // ---- the tile's rows as queries l: key tiles j <= t ----
  __syncthreads();   // DacCol is written; OwnN, OwnP are free
  load_rows(OwnN, LN, g.c, b * g.c_sb, g.c_ss, c0, r0, rows, N, g.bf16);
  load_rows(OwnP, LP, g.dy, dyo, dy_ss, c0, r0, rows, P, g.bf16);
  float dca[4][NJ], rowE[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    rowE[a] = 0.f;
#pragma unroll
    for (int k = 0; k < NJ; ++k) dca[a][k] = 0.f;
  }
  for (int j = 0; j <= t; ++j) {
    __syncthreads();
    load_rows(OthN, LN, g.b, b * g.b_sb, g.b_ss, c0, j * T, rows, N, g.bf16);
    load_rows(OthP, LP, g.x, xo, g.x_ss, c0, j * T, rows, P, g.bf16);
    for (int r = tid; r < T; r += THREADS) {
      AcOth[r] = acum[j * T + r];
      DtOth[r] = j * T + r < rows
                     ? g.dt[ao + (long long)(c0 + j * T + r) * H] : 0.f;
    }
    __syncthreads();
    // thread (ty, tx): queries l = ty + 16 a (tile t), keys s = tx + 16 bb.
    float gs[4][4], xs[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) gs[a][bb] = xs[a][bb] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) cv[a] = OwnN[(ty + 16 * a) * LN + n];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) bv[bb] = OthN[(tx + 16 * bb) * LN + n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) gs[a][bb] = fmaf(cv[a], bv[bb], gs[a][bb]);
    }
    for (int p = 0; p < P; ++p) {
      float dv[4], xv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) dv[a] = OwnP[(ty + 16 * a) * LP + p];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) xv[bb] = OthP[(tx + 16 * bb) * LP + p];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) xs[a][bb] = fmaf(dv[a], xv[bb], xs[a][bb]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int ly = ty + 16 * a, sx = tx + 16 * bb;
        const float m = (j * T + sx <= t * T + ly)   // masked before the exp
                            ? expf(AcOwn[ly] - AcOth[sx]) : 0.f;
        const float r = __fmul_rn(__fmul_rn(xs[a][bb], m), DtOth[sx]);
        S2[ly * LS + sx] = r;
        if (j * T + sx != t * T + ly) rowE[a] = fmaf(r, gs[a][bb], rowE[a]);
      }
    __syncthreads();
    // dC_l[n] += sum_s R[l][s] B_s[n]; thread (ty, tx): queries ty + 16 a,
    // columns tx + 16 k.
    for (int s = 0; s < T; ++s) {
      float rv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) rv[a] = S2[(ty + 16 * a) * LS + s];
#pragma unroll
      for (int k = 0; k < NJ; ++k)
        if (k < nj && tx + 16 * k < N) {
          const float bv = OthN[s * LN + tx + 16 * k];
#pragma unroll
          for (int a = 0; a < 4; ++a) dca[a][k] = fmaf(rv[a], bv, dca[a][k]);
        }
    }
  }
  // The state entering the chunk: dC_l += exp(acum_l) dy_l^T S_c.
  float inter[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) inter[a] = 0.f;
  if (has_s) {
    const float* Sc = g.s_in + cell * P * N;
    float ci[4][NJ];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int k = 0; k < NJ; ++k) ci[a][k] = 0.f;
#pragma unroll
    for (int pb = 0; pb < NPB; ++pb) {
      const int p0 = pb * T, pr = min(T, P - p0);
      __syncthreads();
      for (int e = tid; e < pr * N; e += THREADS) {
        const int r = e >> g.lg_n, n = e & (N - 1);
        OthN[r * LN + n] = Sc[(p0 + r) * N + n];
      }
      __syncthreads();
      for (int r = 0; r < pr; ++r) {
        float dv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) dv[a] = OwnP[(ty + 16 * a) * LP + p0 + r];
#pragma unroll
        for (int k = 0; k < NJ; ++k)
          if (k < nj && tx + 16 * k < N) {
            const float sv = OthN[r * LN + tx + 16 * k];
#pragma unroll
            for (int a = 0; a < 4; ++a) ci[a][k] = fmaf(dv[a], sv, ci[a][k]);
          }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int l = ty + 16 * a;
      const float el = expf(AcOwn[l]);
#pragma unroll
      for (int k = 0; k < NJ; ++k)
        if (k < nj && tx + 16 * k < N) {
          const float v = __fmul_rn(el, ci[a][k]);
          dca[a][k] += v;
          inter[a] = fmaf(v, OwnN[l * LN + tx + 16 * k], inter[a]);
        }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int l = ty + 16 * a, row = c0 + r0 + l;
    const float re = half_warp_sum(rowE[a]);
    const float it = half_warp_sum(inter[a]);
    if (r0 + l < rows) {
      if (tx == 0) g.dac[ao + (long long)row * H] = re + it + DacCol[l];
      const long long no_row = ((long long)(b * S + row) * H + h) * N;
#pragma unroll
      for (int k = 0; k < NJ; ++k)
        if (k < nj && tx + 16 * k < N) g.dc_h[no_row + tx + 16 * k] = dca[a][k];
    }
  }
}

// -- kernel 3: sums over the heads, and da --------------------------------------
//
// blockIdx.y == 0: dB and dC at (b, s, n), summed over h in order.
// blockIdx.y == 1: da of one (b, c, h) cell, a reverse sum over its rows.
__global__ void __launch_bounds__(THREADS) finish(Args g, int Bt) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int H = g.H, S = g.S, N = g.N;
  if (blockIdx.y == 0) {
    if (i >= (long long)Bt * S * N) return;
    const long long bs = i / N;
    const int n = (int)(i - bs * N);
    const float* pb = g.db_h + bs * H * N + n;
    const float* pc = g.dc_h + bs * H * N + n;
    float vb = 0.f, vc = 0.f;
    for (int h = 0; h < H; ++h) {
      vb += pb[(long long)h * N];
      vc += pc[(long long)h * N];
    }
    store(g.db, i, vb, g.bf16);
    store(g.dc, i, vc, g.bf16);
    return;
  }
  if (i >= (long long)Bt * g.nc * H) return;
  const int h = (int)(i % H);
  const int c = (int)((i / H) % g.nc);
  const int b = (int)(i / ((long long)H * g.nc));
  const int c0 = c * g.Q, rows = min(g.Q, S - c0);
  const long long ao = ((long long)b * S + c0) * H + h;
  float tail = __fmul_rn(expf(g.acum[i * g.q_pad + g.q_pad - 1]), g.sd[i]);
  for (int l = 0; l < rows; ++l) tail += g.u[ao + (long long)l * H];
  float run = 0.f;
  for (int l = rows - 1; l >= 0; --l) {
    const long long o = ao + (long long)l * H;
    run += g.dac[o];
    g.da[o] = run + tail;
  }
}

template <typename F>
cudaError_t allow_smem(F* kernel, int bytes, int& configured) {
  if (bytes <= configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) configured = bytes;
  return err;
}

template <int P>
int launch(const Args& g, int Bt, cudaStream_t stream) {
  static int configured1 = 0, configured2 = 0;
  const int bytes1 = state_smem_floats(P, g.N, g.q_pad) * (int)sizeof(float);
  cudaError_t err = allow_smem(state_bwd<P>, bytes1, configured1);
  if (err != cudaSuccess) return (int)err;
  state_bwd<P><<<dim3(g.H, Bt), THREADS, bytes1, stream>>>(g);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int bytes2 = chunk_smem_floats(P, g.N) * (int)sizeof(float);
  err = allow_smem(chunk_bwd<P>, bytes2, configured2);
  if (err != cudaSuccess) return (int)err;
  const int nt = g.q_pad / T;
  chunk_bwd<P><<<dim3(nt * g.nc * g.H, Bt), THREADS, bytes2, stream>>>(g, nt);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const long long n_a = (long long)Bt * g.S * g.N;
  const long long n_b = (long long)Bt * g.nc * g.H;
  const long long most = n_a > n_b ? n_a : n_b;
  finish<<<dim3((unsigned)((most + THREADS - 1) / THREADS), 2), THREADS, 0,
           stream>>>(g, Bt);
  return (int)cudaGetLastError();
}

}  // namespace

// x (Bt, S, H, P) with strides (x_sb, x_ss, x_sh) and unit stride along P;
// b and c (Bt, S, N) with strides (sb, ss) and unit stride along N; dy (Bt,
// S, H, P) contiguous; all four of one dtype (0 float32, 1 bfloat16).  a
// and dt (Bt, S, H) float32, contiguous.  Writes dx (Bt, S, H, P), db and
// dc (Bt, S, N) contiguous in that dtype, and da and ddt (Bt, S, H)
// float32.  float32 scratch, contiguous: s_in and d_out (Bt, nc, H, P, N),
// acum (Bt, nc, H, q_pad), sd (Bt, nc, H), db_h and dc_h (Bt, S, H, N), dac
// and u (Bt, S, H), with nc = ceil(S / Q) and q_pad = 64 ceil(Q / 64).
// Launches three kernels on `stream`.  Returns 0, a CUDA error code, or -1
// for an unsupported dtype, P, N or chunk.
extern "C" int ssd_scan_bwd(
    const void* x, const void* b, const void* c, const void* a,
    const void* dt, const void* dy, void* dx, void* db, void* dc, void* da,
    void* ddt, int dtype, int Bt, int S, int H, int P, int N, int Q,
    long long x_sb, long long x_ss, long long x_sh, long long b_sb,
    long long b_ss, long long c_sb, long long c_ss, void* s_in, void* d_out,
    void* acum, void* sd, void* db_h, void* dc_h, void* dac, void* u,
    void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  if (N < 8 || N > MAX_N || (N & (N - 1)) != 0) return -1;
  if (Q < 1 || Q > MAX_Q) return -1;
  if (Bt * H == 0 || S == 0) return 0;
  int lg_n = 0;
  while ((1 << lg_n) < N) ++lg_n;
  const Args g{x, b, c, static_cast<const float*>(a),
               static_cast<const float*>(dt), dy, dx, db, dc,
               static_cast<float*>(da), static_cast<float*>(ddt),
               static_cast<float*>(s_in), static_cast<float*>(d_out),
               static_cast<float*>(acum), static_cast<float*>(sd),
               static_cast<float*>(db_h), static_cast<float*>(dc_h),
               static_cast<float*>(dac), static_cast<float*>(u),
               x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss,
               dtype, H, S, N, Q, (S + Q - 1) / Q, (Q + T - 1) / T * T, lg_n};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 16: return launch<16>(g, Bt, st);
    case 32: return launch<32>(g, Bt, st);
    case 64: return launch<64>(g, Bt, st);
    case 128: return launch<128>(g, Bt, st);
    default: return -1;
  }
}
