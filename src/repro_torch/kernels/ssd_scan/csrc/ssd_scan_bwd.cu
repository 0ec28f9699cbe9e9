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
// plain PyTorch, and `ssd_scan_bwd_split` the bf16 path's split below.)
//
// Bound at mamba2-370m's training shape (Bt = 8, S = 2048, Q = 256, H = 32,
// P = 64, N = 128; chip_smoke.py `_ssd_bwd_bound`): per chunk of r rows
// the causal half of C B^T once for all heads, r (r + 1) N operations, and
// per head the causal halves of dy x^T and of the products for dx, dB and
// dC, r (r + 1) (2 P + 2 N), and five (P, N) products over the rows, 10 r P
// N: 95 GFLOP, 0.0963 ms at the 989 TFLOP/s bf16 peak, against 0.23 GB of
// inputs and gradients, 0.068 ms at 3.35 TB/s: operations bound it.
//
// bfloat16: four kernels on the stream, chunk-parallel, every product on
// the tensor cores (mma.sync m16n8k16, bf16 in, float32 sums).  x, B, C and
// dy go in as they are; operands computed in float32 (the decay-scaled
// rows, W = G M dt, the head sums of R = dyx M dt, S_c and D_c) go in as hi
// + lo bf16 pairs, two products each, so they keep about 16 bits, as in the
// forward.  mma.sync and not wgmma for the forward's reason: the computed
// operands are made in registers in mma.sync's fragment layouts, and the
// per-tile products are 16-64 columns wide.
//
//   1. ssd_bwd_states, grid (chunk, head, 2 Bt): the forward's pass 1
//      (ssd_tc.cuh) for the chunks' local states (w (.) x)^T B and, in the
//      other half of the grid, their gradients (exp(acum) (.) dy)^T C.
//   2. ssd_bwd_pass, grid (tile of 2048 state elements, head, Bt): the
//      only sequential part, an element-wise walk back over the chunks
//      (D_c) and then forward (S_c, and the tile's share of <D_c, S_c> in a
//      fixed order); S_c and D_c leave as hi + lo bf16.
//   3. ssd_bwd_chunk, grid (64-row key tile x group of g heads x chunk,
//      Bt), g = 4 at P <= 64 (else 1): everything of the tile's rows as
//      keys, and the shares of each query tile's rows that the tile's keys
//      give.  G = C_i B_j^T is computed once per (pair, group) and scaled
//      by each head's decays; dyx once per (pair, head).  Each pair is
//      visited once, by its key tile's block: dx, ddt, dB and dacum's
//      column and state terms stay in the block; the query side's dC and
//      dacum row part leave as per-pair shares (dC summed over the group's
//      heads first, which also cuts the dB and dC products by g).  D and S
//      tiles, dy, C and the decays come in by cp.async, double-buffered.
//      One 8-warp block an SM (255 registers, ~190 KB of shared memory):
//      it is latency-bound, at ~75 TFLOP/s of mma.sync.
//   4. ssd_bwd_finish: dB and dC summed over the groups (and pairs) in
//      order, and da by a reverse sum, a warp per (b, chunk, head).
//
// Determinism: no atomics; every sum runs in a fixed order, so two calls
// on the same inputs give the same bits.
//
// float32: CUDA cores, three kernels: state_bwd, grid (H, Bt), one block
// walking the chunks forward (S_c) and back (D_c, <D_c, S_c>); chunk_bwd,
// grid (64-row tile x chunk x head, Bt), the tile's rows as keys and as
// queries, G and dyx recomputed for each side, the heads' dB and dC shares
// to float32 scratch (Bt, S, H, N); finish, the head sums and da.
//
// Every product is an explicit fmaf, __fmul_rn or mma, so the result does
// not depend on the shared -fmad=false build flag.
#include "ssd_tc.cuh"   // the tensor-core helpers and pass 1's body

namespace {

constexpr int T = 64;          // rows of a tile
constexpr int THREADS = 256;   // 16 x 16
constexpr int MAX_N = 128;
constexpr int MAX_Q = 1024;
constexpr int NJ = MAX_N / 16; // most state columns a thread owns

struct Args {
  const float* x;    // (Bt, S, H, P), strides (x_sb, x_ss, x_sh), unit P
  const float* b;    // (Bt, S, N), strides (b_sb, b_ss), unit N
  const float* c;    // (Bt, S, N), strides (c_sb, c_ss), unit N
  const float* a;    // (Bt, S, H), contiguous
  const float* dt;   // (Bt, S, H), contiguous
  const float* dy;   // (Bt, S, H, P), contiguous
  float* dx;         // (Bt, S, H, P), contiguous
  float* db;         // (Bt, S, N), contiguous
  float* dc;         // (Bt, S, N), contiguous
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
  int H, S, N, Q, nc, q_pad, lg_n;
};

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
// (row stride `ss`, chunk starting at row c0) into shared [T][ld]; rows
// at or past `rows` (chunk-relative) as zeros.
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          long long base, long long ss,
                                          int c0, int r0, int rows, int cols) {
  for (int e = threadIdx.x; e < T * cols; e += THREADS) {
    const int r = e / cols, k = e - r * cols;
    dst[r * ld + k] =
        r0 + r < rows ? src[base + (long long)(c0 + r0 + r) * ss + k] : 0.f;
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
      load_rows(Ps, LP, g.x, xo, g.x_ss, c0, r0, rows, P);
      load_rows(Ns, LN, g.b, b * g.b_sb, g.b_ss, c0, r0, rows, N);
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
      load_rows(Ps, LP, g.dy, dyo, (long long)H * P, c0, r0, rows, P);
      load_rows(Ns, LN, g.c, b * g.c_sb, g.c_ss, c0, r0, rows, N);
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
  load_rows(OwnN, LN, g.b, b * g.b_sb, g.b_ss, c0, r0, rows, N);
  load_rows(OwnP, LP, g.x, xo, g.x_ss, c0, r0, rows, P);
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
    load_rows(OthN, LN, g.c, b * g.c_sb, g.c_ss, c0, i * T, rows, N);
    load_rows(OthP, LP, g.dy, dyo, dy_ss, c0, i * T, rows, P);
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
        g.dx[xo_row + tx + 16 * j] = dxa[a][j];
      const long long no_row = ((long long)(b * S + row) * H + h) * N;
#pragma unroll
      for (int k = 0; k < NJ; ++k)
        if (k < nj && tx + 16 * k < N) g.db_h[no_row + tx + 16 * k] = dba[a][k];
    }
  }

  // ---- the tile's rows as queries l: key tiles j <= t ----
  __syncthreads();   // DacCol is written; OwnN, OwnP are free
  load_rows(OwnN, LN, g.c, b * g.c_sb, g.c_ss, c0, r0, rows, N);
  load_rows(OwnP, LP, g.dy, dyo, dy_ss, c0, r0, rows, P);
  float dca[4][NJ], rowE[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    rowE[a] = 0.f;
#pragma unroll
    for (int k = 0; k < NJ; ++k) dca[a][k] = 0.f;
  }
  for (int j = 0; j <= t; ++j) {
    __syncthreads();
    load_rows(OthN, LN, g.b, b * g.b_sb, g.b_ss, c0, j * T, rows, N);
    load_rows(OthP, LP, g.x, xo, g.x_ss, c0, j * T, rows, P);
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
    g.db[i] = vb;
    g.dc[i] = vc;
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

// ---------------------------------------------------------------------------
// bfloat16: chunk-parallel on the tensor cores
// ---------------------------------------------------------------------------

namespace tcb {

using tc::LOG2E;
using tc::PAD;
using tc::T;
using tc::allow_smem;
using tc::bf16;
using tc::cp16;
using tc::cp4;
using tc::cp_commit;
using tc::cp_wait;
using tc::ex2;
using tc::ldmatrix_x2_trans;
using tc::ldmatrix_x4_trans;
using tc::load_tile;
using tc::mma;
using tc::pack;
using tc::split;

constexpr int THREADS_B = 256;              // every kernel here: 8 warps
constexpr int LW = T + PAD;                 // a staged 64 x 64 score tile
constexpr int MAXNH = MAX_N / 16;           // n-tiles a warp owns, at most
constexpr int KT = 2;                       // state float4s a thread

struct Args {
  const bf16* x;      // (Bt, S, H, P), strides (x_sb, x_ss, x_sh)
  const bf16* b;      // (Bt, S, N), strides (b_sb, b_ss)
  const bf16* c;      // (Bt, S, N), strides (c_sb, c_ss)
  const float* a;     // (Bt, S, H), contiguous
  const float* dt;    // (Bt, S, H), contiguous
  const bf16* dy;     // (Bt, S, H, P), contiguous
  bf16* dx;           // (Bt, S, H, P), contiguous
  bf16* db;           // (Bt, S, N), contiguous
  bf16* dc;           // (Bt, S, N), contiguous
  float* da;          // (Bt, S, H)
  float* ddt;         // (Bt, S, H)
  float* sloc;        // scratch (Bt, nc, H, P, N): the chunks' local states
  float* dloc;        // scratch (Bt, nc, H, P, N): local gradients, then D_c
  float* acum;        // scratch (Bt, nc, H, q_pad)
  bf16* s_hl;         // scratch (Bt, nc, H, 2, P, N): S_c as hi, lo
  bf16* d_hl;         // scratch (Bt, nc, H, 2, P, N): D_c as hi, lo
  float* sd;          // scratch (Bt, nc, H, n_sd): <D_c, S_c> by tile
  float* db_part;     // scratch (Bt, S, G, N): dB by head group
  float* dc_part;     // scratch (Bt, nc, G, n_pairs, T, N): dC by group, pair
  float* rowpart;     // scratch (Bt, nc, H, n_pairs, T): dacum's row part
  float* dac;         // scratch (Bt, S, H): dacum's other terms
  float* u;           // scratch (Bt, S, H): u_s
  long long x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss;
  int H, S, P, N, Q, nc, q_pad, nt, n_pairs, G;   // G head groups
  int n_sd;           // tiles of kernel 2 over a (P, N) state
};

// The slot of the tile pair (query tile i, key tile j <= i).
__device__ __forceinline__ int pair_slot(int i, int j) {
  return i * (i + 1) / 2 + j;
}

// Four 8 x 8 b16 matrices: lane l gives the address of row l % 8 of
// matrix l / 8; register i of lane (g, t) holds (row g; columns 2t, 2t + 1)
// of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// A fragment (rows m0 .., k0 ..) of a row-major [m][k] tile.
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const bf16* tile,
                                       int ld, int m0, int k0, int lane) {
  ldmatrix_x4(a, tile + (m0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + k0 +
                     8 * (lane >> 4));
}

// A fragment (rows m0 .., k0 ..) of the transpose of a row-major [k][m]
// tile.
__device__ __forceinline__ void a_frag_t(uint32_t (&a)[4], const bf16* tile,
                                         int ld, int m0, int k0, int lane) {
  const int mi = lane >> 3;
  ldmatrix_x4_trans(a, tile + (k0 + (lane & 7) + 8 * (mi >> 1)) * ld + m0 +
                           8 * (mi & 1));
}

// B fragments (k0 ..) of the n-tiles n0 and n0 + 8 of a row-major [n][k]
// tile: b[0], b[1] of the first, b[2], b[3] of the second.
__device__ __forceinline__ void b_frag2(uint32_t (&b)[4], const bf16* tile,
                                        int ld, int k0, int n0, int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + 8 * (lane >> 4)) * ld + k0 +
                     8 * ((lane >> 3) & 1));
}

// B fragments (k0 .., columns n0 ..) of a row-major [n][k] pair of tiles
// (hi, lo): b[0], b[1] of hi, b[2], b[3] of lo.
__device__ __forceinline__ void b_frag_hl(uint32_t (&b)[4], const bf16* hi,
                                          const bf16* lo, int ld, int k0,
                                          int n0, int lane) {
  ldmatrix_x4(b, (lane < 16 ? hi : lo) + (n0 + (lane & 7)) * ld + k0 +
                     8 * ((lane >> 3) & 1));
}

// B fragment (k0 .., columns n0 ..) of a row-major [k][n] tile.
__device__ __forceinline__ void b_frag_t(uint32_t& b0, uint32_t& b1,
                                         const bf16* tile, int ld, int k0,
                                         int n0, int lane) {
  uint32_t r[2];
  ldmatrix_x2_trans(r, tile + (k0 + (lane & 15)) * ld + n0);
  b0 = r[0];
  b1 = r[1];
}

// B fragments (k0 ..) of the n-tiles n0 and n0 + 8 of a row-major [k][n]
// tile, as b_frag2.
__device__ __forceinline__ void b_frag2_t(uint32_t (&b)[4], const bf16* tile,
                                          int ld, int k0, int n0, int lane) {
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld +
                           n0 + 8 * (lane >> 4));
}

// B fragments (k0 .., columns n0 ..) of a row-major [k][n] pair of tiles
// (hi, lo), as b_frag_hl.
__device__ __forceinline__ void b_frag_hl_t(uint32_t (&b)[4], const bf16* hi,
                                            const bf16* lo, int ld, int k0,
                                            int n0, int lane) {
  ldmatrix_x4_trans(b, (lane < 16 ? hi : lo) + (k0 + (lane & 15)) * ld + n0);
}

// acc[q] += (ah + al) . tile[k0 .. k0 + 15][8 (nw0 + q) ..] for the
// warp's nwn n-tiles of a row-major [k][n] tile, two n-tiles a load.
template <int NQ>
__device__ __forceinline__ void mma_kn(float (&acc)[NQ][4],
                                       const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4],
                                       const bf16* tile, int ld, int k0,
                                       int nw0, int nwn, int lane) {
#pragma unroll
  for (int q = 0; q < NQ; q += 2) {
    if (q + 1 < nwn) {
      uint32_t bf[4];
      b_frag2_t(bf, tile, ld, k0, 8 * (nw0 + q), lane);
      mma(acc[q], ah, bf[0], bf[1]);
      mma(acc[q], al, bf[0], bf[1]);
      mma(acc[q + 1], ah, bf[2], bf[3]);
      mma(acc[q + 1], al, bf[2], bf[3]);
    } else if (q < nwn) {
      uint32_t b0, b1;
      b_frag_t(b0, b1, tile, ld, k0, 8 * (nw0 + q), lane);
      mma(acc[q], ah, b0, b1);
      mma(acc[q], al, b0, b1);
    }
  }
}

// 16 bytes of float32 global -> shared, asynchronously.
__device__ __forceinline__ void cp16f(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// rows [0, n_rows) x cols of a row-major bf16 matrix (row stride src_ld)
// into shared [n_rows][ld], asynchronously.
__device__ __forceinline__ void load_mat(bf16* dst, int ld, const bf16* src,
                                         int src_ld, int n_rows, int cols,
                                         int tid) {
  const int per_row = cols / 8;
  for (int e = tid; e < n_rows * per_row; e += THREADS_B) {
    const int r = e / per_row, ch = e - r * per_row;
    cp16(dst + r * ld + 8 * ch, src + (long long)r * src_ld + 8 * ch, true);
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float4 fma4(float d, float4 s, float4 l) {
  return make_float4(fmaf(d, s.x, l.x), fmaf(d, s.y, l.y),
                     fmaf(d, s.z, l.z), fmaf(d, s.w, l.w));
}

// Elements 4e .. 4e + 3 of a (P N hi, P N lo) pair.
__device__ __forceinline__ void store_hl(bf16* hl, int PN, int e, float4 v) {
  uint32_t h0, l0, h1, l1;
  split(v.x, v.y, h0, l0);
  split(v.z, v.w, h1, l1);
  *reinterpret_cast<uint2*>(hl + 4 * e) = make_uint2(h0, h1);
  *reinterpret_cast<uint2*>(hl + PN + 4 * e) = make_uint2(l0, l1);
}

// -- kernel 1: the chunks' local states and state gradients ------------------
//
// Pass 1 of the forward (ssd_tc.cuh) over grid (chunk, head, 2 Bt): blocks
// z < Bt the local states of (x, B) into sloc and acum, the others the
// local gradients sum_l exp(acum_l) dy_l^T C_l into dloc.
template <int NTW>
__global__ void __launch_bounds__(tc::THREADS1)
    ssd_bwd_states(tc::Args fwd, tc::Args rev, int Bt) {
  if ((int)blockIdx.z < Bt)
    tc::chunk_state_body<NTW>(fwd, blockIdx.z, false);
  else
    tc::chunk_state_body<NTW>(rev, blockIdx.z - Bt, true);
}

template <int NTW>
int launch_states(const tc::Args& fwd, const tc::Args& rev, int Bt,
                  cudaStream_t stream) {
  static int configured = 0;
  const int bytes = tc::state_smem(fwd);
  cudaError_t err = allow_smem(ssd_bwd_states<NTW>, bytes, configured);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_states<NTW>
      <<<dim3(fwd.nc, fwd.H, 2 * Bt), tc::THREADS1, bytes, stream>>>(fwd, rev,
                                                                   Bt);
  return (int)cudaGetLastError();
}

// -- kernel 2: the passes over the chunks -------------------------------------
//
// Block (tile of 256 KT float4s of a (P, N) state, h, b); thread tid walks
// the float4s tid + 256 k of the tile, the next chunk's loads started before
// this chunk's update.  Backward over the chunks: D_c over the local
// gradient of chunk c (in place, float32) and as hi + lo, D_{c-1} =
// exp(acum_L) D_c + local.  Then forward: S_c as hi + lo, S_{c+1} =
// exp(acum_L) S_c + local, and the tile's share of <D_c, S_c> in a fixed
// order (each thread's elements in order, then the block's fixed tree).
__global__ void __launch_bounds__(THREADS_B) ssd_bwd_pass(Args g) {
  __shared__ float warp_sum[THREADS_B / 32];
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int PN = g.P * g.N, PN4 = PN / 4;
  const int e0 = blockIdx.x * THREADS_B * KT + tid;
  const long long cell0 = (long long)b * g.nc * g.H + h;   // + c H
  const auto at = [&](int c) { return cell0 + (long long)c * g.H; };
  const auto last = [&](int c) {
    return g.acum[at(c) * g.q_pad + g.q_pad - 1];
  };
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 run[KT], nxt[KT], nxd[KT];
  float a_nxt = last(g.nc - 1);
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    const int e = e0 + k * THREADS_B;
    run[k] = zero;
    nxt[k] = e < PN4 ? reinterpret_cast<const float4*>(
                           g.dloc + at(g.nc - 1) * PN)[e] : zero;
  }
  for (int c = g.nc - 1; c >= 0; --c) {
    const float d = expf(a_nxt);
    float4 cur[KT];
#pragma unroll
    for (int k = 0; k < KT; ++k) cur[k] = nxt[k];
    if (c > 0) {
      a_nxt = last(c - 1);
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        const int e = e0 + k * THREADS_B;
        if (e < PN4)
          nxt[k] = reinterpret_cast<const float4*>(g.dloc + at(c - 1) * PN)[e];
      }
    }
    float4* loc = reinterpret_cast<float4*>(g.dloc + at(c) * PN);
    bf16* hl = g.d_hl + at(c) * 2 * PN;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const int e = e0 + k * THREADS_B;
      if (e < PN4) {
        loc[e] = run[k];
        store_hl(hl, PN, e, run[k]);
        run[k] = fma4(d, run[k], cur[k]);
      }
    }
  }
  a_nxt = last(0);
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    const int e = e0 + k * THREADS_B;
    run[k] = zero;
    nxt[k] = nxd[k] = zero;
    if (e < PN4) {
      nxt[k] = reinterpret_cast<const float4*>(g.sloc + at(0) * PN)[e];
      nxd[k] = reinterpret_cast<const float4*>(g.dloc + at(0) * PN)[e];
    }
  }
  for (int c = 0; c < g.nc; ++c) {
    const float d = expf(a_nxt);
    float4 cur[KT], dd[KT];
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      cur[k] = nxt[k];
      dd[k] = nxd[k];
    }
    if (c + 1 < g.nc) {
      a_nxt = last(c + 1);
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        const int e = e0 + k * THREADS_B;
        if (e < PN4) {
          nxt[k] = reinterpret_cast<const float4*>(g.sloc + at(c + 1) * PN)[e];
          nxd[k] = reinterpret_cast<const float4*>(g.dloc + at(c + 1) * PN)[e];
        }
      }
    }
    bf16* hl = g.s_hl + at(c) * 2 * PN;
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const int e = e0 + k * THREADS_B;
      if (e < PN4) {
        const float4 s = run[k], v = dd[k];
        part = fmaf(v.x, s.x, part);
        part = fmaf(v.y, s.y, part);
        part = fmaf(v.z, s.z, part);
        part = fmaf(v.w, s.w, part);
        store_hl(hl, PN, e, s);
        run[k] = fma4(d, s, cur[k]);
      }
    }
    const float tot = block_sum(part, warp_sum);
    if (tid == 0) g.sd[at(c) * g.n_sd + blockIdx.x] = tot;
  }
}

// -- kernel 3: a key tile's rows ----------------------------------------------
//
// Block (64-row key tile j x head group x chunk c, b), GH heads h0 .. of
// the group.  Warp w owns the tile's rows 16 (w % 4) .. + 15 and half w / 4
// of each product's columns.  First the tile's rows as keys against D_c,
// the gradient leaving the chunk, head by head: V = B_j D^T, dx += w_s V,
// u_s and ddt from x_s . V_s; dB += w_s x_s D.  Then each query tile i >=
// j, each head (dy_i, its decays and C_i double-buffered): G^T = B_j C_i^T
// once per pair and group, dyx^T = x_j dy_i^T, and in registers M, W^T =
// G^T M dt_s, R^T = dyx^T M dt_s and E = G^T M dyx^T (ddt's and dacum's
// sums); W^T is staged in shared memory as hi + lo for dx += W^T dy_i.  R^T
// is summed over the group's heads in registers and staged once per pair
// for dB += Rsum^T C_i and the pair's share of dC_i, Rsum B_j, to scratch.
// Last the tile's rows as queries against S_c, the state entering the
// chunk: dC_j += exp(acum_l) dy_l S, summed over the group's heads into
// the diagonal pair's share, and dacum's state term.  D and S tiles come
// NSLOT heads ahead; fragments by ldmatrix, hi and lo of one tile in one
// load.
template <int P>
struct Tile {
  static constexpr int LX = P + PAD;       // row length of an x or dy tile
  static constexpr int NPT = P / 16;       // p n-tiles a warp owns (P / 2)
  static constexpr int NSLOT = P <= 64 ? 2 : 1;   // D, S tiles in flight
};

template <int P, int GH>
int chunk_smem(const Args& g) {
  const int LC = (g.N < 16 ? 16 : g.N) + PAD, LX = Tile<P>::LX;
  const int ds = Tile<P>::NSLOT * 2 * P * LC, st = 4 * T * LW;
  const int halves =
      GH * T * LX + 3 * T * LC + 2 * T * LX + (ds > st ? ds : st);
  const int floats = 2 * GH * T + 2 * T + 4 * GH * T + 8 * GH * T;
  return halves * 2 + floats * 4;
}

template <int P, int GH>
__global__ void __launch_bounds__(THREADS_B, 1) ssd_bwd_chunk(Args g) {
  constexpr int LX = Tile<P>::LX, NPT = Tile<P>::NPT;
  constexpr int NSLOT = Tile<P>::NSLOT;
  constexpr int CE = 0, CO = 1, XV = 2, DI = 3;   // the row sums in Red
  extern __shared__ float smem[];
  const int N = g.N, NP = N < 16 ? 16 : N, LC = NP + PAD, NT = N / 8;
  const int nh = (NT + 1) / 2;
  bf16* Xj = reinterpret_cast<bf16*>(smem);   // [GH][T][LX] x of the tile
  bf16* Bj = Xj + GH * T * LX;                // [T][LC]
  bf16* Cs = Bj + T * LC;                     // [2][T][LC] C_j, then C_i
  bf16* Dy = Cs + 2 * T * LC;                 // [2][T][LX] dy of a tile
  bf16* U = Dy + 2 * T * LX;                  // D, S tiles; or W, R staged
  bf16* Wh = U;                               // [T][LW] each
  bf16* Wl = Wh + T * LW;
  bf16* Rh = Wl + T * LW;
  bf16* Rl = Rh + T * LW;
  const int ds = NSLOT * 2 * P * LC;
  float* AcJ = reinterpret_cast<float*>(U + (ds > 4 * T * LW ? ds
                                                              : 4 * T * LW));
  float* DtJ = AcJ + GH * T;                  // [GH][T]
  float* AcI = DtJ + GH * T;                  // [2][T]
  float* ColP = AcI + 2 * T;                  // [GH][4][T]
  float* Red = ColP + 4 * GH * T;             // [4][2][GH][T]

  const int nt = g.nt;
  const int jt = blockIdx.x % nt;
  const int grp = (blockIdx.x / nt) % g.G;
  const int c = blockIdx.x / (nt * g.G);
  const int b = blockIdx.y;
  const int c0 = c * g.Q, rows = min(g.Q, g.S - c0), j0 = jt * T;
  if (j0 >= rows) return;   // the key tile is all padding
  const int nt_rows = (rows + T - 1) / T;
  const int h0 = grp * GH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rw = warp & 3, cw = warp >> 2, gq = lane >> 2, t = lane & 3;
  const int m0 = 16 * rw;                     // the warp's rows
  const int pw0 = cw * (P / 2);               // its p columns
  const int nw0 = cw * nh;                    // its n-tiles: nw0 ..
  const int nwn = max(0, min(nh, NT - nw0));  // .. nw0 + nwn - 1
  const bool has_d = c + 1 < g.nc, has_s = c > 0;
  const long long cell0 = ((long long)b * g.nc + c) * g.H + h0;
  const float* acum = g.acum + cell0 * g.q_pad;   // + hh q_pad
  const bf16* xb = g.x + b * g.x_sb + h0 * g.x_sh;
  const bf16* cb = g.c + b * g.c_sb;
  const long long dy_ss = (long long)g.H * P;
  const bf16* dyb = g.dy + (long long)b * g.S * dy_ss + (long long)h0 * P;
  const int PN = P * N;
  float* dcp = g.dc_part +
      (((long long)b * g.nc + c) * g.G + grp) * g.n_pairs * T * N;

  if (N < 16)   // zero the k-step's padding columns, never loaded
    for (int r = tid; r < 3 * T + NSLOT * 2 * P; r += THREADS_B) {
      bf16* row = r < 3 * T ? Bj + r * LC : U + (r - 3 * T) * LC;
      *reinterpret_cast<uint4*>(row + 8) = make_uint4(0, 0, 0, 0);
    }
  for (int e = tid; e < 8 * GH * T; e += THREADS_B) Red[e] = 0.f;

  // The key tile: B_j, C_j, the heads' x_j, decays and dt.
  load_tile(Bj, LC, g.b + b * g.b_sb, g.b_ss, c0, j0, rows, N, tid,
            THREADS_B);
  load_tile(Cs, LC, cb, g.c_ss, c0, j0, rows, N, tid, THREADS_B);
#pragma unroll
  for (int hh = 0; hh < GH; ++hh)
    load_tile(Xj + hh * T * LX, LX, xb + hh * g.x_sh, g.x_ss, c0, j0, rows,
              P, tid, THREADS_B);
  for (int e = tid; e < GH * T / 4; e += THREADS_B) {
    const int hh = e / (T / 4), r = 4 * (e - hh * (T / 4));
    cp16f(AcJ + hh * T + r, acum + hh * g.q_pad + j0 + r);
  }
  for (int e = tid; e < GH * T; e += THREADS_B) {
    const int r = e / GH, hh = e - r * GH, s = j0 + r;
    const bool valid = s < rows;
    cp4(DtJ + hh * T + r,
        valid ? g.dt + ((long long)b * g.S + c0 + s) * g.H + h0 + hh : g.dt,
        valid);
  }
  cp_commit();

  float dx[GH][NPT][4], dbv[MAXNH][4];
#pragma unroll
  for (int q = 0; q < MAXNH; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) dbv[q][e] = 0.f;
#pragma unroll
  for (int hh = 0; hh < GH; ++hh)
#pragma unroll
    for (int n = 0; n < NPT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dx[hh][n][e] = 0.f;

  // Head hh's D or S tile (hi rows 0 .. P - 1, lo P .. 2P - 1) into slot
  // hh % NSLOT, for S also its dy_j over its x_j, no longer read then; an
  // empty group past the last head.
  const auto fetch_state = [&](int hh, const bf16* hl, bool with_dy) {
    if (hh < GH) {
      load_mat(U + (hh % NSLOT) * 2 * P * LC, LC,
               hl + (cell0 + hh) * 2 * PN, N, 2 * P, N, tid);
      if (with_dy)
        load_tile(Xj + hh * T * LX, LX, dyb + hh * P, dy_ss, c0, j0, rows,
                  P, tid, THREADS_B);
    }
    cp_commit();
  };

  // ---- the key tile against D_c, the gradient leaving the chunk ----
  if (has_d) {
#pragma unroll
    for (int hh = 0; hh < NSLOT; ++hh) fetch_state(hh, g.d_hl, false);
#pragma unroll
    for (int hh = 0; hh < GH; ++hh) {
      cp_wait<NSLOT - 1>();
      __syncthreads();
      const bf16* Mh = U + (hh % NSLOT) * 2 * P * LC;   // D, hi
      const bf16* Ml = Mh + P * LC;                     // and lo
      const float* acj = AcJ + hh * T;
      const float* dtj = DtJ + hh * T;
      const float a_last = acum[hh * g.q_pad + g.q_pad - 1];
      // V = B_j D^T: rows s, the warp's p columns; k over n.
      float v[NPT][4];
#pragma unroll
      for (int n = 0; n < NPT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[n][e] = 0.f;
      for (int ks = 0; ks < NP / 16; ++ks) {
        uint32_t a[4];
        a_frag(a, Bj, LC, m0, 16 * ks, lane);
#pragma unroll
        for (int n = 0; n < NPT; ++n) {
          uint32_t bf[4];
          b_frag_hl(bf, Mh, Ml, LC, 16 * ks, pw0 + 8 * n, lane);
          mma(v[n], a, bf[0], bf[1]);
          mma(v[n], a, bf[2], bf[3]);
        }
      }
      // dx += w_s V; x_s . V_s over the warp's columns.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int s = m0 + gq + 8 * r;
        const float w = __fmul_rn(expf(a_last - acj[s]), dtj[s]);
        float xv = 0.f;
#pragma unroll
        for (int n = 0; n < NPT; ++n) {
          const __nv_bfloat162 xp = *reinterpret_cast<const __nv_bfloat162*>(
              Xj + (hh * T + s) * LX + pw0 + 8 * n + 2 * t);
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const float val = v[n][2 * r + cc];
            dx[hh][n][2 * r + cc] = fmaf(w, val, dx[hh][n][2 * r + cc]);
            xv = fmaf(cc ? __high2float(xp) : __low2float(xp), val, xv);
          }
        }
        xv = quad_sum(xv);
        if (t == 0) Red[((XV * 2 + cw) * GH + hh) * T + s] = xv;
      }
      // dB += w_s x_s D: rows s, the warp's n-tiles; k over p.
      float xd[MAXNH][4];
#pragma unroll
      for (int q = 0; q < MAXNH; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) xd[q][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks) {
        uint32_t a[4];
        a_frag(a, Xj + hh * T * LX, LX, m0, 16 * ks, lane);
#pragma unroll
        for (int q = 0; q < MAXNH; ++q)
          if (q < nwn) {
            uint32_t bf[4];
            b_frag_hl_t(bf, Mh, Ml, LC, 16 * ks, 8 * (nw0 + q), lane);
            mma(xd[q], a, bf[0], bf[1]);
            mma(xd[q], a, bf[2], bf[3]);
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int s = m0 + gq + 8 * r;
        const float w = __fmul_rn(expf(a_last - acj[s]), dtj[s]);
#pragma unroll
        for (int q = 0; q < MAXNH; ++q)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc)
            dbv[q][2 * r + cc] =
                fmaf(w, xd[q][2 * r + cc], dbv[q][2 * r + cc]);
      }
      __syncthreads();   // the slot is read
      fetch_state(hh + NSLOT, g.d_hl, false);
    }
  }

  // ---- the pairs: step k is query tile jt + k / GH, head k % GH; its dy
  // and decays in stage k % 2, C_i in stage (i - jt) % 2 ----
  const int n_steps = (nt_rows - jt) * GH;
  const auto fetch_step = [&](int k) {
    const int i = jt + k / GH, hh = k % GH;
    if (hh == 0 && i > jt)
      load_tile(Cs + ((i - jt) & 1) * T * LC, LC, cb, g.c_ss, c0, i * T,
                rows, N, tid, THREADS_B);
    load_tile(Dy + (k & 1) * T * LX, LX, dyb + hh * P, dy_ss, c0, i * T,
              rows, P, tid, THREADS_B);
    for (int e = tid; e < T / 4; e += THREADS_B)
      cp16f(AcI + (k & 1) * T + 4 * e, acum + hh * g.q_pad + i * T + 4 * e);
    cp_commit();
  };
  fetch_step(0);
  float G[4][4], Rs[4][4];
  for (int i = jt; i < nt_rows; ++i) {
    const bf16* Ci = Cs + ((i - jt) & 1) * T * LC;
    const bool diag = i == jt;
#pragma unroll
    for (int hh = 0; hh < GH; ++hh) {
      const int k = (i - jt) * GH + hh, st = k & 1;
      cp_wait<0>();
      __syncthreads();   // step k is in; step k - 1 is read
      if (k + 1 < n_steps) fetch_step(k + 1);
      const bf16* DyS = Dy + st * T * LX;
      const float* aci = AcI + st * T;
      const float* acj = AcJ + hh * T;
      const float* dtj = DtJ + hh * T;
      if (hh == 0) {
        // G^T = B_j C_i^T: the warp's rows s, its 32 columns l; k over n.
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) G[n][e] = Rs[n][e] = 0.f;
        for (int ks = 0; ks < NP / 16; ++ks) {
          uint32_t a[4];
          a_frag(a, Bj, LC, m0, 16 * ks, lane);
#pragma unroll
          for (int n = 0; n < 4; n += 2) {
            uint32_t bf[4];
            b_frag2(bf, Ci, LC, 16 * ks, 32 * cw + 8 * n, lane);
            mma(G[n], a, bf[0], bf[1]);
            mma(G[n + 1], a, bf[2], bf[3]);
          }
        }
      }
      // dyx^T = x_j dy_i^T; k over p.
      float xy[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) xy[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks) {
        uint32_t a[4];
        a_frag(a, Xj + hh * T * LX, LX, m0, 16 * ks, lane);
#pragma unroll
        for (int n = 0; n < 4; n += 2) {
          uint32_t bf[4];
          b_frag2(bf, DyS, LX, 16 * ks, 32 * cw + 8 * n, lane);
          mma(xy[n], a, bf[0], bf[1]);
          mma(xy[n + 1], a, bf[2], bf[3]);
        }
      }
      // M (masked before the exp on the diagonal), W^T staged as hi + lo,
      // Rsum^T, and E's sums: over l (ddt, dacum's column part) and over s
      // (dacum's row part), the diagonal left out of dacum's.
      float ce[2] = {0.f, 0.f}, co[2] = {0.f, 0.f}, cs[4][2];
#pragma unroll
      for (int n = 0; n < 4; ++n) cs[n][0] = cs[n][1] = 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int s = m0 + gq + 8 * r;
          const float ajs = acj[s], dts = dtj[s];
          float wv[2];
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int l = 32 * cw + 8 * n + 2 * t + cc, e = 2 * r + cc;
            const float m = (!diag || s <= l)
                                ? ex2(__fmul_rn(aci[l] - ajs, LOG2E)) : 0.f;
            const float gm = __fmul_rn(G[n][e], m);
            const float E = __fmul_rn(gm, xy[n][e]);
            wv[cc] = __fmul_rn(gm, dts);
            Rs[n][e] += __fmul_rn(__fmul_rn(xy[n][e], m), dts);
            ce[r] += E;
            if (!diag || s != l) {
              co[r] += E;
              cs[n][cc] = fmaf(E, dts, cs[n][cc]);
            }
          }
          uint32_t hi, lo;
          split(wv[0], wv[1], hi, lo);
          const int o = s * LW + 32 * cw + 8 * n + 2 * t;
          *reinterpret_cast<uint32_t*>(Wh + o) = hi;
          *reinterpret_cast<uint32_t*>(Wl + o) = lo;
        }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          float v = cs[n][cc];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (gq == 0)
            ColP[(hh * 4 + rw) * T + 32 * cw + 8 * n + 2 * t + cc] = v;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float e_sum = quad_sum(ce[r]), o_sum = quad_sum(co[r]);
        if (t == 0) {
          const int s = m0 + gq + 8 * r;
          Red[((CE * 2 + cw) * GH + hh) * T + s] += e_sum;
          Red[((CO * 2 + cw) * GH + hh) * T + s] += o_sum;
        }
      }
      __syncthreads();   // W is staged
      // dx += W^T dy_i: rows s, the warp's p columns; k over l.
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ah[4], al[4];
        a_frag(ah, Wh, LW, m0, 16 * kk, lane);
        a_frag(al, Wl, LW, m0, 16 * kk, lane);
        if constexpr (NPT == 1) {
          uint32_t b0, b1;
          b_frag_t(b0, b1, DyS, LX, 16 * kk, pw0, lane);
          mma(dx[hh][0], ah, b0, b1);
          mma(dx[hh][0], al, b0, b1);
        } else {
#pragma unroll
          for (int n = 0; n < NPT; n += 2) {
            uint32_t bf[4];
            b_frag2_t(bf, DyS, LX, 16 * kk, pw0 + 8 * n, lane);
            mma(dx[hh][n], ah, bf[0], bf[1]);
            mma(dx[hh][n], al, bf[0], bf[1]);
            mma(dx[hh][n + 1], ah, bf[2], bf[3]);
            mma(dx[hh][n + 1], al, bf[2], bf[3]);
          }
        }
      }
      if (hh < GH - 1) continue;

      // ---- the pair's end: Rsum^T staged as hi + lo ----
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          uint32_t hi, lo;
          split(Rs[n][2 * r], Rs[n][2 * r + 1], hi, lo);
          const int o = (m0 + gq + 8 * r) * LW + 32 * cw + 8 * n + 2 * t;
          *reinterpret_cast<uint32_t*>(Rh + o) = hi;
          *reinterpret_cast<uint32_t*>(Rl + o) = lo;
        }
      __syncthreads();
      // dacum's row part of the pair, each head: the 4 row warps in order.
      for (int e = tid; e < GH * T; e += THREADS_B) {
        const int h2 = e / T, l = e - h2 * T;
        const float* cp = ColP + h2 * 4 * T + l;
        g.rowpart[((cell0 + h2) * g.n_pairs + pair_slot(i, jt)) * T + l] =
            ((cp[0] + cp[T]) + cp[2 * T]) + cp[3 * T];
      }
      // dB_j += Rsum^T C_i: rows s, the warp's n-tiles; k over l.
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ah[4], al[4];
        a_frag(ah, Rh, LW, m0, 16 * kk, lane);
        a_frag(al, Rl, LW, m0, 16 * kk, lane);
        mma_kn(dbv, ah, al, Ci, LC, 16 * kk, nw0, nwn, lane);
      }
      // The pair's share of dC_i, Rsum B_j: rows l, the warp's n-tiles; k
      // over s.
      float dcv[MAXNH][4];
#pragma unroll
      for (int q = 0; q < MAXNH; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) dcv[q][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ah[4], al[4];
        a_frag_t(ah, Rh, LW, m0, 16 * kk, lane);
        a_frag_t(al, Rl, LW, m0, 16 * kk, lane);
        mma_kn(dcv, ah, al, Bj, LC, 16 * kk, nw0, nwn, lane);
      }
      float* o = dcp + (long long)pair_slot(i, jt) * T * N;
#pragma unroll
      for (int q = 0; q < MAXNH; ++q)
        if (q < nwn)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(o + (m0 + gq + 8 * r) * N +
                                       8 * (nw0 + q) + 2 * t) =
                make_float2(dcv[q][2 * r], dcv[q][2 * r + 1]);
    }
  }

  // dx, and the group's share of dB.
#pragma unroll
  for (int hh = 0; hh < GH; ++hh)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = m0 + gq + 8 * r;
      if (j0 + s >= rows) continue;
      bf16* dxr = g.dx +
          (((long long)b * g.S + c0 + j0 + s) * g.H + h0 + hh) * P + pw0;
#pragma unroll
      for (int n = 0; n < NPT; ++n)
        *reinterpret_cast<uint32_t*>(dxr + 8 * n + 2 * t) =
            pack(dx[hh][n][2 * r], dx[hh][n][2 * r + 1]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = m0 + gq + 8 * r;
    if (j0 + s >= rows) continue;
    float* dbr = g.db_part +
        (((long long)b * g.S + c0 + j0 + s) * g.G + grp) * N;
#pragma unroll
    for (int q = 0; q < MAXNH; ++q)
      if (q < nwn)
        *reinterpret_cast<float2*>(dbr + 8 * (nw0 + q) + 2 * t) =
            make_float2(dbv[q][2 * r], dbv[q][2 * r + 1]);
  }

  // ---- the tile's rows as queries against S_c, the state entering the
  // chunk: dC_j += exp(acum_l) dy_l S (the group's heads summed, added to
  // the diagonal pair's share) and dacum's state term ----
  if (has_s) {
    __syncthreads();   // the pairs' reads of Dy, U and Cs are done
    load_tile(Cs, LC, cb, g.c_ss, c0, j0, rows, N, tid, THREADS_B);   // C_j
#pragma unroll
    for (int hh = 0; hh < NSLOT; ++hh) fetch_state(hh, g.s_hl, true);
    float dcin[MAXNH][4];
#pragma unroll
    for (int q = 0; q < MAXNH; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) dcin[q][e] = 0.f;
#pragma unroll
    for (int hh = 0; hh < GH; ++hh) {
      cp_wait<NSLOT - 1>();
      __syncthreads();
      const bf16* Mh = U + (hh % NSLOT) * 2 * P * LC;   // S, hi
      const bf16* Ml = Mh + P * LC;                     // and lo
      const bf16* DyJ = Xj + hh * T * LX;
      // dy_j S: rows l, the warp's n-tiles; k over p.
      float tv[MAXNH][4];
#pragma unroll
      for (int q = 0; q < MAXNH; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) tv[q][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks) {
        uint32_t a[4];
        a_frag(a, DyJ, LX, m0, 16 * ks, lane);
#pragma unroll
        for (int q = 0; q < MAXNH; ++q)
          if (q < nwn) {
            uint32_t bf[4];
            b_frag_hl_t(bf, Mh, Ml, LC, 16 * ks, 8 * (nw0 + q), lane);
            mma(tv[q], a, bf[0], bf[1]);
            mma(tv[q], a, bf[2], bf[3]);
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int l = m0 + gq + 8 * r;
        const float el = expf(AcJ[hh * T + l]);
        float di = 0.f;
#pragma unroll
        for (int q = 0; q < MAXNH; ++q)
          if (q < nwn) {
            const __nv_bfloat162 cv =
                *reinterpret_cast<const __nv_bfloat162*>(
                    Cs + l * LC + 8 * (nw0 + q) + 2 * t);
#pragma unroll
            for (int cc = 0; cc < 2; ++cc) {
              const float val = __fmul_rn(el, tv[q][2 * r + cc]);
              dcin[q][2 * r + cc] += val;
              di = fmaf(val, cc ? __high2float(cv) : __low2float(cv), di);
            }
          }
        di = quad_sum(di);
        if (t == 0) Red[((DI * 2 + cw) * GH + hh) * T + l] = di;
      }
      __syncthreads();   // the slot is read
      fetch_state(hh + NSLOT, g.s_hl, true);
    }
    float* o = dcp + (long long)pair_slot(jt, jt) * T * N;
#pragma unroll
    for (int q = 0; q < MAXNH; ++q)
      if (q < nwn)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float2* p = reinterpret_cast<float2*>(o + (m0 + gq + 8 * r) * N +
                                                8 * (nw0 + q) + 2 * t);
          const float2 w = *p;   // the diagonal pair's share, from above
          *p = make_float2(w.x + dcin[q][2 * r], w.y + dcin[q][2 * r + 1]);
        }
  }

  __syncthreads();   // Red's sums are complete
  for (int e = tid; e < GH * T; e += THREADS_B) {
    const int hh = e / T, s = e - hh * T;
    if (j0 + s >= rows) continue;
    const auto red = [&](int kind) {
      return Red[((kind * 2) * GH + hh) * T + s] +
             Red[((kind * 2 + 1) * GH + hh) * T + s];
    };
    const float e_s =
        expf(acum[hh * g.q_pad + g.q_pad - 1] - AcJ[hh * T + s]);
    const float dts = DtJ[hh * T + s], xv = red(XV);
    const float u = __fmul_rn(__fmul_rn(e_s, dts), xv);
    const long long o = ((long long)b * g.S + c0 + j0 + s) * g.H + h0 + hh;
    g.ddt[o] = fmaf(e_s, xv, red(CE));
    g.u[o] = u;
    g.dac[o] = red(DI) - fmaf(dts, red(CO), u);
  }
}

// -- kernel 4: the sums over head groups and pairs, and da -------------------
//
// blockIdx.y == 0: dB and dC at (b, s, n), summed over the groups (and for
// dC the key tiles j <= the row's tile) in order.  blockIdx.y == 1: a warp
// per (b, c, h) cell: dacum from its row parts and other terms, then da by
// a reverse sum (lane-local runs, a fixed shuffle scan over the lanes).
__global__ void __launch_bounds__(THREADS_B) ssd_bwd_finish(Args g, int Bt) {
  const int H = g.H, S = g.S, N = g.N;
  if (blockIdx.y == 0) {
    const long long i = (long long)blockIdx.x * THREADS_B + threadIdx.x;
    if (i >= (long long)Bt * S * N) return;
    const long long bs = i / N;
    const int n = (int)(i - bs * N);
    const int b = (int)(bs / S), s = (int)(bs - (long long)b * S);
    const int c = s / g.Q, r = s - c * g.Q, it = r / T, rr = r - it * T;
    const long long pair_stride = (long long)T * N;
    const float* pb = g.db_part + bs * g.G * N + n;
    const float* pc = g.dc_part +
        ((long long)b * g.nc + c) * g.G * g.n_pairs * pair_stride +
        pair_slot(it, 0) * pair_stride + rr * N + n;
    float vb = 0.f, vc = 0.f;
    for (int grp = 0; grp < g.G; ++grp) {
      vb += pb[(long long)grp * N];
      const float* q = pc + (long long)grp * g.n_pairs * pair_stride;
      for (int j = 0; j <= it; ++j) vc += q[j * pair_stride];
    }
    g.db[i] = __float2bfloat16_rn(vb);
    g.dc[i] = __float2bfloat16_rn(vc);
    return;
  }
  const long long cell =
      (long long)blockIdx.x * (THREADS_B / 32) + (threadIdx.x >> 5);
  if (cell >= (long long)Bt * g.nc * H) return;   // the whole warp
  const int lane = threadIdx.x & 31;
  const int h = (int)(cell % H), c = (int)((cell / H) % g.nc);
  const int b = (int)(cell / ((long long)H * g.nc));
  const int c0 = c * g.Q, rows = min(g.Q, S - c0);
  const long long ao = ((long long)b * S + c0) * H + h;
  const float* rp = g.rowpart + cell * g.n_pairs * T;
  const auto dacum = [&](int l) {
    const int i = l / T, r = l - i * T;
    float v = g.dac[ao + (long long)l * H];
    for (int j = 0; j <= i; ++j) v += rp[pair_slot(i, j) * T + r];
    return v;
  };
  const int per = (rows + 31) / 32;
  const int lo = min(rows, lane * per), hi = min(rows, lo + per);
  float tot = 0.f, us = 0.f;
  for (int l = lo; l < hi; ++l) {
    tot += dacum(l);
    us += g.u[ao + (long long)l * H];
  }
  // What the later lanes' rows add: an inclusive suffix scan, shifted.
  float v = tot;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float w = __shfl_down_sync(0xffffffffu, v, o);
    if (lane + o < 32) v += w;
  }
  float run = __shfl_down_sync(0xffffffffu, v, 1);
  if (lane == 31) run = 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) us += __shfl_xor_sync(0xffffffffu, us, o);
  float sd = 0.f;
  for (int k = 0; k < g.n_sd; ++k) sd += g.sd[cell * g.n_sd + k];
  const float tail =
      __fmul_rn(expf(g.acum[cell * g.q_pad + g.q_pad - 1]), sd) + us;
  for (int l = hi - 1; l >= lo; --l) {
    run += dacum(l);
    g.da[ao + (long long)l * H] = run + tail;
  }
}

template <int P, int GH>
int launch_chunk(const Args& g, int Bt, cudaStream_t stream) {
  static int configured = 0;
  const int bytes = chunk_smem<P, GH>(g);
  cudaError_t err = allow_smem(ssd_bwd_chunk<P, GH>, bytes, configured);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_chunk<P, GH>
      <<<dim3(g.nt * g.G * g.nc, Bt), THREADS_B, bytes, stream>>>(g);
  return (int)cudaGetLastError();
}

template <int P>
int launch_chunk_p(const Args& g, int Bt, cudaStream_t stream) {
  if constexpr (P <= 64)
    if (g.H / g.G == 4) return launch_chunk<P, 4>(g, Bt, stream);
  return g.H == g.G ? launch_chunk<P, 1>(g, Bt, stream) : -1;
}

// The four kernels on `stream`.
int launch(const Args& g, const tc::Args& fwd, const tc::Args& rev, int Bt,
           cudaStream_t stream) {
  int err;
  switch (tc::state_ntw(fwd)) {
    case 1: err = launch_states<1>(fwd, rev, Bt, stream); break;
    case 2: err = launch_states<2>(fwd, rev, Bt, stream); break;
    case 4: err = launch_states<4>(fwd, rev, Bt, stream); break;
    case 8: err = launch_states<8>(fwd, rev, Bt, stream); break;
    case 16: err = launch_states<16>(fwd, rev, Bt, stream); break;
    default: return -1;
  }
  if (err) return err;
  ssd_bwd_pass<<<dim3(g.n_sd, g.H, Bt), THREADS_B, 0, stream>>>(g);
  if ((err = (int)cudaGetLastError())) return err;
  switch (g.P) {
    case 16: err = launch_chunk_p<16>(g, Bt, stream); break;
    case 32: err = launch_chunk_p<32>(g, Bt, stream); break;
    case 64: err = launch_chunk_p<64>(g, Bt, stream); break;
    case 128: err = launch_chunk_p<128>(g, Bt, stream); break;
    default: return -1;
  }
  if (err) return err;
  const long long n_a = ((long long)Bt * g.S * g.N + THREADS_B - 1) /
                        THREADS_B;
  const long long n_b = ((long long)Bt * g.nc * g.H + THREADS_B / 32 - 1) /
                        (THREADS_B / 32);
  ssd_bwd_finish<<<dim3((unsigned)(n_a > n_b ? n_a : n_b), 2), THREADS_B, 0,
              stream>>>(g, Bt);
  return (int)cudaGetLastError();
}

}  // namespace tcb

}  // namespace

// x (Bt, S, H, P) with strides (x_sb, x_ss, x_sh) and unit stride along P;
// b and c (Bt, S, N) with strides (sb, ss) and unit stride along N; dy (Bt,
// S, H, P) contiguous; all four of one dtype (0 float32, 1 bfloat16).  a
// and dt (Bt, S, H) float32, contiguous.  Writes dx (Bt, S, H, P), db and
// dc (Bt, S, N) contiguous in that dtype, and da and ddt (Bt, S, H)
// float32.  `scratch` holds n_scratch contiguous buffers, with nc =
// ceil(S / Q), q_pad = 64 ceil(Q / 64), nt = q_pad / 64, n_pairs = nt (nt +
// 1) / 2 and G = H / gh head groups of gh heads:
//   float32 (8): s_in, d_out (Bt, nc, H, P, N), acum (Bt, nc, H, q_pad), sd
//     (Bt, nc, H), db_h, dc_h (Bt, S, H, N), dac, u (Bt, S, H), all float32;
//   bfloat16 (11): sloc, dloc (Bt, nc, H, P, N), acum, s_hl, d_hl (Bt, nc,
//     H, 2, P, N) bfloat16, sd (Bt, nc, H, n_sd), n_sd = ceil(P N / 2048),
//     db_part (Bt, S, G, N), dc_part (Bt, nc, G,
//     n_pairs, 64, N), rowpart (Bt, nc, H, n_pairs, 64), dac, u, the rest
//     float32; gh 1, or 4 at P <= 64 with H a multiple of 4; and 16-byte
//     aligned x, b, c with strides of multiples of 8 elements.
// Launches three (float32) or four (bfloat16) kernels on `stream`.  Returns
// 0, a CUDA error code, or -1 for an unsupported dtype, P, N, chunk, head
// group or scratch count.
extern "C" int ssd_scan_bwd(
    const void* x, const void* b, const void* c, const void* a,
    const void* dt, const void* dy, void* dx, void* db, void* dc, void* da,
    void* ddt, int dtype, int Bt, int S, int H, int P, int N, int Q, int gh,
    long long x_sb, long long x_ss, long long x_sh, long long b_sb,
    long long b_ss, long long c_sb, long long c_ss, void* const* scratch,
    int n_scratch, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  if (N < 8 || N > MAX_N || (N & (N - 1)) != 0) return -1;
  if (Q < 1 || Q > MAX_Q) return -1;
  if (P != 16 && P != 32 && P != 64 && P != 128) return -1;
  if (n_scratch != (dtype == 1 ? 11 : 8)) return -1;
  if (Bt * H == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = (S + Q - 1) / Q, q_pad = (Q + T - 1) / T * T;
  const auto f32 = [&](int i) { return static_cast<float*>(scratch[i]); };
  if (dtype == 1) {
    if (!(gh == 1 || (gh == 4 && P <= 64 && H % 4 == 0))) return -1;
    typedef tc::bf16 bf;
    const int nt = q_pad / T;
    const tcb::Args g{
        static_cast<const bf*>(x), static_cast<const bf*>(b),
        static_cast<const bf*>(c), static_cast<const float*>(a),
        static_cast<const float*>(dt), static_cast<const bf*>(dy),
        static_cast<bf*>(dx), static_cast<bf*>(db), static_cast<bf*>(dc),
        static_cast<float*>(da), static_cast<float*>(ddt), f32(0), f32(1),
        f32(2), static_cast<bf*>(scratch[3]), static_cast<bf*>(scratch[4]),
        f32(5), f32(6), f32(7), f32(8), f32(9), f32(10),
        x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss,
        H, S, P, N, Q, nc, q_pad, nt, nt * (nt + 1) / 2, H / gh,
        (P * N / 4 + tcb::THREADS_B * tcb::KT - 1) /
            (tcb::THREADS_B * tcb::KT)};
    // Pass 1's two halves: (x, B) into sloc, and (dy, C) into dloc.
    const tc::Args fwd{g.x, g.b, g.c, g.a, g.dt, nullptr, nullptr, g.sloc,
                       g.acum, x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss,
                       H, S, P, N, Q, nc, q_pad};
    const long long dy_ss = (long long)H * P;
    const tc::Args rev{g.dy, g.c, g.c, g.a, g.dt, nullptr, nullptr, g.dloc,
                       g.acum, S * dy_ss, dy_ss, P, c_sb, c_ss, c_sb, c_ss,
                       H, S, P, N, Q, nc, q_pad};
    return tcb::launch(g, fwd, rev, Bt, st);
  }
  int lg_n = 0;
  while ((1 << lg_n) < N) ++lg_n;
  const Args g{static_cast<const float*>(x), static_cast<const float*>(b),
               static_cast<const float*>(c), static_cast<const float*>(a),
               static_cast<const float*>(dt), static_cast<const float*>(dy),
               static_cast<float*>(dx), static_cast<float*>(db),
               static_cast<float*>(dc), static_cast<float*>(da),
               static_cast<float*>(ddt), f32(0), f32(1), f32(2), f32(3),
               f32(4), f32(5), f32(6), f32(7),
               x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss,
               H, S, N, Q, nc, q_pad, lg_n};
  switch (P) {
    case 16: return launch<16>(g, Bt, st);
    case 32: return launch<32>(g, Bt, st);
    case 64: return launch<64>(g, Bt, st);
    default: return launch<128>(g, Bt, st);
  }
}
