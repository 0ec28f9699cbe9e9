// One Flex placement decision over the node table: filter + score + argmax.
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/flex_score/flex_score.py (launched by
// `flex_score_tiles`, reduced across tiles by `ops.flex_pick_node`).
//
//   load     = penalty * est + reserved                    (N, R)
//   feasible = all_R(load + r <= cap)
//   score    = -(w_load * max_R(load) + w_src * src_frac), NEG_INF where
//              infeasible
//   result   = argmax (lowest index on ties), or -1 when nothing fits
//
// Bound: one decision reads est and reserved (N x R f32 each), src_frac
// (N f32) and a 24-byte task vector: 20 N bytes, 80 KB at N = 4000, about
// 24 ns at the H100's 3.35 TB/s.  A launch costs a few microseconds, so
// launch latency, not memory, bounds a decision; a CUDA graph or a
// persistent kernel that admits a whole queue is the later remedy.
//
// Design: one block of 1024 threads strides over the rows, keeping its
// best (score, index) pair; warp shuffles and then one warp reduce the
// block's 1024 pairs.  With a run axis (B independent runs, each with its
// own node table and task) block b decides for run b: one launch of B
// blocks makes one decision in every run.  Comparing (score desc, index asc) gives the lowest
// index on ties, as argmax does.  The TPU kernel's tiles, zero padding and
// tail mask have no counterpart: the loop stops at N.
//
// Rounding is that of the reference as XLA compiles it: `penalty * est +
// reserved` and `w_load * max + w_src * src_frac` are fused multiply-adds
// (__fmaf_rn, one rounding), every other product and sum rounds on its own
// (__fmul_rn, __fadd_rn), and the build passes -fmad=false so the
// compiler contracts nothing else.  The plain PyTorch version
// (kernels/flex_score/ref.py) rounds at the same places, so the two agree
// bit for bit.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ bool better(float s, int i, float best_s,
                                       int best_i) {
  return s > best_s || (s == best_s && i < best_i);
}

__device__ __forceinline__ void warp_reduce(float& s, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_down_sync(0xffffffffu, s, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(os, oi, s, i)) {
      s = os;
      i = oi;
    }
  }
}

// task = [r_0 .. r_{R-1}, penalty, cap, w_load, w_src]
__global__ void __launch_bounds__(kThreads)
    flex_pick_kernel(const float* __restrict__ est,
                     const float* __restrict__ reserved,
                     const float* __restrict__ src_frac,
                     const float* __restrict__ task, int n, int r,
                     float* __restrict__ out_score, int* __restrict__ out_idx) {
  __shared__ float warp_s[kWarps];
  __shared__ int warp_i[kWarps];

  // Run blockIdx.x's table, task and output.
  const size_t run = blockIdx.x;
  est += run * n * r;
  reserved += run * n * r;
  src_frac += run * n;
  task += run * (r + 4);
  out_score += run;
  out_idx += run;

  const float penalty = task[r];
  const float cap = task[r + 1];
  const float w_load = task[r + 2];
  const float w_src = task[r + 3];

  float best_s = kNegInf;
  int best_i = INT_MAX;
  for (int row = threadIdx.x; row < n; row += kThreads) {
    bool feasible = true;
    float max_load = 0.0f;
    for (int j = 0; j < r; ++j) {
      const float load =
          __fmaf_rn(penalty, est[row * r + j], reserved[row * r + j]);
      feasible = feasible && (__fadd_rn(load, task[j]) <= cap);
      max_load = (j == 0) ? load : fmaxf(max_load, load);
    }
    const float score =
        feasible ? -__fmaf_rn(w_load, max_load, __fmul_rn(w_src, src_frac[row]))
                 : kNegInf;
    if (better(score, row, best_s, best_i)) {
      best_s = score;
      best_i = row;
    }
  }

  warp_reduce(best_s, best_i);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if (lane == 0) {
    warp_s[warp] = best_s;
    warp_i[warp] = best_i;
  }
  __syncthreads();
  if (warp == 0) {
    best_s = warp_s[lane];
    best_i = warp_i[lane];
    warp_reduce(best_s, best_i);
    if (lane == 0) {
      *out_score = best_s;
      *out_idx = best_s > kNegInf / 2 ? best_i : -1;
    }
  }
}

}  // namespace

// Launches one decision in each of `runs` runs on `stream` (run b's
// tables, src_frac, task vector and output at b times their size); returns
// cudaGetLastError() as an int.
extern "C" int flex_score_pick(const float* est, const float* reserved,
                               const float* src_frac, const float* task, int n,
                               int r, float* out_score, int* out_idx,
                               cudaStream_t stream, int runs) {
  if (runs < 1) return static_cast<int>(cudaErrorInvalidValue);
  flex_pick_kernel<<<runs, kThreads, 0, stream>>>(
      est, reserved, src_frac, task, n, r, out_score, out_idx);
  return static_cast<int>(cudaGetLastError());
}
