// Flex placement scores of a whole queue against the node table: the
// batched argmax and the batched top-K of wavefront admission.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/flex_score/
// flex_score.py:
//   flex_batch_pick_kernel   <- `_batch_kernel` (launched by
//       `flex_score_batch_tiles`, reduced across tiles by
//       `ops.flex_pick_node_batch`);
//   flex_batch_topk_kernel   <- `_batch_topk_kernel` (launched by
//       `flex_score_batch_topk_tiles`, merged across tiles with
//       `lax.top_k` in `ops.flex_pick_node_batch_topk`).
//
// For task q (a row of task_mat = [r_0 .. r_{R-1}, penalty, cap, w_load,
// w_src]) and node n:
//   load     = penalty * est[n] + reserved[n]                    (R,)
//   feasible = all_R(load + r <= cap)
//   score    = -(w_load * max_R(load) + w_src * src_frac[q, n])
// The argmax kernel returns each task's best (score, node), the lowest
// node on ties, or (NEG_INF, -1) when nothing fits.  The top-K kernel
// returns each task's k best, ordered by (score desc, node asc), with
// (NEG_INF, -1) in the slots past its feasible nodes: the order of
// `lax.top_k` over the whole table, so the TPU kernel's per-tile lists and
// their merge have no counterpart here.
//
// Bound: a sweep reads the (Q, N) src_frac plane once (4 Q N bytes: 65.5 MB
// at Q = 4096, N = 4000, about 20 us at 3.35 TB/s); the node table (8 R N
// bytes) and the task rows are small beside it, and the arithmetic (about
// 13 operations per task and node) is a few microseconds at the card's
// float32 rate.  So bytes bound a sweep.
//
// Design: a block of 8 warps takes 8 tasks, a warp per task.  The node
// table streams through shared memory in tiles shared by the block's 8
// tasks; each lane takes every 32nd node of a tile, so a warp reads its
// task's src_frac row coalesced.  The argmax keeps one (score, node) pair
// per lane and reduces the warp by shuffles.  The top-K keeps a sorted
// list of KMAX pairs per lane in registers (insertion by compare and swap,
// fully unrolled) and merges the warp's 32 lists by k rounds of a
// shuffle argmax over the list heads, the winner popping its head.  A lane
// visits its nodes in increasing order and an equal score never displaces
// an earlier node, so ties keep the lowest index, as argmax and top_k do.
// One pass holds at most kMaxK = 32 slots; a larger k runs further passes,
// each taking the best pairs strictly after the last one the previous pass
// wrote.
//
// Rounding is that of the reference as XLA compiles it, as in
// flex_score.cu: __fmaf_rn for `penalty * est + reserved` and for
// `w_load * max + w_src * src_frac`, __fmul_rn and __fadd_rn elsewhere, and
// the build passes -fmad=false.  The plain PyTorch versions
// (kernels/flex_score/ref.py) round at the same places, so kernel and plain
// version agree bit for bit.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;   // tasks per block
constexpr int kTileFloats = 2048;       // est and reserved floats per tile
constexpr int kMaxR = 16;
constexpr int kMaxK = 32;               // slots of one top-K pass
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ bool better(float s, int i, float best_s,
                                       int best_i) {
  return s > best_s || (s == best_s && i < best_i);
}

// The best pair of the warp, on every lane (butterfly shuffles).
__device__ __forceinline__ void warp_best(float& s, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_xor_sync(0xffffffffu, s, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(os, oi, s, i)) {
      s = os;
      i = oi;
    }
  }
}

// Score of the tile's node `row` for `task`; kNegInf when it does not fit.
__device__ __forceinline__ float node_score(const float* est_s,
                                            const float* res_s, int row,
                                            int r, const float* task,
                                            float src) {
  const float penalty = task[r];
  const float cap = task[r + 1];
  bool feasible = true;
  float max_load = 0.0f;
  for (int j = 0; j < r; ++j) {
    const float load = __fmaf_rn(penalty, est_s[row * r + j],
                                 res_s[row * r + j]);
    feasible = feasible && (__fadd_rn(load, task[j]) <= cap);
    max_load = (j == 0) ? load : fmaxf(max_load, load);
  }
  return feasible
             ? -__fmaf_rn(task[r + 2], max_load, __fmul_rn(task[r + 3], src))
             : kNegInf;
}

// Streams the node table through shared memory and calls visit(row, score)
// for every node of the warp's task, lane by lane, in increasing row order.
template <typename Visit>
__device__ __forceinline__ void sweep(const float* __restrict__ est,
                                      const float* __restrict__ reserved,
                                      const float* __restrict__ src_frac,
                                      const float* __restrict__ task_mat,
                                      int n, int r, int q_count,
                                      Visit&& visit) {
  __shared__ float est_s[kTileFloats];
  __shared__ float res_s[kTileFloats];
  __shared__ float task_s[kWarps][kMaxR + 4];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int q = blockIdx.x * kWarps + warp;
  const bool active = q < q_count;
  if (active && lane < r + 4) {
    task_s[warp][lane] = task_mat[static_cast<size_t>(q) * (r + 4) + lane];
  }
  const float* src_row = src_frac + static_cast<size_t>(q) * n;
  const int tile_nodes = kTileFloats / r;
  for (int base = 0; base < n; base += tile_nodes) {
    const int rows = min(tile_nodes, n - base);
    __syncthreads();  // the previous tile is consumed; task_s is written
    for (int t = threadIdx.x; t < rows * r; t += kThreads) {
      est_s[t] = est[static_cast<size_t>(base) * r + t];
      res_s[t] = reserved[static_cast<size_t>(base) * r + t];
    }
    __syncthreads();
    if (active) {
      for (int row = lane; row < rows; row += 32) {
        visit(base + row, node_score(est_s, res_s, row, r, task_s[warp],
                                     src_row[base + row]));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    flex_batch_pick_kernel(const float* __restrict__ est,
                           const float* __restrict__ reserved,
                           const float* __restrict__ src_frac,
                           const float* __restrict__ task_mat, int n, int r,
                           int q_count, float* __restrict__ out_score,
                           int* __restrict__ out_idx) {
  float best_s = kNegInf;
  int best_i = INT_MAX;
  sweep(est, reserved, src_frac, task_mat, n, r, q_count,
        [&](int node, float s) {
          if (better(s, node, best_s, best_i)) {
            best_s = s;
            best_i = node;
          }
        });
  warp_best(best_s, best_i);
  const int q = blockIdx.x * kWarps + threadIdx.x / 32;
  if (threadIdx.x % 32 == 0 && q < q_count) {
    out_score[q] = best_s;
    out_idx[q] = best_s > kNegInf / 2 ? best_i : -1;
  }
}

// One pass of top-K: slots [col0, col0 + kpass) of each task's k slots,
// holding the best pairs after slot col0 - 1 (all of them when col0 = 0).
template <int KMAX>
__global__ void __launch_bounds__(kThreads)
    flex_batch_topk_kernel(const float* __restrict__ est,
                           const float* __restrict__ reserved,
                           const float* __restrict__ src_frac,
                           const float* __restrict__ task_mat, int n, int r,
                           int q_count, int k, int col0, int kpass,
                           float* __restrict__ out_score,
                           int* __restrict__ out_idx) {
  const int q = blockIdx.x * kWarps + threadIdx.x / 32;
  const size_t row0 = static_cast<size_t>(q) * k;
  // The last pair the previous pass wrote; every pair kept must come
  // after it.  An empty slot there means the task has no more nodes.
  float after_s = 0.0f;
  int after_i = -1;
  bool exhausted = false;
  if (col0 > 0 && q < q_count) {
    after_s = out_score[row0 + col0 - 1];
    after_i = out_idx[row0 + col0 - 1];
    exhausted = !(after_s > kNegInf / 2);
  }

  float ls[KMAX];
  int li[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    ls[j] = kNegInf;
    li[j] = INT_MAX;
  }
  sweep(est, reserved, src_frac, task_mat, n, r, q_count,
        [&](int node, float s) {
          if (exhausted || !(s > kNegInf / 2)) return;
          if (col0 > 0 && !better(after_s, after_i, s, node)) return;
          if (!better(s, node, ls[KMAX - 1], li[KMAX - 1])) return;
          float cs = s;
          int ci = node;
#pragma unroll
          for (int j = 0; j < KMAX; ++j) {
            if (better(cs, ci, ls[j], li[j])) {
              const float ts = ls[j];
              const int ti = li[j];
              ls[j] = cs;
              li[j] = ci;
              cs = ts;
              ci = ti;
            }
          }
        });

  const int lane = threadIdx.x % 32;
  for (int j = 0; j < kpass; ++j) {
    float s = ls[0];
    int i = li[0];
    warp_best(s, i);
    if (li[0] == i) {  // this lane held the winner (or every head is empty)
#pragma unroll
      for (int t = 0; t < KMAX - 1; ++t) {
        ls[t] = ls[t + 1];
        li[t] = li[t + 1];
      }
      ls[KMAX - 1] = kNegInf;
      li[KMAX - 1] = INT_MAX;
    }
    if (lane == 0 && q < q_count) {
      const bool real = s > kNegInf / 2;
      out_score[row0 + col0 + j] = real ? s : kNegInf;
      out_idx[row0 + col0 + j] = real ? i : -1;
    }
  }
}

template <int KMAX>
int launch_topk(const float* est, const float* reserved,
                const float* src_frac, const float* task_mat, int n, int r,
                int q, int k, int col0, int kpass, float* out_score,
                int* out_idx, cudaStream_t stream) {
  const int blocks = (q + kWarps - 1) / kWarps;
  flex_batch_topk_kernel<KMAX><<<blocks, kThreads, 0, stream>>>(
      est, reserved, src_frac, task_mat, n, r, q, k, col0, kpass, out_score,
      out_idx);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int n, int r, int q) {
  return n > 0 && q > 0 && r > 0 && r <= kMaxR;
}

}  // namespace

// Most resources a task row may have (the kernels keep a row in shared
// memory), and the slots one top-K launch fills.
extern "C" int flex_score_batch_max_r() { return kMaxR; }
extern "C" int flex_score_batch_pass_slots() { return kMaxK; }

// The argmax of every task, on `stream`; returns cudaGetLastError() as an
// int (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int flex_score_batch_pick(const float* est, const float* reserved,
                                     const float* src_frac,
                                     const float* task_mat, int n, int r,
                                     int q, float* out_score, int* out_idx,
                                     cudaStream_t stream) {
  if (!shape_ok(n, r, q)) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (q + kWarps - 1) / kWarps;
  flex_batch_pick_kernel<<<blocks, kThreads, 0, stream>>>(
      est, reserved, src_frac, task_mat, n, r, q, out_score, out_idx);
  return static_cast<int>(cudaGetLastError());
}

// The k best of every task, into (q, k) row-major outputs, on `stream`:
// ceil(k / 32) launches, one per pass.  Returns as flex_score_batch_pick.
extern "C" int flex_score_batch_topk(const float* est, const float* reserved,
                                     const float* src_frac,
                                     const float* task_mat, int n, int r,
                                     int q, int k, float* out_score,
                                     int* out_idx, cudaStream_t stream) {
  if (!shape_ok(n, r, q) || k <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int col0 = 0; col0 < k; col0 += kMaxK) {
    const int kpass = min(kMaxK, k - col0);
    int err;
    if (kpass <= 1) {
      err = launch_topk<1>(est, reserved, src_frac, task_mat, n, r, q, k,
                           col0, kpass, out_score, out_idx, stream);
    } else if (kpass <= 2) {
      err = launch_topk<2>(est, reserved, src_frac, task_mat, n, r, q, k,
                           col0, kpass, out_score, out_idx, stream);
    } else if (kpass <= 4) {
      err = launch_topk<4>(est, reserved, src_frac, task_mat, n, r, q, k,
                           col0, kpass, out_score, out_idx, stream);
    } else if (kpass <= 8) {
      err = launch_topk<8>(est, reserved, src_frac, task_mat, n, r, q, k,
                           col0, kpass, out_score, out_idx, stream);
    } else if (kpass <= 16) {
      err = launch_topk<16>(est, reserved, src_frac, task_mat, n, r, q, k,
                            col0, kpass, out_score, out_idx, stream);
    } else {
      err = launch_topk<32>(est, reserved, src_frac, task_mat, n, r, q, k,
                            col0, kpass, out_score, out_idx, stream);
    }
    if (err != 0) return err;
  }
  return 0;
}
