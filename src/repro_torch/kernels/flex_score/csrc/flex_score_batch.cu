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
// `lax.top_k` over the whole table.
//
// Bound: a sweep reads the (Q, N) src_frac plane once (4 Q N bytes: 65.5 MB
// at Q = 4096, N = 4000, about 20 us at 3.35 TB/s); the node table (8 R N
// bytes) and the task rows are small beside it, and the arithmetic (about
// 13 operations per task and node) is a few microseconds at the card's
// float32 rate.  So bytes bound a sweep, and the design is about keeping
// enough of them in flight.
//
// Design.  A work unit is one task and one chunk of the node range, and a
// warp takes one unit; a block holds kWarps units.  The launcher picks the
// chunk (`batch_plan` in flex_score.py): the whole range when the queue
// alone fills the card, else the range split so that about 16 warps
// stream on every SM (Q = 1, 33, 64), each chunk a multiple of 4 nodes.
// A lane takes whole quads of 4 nodes, 32 quads apart, and loads kUnroll
// of them before it scores any: a 16-byte streaming load of src_frac per
// quad (scalar loads where the task's row does not start on 16 bytes, as
// at N % 4 != 0, and in a ragged last quad).  Registers are held to 64 so
// that 4 blocks fit on an SM: at Q = 4096 the whole grid is resident, 31
// warps an SM with 1 KB each in flight.  The node table is read through
// the L1 cache, which holds it across the SM's blocks (64 KB at N = 4000,
// R = 2); src_frac is read with evict-first loads so that it does not
// push the table out.  At R = 2 on a 16-byte aligned table a quad's est
// and reserved are four 16-byte loads; any other R (up to kMaxR), or a
// table off 16 bytes, takes the same kernel instantiated with R read at
// run time.
//
// Every node a warp scores comes after every node it has scored before
// (a call of the sweep's visit covers the next 128 nodes), so within a
// warp a strict `>` on the score alone keeps the lowest node among equal
// scores; lanes, chunks and merges combine pairs by better(), the total
// order (score desc, node asc).  The argmax keeps one pair per lane.  The
// top-K keeps, per warp, the 32 best pairs so far in registers (lane j
// holds rank j) and the pair at rank k - 1 as a warp-wide threshold
// (FAISS's WarpSelect: Johnson, Douze and Jegou, "Billion-scale
// similarity search with GPUs", 2017).  A node is a candidate only if its
// score beats the threshold's, one compare; a quad in which no lane has
// one costs one vote.  Candidates go to a per-warp buffer in shared
// memory (a ballot and a prefix count); at 32 the warp sorts them (a
// bitonic sort over the lanes) and merges them into its list (a bitonic
// merge), which raises the threshold.  The first time any lane has a
// candidate, each lane's best goes straight into the list, so that the
// threshold rises before the rest are tested.  One pass holds at most
// kMaxK = 32 slots; a larger k runs further passes, each taking the best
// pairs strictly after the last one the previous pass wrote.
//
// With a run axis (B independent runs, each with its own node table) the
// runs' queues are one flattened queue of B Q tasks, rows of task_mat and
// src_frac as one run's are; task q scores against run q / Q's table.
// The grid, the split and the merge are those of one queue of B Q tasks.
//
// When the node range is split, each unit writes its partial (the argmax
// pair, or the pass's k-list) to scratch the launcher allocates, and a
// second small kernel merges a task's partials under the same total
// order: the TPU kernels' per-tile partials and their merge, here across
// blocks.  A launcher call counts as one launch (per top-K pass) whether
// or not the merge runs.
//
// Measured (chip_smoke.py phase a, NVIDIA H100 80GB HBM3, 700 W): at
// N = 4000, Q = 4096 the argmax takes about 24 us and the top-K (K = 8)
// about 37 us, replayed from a CUDA graph: 0.80 and 0.53 of the bound.
//
// Rounding is that of the reference as XLA compiles it, as in
// flex_score.cu: __fmaf_rn for `penalty * est + reserved` and for
// `w_load * max + w_src * src_frac`, __fmul_rn and __fadd_rn elsewhere, and
// the build passes -fmad=false.  The plain PyTorch versions
// (kernels/flex_score/ref.py) round at the same places, so kernel and plain
// version agree bit for bit.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;   // work units per block
constexpr int kBlocksPerSm = 4;         // the sweeps' registers fit 4 blocks
constexpr int kUnroll = 2;              // quads a lane loads before scoring
constexpr int kMaxR = 16;
constexpr int kMaxK = 32;               // slots of one top-K pass
constexpr int kBuf = 32 * 5;            // a warp's candidates: < 32 + a quad's
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ bool better(float s, int i, float best_s,
                                       int best_i) {
  return s > best_s || (s == best_s && i < best_i);
}

// The best pair of the warp, on every lane (butterfly shuffles).
__device__ __forceinline__ void warp_best(float& s, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_xor_sync(kFull, s, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (better(os, oi, s, i)) {
      s = os;
      i = oi;
    }
  }
}

// One task row: R resources in registers (read from the row when R = 0,
// the run-time instance), then penalty, cap, w_load, w_src.
template <int R>
struct TaskRow {
  float req[R > 0 ? R : 1];
  const float* row;
  float penalty, cap, w_load, w_src;

  __device__ __forceinline__ TaskRow(const float* task_mat, int q, int r) {
    row = task_mat + static_cast<size_t>(q) * (r + 4);
    if constexpr (R > 0) {
#pragma unroll
      for (int j = 0; j < R; ++j) req[j] = __ldg(row + j);
    }
    penalty = __ldg(row + r);
    cap = __ldg(row + r + 1);
    w_load = __ldg(row + r + 2);
    w_src = __ldg(row + r + 3);
  }
  __device__ __forceinline__ float r_at(int j) const {
    if constexpr (R > 0) {
      return req[j];
    } else {
      return __ldg(row + j);
    }
  }
};

// Score of one node (its est and reserved rows at `e` and `res`);
// kNegInf when it does not fit.
template <int R>
__device__ __forceinline__ float node_score(const TaskRow<R>& t,
                                            const float* e, const float* res,
                                            int r, float src) {
  const int rr = R > 0 ? R : r;
  bool feasible = true;
  float max_load = 0.0f;
#pragma unroll
  for (int j = 0; j < rr; ++j) {
    const float load = __fmaf_rn(t.penalty, e[j], res[j]);
    feasible = feasible && (__fadd_rn(load, t.r_at(j)) <= t.cap);
    max_load = (j == 0) ? load : fmaxf(max_load, load);
  }
  return feasible
             ? -__fmaf_rn(t.w_load, max_load, __fmul_rn(t.w_src, src))
             : kNegInf;
}

// src_frac of quad j of a task's row (nodes 4j .. 4j + cnt - 1).
__device__ __forceinline__ void load_src(const float* row, bool aligned,
                                         int j, int cnt, float (&v)[4]) {
  if (aligned && cnt == 4) {
    const float4 x = __ldcs(reinterpret_cast<const float4*>(row) + j);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < cnt ? __ldcs(row + 4 * j + e) : 0.f;
  }
}

// Scores of quad j; kNegInf past the `cnt` nodes it has.
template <int R>
__device__ __forceinline__ void quad_scores(const TaskRow<R>& t,
                                            const float* __restrict__ est,
                                            const float* __restrict__ res,
                                            int r, int j, int cnt,
                                            const float (&v)[4],
                                            float (&s)[4]) {
  if constexpr (R == 2) {
    if (cnt == 4) {  // the instance runs only on a 16-byte aligned table
      const float4* e4 = reinterpret_cast<const float4*>(est) + 2 * j;
      const float4* r4 = reinterpret_cast<const float4*>(res) + 2 * j;
      const float4 ea = __ldg(e4), eb = __ldg(e4 + 1);
      const float4 ra = __ldg(r4), rb = __ldg(r4 + 1);
      const float ev[8] = {ea.x, ea.y, ea.z, ea.w, eb.x, eb.y, eb.z, eb.w};
      const float rv[8] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[e] = node_score<2>(t, ev + 2 * e, rv + 2 * e, 2, v[e]);
      }
      return;
    }
  }
  const int rr = R > 0 ? R : r;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (e < cnt) {
      float ev[R > 0 ? R : kMaxR], rv[R > 0 ? R : kMaxR];
      const size_t at = static_cast<size_t>(4 * j + e) * rr;
#pragma unroll
      for (int x = 0; x < (R > 0 ? R : kMaxR); ++x) {
        if (x < rr) {
          ev[x] = __ldg(est + at + x);
          rv[x] = __ldg(res + at + x);
        }
      }
      s[e] = node_score<R>(t, ev, rv, r, v[e]);
    } else {
      s[e] = kNegInf;
    }
  }
}

// The warp's work unit: task q against nodes [n0, n1).  Calls
// visit(s, node0) on every lane for each of its quads, kNegInf past the
// unit's last node, in increasing node order: a lane's quads increase, and
// every node of a call comes after every node of the warp's earlier calls.
// Every lane makes the same number of calls.
template <int R, typename Visit>
__device__ __forceinline__ void sweep(const float* __restrict__ est,
                                      const float* __restrict__ res,
                                      const float* __restrict__ src_frac,
                                      const TaskRow<R>& t, int q, int n,
                                      int r, int n0, int n1, Visit&& visit) {
  const int lane = threadIdx.x % 32;
  const float* row = src_frac + static_cast<size_t>(q) * n;
  const bool aligned = (reinterpret_cast<uintptr_t>(row) & 15) == 0;
  const int j0 = n0 / 4;
  const int j1 = (n1 + 3) / 4;
  for (int jb = j0; jb < j1; jb += 32 * kUnroll) {
    float v[kUnroll][4];
    int cnt[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = jb + lane + 32 * u;
      cnt[u] = j < j1 ? min(4, n - 4 * j) : 0;
      load_src(row, aligned, j, cnt[u], v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = jb + lane + 32 * u;
      float s[4];
      quad_scores<R>(t, est, res, r, j, cnt[u], v[u], s);
      visit(s, 4 * j);
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    flex_batch_pick_kernel(const float* __restrict__ est,
                           const float* __restrict__ reserved,
                           const float* __restrict__ src_frac,
                           const float* __restrict__ task_mat, int n, int r,
                           int q_count, int q_run, int chunk, int splits,
                           float* __restrict__ dst_score,
                           int* __restrict__ dst_idx) {
  const int unit = blockIdx.x * kWarps + threadIdx.x / 32;
  if (unit >= q_count * splits) return;
  const int q = unit / splits;
  const int n0 = (unit % splits) * chunk;
  const size_t table = static_cast<size_t>(q / q_run) * n * r;  // q's run
  const TaskRow<R> t(task_mat, q, r);
  float best_s = kNegInf;
  int best_i = INT_MAX;
  sweep<R>(est + table, reserved + table, src_frac, t, q, n, r, n0,
           min(n, n0 + chunk),
           [&](const float (&s)[4], int node0) {
#pragma unroll
             for (int e = 0; e < 4; ++e) {
               if (s[e] > best_s) {
                 best_s = s[e];
                 best_i = node0 + e;
               }
             }
           });
  warp_best(best_s, best_i);
  if (threadIdx.x % 32 == 0) {
    if (splits == 1) {  // the final answer
      dst_score[q] = best_s;
      dst_idx[q] = best_s > kNegInf / 2 ? best_i : -1;
    } else {  // the chunk's partial
      dst_score[unit] = best_s;
      dst_idx[unit] = best_i;
    }
  }
}

// Each task's best of its `splits` partials, one thread per task.
__global__ void flex_batch_pick_merge(const float* __restrict__ part_score,
                                      const int* __restrict__ part_idx,
                                      int q_count, int splits,
                                      float* __restrict__ out_score,
                                      int* __restrict__ out_idx) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= q_count) return;
  float best_s = kNegInf;
  int best_i = INT_MAX;
  for (int c = 0; c < splits; ++c) {
    const size_t at = static_cast<size_t>(q) * splits + c;
    const float s = part_score[at];
    const int i = part_idx[at];
    if (better(s, i, best_s, best_i)) {
      best_s = s;
      best_i = i;
    }
  }
  out_score[q] = best_s;
  out_idx[q] = best_s > kNegInf / 2 ? best_i : -1;
}

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x % 32)) - 1u;
}

// Compare-and-exchange with the lane `j` away: keep the better pair when
// `first`, else the worse.  (Two equal pairs are the same empty slot, so
// taking the other one changes nothing.)
__device__ __forceinline__ void exchange(float& s, int& i, int j,
                                         bool first) {
  const float os = __shfl_xor_sync(kFull, s, j);
  const int oi = __shfl_xor_sync(kFull, i, j);
  if (better(os, oi, s, i) == first) {
    s = os;
    i = oi;
  }
}

struct Pair {
  float s;
  int i;
};

// The lane's entry of the best 32 of the warp's list (ls, li: lane j holds
// rank j) and the lanes' 32 pairs (cs, ci).  Sorts the pairs (a bitonic
// sort over the lanes, best first), keeps the better of rank j and the
// pairs' rank 31 - j (the best 32 of both, as a bitonic sequence) and
// sorts that.  Not inlined: it runs a few times per work unit, and a copy
// at every call site would crowd the sweep's instruction cache.
__device__ __noinline__ Pair merge_into(float ls, int li, float cs, int ci) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      exchange(cs, ci, j, ((lane & j) == 0) == ((lane & k) == 0));
    }
  }
  const float rs = __shfl_sync(kFull, cs, 31 - lane);
  const int ri = __shfl_sync(kFull, ci, 31 - lane);
  if (better(rs, ri, ls, li)) {
    ls = rs;
    li = ri;
  }
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) exchange(ls, li, j, (lane & j) == 0);
  return {ls, li};
}

// A warp's running top list: lane j holds rank j of the best pairs merged
// so far (32 of them), the pair at rank `kth` is the threshold, and a
// buffer in shared memory holds the candidates not yet merged.  Until
// rank `kth` is real the threshold is (kNegInf, -1), which every feasible
// node beats and no infeasible one does.
struct WarpTopK {
  float ls;
  int li;
  float th_s;
  int th_i;
  int kth;
  int count;
  bool fresh;  // nothing merged yet
  float* buf_s;
  int* buf_i;

  __device__ __forceinline__ WarpTopK(int kpass, float* bs, int* bi)
      : ls(kNegInf), li(INT_MAX), th_s(kNegInf), th_i(-1), kth(kpass - 1),
        count(0), fresh(true), buf_s(bs), buf_i(bi) {}

  // Whether pair (s, i) beats the threshold.
  __device__ __forceinline__ bool beats(float s, int i) const {
    return better(s, i, th_s, th_i);
  }

  // Merges the lanes' pairs (cs, ci) into the list; raises the threshold.
  __device__ __forceinline__ void absorb(float cs, int ci) {
    const Pair p = merge_into(ls, li, cs, ci);
    ls = p.s;
    li = p.i;
    th_s = __shfl_sync(kFull, ls, kth);
    th_i = __shfl_sync(kFull, li, kth);
    if (!(th_s > kNegInf / 2)) th_i = -1;
    fresh = false;
  }

  // Every lane offers its pair; `cand` says whether it is one.  Appends
  // the candidates to the buffer; drain() merges them.
  __device__ __forceinline__ void push(float s, int i, bool cand) {
    const unsigned m = __ballot_sync(kFull, cand);
    if (cand) {
      const int at = count + __popc(m & lanes_below());
      buf_s[at] = s;
      buf_i[at] = i;
    }
    count += __popc(m);
  }

  // Merges the buffer's first 32 candidates while it holds that many.
  __device__ __forceinline__ void drain() {
    const int lane = threadIdx.x % 32;
    while (count >= 32) {
      __syncwarp();
      const float cs = buf_s[lane];
      const int ci = buf_i[lane];
      // Shift the rest down 32: each slot is read and written by one lane.
      for (int at = lane + 32; at < count; at += 32) {
        buf_s[at - 32] = buf_s[at];
        buf_i[at - 32] = buf_i[at];
      }
      count -= 32;
      __syncwarp();
      absorb(cs, ci);
    }
  }

  // Offers a quad's pairs (s, node0 + e), those with c[e] set.  The first
  // time any lane has one, each lane's best goes straight into the list,
  // so that the threshold is raised before the rest are tested: else
  // every feasible node of the first quads would be a candidate.
  __device__ __forceinline__ void offer(const float (&s)[4], int node0,
                                        bool (&c)[4]) {
    if (fresh) {
      float bs = kNegInf;
      int bi = INT_MAX;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (c[e] && better(s[e], node0 + e, bs, bi)) {
          bs = s[e];
          bi = node0 + e;
        }
      }
      absorb(bs, bi);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        c[e] = c[e] && node0 + e != bi && beats(s[e], node0 + e);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) push(s[e], node0 + e, c[e]);
    drain();
  }

  // Merges what the buffer still holds.
  __device__ __forceinline__ void flush() {
    drain();
    if (count == 0) return;
    const int lane = threadIdx.x % 32;
    __syncwarp();
    const float cs = lane < count ? buf_s[lane] : kNegInf;
    const int ci = lane < count ? buf_i[lane] : INT_MAX;
    count = 0;
    __syncwarp();
    absorb(cs, ci);
  }
};

// One pass of top-K: slots [col0, col0 + kpass) of each task's k slots,
// holding the best pairs after slot col0 - 1 (all of them when col0 = 0).
// With one chunk it writes them to out; else each unit writes its
// chunk's kpass best to part (a stride of kp slots per unit).  kAfter:
// col0 > 0.
template <int R, bool kAfter>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    flex_batch_topk_kernel(const float* __restrict__ est,
                           const float* __restrict__ reserved,
                           const float* __restrict__ src_frac,
                           const float* __restrict__ task_mat, int n, int r,
                           int q_count, int q_run, int chunk, int splits,
                           int k, int col0, int kpass, int kp,
                           float* __restrict__ part_score,
                           int* __restrict__ part_idx,
                           float* __restrict__ out_score,
                           int* __restrict__ out_idx) {
  __shared__ float buf_s[kWarps][kBuf];
  __shared__ int buf_i[kWarps][kBuf];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int unit = blockIdx.x * kWarps + warp;
  if (unit >= q_count * splits) return;
  const int q = unit / splits;
  const int n0 = (unit % splits) * chunk;
  const size_t row0 = static_cast<size_t>(q) * k;
  // The last pair the previous pass wrote; every pair kept must come
  // after it.  An empty slot there means the task has no more nodes.
  float after_s = 0.0f;
  int after_i = -1;
  if (kAfter) {
    after_s = out_score[row0 + col0 - 1];
    after_i = out_idx[row0 + col0 - 1];
  }
  WarpTopK top(kpass, buf_s[warp], buf_i[warp]);
  if (!kAfter || after_s > kNegInf / 2) {
    const size_t table = static_cast<size_t>(q / q_run) * n * r;  // q's run
    const TaskRow<R> t(task_mat, q, r);
    sweep<R>(est + table, reserved + table, src_frac, t, q, n, r, n0,
             min(n, n0 + chunk),
             [&](const float (&s)[4], int node0) {
               // Every node merged so far comes before node0, so a node
               // beats the threshold only by its score.
               bool c[4];
               bool any = false;
#pragma unroll
               for (int e = 0; e < 4; ++e) {
                 c[e] = s[e] > top.th_s &&
                        (!kAfter ||
                         better(after_s, after_i, s[e], node0 + e));
                 any = any || c[e];
               }
               if (__any_sync(kFull, any)) top.offer(s, node0, c);
             });
    top.flush();
  }
  if (lane < kpass) {
    if (splits == 1) {
      const bool real = top.ls > kNegInf / 2;
      out_score[row0 + col0 + lane] = real ? top.ls : kNegInf;
      out_idx[row0 + col0 + lane] = real ? top.li : -1;
    } else {
      const size_t at = static_cast<size_t>(unit) * kp + lane;
      part_score[at] = top.ls;
      part_idx[at] = top.li;
    }
  }
}

// Slots [col0, col0 + kpass) of each task from its `splits` partial lists
// (kpass pairs each, kp apart), one warp per task.
__global__ void __launch_bounds__(kThreads)
    flex_batch_topk_merge(const float* __restrict__ part_score,
                          const int* __restrict__ part_idx, int q_count,
                          int splits, int k, int col0, int kpass, int kp,
                          float* __restrict__ out_score,
                          int* __restrict__ out_idx) {
  __shared__ float buf_s[kWarps][kBuf];
  __shared__ int buf_i[kWarps][kBuf];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q = blockIdx.x * kWarps + warp;
  if (q >= q_count) return;
  WarpTopK top(kpass, buf_s[warp], buf_i[warp]);
  const int pairs = splits * kpass;
  for (int base = 0; base < pairs; base += 32) {
    const int t = base + lane;
    float s = kNegInf;
    int i = INT_MAX;
    if (t < pairs) {
      const size_t at =
          (static_cast<size_t>(q) * splits + t / kpass) * kp + t % kpass;
      s = part_score[at];
      i = part_idx[at];
    }
    top.push(s, i, top.beats(s, i));
    top.drain();
  }
  top.flush();
  if (lane < kpass) {
    const size_t row0 = static_cast<size_t>(q) * k;
    const bool real = top.ls > kNegInf / 2;
    out_score[row0 + col0 + lane] = real ? top.ls : kNegInf;
    out_idx[row0 + col0 + lane] = real ? top.li : -1;
  }
}

bool shape_ok(int n, int r, int q, int chunk, const void* part_score,
              const void* part_idx) {
  if (n <= 0 || q <= 0 || r <= 0 || r > kMaxR || chunk <= 0 || chunk % 4) {
    return false;
  }
  return chunk >= n || (part_score != nullptr && part_idx != nullptr);
}

// Whether the R = 2 instance may run: it reads every run's table 16 bytes
// at a time.
bool table_vectors(int r, int n, int runs, const float* est,
                   const float* reserved) {
  return r == 2 && (runs == 1 || n % 2 == 0) &&
         (reinterpret_cast<uintptr_t>(est) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(reserved) & 15) == 0;
}

int blocks_for(long long units) {
  return static_cast<int>((units + kWarps - 1) / kWarps);
}

}  // namespace

// Most resources a task row may have, and the slots one top-K pass fills.
extern "C" int flex_score_batch_max_r() { return kMaxR; }
extern "C" int flex_score_batch_pass_slots() { return kMaxK; }

// The argmax of every task of `runs` runs (q each, run b's table at b
// times its size, its tasks after run b - 1's), on `stream`, over chunks
// of `chunk` nodes (a multiple of 4; chunk >= n sweeps each task's row
// whole).  With more than
// one chunk, part_score/part_idx hold q * ceil(n / chunk) partials and a
// merge kernel follows.  Returns cudaGetLastError() as an int
// (cudaErrorInvalidValue for a shape the kernels do not take).
extern "C" int flex_score_batch_pick(const float* est, const float* reserved,
                                     const float* src_frac,
                                     const float* task_mat, int n, int r,
                                     int q, int chunk, float* part_score,
                                     int* part_idx, float* out_score,
                                     int* out_idx, cudaStream_t stream,
                                     int runs) {
  if (runs < 1 || !shape_ok(n, r, q, chunk, part_score, part_idx)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int q_run = q;
  q *= runs;
  const int splits = (n + chunk - 1) / chunk;
  float* dst_s = splits == 1 ? out_score : part_score;
  int* dst_i = splits == 1 ? out_idx : part_idx;
  const int blocks = blocks_for(static_cast<long long>(q) * splits);
  if (table_vectors(r, n, runs, est, reserved)) {
    flex_batch_pick_kernel<2><<<blocks, kThreads, 0, stream>>>(
        est, reserved, src_frac, task_mat, n, r, q, q_run, chunk, splits,
        dst_s, dst_i);
  } else {
    flex_batch_pick_kernel<0><<<blocks, kThreads, 0, stream>>>(
        est, reserved, src_frac, task_mat, n, r, q, q_run, chunk, splits,
        dst_s, dst_i);
  }
  if (splits > 1) {
    flex_batch_pick_merge<<<(q + kThreads - 1) / kThreads, kThreads, 0,
                            stream>>>(part_score, part_idx, q, splits,
                                      out_score, out_idx);
  }
  return static_cast<int>(cudaGetLastError());
}

// The k best of every task of `runs` runs (laid out as for
// flex_score_batch_pick), into (runs q, k) row-major outputs, on `stream`:
// ceil(k / 32) passes, each one sweep (and, with more than one chunk, a
// merge over part_score/part_idx, which hold q * ceil(n / chunk) *
// min(k, 32) pairs).  Returns as flex_score_batch_pick.
extern "C" int flex_score_batch_topk(const float* est, const float* reserved,
                                     const float* src_frac,
                                     const float* task_mat, int n, int r,
                                     int q, int k, int chunk,
                                     float* part_score, int* part_idx,
                                     float* out_score, int* out_idx,
                                     cudaStream_t stream, int runs) {
  if (runs < 1 || !shape_ok(n, r, q, chunk, part_score, part_idx) ||
      k <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int q_run = q;
  q *= runs;
  const int splits = (n + chunk - 1) / chunk;
  const int kp = k < kMaxK ? k : kMaxK;
  const int blocks = blocks_for(static_cast<long long>(q) * splits);
  const bool vec = table_vectors(r, n, runs, est, reserved);
  for (int col0 = 0; col0 < k; col0 += kMaxK) {
    const int kpass = k - col0 < kMaxK ? k - col0 : kMaxK;
    auto kernel = vec ? (col0 > 0 ? flex_batch_topk_kernel<2, true>
                                  : flex_batch_topk_kernel<2, false>)
                      : (col0 > 0 ? flex_batch_topk_kernel<0, true>
                                  : flex_batch_topk_kernel<0, false>);
    kernel<<<blocks, kThreads, 0, stream>>>(
        est, reserved, src_frac, task_mat, n, r, q, q_run, chunk, splits, k,
        col0, kpass, kp, part_score, part_idx, out_score, out_idx);
    if (splits > 1) {
      flex_batch_topk_merge<<<blocks_for(q), kThreads, 0, stream>>>(
          part_score, part_idx, q, splits, k, col0, kpass, kp, out_score,
          out_idx);
    }
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return 0;
}
