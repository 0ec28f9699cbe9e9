// A whole queue of Flex placement decisions, admitted in order in one
// launch: the sequential admission scan with the node table held on chip.
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/flex_score/flex_score.py (launched by
// `flex_score_tiles`) where the reference runs it: in the body of the
// `lax.scan` over `admit_one` in src/repro/api/admission.py
// (`admit_queue`, use_kernel=True), which makes a slot's queue one device
// program on the TPU.  flex_score.cu keeps the one-decision kernel for
// the callers of `pick_node` and `admit_one`.
//
// For each queued task q in order (task row q = [r_0 .. r_{R-1}, penalty,
// cap, w_load, w_src], source bucket srcs[q], valid[q]):
//   src_frac = f32(src_count[n, src]) / f32(max(n_tasks[n], 1))   (IEEE)
//   load     = penalty * est[n] + reserved[n]                      (R,)
//   feasible = all_R(load + r <= cap)
//   score    = -(w_load * max_R(load) + w_src * src_frac), NEG_INF where
//              infeasible
//   pick     = argmax (lowest node on ties); ok = any feasible && valid
// then the reference's commit: at node c = ok ? pick : 0, reserved[c] and
// requested[c] add ok * r, n_tasks[c] adds ok and src_count[c, src] adds
// ok; placements[q] = ok ? pick : -1.
//
// Bound.  Each input is read once and each output written once: est,
// reserved, requested, n_tasks and src_count (284 N bytes in, 276 N out
// at R = 2), the task rows; 2.4 MB at N = 4000, under a microsecond at
// 3.35 TB/s.  The arithmetic, about 14 float32 operations per (task, node),
// is 3.2 us for Q = 4096 at N = 4000 at the card's 67 TFLOP/s.  Neither
// binds: decision q + 1 depends on decision q's commit, so a queue is a
// chain of Q dependent argmaxes, and the latency of one link (a pass over
// the node table, a reduction across the cluster, a commit) sets the time.
//
// Design.  One thread-block cluster of kCluster CTAs admits the queue.
// With a run axis (B independent runs, each with its own node table and
// queue) the grid holds B clusters and cluster b admits run b's queue into
// run b's tables; the clusters share nothing, so everything below is per
// cluster.  About 8 clusters of the largest on-chip plan (N = 4000 at
// R = 2: 69.6 KB a CTA) fit an H100 at once; more runs go in waves.
// CTA k owns the node rows [k rows, (k + 1) rows) and keeps them in its
// shared memory for the whole queue: est and reserved (stored (R, rows),
// one resource's column contiguous), n_tasks and, where they fit (the
// launcher's plan, flex_score.py `admit_plan`), the rows of src_count,
// stored transposed as (64, rows) so that a decision's column is
// contiguous (row-major, every row's entry of one source falls in one
// bank).  Where src_count does not fit (N above ~13,400 at R = 2), the
// kSrcOnChip = false instance gathers it from global memory, where it is
// L2-resident (25.6 MB at N = 100,000), and commits to it there.  A
// thread owns the rows tid, tid + kThreads, ... of its CTA for the whole
// queue: it scores them and it alone commits to them, so no barrier
// inside the CTA orders a commit before the next pass.
//
// Per decision:
//   1. each thread scores its rows, keeping the best (score, node) pair;
//      within a thread the nodes come in increasing order, so a strict `>`
//      keeps the lowest node among equal scores;
//   2. the CTA reduces its pairs (a warp reduction, then warp 0 over the
//      warps' pairs), every merge in the order (score desc, node asc): the
//      score as an order-preserving unsigned key, so that one merge is two
//      warp reductions (redux.sync: max of the keys, then min of the nodes
//      that hold it) instead of five rounds of shuffles;
//   3. warp 0's lane k stores the CTA's pair into slot (q & 1, rank) of
//      CTA k's shared memory with st.async (distributed shared memory),
//      which signals CTA k's mbarrier q & 1 with release semantics at
//      cluster scope when the 8 bytes have landed;
//   4. every thread of the CTA waits on its own mbarrier q & 1 (acquire
//      at cluster scope) until all kCluster pairs of decision q are in;
//   5. every warp merges the kCluster pairs from its own shared memory in
//      the same order, so all of them know the decision, and the thread that
//      owns node c commits to it: reserved, n_tasks and src_count in
//      shared memory, requested (which nothing else in the kernel reads)
//      straight to global memory.
// No cluster-wide barrier runs per decision: a CTA waits only for the
// kCluster pairs addressed to it, which took a large part off a
// decision's time against one cluster.sync() per decision in development
// runs on an H100.  The mbarriers and the pair
// slots are double buffered, and a slot is never overwritten before it
// has been read: CTA j stores into slot (q & 1, j) of CTA k for decision
// q + 2 only after its own wait of decision q + 1 has seen CTA k's pair of
// q + 1, which CTA k's warp 0 stores after the __syncthreads of decision
// q + 1, which every warp of CTA k reaches only after it has read slot
// q & 1 in step 5 of decision q.  By the same chain, mbarrier q & 1 of a
// CTA completes the phase of decision q (its thread 0 arms it with
// expect_tx(kCluster * 8) in decision q; a complete_tx that lands first
// takes the transaction count below zero, which the phase allows) before
// any store of decision q + 2 reaches it, so the wait of decision q waits
// for phase (q >> 1) & 1.  The warps' pairs of step 2 are written after a
// warp's wait of decision q - 1 and read by warp 0 before its store of
// decision q, which every CTA's wait of decision q needs.  A cluster
// barrier at the start makes sure every CTA of the cluster runs, with its
// barriers initialised and its rows loaded, before any store reaches it,
// and one at the end that none exits while a store may still be in
// flight towards it.  Then each CTA writes its rows back once.  A wait
// that spins 2^26 times, far beyond any decision's time, traps: a fault
// becomes a launch failure, not a hung card.
//
// The next task row is loaded into registers while the current decision
// runs, so no decision waits for a load from global memory on its path
// except the global instance's src_count gathers.
//
// Rounding is that of the reference as XLA compiles it, as in
// flex_score.cu: __fmaf_rn for `penalty * est + reserved` and for
// `w_load * max + w_src * src_frac`, __fmul_rn, __fadd_rn and __fdiv_rn
// elsewhere, and the build passes -fmad=false.  The plain PyTorch version
// (`admit_queue_ref` in kernels/flex_score/ref.py) rounds at the same
// places, so kernel and plain version agree bit for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 16;       // CTAs of the cluster (non-portable)
constexpr int kMaxR = 8;           // most resources a task row may have
constexpr int kSrcBuckets = 64;    // NUM_SRC_BUCKETS
constexpr int kFixedSmem = 640;    // pair slots, warps' pairs, mbarriers
constexpr int kOnChipThreads = 256;
constexpr int kGlobalThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;

// Return codes beside cudaError_t's.
constexpr int kErrShape = -1;      // r, the plan or its shared memory
constexpr int kErrCluster = -2;    // the cluster cannot be scheduled

// A (score, node) pair as two unsigned keys: the score mapped to an
// unsigned integer in the same order (-0 taken as +0, as the comparisons
// of argmax take it), and the node.  The best pair has the largest score
// key and, among those, the smallest node: argmax with its lowest node on
// ties.
struct __align__(8) Pair {
  uint32_t key;
  uint32_t node;
};

__device__ __forceinline__ uint32_t score_key(float s) {
  const uint32_t b = __float_as_uint(s + 0.0f);
  return (b & 0x80000000u) ? ~b : b | 0x80000000u;
}

__device__ __forceinline__ float key_score(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? k & 0x7fffffffu : ~k);
}

// The best pair of the warp's lanes, on every lane: two warp reductions.
__device__ __forceinline__ Pair warp_best(Pair p) {
  const uint32_t key = __reduce_max_sync(kFull, p.key);
  return Pair{key, __reduce_min_sync(kFull, p.key == key ? p.node
                                                         : UINT32_MAX)};
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of the same shared-memory location in CTA `rank`.
__device__ __forceinline__ uint32_t peer_u32(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}

// One arrival that also expects `bytes` of st.async stores this phase.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of the given parity to complete; traps after 2^26
// tries.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// Stores a pair into another CTA's shared memory (`dst`, a cluster
// address) and signals 8 bytes to that CTA's mbarrier `bar` on arrival.
__device__ __forceinline__ void st_async_pair(uint32_t dst, Pair p,
                                              uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], "
      "{%1, %2}, [%3];" ::"r"(dst),
      "r"(p.key), "r"(p.node), "r"(bar)
      : "memory");
}

// One queued task, in registers.
struct Task {
  float req[kMaxR];
  float penalty, cap, w_load, w_src;
  int src;
  bool valid;
};

__device__ __forceinline__ void load_task(Task& t, const float* task_mat,
                                          const int* srcs,
                                          const unsigned char* valid, int q,
                                          int r) {
  const float* row = task_mat + static_cast<size_t>(q) * (r + 4);
#pragma unroll
  for (int j = 0; j < kMaxR; ++j) t.req[j] = j < r ? __ldg(row + j) : 0.0f;
  t.penalty = __ldg(row + r);
  t.cap = __ldg(row + r + 1);
  t.w_load = __ldg(row + r + 2);
  t.w_src = __ldg(row + r + 3);
  // A source outside [0, 64) would address outside the table: clamped.
  t.src = min(max(__ldg(srcs + q), 0), kSrcBuckets - 1);
  t.valid = __ldg(valid + q) != 0;
}

// R > 0: R resources known at compile time; R = 0: read at run time.
template <int R, int kThreads, bool kSrcOnChip>
__global__ void __launch_bounds__(kThreads)
    flex_admit_kernel(const float* __restrict__ est,
                      float* __restrict__ reserved,
                      float* __restrict__ requested,
                      int* __restrict__ n_tasks, int* __restrict__ src_count,
                      const float* __restrict__ task_mat,
                      const int* __restrict__ srcs,
                      const unsigned char* __restrict__ valid, int n,
                      int r_run, int q_len, int rows,
                      int* __restrict__ placements) {
  constexpr int kWarps = kThreads / 32;
  const int r = R > 0 ? R : r_run;
  // This cluster's run: its tables, queue and placements.
  const size_t run = blockIdx.x / kCluster;
  est += run * n * r;
  reserved += run * n * r;
  requested += run * n * r;
  n_tasks += run * n;
  src_count += run * n * kSrcBuckets;
  task_mat += run * q_len * (r + 4);
  srcs += run * q_len;
  valid += run * q_len;
  placements += run * q_len;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = rank * rows;
  const int my_rows = max(0, min(rows, n - row0));

  extern __shared__ __align__(16) unsigned char smem[];
  Pair* slots = reinterpret_cast<Pair*>(smem);          // [2][kCluster]
  Pair* warp_pairs = slots + 2 * kCluster;              // [32]
  uint64_t* bars = reinterpret_cast<uint64_t*>(warp_pairs + 32);  // [2]
  static_assert((2 * kCluster + 32) * sizeof(Pair) + 2 * sizeof(uint64_t) <=
                kFixedSmem);
  float* est_s = reinterpret_cast<float*>(smem + kFixedSmem);  // [r][rows]
  float* res_s = est_s + r * rows;                             // [r][rows]
  int* nt_s = reinterpret_cast<int*>(res_s + r * rows);        // [rows]
  int* sc_s = nt_s + rows;                       // [64][rows], on chip only

  const size_t base = static_cast<size_t>(row0);
  for (int e = tid; e < my_rows * r; e += kThreads) {
    const int row = e / r;
    const int j = e - row * r;
    est_s[j * rows + row] = est[base * r + e];
    res_s[j * rows + row] = reserved[base * r + e];
  }
  for (int row = tid; row < my_rows; row += kThreads)
    nt_s[row] = n_tasks[row0 + row];
  if constexpr (kSrcOnChip) {
    for (int e = tid; e < my_rows * kSrcBuckets; e += kThreads)
      sc_s[(e & (kSrcBuckets - 1)) * rows + e / kSrcBuckets] =
          src_count[base * kSrcBuckets + e];
  }
  const uint32_t bar0 = smem_u32(bars);
  if (tid == 0) {
    mbar_init(bar0);
    mbar_init(bar0 + 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Lane k of warp 0 stores this CTA's pair into CTA k's slots.
  const uint32_t peer_slot0 = peer_u32(smem_u32(slots), lane % kCluster);
  const uint32_t peer_bar0 = peer_u32(bar0, lane % kCluster);
  cluster.sync();

  Task cur;
  load_task(cur, task_mat, srcs, valid, 0, r);
  for (int q = 0; q < q_len; ++q) {
    Task next = cur;
    if (q + 1 < q_len) load_task(next, task_mat, srcs, valid, q + 1, r);

    float best_s = kNegInf;
    int best_i = INT_MAX;
    for (int row = tid; row < my_rows; row += kThreads) {
      int same;
      if constexpr (kSrcOnChip) {
        same = sc_s[cur.src * rows + row];
      } else {
        same = src_count[(base + row) * kSrcBuckets + cur.src];
      }
      const float frac = __fdiv_rn(__int2float_rn(same),
                                   __int2float_rn(max(nt_s[row], 1)));
      bool feasible = true;
      float max_load = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxR; ++j) {
        if (j < r) {
          const float load =
              __fmaf_rn(cur.penalty, est_s[j * rows + row],
                        res_s[j * rows + row]);
          feasible = feasible && (__fadd_rn(load, cur.req[j]) <= cur.cap);
          max_load = j == 0 ? load : fmaxf(max_load, load);
        }
      }
      const float score =
          feasible ? -__fmaf_rn(cur.w_load, max_load, __fmul_rn(cur.w_src,
                                                                frac))
                   : kNegInf;
      if (score > best_s) {
        best_s = score;
        best_i = row0 + row;
      }
    }

    const int slot = (q & 1) * kCluster;
    const uint32_t bar = bar0 + 8u * (q & 1);
    const Pair mine = warp_best(Pair{score_key(best_s),
                                     static_cast<uint32_t>(best_i)});
    if (lane == 0) warp_pairs[warp] = mine;
    __syncthreads();
    if (warp == 0) {
      const Pair p = warp_best(warp_pairs[lane % kWarps]);
      if (lane < kCluster)
        st_async_pair(peer_slot0 + 8u * (slot + rank), p,
                      peer_bar0 + 8u * (q & 1));
    }
    if (tid == 0) mbar_expect(bar, kCluster * sizeof(Pair));
    mbar_wait(bar, (q >> 1) & 1);

    const Pair p = warp_best(slots[slot + lane % kCluster]);
    const bool ok = key_score(p.key) > kNegInf / 2 && cur.valid;
    const int c = ok ? static_cast<int>(p.node) : 0;  // max(idx, 0)
    const int loc = c - row0;
    if (loc >= 0 && loc < my_rows && tid == loc % kThreads) {
      const float okf = ok ? 1.0f : 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxR; ++j) {
        if (j < r) {
          const float add = __fmul_rn(okf, cur.req[j]);
          res_s[j * rows + loc] = __fadd_rn(res_s[j * rows + loc], add);
          float* req_c = requested + static_cast<size_t>(c) * r + j;
          *req_c = __fadd_rn(*req_c, add);
        }
      }
      nt_s[loc] += ok;
      if constexpr (kSrcOnChip) {
        sc_s[cur.src * rows + loc] += ok;
      } else {
        src_count[static_cast<size_t>(c) * kSrcBuckets + cur.src] += ok;
      }
    }
    if (rank == 0 && tid == 0) placements[q] = ok ? c : -1;
    cur = next;
  }

  // No store is in flight towards any CTA; the owners' last commits are
  // in.  Then this CTA's rows go back, once.
  cluster.sync();
  for (int e = tid; e < my_rows * r; e += kThreads) {
    const int row = e / r;
    reserved[base * r + e] = res_s[(e - row * r) * rows + row];
  }
  for (int row = tid; row < my_rows; row += kThreads)
    n_tasks[row0 + row] = nt_s[row];
  if constexpr (kSrcOnChip) {
    for (int e = tid; e < my_rows * kSrcBuckets; e += kThreads)
      src_count[base * kSrcBuckets + e] =
          sc_s[(e & (kSrcBuckets - 1)) * rows + e / kSrcBuckets];
  }
}

__host__ __device__ constexpr int smem_bytes(int rows, int r, bool on_chip) {
  return kFixedSmem + rows * (8 * r + 4 + (on_chip ? 4 * kSrcBuckets : 0));
}

template <int R, int kThreads, bool kSrcOnChip>
int launch(const float* est, float* reserved, float* requested, int* n_tasks,
           int* src_count, const float* task_mat, const int* srcs,
           const unsigned char* valid, int n, int r, int q, int rows,
           int smem, int* placements, cudaStream_t stream, int runs) {
  auto kernel = flex_admit_kernel<R, kThreads, kSrcOnChip>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);   // one cluster, for the scheduling check
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // The attributes and the scheduling check, once per instance for the
  // largest shared memory asked so far (not thread-safe; a launch inside
  // CUDA-graph capture after a first eager one takes no such call).
  static int checked_smem = 0;
  if (smem > checked_smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    int clusters = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters < 1) return kErrCluster;
    checked_smem = smem;
  }
  cfg.gridDim = dim3(kCluster * runs);   // a cluster a run
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, est, reserved, requested,
                                       n_tasks, src_count, task_mat, srcs,
                                       valid, n, r, q, rows, placements);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flex_score_admit_cluster() { return kCluster; }
extern "C" int flex_score_admit_max_r() { return kMaxR; }

// Admits q tasks in each of `runs` runs on `stream` (run b's tables,
// queue and placements at b times their size), a cluster a run: the plan (rows per CTA, src_count on chip or
// not, shared memory per CTA) is the launcher's (`admit_plan` in
// flex_score.py), checked here against the layout above.  Updates
// reserved, requested, n_tasks and src_count in place and writes
// placements.  Returns cudaGetLastError() as an int, kErrShape for a plan
// this kernel cannot take, or kErrCluster when no cluster of kCluster CTAs
// with that shared memory can be scheduled on the card.
extern "C" int flex_score_admit(const float* est, float* reserved,
                                float* requested, int* n_tasks,
                                int* src_count, const float* task_mat,
                                const int* srcs, const unsigned char* valid,
                                int n, int r, int q, int rows, int on_chip,
                                int smem, int* placements,
                                cudaStream_t stream, int runs) {
  if (runs < 1 || r < 1 || r > kMaxR || n < 1 || q < 1 || rows < 1 ||
      static_cast<long long>(rows) * kCluster < n ||
      static_cast<long long>(rows - 1) * kCluster >= n ||
      smem < smem_bytes(rows, r, on_chip != 0))
    return kErrShape;
  if (on_chip) {
    return r == 2 ? launch<2, kOnChipThreads, true>(
                        est, reserved, requested, n_tasks, src_count,
                        task_mat, srcs, valid, n, r, q, rows, smem,
                        placements, stream, runs)
                  : launch<0, kOnChipThreads, true>(
                        est, reserved, requested, n_tasks, src_count,
                        task_mat, srcs, valid, n, r, q, rows, smem,
                        placements, stream, runs);
  }
  return r == 2 ? launch<2, kGlobalThreads, false>(
                      est, reserved, requested, n_tasks, src_count, task_mat,
                      srcs, valid, n, r, q, rows, smem, placements, stream,
                      runs)
                : launch<0, kGlobalThreads, false>(
                      est, reserved, requested, n_tasks, src_count, task_mat,
                      srcs, valid, n, r, q, rows, smem, placements, stream,
                      runs);
}
