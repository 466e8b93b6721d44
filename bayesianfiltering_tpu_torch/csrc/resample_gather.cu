// Parent index of every output slot from the sorted cumulative child counts
// of systematic / stratified resampling (K5), m counts (particles or
// components) and n output slots:
//
//   parent(j) = min(#{i : counts_i <= j}, m - 1),   j = 0 .. n-1.
//
// The bootstrap PF has m = n; a Gaussian-sum reduction keeps n < m.
//
// Replaces the TPU kernel bayesianfiltering_tpu/ops/resample_gather.py
// `_parents_kernel`. That kernel counts, for each 2048-output tile, over a
// 4096-wide window of counts brought in by one aligned DMA and transposed
// in VMEM, and its caller defers the step when a tile's parents span more
// than the window. None of that carries over: the parents here come from a
// merge of the two sorted lists `counts` and 0 .. n-1, which is exact for
// every weight profile, so there is no window, no span check and no
// deferral.
//
// The merge path: in the merge of counts (ties first: counts_i <= j puts
// count i before slot j) with the slots, count i lands at position
// counts_i + i and slot j at j + #{i : counts_i <= j}. So the parent of a
// slot is the number of counts merged before it, and the counts merged
// before position d are a(d) = #{i : counts_i + i < d}, a search over the
// strictly increasing keys counts_i + i.
//
// What bounds it on an H100: 8 bytes a slot (a count read once, a parent
// written once) and m + n comparisons: at n = m = 1M, 8 MB, a 2.4 µs byte
// bound. A search of the whole counts array for every slot costs ~20
// dependent L2 reads a slot. This design:
// - each block owns an equal stretch of the merged sequence, kStretch =
//   256 threads × kItems positions, whatever the weights' skew: a tile of
//   slots whose parents span far more than n / tiles counts (the "first",
//   "last", "spread" and "tail" profiles, where the TPU kernel needed its
//   window and deferral) costs what any other does;
// - warps 0 and 1 find the block's two ends on the merge path, a(d0) and
//   a(d1), by a 32-way search (each round 32 lanes probe 32 points and a
//   ballot keeps the interval: 4 dependent reads at 1M counts), after
//   every thread has cleared its marks. That is the only global search,
//   once a block, in the one launch (a separate partition kernel would
//   cost a queued launch, ~2.6 µs, more than the byte bound);
// - the block's counts a(d0) .. a(d1), read by coalesced loads, mark their
//   positions in shared memory; each thread reads the marks of its kItems
//   positions (at a stride of kItems, odd: distinct banks), a block scan
//   of the threads' mark counts gives each thread the counts merged before
//   its first position, and the thread walks its positions, writing the
//   parents of its slots back over the marks; the block's parents go out
//   in one coalesced store.
// The marks replace a thread's own binary search over staged counts and
// a serial merge reading them: dependent, divergent shared loads, which
// were slower on an H100 than the marks and the scan.
//
// The clamp keeps the tail slot in range when the last count is n-1 (float
// rounding in ceil(n·cdf − u0)): the count formula would give m there, the
// scatter form of utils/resampling.py gives m-1.
//
// Positions are int32: m + n must stay below 2^31 − 1 − kStretch
// (kMaxPositions; the C entry returns cudaErrorInvalidValue above it).
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 11;
constexpr int kStretch = kThreads * kItems;  // merged positions a block
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxPositions = INT_MAX - kStretch;

// a(d) = #{i < m : counts_i + i < d}, by the calling warp (every lane gets
// it). The answer lies in [max(0, d − n), min(d, m)]; each round the 32
// lanes probe lo, lo + step, ..., the probes below the answer are a prefix
// of the lanes (the keys increase), and the interval shrinks to one step.
__device__ __forceinline__ int merge_split(const int* __restrict__ counts,
                                           int m, int n, int d) {
  const int lane = threadIdx.x % kWarp;
  int lo = d - n > 0 ? d - n : 0;
  int hi = d < m ? d : m;
  while (lo < hi) {
    const int step = (hi - lo + kWarp - 1) / kWarp;
    const int i = lo + lane * step;
    const bool below = i < hi && __ldg(counts + i) + i < d;
    const int k = __popc(__ballot_sync(kFullMask, below));
    if (k == 0) {
      hi = lo;
    } else {
      const int top = lo + k * step;
      lo += (k - 1) * step + 1;
      hi = top < hi ? top : hi;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads) resample_parents_kernel(
    const int* __restrict__ counts, int* __restrict__ parents, int m,
    int n) {
  // 1 where a count lands, then the block's parents
  __shared__ int mark[kStretch];
  __shared__ int ends[2];
  __shared__ int warp_counts[kWarps];
  const int total = m + n;
  const int d0 = blockIdx.x * kStretch;
  const int d1 = d0 + kStretch < total ? d0 + kStretch : total;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
#pragma unroll
  for (int q = 0; q < kItems; ++q) mark[q * kThreads + threadIdx.x] = 0;
  if (warp < 2) {
    const int a = merge_split(counts, m, n, warp == 0 ? d0 : d1);
    if (lane == 0) ends[warp] = a;
  }
  __syncthreads();
  const int a0 = ends[0], a1 = ends[1];
  const int b0 = d0 - a0, nb = (d1 - a1) - b0;  // the block's slots
  // count a0 + k lands at position counts + a0 + k, d0 + (counts + k − b0)
  for (int k = threadIdx.x; k < a1 - a0; k += kThreads)
    mark[__ldg(counts + a0 + k) + k - b0] = 1;
  __syncthreads();

  // this thread's positions t0 .. t0 + kItems − 1 (block-relative): which
  // hold counts, and how many counts the block merges before them
  const int t0 = threadIdx.x * kItems;
  int bits = 0, own = 0;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int f = mark[t0 + q];
    bits |= f << q;
    own += f;
  }
  int k = own;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const int v = __shfl_up_sync(kFullMask, k, o);
    if (lane >= o) k += v;
  }
  if (lane == kWarp - 1) warp_counts[warp] = k;
  __syncthreads();
  k -= own;
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    if (w < warp) k += warp_counts[w];
  // the slot at position t is t − k (block-relative), its parent a0 + k
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int t = t0 + q;
    if (d0 + t < d1) {
      if ((bits >> q) & 1) {
        ++k;
      } else {
        const int a = a0 + k;
        mark[t - k] = a < m - 1 ? a : m - 1;
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nb; j += kThreads) parents[b0 + j] = mark[j];
}

}  // namespace

extern "C" {

int bft_resample_parents_i32(const void* counts, void* parents, int m, int n,
                             void* stream) {
  if (m < 0 || n < 0 || m > kMaxPositions - n)
    return int(cudaErrorInvalidValue);
  const int blocks = (m + n + kStretch - 1) / kStretch;
  resample_parents_kernel<<<blocks, kThreads, 0, cudaStream_t(stream)>>>(
      static_cast<const int*>(counts), static_cast<int*>(parents), m, n);
  return int(cudaGetLastError());
}

}  // extern "C"
