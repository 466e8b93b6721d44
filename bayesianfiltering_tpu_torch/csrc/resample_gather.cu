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
// than the window. None of that carries over: here one thread owns one
// output slot and finds its parent by a binary search (upper_bound) over
// the whole counts array. That is exact for every weight profile, so there
// is no window, no span check and no deferral.
//
// What bounds it on an H100: at n = 1M the counts are 4 MB and stay in the
// 50 MB L2 after the first touches, so a search is ~20 dependent L2 reads;
// the work is n·log2(n) comparisons and the bytes 8 per slot (one count
// read once, one parent written), so the bound is bytes, and the kernel is
// latency-bound on the dependent reads. What the simple design does about
// it: threads of a warp search for adjacent j, so their paths share the
// first levels of the search and those reads coalesce; the output is one
// coalesced store per thread. A block-cooperative search (one search per
// block, then the block's count range from shared memory) is the redesign.
//
// The clamp keeps the tail slot in range when the last count is n-1 (float
// rounding in ceil(n·cdf − u0)): the count formula would give m there, the
// scatter form of utils/resampling.py gives m-1.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) resample_parents_kernel(
    const int* __restrict__ counts, int* __restrict__ parents, int m,
    int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  // first i with counts[i] > j, i.e. #{i : counts_i <= j} for sorted counts
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(counts + mid) <= j)
      lo = mid + 1;
    else
      hi = mid;
  }
  parents[j] = lo < m - 1 ? lo : m - 1;
}

}  // namespace

extern "C" {

int bft_resample_parents_i32(const void* counts, void* parents, int m, int n,
                             void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  resample_parents_kernel<<<blocks, kThreads, 0, cudaStream_t(stream)>>>(
      static_cast<const int*>(counts), static_cast<int*>(parents), m, n);
  return int(cudaGetLastError());
}

}  // extern "C"
