// Segment-sum with non-finite markers, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flox_tpu/pallas_kernels.py:_kernel with
// _accum_update and _two_sum (built by _build, entered through
// segment_sum_raw_pallas). It computes the same function, not the same tiles:
//
//   data  (K, N) row-major, N contiguous: the trailing-reduce layout the
//         caller already holds, read once and in place (no transposed,
//         padded or zero-filled copy)
//   codes (N,) int32; a code outside [0, size) drops out
//   sums, nan_c, pos_c, neg_c  (size, K) float32: per (group, row) the sum
//         of the finite values, and the counts of NaN, +inf and -inf.
//         Non-finite values are zero-filled and counted, never added.
//
// Accumulation along N, per (group, row), under accum:
//   0 plain  an f32 running sum
//   1 kahan  compensated (Kahan) summation
//   2 dd     a double-double (hi, lo) f32 pair: each addend is Dekker-split
//            by 4097 (values above 8e34 stay whole), the halves are reduced
//            separately and merged with Knuth two_sum, as the Pallas kernel
//            does per tile
//
// Design. One warp per row k; 8 rows per block; per 32-column chunk the warp
// walks the distinct codes present and reduces each group's lanes with a
// fixed butterfly, and lane 0 folds the partials into per-group accumulators
// in shared memory. No atomics: two launches give bit-identical outputs. The
// code is segment_reduce.cuh's, shared with the multi-statistic kernel
// (segment_multistat.cu), whose sums and markers are therefore bit-identical
// to these.
//
// Bound on the card: the kernel must read K*N*itemsize bytes of data once
// (plus N*4 of codes, and write 4*size*K*4). At the benchmark width,
// 65160 x 26304 float32 = 6.86 GB, that is at least 2.05 ms at the H100's
// 3.35 TB/s (computed, not measured). It is memory-bound: the work per
// element is a few dozen warp instructions. The design keeps loads
// coalesced and several in flight; it does not yet stage codes in shared
// memory or reduce several rows per ballot.

#include "segment_reduce.cuh"

extern "C" {

// dtype: 0 float32, 1 bfloat16. accum: 0 plain, 1 kahan, 2 dd.
// Returns the cudaError_t of the launch (0 on success).
int flox_segment_sum(const void* data, int dtype, const int* codes, long long K, long long N,
                     int size, int accum, void* sums, void* nan_c, void* pos_c, void* neg_c,
                     void* stream) {
  return flox::dispatch_segment_reduce<false>(data, dtype, codes, K, N, size, accum, sums,
                                              nan_c, pos_c, neg_c, nullptr, nullptr, stream);
}

const char* flox_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
