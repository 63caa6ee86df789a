// Radix-binning segment-sum (B5) with non-finite markers, for Hopper (sm_90a):
// the segment-sum of segment_sum.cu past its 512-group cap.
//
// Replaces the Pallas TPU kernel flox_tpu/pallas_kernels.py:_radixbin_kernel
// (built by _build_radixbin, entered through segment_sum_radixbin_pallas). It
// computes the same function:
//
//   data  (K, N) row-major, N contiguous, read in place; float32 or bfloat16
//   codes binned on the card (perm, scodes, offsets; cuda_kernels.
//         _radixbin_bins); a code outside [0, size) drops out
//   sums, nan_c, pos_c, neg_c  (size, K) float32: per (group, row) the sum
//         of the finite values and the counts of NaN, +inf and -inf
//
// Design: segment_reduce.cuh's run walk with its MINMAX legs off, as B1
// takes it, over any int number of groups; the template's notes hold the
// walk, its invariants (B5 equals B1 bit for bit at any size <= 512) and its
// bound. Why 8 groups a block (min(8, size), cuda_kernels._RADIXBIN_GROUPS):
// the ~396 blocks resident at once (3 per SM) span about 396 / nseg row
// tiles; a tile is 27 MB at 26304 float32 columns, so a narrow segment keeps
// random codes over a few thousand groups within about one tile, which stays
// in the 50 MB L2 while its segments gather from it. Wider segments span
// more tiles and miss more; sorted codes are indifferent to the width.

#include "segment_reduce.cuh"

extern "C" {

// dtype: 0 float32, 1 bfloat16. accum: 0 plain, 1 kahan, 2 dd. perm, scodes
// (N,) and offsets (size + 1,) int32 are the binned codes, so any int size
// fits them; groups is the number of groups per block (1 <= groups <= size).
// Returns the cudaError_t of the launch (0 on success).
int flox_segment_radixbin(const void* data, int dtype, const int* perm, const int* scodes,
                          const int* offsets, long long K, long long N, int size, int groups,
                          int accum, void* sums, void* nan_c, void* pos_c, void* neg_c,
                          void* stream) {
  return flox::dispatch_segment_reduce<false>(data, dtype, perm, scodes, offsets, K, N, size,
                                              groups, 1, accum, sums, nan_c, pos_c, neg_c,
                                              nullptr, nullptr, stream);
}

const char* flox_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
