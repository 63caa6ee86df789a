// Multi-statistic segment reduction: sums, non-finite markers, min and max
// from one read of the data, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flox_tpu/pallas_kernels.py:_multistat_kernel
// with _minmax_accumulate (built by _build_multistat, entered through
// segment_multistat_pallas):
//
//   data  (K, N) row-major, N contiguous, read once and in place;
//         float32 or bfloat16
//   codes binned on the card (perm, scodes, offsets; cuda_kernels.
//         _radixbin_bins); a code outside [0, size) drops out
//   sums, nan_c, pos_c, neg_c  (size, K) float32: as segment_sum.cu gives
//         them, bit for bit, for the same input and accumulation
//   mins, maxs  (size, K) in the data dtype: the NaN-skipping min and max.
//         An empty group, and a group whose values are all NaN, comes out at
//         the op's identity (+inf for min, -inf for max); the propagating
//         min/max re-inject NaN outside from nan_c.
//
// Design: segment_reduce.cuh with its MINMAX legs on. Each value is staged
// once and feeds the sum path and an fminf / fmaxf in registers in the same
// per-thread walk over the row's columns; a finished group's six outputs
// are written once, coalesced along K. Nothing is atomic and every order is
// fixed, so reruns are bit-identical; min and max are exact in any order, so
// the extrema equal the segment-min/max kernel's (segment_minmax.cu) on
// NaN-parked data.
//
// Bound on the card: one read of the data, K*N*itemsize bytes (plus 3*N*4
// of binned codes, and 4*size*K*4 + 2*size*K*itemsize written). At the
// benchmark width of 65160 x 26304 float32 that is 6.86 GB, at least 2.05
// ms at 3.35 TB/s (computed, not measured) -- the bound of segment_sum.cu
// alone, which is the point of the fusion: mean, min and max for the price
// of one read.

#include "segment_reduce.cuh"

extern "C" {

// dtype: 0 float32, 1 bfloat16. accum: 0 plain, 1 kahan, 2 dd. perm, scodes
// (N,) and offsets (size + 1,) int32 are the binned codes; groups is the
// number of groups per block (1 <= groups <= size <= 512). Returns the
// cudaError_t of the launch (0 on success).
int flox_segment_multistat(const void* data, int dtype, const int* perm, const int* scodes,
                           const int* offsets, long long K, long long N, int size, int groups,
                           int accum, void* sums, void* nan_c, void* pos_c, void* neg_c,
                           void* mins, void* maxs, void* stream) {
  if (size > flox::kGroupCap) return static_cast<int>(cudaErrorInvalidValue);
  return flox::dispatch_segment_reduce<true>(data, dtype, perm, scodes, offsets, K, N, size,
                                             groups, 1, accum, sums, nan_c, pos_c, neg_c, mins,
                                             maxs, stream);
}

const char* flox_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
