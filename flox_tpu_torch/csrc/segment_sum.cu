// Segment-sum with non-finite markers, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flox_tpu/pallas_kernels.py:_kernel with
// _accum_update and _two_sum (built by _build, entered through
// segment_sum_raw_pallas). It computes the same function, not the same tiles:
//
//   data  (K, N) row-major, N contiguous: the trailing-reduce layout the
//         caller already holds, read once and in place (no transposed,
//         padded or zero-filled copy); float32 or bfloat16
//   codes binned on the card (perm, scodes, offsets; cuda_kernels.
//         _radixbin_bins); a code outside [0, size) drops out
//   sums, nan_c, pos_c, neg_c  (size, K) float32: per (group, row) the sum
//         of the finite values, and the counts of NaN, +inf and -inf.
//         Non-finite values are zero-filled and counted, never added.
//
// Accumulation along N, per (group, row), under accum: 0 plain (an f32
// running sum), 1 kahan (compensated), 2 dd (a double-double f32 pair, each
// addend Dekker-split and merged with two_sum).
//
// Design: segment_reduce.cuh with its MINMAX legs off. Blocks of 256 rows,
// one thread each, over a segment of whole consecutive groups;
// cp.async-staged (256, 33) tiles of 32 columns, double-buffered, with the
// accumulators in registers. Two walks, chosen by the wrapper from the
// shape (cuda_kernels._window): where the groups average four 32-column
// stages or more (N >= 128 * size), the run walk, over groups in code order
// (one ballot per stage marks where the code changes; the groups per block
// derived from size and K); else the window walk, over windows of 8
// consecutive groups whose columns come in column order (one ballot per
// stage and group), so that neighbouring groups' words of one 32-byte
// sector are read by one block.
//
// Invariants: per (group, row) the sum is sequential over the group's
// columns in column order under either walk, so it equals the radix-binning
// kernel (segment_radixbin.cu) bit for bit at any size <= 512 and does not
// depend on where other groups' columns lie; the multi-statistic kernel
// (segment_multistat.cu), the same template, gives these sums and markers
// bit for bit; no atomics, so two launches give the same bits.
//
// Bound on the card: the kernel must read K*N*itemsize bytes of data once
// (plus 3*N*4 of binned codes, and write 4*size*K*4). At the benchmark
// width, 65160 x 26304 float32 = 6.86 GB, that is at least 2.05 ms at the
// H100's 3.35 TB/s (computed, not measured). It is memory-bound: the work
// per element is a shared-memory load, a finiteness test and the
// discipline's adds.

#include "segment_reduce.cuh"

extern "C" {

// dtype: 0 float32, 1 bfloat16. accum: 0 plain, 1 kahan, 2 dd. perm, scodes
// (N,) and offsets (size + 1,) int32 are the binned codes; groups is the
// number of groups per block (1 <= groups <= size <= 512); window is 1 (the
// run walk) or 8 (the window walk, with groups min(8, size), on codes
// binned by window of 8 groups). Returns the cudaError_t of the launch (0 on success).
int flox_segment_sum(const void* data, int dtype, const int* perm, const int* scodes,
                     const int* offsets, long long K, long long N, int size, int groups,
                     int window, int accum, void* sums, void* nan_c, void* pos_c, void* neg_c,
                     void* stream) {
  return flox::dispatch_segment_reduce<false>(data, dtype, perm, scodes, offsets, K, N, size,
                                              groups, window, accum, sums, nan_c, pos_c, neg_c,
                                              nullptr, nullptr, stream);
}

const char* flox_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
