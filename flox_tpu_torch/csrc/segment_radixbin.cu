// Radix-binning segment-sum with non-finite markers, for Hopper (sm_90a): the
// segment-sum of segment_sum.cu past its 512-group cap.
//
// Replaces the Pallas TPU kernel flox_tpu/pallas_kernels.py:_radixbin_kernel
// (built by _build_radixbin, entered through segment_sum_radixbin_pallas). It
// computes the same function:
//
//   data  (K, N) row-major, N contiguous, read in place; float32 or bfloat16
//   codes (N,) int32; a code outside [0, size) drops out
//   sums, nan_c, pos_c, neg_c  (size, K) float32: per (group, row) the sum
//         of the finite values and the counts of NaN, +inf and -inf, under
//         the plain, kahan or dd accumulation of segment_sum.cu
//
// Design: segment_reduce.cuh with RADIX on. The grid is (row blocks, group
// blocks); the block at (x, y) reduces rows [8x, 8x + 8) over groups
// [512y, 512y + 512), with its accumulators in shared memory (80 KB at 512
// groups). A warp loads the codes of each 128-column step first and skips
// the step's data unless one of them falls in its group block. Per group the
// walk along N, the butterflies and the accumulator update are B1's, so:
//   - at size <= 512 the outputs are segment_sum.cu's bit for bit;
//   - the outputs of group block y are segment_sum.cu's on the codes shifted
//     by -512y with every code outside the block set to -1;
//   - nothing is atomic, so two launches give the same bits.
// As in the Pallas kernel, the block structure is built for codes sorted
// along N (the sort engine's compact codes, a time axis binned by day): each
// group block then reads only its own columns and the launch reads the data
// about once. Unsorted codes stay correct but cost one read of the data per
// group block.
//
// Bound on the card, for sorted codes: one read of the data, K*N*itemsize
// bytes, plus N*4 of codes and 4*size*K*4 of outputs. For the daily means of
// the benchmark array, 65160 x 26304 float32 over 1096 days, that is
// (6.856 + 1.143) GB at 3.35 TB/s = 2.39 ms (computed, not measured). The
// design is the simple one: codes are re-read per group block from L2, and
// the 80 KB of accumulators hold occupancy at 16 warps per SM.

#include "segment_reduce.cuh"

extern "C" {

// dtype: 0 float32, 1 bfloat16. accum: 0 plain, 1 kahan, 2 dd. size at most
// 512 * 65535 (the grid's group-block dimension).
// Returns the cudaError_t of the launch (0 on success).
int flox_segment_radixbin(const void* data, int dtype, const int* codes, long long K,
                          long long N, int size, int accum, void* sums, void* nan_c,
                          void* pos_c, void* neg_c, void* stream) {
  return flox::dispatch_segment_reduce<false, true>(data, dtype, codes, K, N, size, accum, sums,
                                                    nan_c, pos_c, neg_c, nullptr, nullptr,
                                                    stream);
}

const char* flox_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
