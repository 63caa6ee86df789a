// Segment-min/max, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flox_tpu/pallas_kernels.py:_minmax_kernel
// (built by _build_minmax, entered through segment_minmax_pallas):
//
//   data  (K, N) row-major, N contiguous, read once and in place;
//         float32, bfloat16 or int32
//   codes binned on the card (perm, scodes, offsets; cuda_kernels.
//         _radixbin_bins); a code outside [0, size) drops out
//   out   (size, K) in the data dtype: per (group, row) the min or the max.
//         An empty group comes out at the op's identity: -inf / +inf for
//         floats (max / min), INT32_MIN / INT32_MAX for int32.
//
// NaN: callers map NaN to the identity or the absorbing element before the
// call (kernels._make_minmax), so none should arrive. One that does
// propagates: a group whose values include a NaN comes out NaN, as
// jnp.maximum / jnp.minimum give in the Pallas kernel and as
// torch.scatter_reduce("amax"/"amin") gives in the plain version.
//
// Design: segment_reduce.cuh with its ExtremumLegs, the template of the
// segment-sum (B1) and multi-statistic (B2) kernels. Blocks of 256 rows,
// one thread each, over a segment of whole consecutive groups (the number
// derived by the wrapper, cuda_kernels._groups_per_block); cp.async-staged
// (256, 33) tiles of 32 columns, double-buffered (bfloat16 through registers
// a stage ahead; int32 as float32); one ballot per stage marks where the
// code changes, and each thread folds its row's columns in order into one
// extremum in registers, in the working type (float for float32 and
// bfloat16, int for int32), with an explicit NaN test so that a NaN sticks.
//
// Invariants: min and max are exact in any order, so the result equals the
// plain version exactly; on NaN-parked data it equals B2's extrema bit for
// bit (the same fminf / fmaxf over the same columns in the same order); no
// atomics, so two launches give the same bits.
//
// Bound on the card: one read of the data, K*N*itemsize bytes (plus 3*N*4
// of binned codes, and size*K*itemsize written). At the benchmark width of
// 65160 x 26304 float32 that is 6.86 GB, at least 2.05 ms at 3.35 TB/s
// (computed, not measured). It is memory-bound: the work per element is a
// shared-memory load, a NaN test and an fminf / fmaxf.

#include "segment_reduce.cuh"

extern "C" {

// dtype: 0 float32, 1 bfloat16, 2 int32. op: 0 min, 1 max. perm, scodes
// (N,) and offsets (size + 1,) int32 are the binned codes; groups is the
// number of groups per block (1 <= groups <= size <= 512). Returns the
// cudaError_t of the launch (0 on success).
int flox_segment_minmax(const void* data, int dtype, const int* perm, const int* scodes,
                        const int* offsets, long long K, long long N, int size, int groups,
                        int op, void* out, void* stream) {
  if (size > flox::kGroupCap) return static_cast<int>(cudaErrorInvalidValue);
  if (op == 0)
    return flox::dispatch_segment_extremum<false>(data, dtype, perm, scodes, offsets, K, N, size,
                                                  groups, out, stream);
  if (op == 1)
    return flox::dispatch_segment_extremum<true>(data, dtype, perm, scodes, offsets, K, N, size,
                                                 groups, out, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flox_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
