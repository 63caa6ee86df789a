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
// Design. One warp per row k; 8 rows per block. Lanes stride over N with
// coalesced loads of data and codes, 4 chunks of 32 columns in flight per
// warp. For each chunk the warp walks the distinct codes present: the
// lowest lane not yet served names a group g, a ballot finds its lanes, and
// a fixed butterfly (xor-shuffle) tree sums their values into every lane;
// popcounts of ballots give the marker counts. Lane 0 alone then folds the
// chunk's partial into the warp's per-group accumulators in shared memory,
// under the chosen discipline. Every step has a fixed order given the input,
// and there are no atomics, so two launches give bit-identical outputs.
// All float arithmetic in the discipline uses the _rn intrinsics, which
// nvcc never contracts into FMAs: a contracted Dekker split or two_sum
// would lose the error terms.
//
// Bound on the card: the kernel must read K*N*itemsize bytes of data once
// (plus N*4 of codes, and write 4*size*K*4). At the benchmark width,
// 65160 x 26304 float32 = 6.86 GB, that is at least 2.05 ms at the H100's
// 3.35 TB/s (computed, not measured). It is memory-bound: the work per
// element is a few dozen warp instructions. The design keeps loads
// coalesced and several in flight; it does not yet stage codes in shared
// memory or reduce several rows per ballot.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // rows per block
constexpr int kUnroll = 4;  // 32-column chunks loaded before any is reduced
constexpr unsigned kFull = 0xffffffffu;
constexpr int kAccVals = 5;  // hi, lo (f32) and nan, pos, neg (u32) per group

__device__ __forceinline__ float load_value(const float* p) { return __ldcs(p); }

__device__ __forceinline__ float load_value(const uint16_t* p) {
  // bfloat16 is the top half of a float32: widening is exact
  return __uint_as_float(static_cast<unsigned>(__ldcs(p)) << 16);
}

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& err) {
  s = __fadd_rn(a, b);
  float bb = __fsub_rn(s, a);
  err = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, s));
  return v;
}

template <int ACC>
__device__ __forceinline__ void reduce_chunk(float x, int code, int size, int lane,
                                             float* hi, float* lo, unsigned* cnt) {
  const bool valid = static_cast<unsigned>(code) < static_cast<unsigned>(size);
  const bool is_nan = isnan(x);
  const bool is_pos = x == __int_as_float(0x7f800000);
  const bool is_neg = x == __int_as_float(0xff800000);
  const float z = (is_nan || is_pos || is_neg) ? 0.0f : x;
  float z_hi = z, z_lo = 0.0f;
  if (ACC == 2) {
    // Dekker split 24 -> 12 + 12 bits; the split constant overflows above
    // f32max / 4097 ~ 8.3e34, so such values stay whole
    const float c = __fmul_rn(z, 4097.0f);
    z_hi = __fsub_rn(c, __fsub_rn(c, z));
    z_lo = __fsub_rn(z, z_hi);
    if (fabsf(z) > 8e34f) {
      z_hi = z;
      z_lo = 0.0f;
    }
  }
  const unsigned nan_b = __ballot_sync(kFull, valid && is_nan);
  const unsigned pos_b = __ballot_sync(kFull, valid && is_pos);
  const unsigned neg_b = __ballot_sync(kFull, valid && is_neg);
  unsigned todo = __ballot_sync(kFull, valid);
  while (todo) {  // warp-uniform: todo comes from a ballot
    const int leader = __ffs(todo) - 1;
    const int g = __shfl_sync(kFull, code, leader);
    const bool mine = valid && code == g;
    const unsigned peers = __ballot_sync(kFull, mine);
    const float s_hi = warp_sum(mine ? z_hi : 0.0f);
    float s_lo = 0.0f;
    if (ACC == 2) s_lo = warp_sum(mine ? z_lo : 0.0f);
    if (lane == 0) {
      cnt[g] += __popc(nan_b & peers);
      cnt[size + g] += __popc(pos_b & peers);
      cnt[2 * size + g] += __popc(neg_b & peers);
      if (ACC == 0) {
        hi[g] = __fadd_rn(hi[g], s_hi);
      } else if (ACC == 1) {
        const float y = __fsub_rn(s_hi, lo[g]);
        const float t = __fadd_rn(hi[g], y);
        lo[g] = __fsub_rn(__fsub_rn(t, hi[g]), y);
        hi[g] = t;
      } else {
        float s, e1, h, e2, h2, l2;
        two_sum(s_hi, s_lo, s, e1);
        two_sum(hi[g], s, h, e2);
        const float l = __fadd_rn(lo[g], __fadd_rn(e1, e2));
        // Knuth two_sum, not Fast2Sum: after cancellation |l| may exceed |h|
        two_sum(h, l, h2, l2);
        hi[g] = h2;
        lo[g] = l2;
      }
    }
    todo &= ~peers;
  }
}

template <typename T, int ACC>
__global__ void __launch_bounds__(kWarps * 32)
segment_sum_kernel(const T* __restrict__ data, const int* __restrict__ codes, long long K,
                   long long N, int size, float* __restrict__ sums, float* __restrict__ nan_c,
                   float* __restrict__ pos_c, float* __restrict__ neg_c) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long k = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (k >= K) return;  // whole warp; no block-wide barrier follows

  float* hi = smem + static_cast<size_t>(warp) * size * kAccVals;
  float* lo = hi + size;
  unsigned* cnt = reinterpret_cast<unsigned*>(lo + size);  // nan | pos | neg
  for (int g = lane; g < size; g += 32) {
    hi[g] = 0.0f;
    lo[g] = 0.0f;
    cnt[g] = cnt[size + g] = cnt[2 * size + g] = 0u;
  }
  __syncwarp();

  const T* row = data + k * N;  // 64-bit offset: K*N exceeds 2^31 at full width
  for (long long c0 = 0; c0 < N; c0 += 32 * kUnroll) {
    float x[kUnroll];
    int code[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long c = c0 + u * 32 + lane;
      if (c < N) {
        x[u] = load_value(row + c);
        code[u] = __ldg(codes + c);
      } else {
        x[u] = 0.0f;
        code[u] = -1;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) reduce_chunk<ACC>(x[u], code[u], size, lane, hi, lo, cnt);
  }
  __syncwarp();  // lane 0's accumulator writes, visible to the whole warp

  for (int g = lane; g < size; g += 32) {
    const long long o = static_cast<long long>(g) * K + k;
    sums[o] = hi[g];
    nan_c[o] = static_cast<float>(cnt[g]);
    pos_c[o] = static_cast<float>(cnt[size + g]);
    neg_c[o] = static_cast<float>(cnt[2 * size + g]);
  }
}

template <typename T, int ACC>
cudaError_t launch(const void* data, const int* codes, long long K, long long N, int size,
                   float* sums, float* nan_c, float* pos_c, float* neg_c, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kWarps) * size * kAccVals * sizeof(float);
  auto kernel = segment_sum_kernel<T, ACC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (K + kWarps - 1) / kWarps;
  kernel<<<static_cast<unsigned>(blocks), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(data), codes, K, N, size, sums, nan_c, pos_c, neg_c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. accum: 0 plain, 1 kahan, 2 dd.
// Returns the cudaError_t of the launch (0 on success).
int flox_segment_sum(const void* data, int dtype, const int* codes, long long K, long long N,
                     int size, int accum, void* sums, void* nan_c, void* pos_c, void* neg_c,
                     void* stream) {
  if (K <= 0 || N < 0 || size <= 0 || size > 512 || K > 0x7fffffffLL * kWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  float* s = static_cast<float*>(sums);
  float* a = static_cast<float*>(nan_c);
  float* p = static_cast<float*>(pos_c);
  float* m = static_cast<float*>(neg_c);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    if (accum == 0) err = launch<float, 0>(data, codes, K, N, size, s, a, p, m, st);
    if (accum == 1) err = launch<float, 1>(data, codes, K, N, size, s, a, p, m, st);
    if (accum == 2) err = launch<float, 2>(data, codes, K, N, size, s, a, p, m, st);
  } else if (dtype == 1) {
    if (accum == 0) err = launch<uint16_t, 0>(data, codes, K, N, size, s, a, p, m, st);
    if (accum == 1) err = launch<uint16_t, 1>(data, codes, K, N, size, s, a, p, m, st);
    if (accum == 2) err = launch<uint16_t, 2>(data, codes, K, N, size, s, a, p, m, st);
  }
  return static_cast<int>(err);
}

const char* flox_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
