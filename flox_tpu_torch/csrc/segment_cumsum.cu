// Grouped inclusive cumsum / nancumsum, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flox_tpu/pallas_kernels.py:_scan_kernel
// (built by _build_scan, entered through segment_cumsum_pallas):
//
//   data  (K, N) row-major, N contiguous, read once and in place;
//         float32 or bfloat16
//   codes (N,) int32; a code outside [0, size) is a missing label, and the
//         missing labels scan among themselves as one extra group, `size`
//   out   (K, N) in the data dtype: per row, each value's running sum over
//         the earlier values of its group, accumulated in float32 (bfloat16
//         is rounded back per element, to nearest even)
//
// IEEE prefix semantics, per group, as the Pallas kernel gives them:
//   - NaN beats inf; +inf together with -inf is NaN;
//   - nancumsum (SKIPNA) skips NaN values only; inf still propagates;
//   - a running sum that overflows becomes +-inf (NaN if the tree order
//     below forms opposite infinities) and stays so.
// The state is sticky: a lane of group g that reports a non-finite value is
// never followed by a finite lane of g. Non-finite values are zero-filled
// before the additions and tracked as per-group marker bits instead (NaN,
// +inf, -inf), carried across chunks next to the finite running sum; an
// arithmetic overflow is recorded as a marker only while the group has none
// (a true +-inf running sum absorbs finite addends and cannot overflow
// again), and within a chunk the first overflowing lane decides the sign.
//
// Design. One warp per row k, 8 rows per block; the warp walks N in order in
// 32-column chunks (4 loaded before any is scanned) and keeps, in shared
// memory, a float32 carry and the marker bits of each of its size + 1 groups.
// For each distinct code in a chunk, a warp inclusive scan (__shfl_up_sync,
// Hillis-Steele, 5 steps) over that group's lanes -- the others contribute 0
// -- is added to the group's carry; the group's last lane writes the new
// carry and markers back. Outputs are written coalesced, one column per lane.
// The in-chunk order is a fixed tree, not sequential, so a partial sum can
// overflow where the sequential one does not: the same boundary as the
// Pallas kernel's matrix-unit contraction (pallas_kernels.py:547-553). The
// sticky markers keep the group state consistent whatever that order does.
//
// Bound on the card: one read and one write of the data, 2*K*N*itemsize
// bytes (plus N*4 of codes). At the benchmark width of 65160 x 26304 float32
// that is 13.71 GB, at least 4.09 ms at 3.35 TB/s (computed, not measured).

#include "segment_reduce.cuh"

namespace {

using flox::kFull;
using flox::kUnroll;
using flox::kWarps;

constexpr unsigned kNaN = 1u;
constexpr unsigned kPos = 2u;
constexpr unsigned kNeg = 4u;

__device__ __forceinline__ void store_out(float* p, float v) { __stcs(p, v); }

__device__ __forceinline__ void store_out(uint16_t* p, float v) {
  // float32 -> bfloat16, round to nearest even (as torch rounds); NaN stays NaN
  const unsigned u = __float_as_uint(v);
  const unsigned r = isnan(v) ? 0x7fc00000u : u + 0x7fffu + ((u >> 16) & 1u);
  *p = static_cast<uint16_t>(r >> 16);
}

__device__ __forceinline__ float resolve(unsigned seen, float r) {
  if ((seen & kNaN) || (seen & (kPos | kNeg)) == (kPos | kNeg))
    return __int_as_float(0x7fc00000);
  if (seen & kPos) return flox::pos_inf();
  if (seen & kNeg) return flox::neg_inf();
  return r;
}

// Scans one 32-column chunk; returns this lane's output. `code` is in
// [0, size] for a real column and -1 for padding past N.
template <bool SKIPNA>
__device__ __forceinline__ float scan_chunk(float x, int code, int lane, unsigned le,
                                            float* carry, unsigned* state) {
  const bool valid = code >= 0;
  const bool is_nan = isnan(x);
  const bool is_pos = x == flox::pos_inf();
  const bool is_neg = x == flox::neg_inf();
  const float z = (is_nan || is_pos || is_neg) ? 0.0f : x;
  const unsigned nan_b = SKIPNA ? 0u : __ballot_sync(kFull, valid && is_nan);
  const unsigned pos_b = __ballot_sync(kFull, valid && is_pos);
  const unsigned neg_b = __ballot_sync(kFull, valid && is_neg);
  float res = 0.0f;
  unsigned todo = __ballot_sync(kFull, valid);
  while (todo) {  // warp-uniform: todo comes from a ballot
    const int leader = __ffs(todo) - 1;
    const int g = __shfl_sync(kFull, code, leader);
    const bool mine = valid && code == g;
    const unsigned peers = __ballot_sync(kFull, mine);
    float v = mine ? z : 0.0f;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float t = __shfl_up_sync(kFull, v, d);
      if (lane >= d) v = __fadd_rn(v, t);
    }
    const float r = __fadd_rn(carry[g], v);
    // markers of the group's values at or before this lane, and its state
    unsigned seen = state[g];
    const unsigned upto = peers & le;
    if (nan_b & upto) seen |= kNaN;
    if (pos_b & upto) seen |= kPos;
    if (neg_b & upto) seen |= kNeg;
    // an overflow counts only while the group has no marker; the first
    // overflowing lane of the group decides the sign for all later lanes
    const unsigned ovf = __ballot_sync(kFull, mine && seen == 0u && !isfinite(r));
    if (ovf) {  // warp-uniform
      const int first = __ffs(ovf) - 1;
      const float rf = __shfl_sync(kFull, r, first);
      const unsigned ev =
          isnan(rf) ? (SKIPNA ? (kPos | kNeg) : kNaN) : (rf > 0.0f ? kPos : kNeg);
      if (lane >= first) seen |= ev;
    }
    if (mine) res = resolve(seen, r);
    const int last = 31 - __clz(peers);
    __syncwarp();  // every lane has read carry[g] and state[g]
    if (lane == last) {
      state[g] = seen;
      carry[g] = seen ? 0.0f : r;  // with a marker the carry is never read
    }
    __syncwarp();  // the write, visible to the whole warp
    todo &= ~peers;
  }
  return res;
}

template <typename T, bool SKIPNA>
__global__ void __launch_bounds__(kWarps * 32)
segment_cumsum_kernel(const T* __restrict__ data, const int* __restrict__ codes, long long K,
                      long long N, int size, T* __restrict__ out) {
  extern __shared__ float smem[];
  const int groups = size + 1;  // the last one holds the missing labels
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long k = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (k >= K) return;  // whole warp; no block-wide barrier follows

  float* carry = smem + static_cast<size_t>(warp) * groups * 2;
  unsigned* state = reinterpret_cast<unsigned*>(carry + groups);
  for (int g = lane; g < groups; g += 32) {
    carry[g] = 0.0f;
    state[g] = 0u;
  }
  __syncwarp();

  const unsigned le = (2u << lane) - 1u;  // this lane and the ones before it
  const T* row = data + k * N;  // 64-bit offsets: K*N exceeds 2^31 at full width
  T* orow = out + k * N;
  for (long long c0 = 0; c0 < N; c0 += 32 * kUnroll) {
    float x[kUnroll];
    int code[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long c = c0 + u * 32 + lane;
      if (c < N) {
        x[u] = flox::load_value(row + c);
        const int cd = __ldg(codes + c);
        code[u] = static_cast<unsigned>(cd) < static_cast<unsigned>(size) ? cd : size;
      } else {
        x[u] = 0.0f;
        code[u] = -1;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float r = scan_chunk<SKIPNA>(x[u], code[u], lane, le, carry, state);
      const long long c = c0 + u * 32 + lane;
      if (c < N) store_out(orow + c, r);
    }
  }
}

template <typename T, bool SKIPNA>
cudaError_t launch(const void* data, const int* codes, long long K, long long N, int size,
                   void* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kWarps) * (size + 1) * 2 * sizeof(float);
  auto kernel = segment_cumsum_kernel<T, SKIPNA>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (K + kWarps - 1) / kWarps;
  kernel<<<static_cast<unsigned>(blocks), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(data), codes, K, N, size, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. skipna: 0 cumsum, 1 nancumsum.
// size + 1 groups (the missing-label group included), at most 512.
// Returns the cudaError_t of the launch (0 on success).
int flox_segment_cumsum(const void* data, int dtype, const int* codes, long long K, long long N,
                        int size, int skipna, void* out, void* stream) {
  if (K <= 0 || N < 0 || size <= 0 || size + 1 > 512 || K > 0x7fffffffLL * kWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = skipna ? launch<float, true>(data, codes, K, N, size, out, st)
                 : launch<float, false>(data, codes, K, N, size, out, st);
  } else if (dtype == 1) {
    err = skipna ? launch<uint16_t, true>(data, codes, K, N, size, out, st)
                 : launch<uint16_t, false>(data, codes, K, N, size, out, st);
  }
  return static_cast<int>(err);
}

const char* flox_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
