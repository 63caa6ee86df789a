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
//         is rounded back per element, to nearest even, as torch rounds on
//         the card)
//   state (size + 1, K) pairs of 32-bit words, scratch: per (group, row) the
//         float32 running sum and the marker bits between the group's runs
//
// IEEE prefix semantics, per group, as the Pallas kernel gives them:
//   - NaN beats inf; +inf together with -inf is NaN;
//   - nancumsum (SKIPNA) skips NaN values only; inf still propagates;
//   - a running sum that overflows becomes +-inf and stays so.
// The state is sticky: once a group reports a non-finite value, every later
// value of the group does. Non-finite values are never added: they set
// marker bits (NaN, +inf, -inf) beside the finite running sum, and the
// output is resolved from the markers while any is set. An overflow of the
// running sum sets the marker of its sign only while the group has none (a
// true +-inf running sum absorbs finite addends and cannot overflow again).
//
// Design. Block b owns a tile of kRows = 128 rows, one thread per row, and
// walks all N columns in their original order in stages of 32: each stage is
// a (kRows, 33) float tile in shared memory
// (the pitch of 33 words makes thread r's reads of column c, and a warp's
// reads of a row, conflict-free), filled by cp.async from 128-byte row
// segments (warps fill along the row, lane = column), double-buffered, with
// the stage's codes beside it; bfloat16, below cp.async's 4-byte minimum, is
// loaded into registers a stage ahead and stored widened to its tile after
// the stage is written back. Thread r walks the stage's 32 columns in order
// with the current group's running sum and markers in registers; one ballot
// per stage marks the columns where the code changes, and at a change the
// thread stores the finished group's (sum, markers) to state[g * K + k] and
// loads the next group's (a warp moves 32 consecutive k: 256 bytes). Each
// row's state is its thread's alone, so nothing is atomic and nothing
// races; the kernel zeroes it first, with no launch of its own. The scanned
// value overwrites its input in the tile (bfloat16 already rounded), and
// after a barrier the warps store the tile, lane = column, to out with
// streaming stores. There is no binning: the output lands in column order,
// so the stores, like the loads, stay 128-byte row segments. On the month
// codes (runs of ~730 columns) the state moves about once every 23 stages,
// and at 13 groups it is 6.8 MB, resident in L2.
//
// Rows per block. Every block walks all of N, so the grid is one wave, and
// at K = 65160 an SM holds at most 512 rows either way (510 blocks of 128
// or 255 of 256 on 132 SMs). Measured on the H100 (PERF.md, PR 7), 128 rows
// ran faster than 256; the likely reason, not measured: a block waits at two
// barriers a stage, and four smaller blocks an SM overlap their waits better
// than two.
//
// Invariants (checked on the card by chip_smoke.py):
//   - per (group, row), the running sum is sequential in column order, one
//     __fadd_rn per finite value (nvcc contracts nothing); an overflow is
//     seen on that sequential float32 sum. The Pallas kernel's boundary of
//     overflow in a reordered (matrix-unit) sum (pallas_kernels.py:547-553)
//     does not apply here; nor can finite + finite give NaN, so an overflow
//     is always +-inf;
//   - hence the output equals a float32 column-order emulation of the walk
//     (one torch op per rounding) bit for bit, and two launches give the
//     same bits; against the plain version (a float64 cumsum rounded to
//     float32) it lies within n_g * u * cumsum|x| plus one ulp.
//
// Bound on the card: one read and one write of the data, 2*K*N*itemsize
// bytes (plus N*4 of codes; the state, 8*(size + 1)*K bytes, stays in L2 at
// small sizes). At the benchmark width of 65160 x 26304 float32 that is
// 13.71 GB, at least 4.09 ms at 3.35 TB/s (computed, not measured). The
// work per element is a shared-memory load and store, a finiteness test, an
// add and the overflow test.

#include <cuda_bf16.h>

#include "segment_reduce.cuh"

namespace {

using flox::kCols;
using flox::kFull;
using flox::kPitch;

constexpr int kRows = 128;  // rows per block, one thread each

constexpr unsigned kNaN = 1u;
constexpr unsigned kPos = 2u;
constexpr unsigned kNeg = 4u;

__device__ __forceinline__ float resolve(unsigned seen, float r) {
  if ((seen & kNaN) || (seen & (kPos | kNeg)) == (kPos | kNeg))
    return __int_as_float(0x7fc00000);
  if (seen & kPos) return flox::pos_inf();
  if (seen & kNeg) return flox::neg_inf();
  return r;
}

// float32 -> the nearest bfloat16, ties to even, as a float32: CUDA's own
// conversion, which torch's takes on the card (a NaN becomes 0x7fff)
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store_out(float* p, float v) { __stcs(p, v); }

__device__ __forceinline__ void store_out(uint16_t* p, float v) {
  // exact: v is already a bfloat16 value
  __stcs(reinterpret_cast<unsigned short*>(p),
         static_cast<unsigned short>(__float_as_uint(v) >> 16));
}

// One value x of the group whose running sum is r and markers seen; returns
// the group's running result, in the output dtype's precision.
template <typename T, bool SKIPNA>
__device__ __forceinline__ float step(float& r, unsigned& seen, float x) {
  if (__builtin_expect(fabsf(x) < flox::pos_inf(), 1)) {
    r = __fadd_rn(r, x);
    // an overflow counts only while the group has no marker
    if (__builtin_expect(!(fabsf(r) < flox::pos_inf()), 0) && seen == 0u)
      seen = r > 0.0f ? kPos : kNeg;
  } else if (isnan(x)) {
    if (!SKIPNA) seen |= kNaN;
  } else {
    seen |= x > 0.0f ? kPos : kNeg;
  }
  const float v = seen ? resolve(seen, r) : r;
  return sizeof(T) == 2 ? round_bf16(v) : v;
}

template <typename T, bool SKIPNA>
// 512 threads per SM: at the benchmark's K = 65160 the blocks are all
// resident at once, as each walks all of N
__global__ void __launch_bounds__(kRows, 512 / kRows)
segment_cumsum_kernel(const T* __restrict__ data, const int* __restrict__ codes, long long K,
                      long long N, int size, uint2* __restrict__ state, T* __restrict__ out) {
  constexpr int kWarps = kRows / 32;
  constexpr int kTile = kRows * kPitch;
  // warp w moves rows w, w + kWarps, ...: 32 of them
  constexpr int kRowsPerWarp = kRows / kWarps;
  extern __shared__ float smem[];  // 2 tiles of kRows x kPitch, then 2 x kCols codes
  int* codes_s = reinterpret_cast<int*>(smem + 2 * kTile);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long k0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(K - k0 < kRows ? K - k0 : kRows);  // rows of this tile
  const bool row_ok = threadIdx.x < rows;
  const long long nstages = (N + kCols - 1) / kCols;
  uint2* const st = state + k0 + threadIdx.x;  // group g's state of this row: st[g * K]

  uint16_t held[sizeof(T) == 4 ? 1 : kRowsPerWarp];
  int held_code = 0;
  auto fill = [&](long long s) {  // lane = column; bfloat16 into `held`, land() stores it
    const long long col = s * kCols + lane;
    if (col >= N) {
      if (sizeof(T) == 4) flox::cp_async_commit();
      return;
    }
    const T* src = data + (k0 + warp) * N + col;  // 64-bit: K*N exceeds 2^31 at full width
    if constexpr (sizeof(T) == 4) {
      float* dst = smem + (s & 1) * kTile + warp * kPitch + lane;
#pragma unroll 8
      for (int i = 0; i < kRowsPerWarp; ++i)
        if (warp + i * kWarps < rows)
          flox::cp_async4(dst + i * kWarps * kPitch, src + i * kWarps * N);
      if (warp == 0) flox::cp_async4(codes_s + (s & 1) * kCols + lane, codes + col);
      flox::cp_async_commit();
    } else {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        held[i] = warp + i * kWarps < rows ? __ldg(src + i * kWarps * N) : uint16_t(0);
      if (warp == 0) held_code = __ldg(codes + col);
    }
  };
  auto land = [&](long long s) {  // bfloat16 only: the registers of stage s into its tile
    if constexpr (sizeof(T) == 2) {
      if (s * kCols + lane >= N) return;
      float* dst = smem + (s & 1) * kTile + warp * kPitch + lane;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) dst[i * kWarps * kPitch] = flox::widen(held[i]);
      if (warp == 0) codes_s[(s & 1) * kCols + lane] = held_code;
    }
  };
  auto store = [&](long long s) {  // the scanned tile of stage s to out, lane = column
    const long long col = s * kCols + lane;
    if (col >= N) return;
    const float* src = smem + (s & 1) * kTile + warp * kPitch + lane;
    T* dst = out + (k0 + warp) * N + col;
#pragma unroll 8
    for (int i = 0; i < kRowsPerWarp; ++i)
      if (warp + i * kWarps < rows) store_out(dst + i * kWarps * N, src[i * kWarps * kPitch]);
  };

  if (row_ok)
    for (int g = 0; g <= size; ++g) st[g * K] = make_uint2(0u, 0u);
  float r = 0.0f;     // the running sum of group cur
  unsigned seen = 0u;  // and its markers
  int cur = 0;
  if (nstages > 0) {
    fill(0);
    land(0);
  }
  for (long long s = 0; s < nstages; ++s) {
    if constexpr (sizeof(T) == 4) flox::cp_async_wait_all();  // this thread's copies of stage s
    // every thread's stage s is in its tile, and every thread has stored
    // stage s - 1, whose buffer the next fill takes
    __syncthreads();
    const bool ahead = s + 1 < nstages;
    if (ahead) fill(s + 1);
    float* x = smem + (s & 1) * kTile + threadIdx.x * kPitch;
    const int* code = codes_s + (s & 1) * kCols;
    const int ncols = static_cast<int>(N - s * kCols < kCols ? N - s * kCols : kCols);
    auto group = [&](int c) {  // the missing labels are group `size`
      const int v = code[c];
      return static_cast<unsigned>(v) < static_cast<unsigned>(size) ? v : size;
    };
    // bit c of `starts`: column c is of another group than the column before
    // it (for c = 0, than cur); block-uniform, so the walk goes run by run
    const int mine = lane < ncols ? group(lane) : 0;
    const int prev = lane == 0 ? cur : group(lane - 1);
    const unsigned starts = __ballot_sync(kFull, lane < ncols && mine != prev);
    int c = 0;
    while (c < ncols) {
      if ((starts >> c) & 1u) {
        const int g = group(c);
        if (row_ok) {
          st[static_cast<long long>(cur) * K] = make_uint2(__float_as_uint(r), seen);
          const uint2 v = st[static_cast<long long>(g) * K];
          r = __uint_as_float(v.x);
          seen = v.y;
        }
        cur = g;
      }
      const unsigned later = c == kCols - 1 ? 0u : starts >> (c + 1);
      const int e = later ? min(c + __ffs(later), ncols) : ncols;  // the run's end
#pragma unroll 4
      for (; c < e; ++c) x[c] = step<T, SKIPNA>(r, seen, x[c]);
    }
    __syncthreads();  // every row of stage s scanned
    store(s);
    if (ahead) land(s + 1);
  }
}

template <typename T, bool SKIPNA>
cudaError_t launch(const void* data, const int* codes, long long K, long long N, int size,
                   void* state, void* out, cudaStream_t stream) {
  constexpr size_t smem = (2 * kRows * kPitch + 2 * kCols) * sizeof(float);
  auto kernel = segment_cumsum_kernel<T, SKIPNA>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const long long blocks = (K + kRows - 1) / kRows;
  kernel<<<static_cast<unsigned>(blocks), kRows, smem, stream>>>(
      static_cast<const T*>(data), codes, K, N, size, static_cast<uint2*>(state),
      static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. skipna: 0 cumsum, 1 nancumsum. size + 1
// groups (the missing-label group included), at most 512. state:
// (size + 1) * K * 8 bytes of scratch, 8-byte aligned. Returns the
// cudaError_t of the launch (0 on success).
int flox_segment_cumsum(const void* data, int dtype, const int* codes, long long K, long long N,
                        int size, int skipna, void* state, void* out, void* stream) {
  if (K <= 0 || N < 0 || size <= 0 || size + 1 > flox::kGroupCap ||
      (K + kRows - 1) / kRows > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = skipna ? launch<float, true>(data, codes, K, N, size, state, out, st)
                 : launch<float, false>(data, codes, K, N, size, state, out, st);
  } else if (dtype == 1) {
    err = skipna ? launch<uint16_t, true>(data, codes, K, N, size, state, out, st)
                 : launch<uint16_t, false>(data, codes, K, N, size, state, out, st);
  }
  return static_cast<int>(err);
}

const char* flox_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
