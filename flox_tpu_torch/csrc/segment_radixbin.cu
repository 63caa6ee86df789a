// Radix-binning segment-sum with non-finite markers, for Hopper (sm_90a): the
// segment-sum of segment_sum.cu past its 512-group cap.
//
// Replaces the Pallas TPU kernel flox_tpu/pallas_kernels.py:_radixbin_kernel
// (built by _build_radixbin, entered through segment_sum_radixbin_pallas). It
// computes the same function:
//
//   data  (K, N) row-major, N contiguous, read in place; float32 or bfloat16
//   codes (N,); a code outside [0, size) drops out
//   sums, nan_c, pos_c, neg_c  (size, K) float32: per (group, row) the sum
//         of the finite values and the counts of NaN, +inf and -inf
//
// The codes reach the kernel binned (cuda_kernels._radixbin_bins, device ops
// over the N codes only): perm, the columns in stable order of their code
// (invalid codes last); scodes, the codes in that order; offsets (size + 1,),
// so that group g owns columns perm[offsets[g] : offsets[g + 1]] in their
// original order. For codes sorted along N (a time axis binned by day, the
// sort engine's compact codes) perm is the identity.
//
// Design. Block b owns a tile of kRows = 256 rows (one thread per row) and a
// segment of kGroups = 8 consecutive groups; the segment index is the
// fastest (b % nseg), so all segments of one row tile run together and share
// that tile's rows in L2. The ~396 blocks resident at once (3 per SM) span
// about 396 / nseg row tiles; a tile is 27 MB at 26304 float32 columns, so
// the narrow segment keeps random codes over a few thousand groups within
// about one tile, which stays in the 50 MB L2 while its segments gather from
// it. Wider segments span more tiles and miss more (PERF.md has the times
// of widths 4-64); sorted codes are indifferent to the width. The block streams its segment's columns, perm[offsets[g0] :
// offsets[g0 + kGroups]], in stages of kCols columns: each stage is a
// (kRows, kCols + 1) float tile in shared memory, the pitch of 33 words
// making thread r's reads of column c conflict-free, filled by cp.async
// gathers data[k0 + r, perm[j]] (warps fill along the row, lane = column, so
// the identity perm gives 128-byte row segments) with the stage's codes
// beside it. Stage s + 1 is in flight while stage s is walked (bfloat16,
// below cp.async's 4-byte minimum, is loaded into registers instead and
// stored to the tile after the walk). Thread r walks the stage's columns in
// order with one group's (hi, lo, nan, pos, neg) in registers, run by run:
// one ballot per stage marks the columns where the code changes. At a change
// it writes the finished group's outputs at out[g * K + k] (a warp writes 32
// consecutive k) and zeros for any empty group it passes; at the segment's
// end it writes every remaining group. Every output is written exactly once,
// nothing is atomic, and every thread walks the same columns, so all
// branching is block-uniform, but for the rare non-finite value.
//
// Invariant: per (group, row) the sum is a sequential walk over the group's
// columns in column order, under the plain, kahan or dd discipline of
// segment_reduce.cuh applied per element (zero-fill and count non-finites;
// plain __fadd_rn; kahan's _rn compensated update; dd's Dekker split by 4097
// with the 8e34 guard, then two_sum merges). Everything goes through _rn
// intrinsics, so nvcc contracts nothing into FMAs. Hence the result does not
// depend on where other groups' columns lie: random codes give the bits of
// the same data with its columns gathered into code order, the sort engine's
// compact call equals the dense call bit for bit, and reruns are identical.
//
// What this answers in the earlier one-warp-per-row design (B1's walk with a
// second grid axis over 512-group blocks): (1) each 32-column chunk cost four
// ballots, a shuffle, a 5-step butterfly and a serial lane-0 update per
// distinct code, about 80 warp instructions per 32 elements on 24-column
// days; the per-thread walk costs a shared-memory load, a finiteness test
// and the discipline's adds per element, with no shuffle; (2) 80 KB of
// shared accumulators held occupancy at 16 warps per SM and every step
// loaded its codes before its data; here the accumulators live in
// registers, the 67 KB of double-buffered tiles allow 3 blocks (24 warps)
// per SM, and the loads of a stage start a stage ahead; (3) on
// unsorted codes every 512-group block read every column; here each block
// reads only its own groups' columns, gathered. A gathered column costs one
// 32-byte sector request per 4-byte element, so unsorted codes stay several
// times slower than sorted ones.
//
// Skew: a group's columns are never split across blocks, so one group that
// owns most columns is walked serially by the blocks of its segment, one per
// row tile. Correct, but slow; not addressed here.
//
// Bound on the card: one read of the data, K*N*itemsize bytes, plus N*4 of
// codes and 4*size*K*4 of outputs. For the daily means of the benchmark
// array, 65160 x 26304 float32 over 1096 days, that is (6.856 + 1.143) GB at
// 3.35 TB/s = 2.39 ms (computed, not measured).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 256;  // rows per block, one thread each
constexpr int kWarps = kRows / 32;
constexpr int kGroups = 8;  // groups per block (a segment)
constexpr int kCols = 32;    // columns per stage: one per lane when filling
constexpr int kPitch = kCols + 1;
constexpr int kTileWords = kRows * kPitch;
constexpr int kRowsPerWarp = kRows / kWarps;

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float widen(uint16_t v) {
  // bfloat16 is the top half of a float32: widening is exact
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& err) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  err = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct Acc {
  float hi, lo;
  unsigned nan, pos, neg;
};

template <int ACC>
__device__ __forceinline__ void add(Acc& a, float x) {
  float z = x;
  if (__builtin_expect(!(fabsf(x) < pos_inf()), 0)) {  // NaN or +-inf: rare
    a.nan += isnan(x);
    a.pos += x == pos_inf();
    a.neg += x == neg_inf();
    z = 0.0f;
  }
  if (ACC == 0) {
    a.hi = __fadd_rn(a.hi, z);
  } else if (ACC == 1) {
    const float y = __fsub_rn(z, a.lo);
    const float t = __fadd_rn(a.hi, y);
    a.lo = __fsub_rn(__fsub_rn(t, a.hi), y);
    a.hi = t;
  } else {
    // Dekker split 24 -> 12 + 12 bits; the split constant overflows above
    // f32max / 4097 ~ 8.3e34, so such values stay whole
    const float c = __fmul_rn(z, 4097.0f);
    float z_hi = __fsub_rn(c, __fsub_rn(c, z));
    float z_lo = __fsub_rn(z, z_hi);
    if (fabsf(z) > 8e34f) {
      z_hi = z;
      z_lo = 0.0f;
    }
    float s, e1, h, e2, h2, l2;
    two_sum(z_hi, z_lo, s, e1);
    two_sum(a.hi, s, h, e2);
    const float l = __fadd_rn(a.lo, __fadd_rn(e1, e2));
    // Knuth two_sum, not Fast2Sum: after cancellation |l| may exceed |h|
    two_sum(h, l, h2, l2);
    a.hi = h2;
    a.lo = l2;
  }
}

struct Out {
  float *sums, *nan_c, *pos_c, *neg_c;
  long long K;

  __device__ __forceinline__ void put(int g, long long k, const Acc& a) const {
    const long long o = static_cast<long long>(g) * K + k;
    sums[o] = a.hi;
    nan_c[o] = static_cast<float>(a.nan);
    pos_c[o] = static_cast<float>(a.pos);
    neg_c[o] = static_cast<float>(a.neg);
  }
};

template <typename T, int ACC>
__global__ void __launch_bounds__(kRows, sizeof(T) == 4 ? 3 : 2)
radixbin_kernel(const T* __restrict__ data, const int* __restrict__ perm,
                const int* __restrict__ scodes, const int* __restrict__ offsets, long long N,
                int size, int nseg, Out out) {
  extern __shared__ float smem[];  // 2 tiles of kRows x kPitch, then 2 x kCols codes
  int* codes_s = reinterpret_cast<int*>(smem + 2 * kTileWords);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int seg = static_cast<int>(blockIdx.x % nseg);
  const long long k0 = static_cast<long long>(blockIdx.x / nseg) * kRows;
  const long long K = out.K;
  const int rows = static_cast<int>(K - k0 < kRows ? K - k0 : kRows);  // rows of this tile
  const long long k = k0 + threadIdx.x;
  const bool row_ok = threadIdx.x < rows;
  const int g_begin = seg * kGroups;  // < size
  const int g_end = size - g_begin < kGroups ? size : g_begin + kGroups;
  const int j_begin = __ldg(offsets + g_begin);
  const int j_end = __ldg(offsets + g_end);
  const int nstages = (j_end - j_begin + kCols - 1) / kCols;

  // the fill of stage s: lane = column, warp w takes rows w, w + 8, ...;
  // bfloat16 goes through `held` (registers) and land() stores it
  uint16_t held[sizeof(T) == 4 ? 1 : kRowsPerWarp];
  int held_code = 0;
  auto fill = [&](int s) {
    const int j = j_begin + s * kCols + lane;
    if (j >= j_end) {
      if (sizeof(T) == 4) cp_async_commit();
      return;
    }
    const long long col = __ldg(perm + j);
    const T* src = data + (k0 + warp) * N + col;  // 64-bit: K*N exceeds 2^31 at full width
    if constexpr (sizeof(T) == 4) {
      float* dst = smem + (s & 1) * kTileWords + warp * kPitch + lane;
#pragma unroll 8
      for (int i = 0; i < kRowsPerWarp; ++i)
        if (warp + i * kWarps < rows)
          cp_async4(dst + i * kWarps * kPitch,
                    reinterpret_cast<const float*>(src) + i * kWarps * N);
      if (warp == 0) cp_async4(codes_s + (s & 1) * kCols + lane, scodes + j);
      cp_async_commit();
    } else {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        held[i] = warp + i * kWarps < rows ? __ldg(src + i * kWarps * N) : uint16_t(0);
      if (warp == 0) held_code = __ldg(scodes + j);
    }
  };
  auto land = [&](int s) {  // bfloat16 only: the registers of stage s into its tile
    if constexpr (sizeof(T) == 2) {
      if (j_begin + s * kCols + lane >= j_end) return;
      float* dst = smem + (s & 1) * kTileWords + warp * kPitch + lane;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) dst[i * kWarps * kPitch] = widen(held[i]);
      if (warp == 0) codes_s[(s & 1) * kCols + lane] = held_code;
    }
  };

  Acc acc = {0.0f, 0.0f, 0u, 0u, 0u};
  int cur = g_begin;  // the group whose sums acc holds
  if (nstages > 0) {
    fill(0);
    land(0);
  }
  for (int s = 0; s < nstages; ++s) {
    if constexpr (sizeof(T) == 4) cp_async_wait_all();  // this thread's copies of stage s
    // every thread's stage s is in its tile, and every thread is done with
    // stage s - 1, whose buffer the next fill takes
    __syncthreads();
    const bool ahead = s + 1 < nstages;
    if (ahead) fill(s + 1);
    const float* x = smem + (s & 1) * kTileWords + threadIdx.x * kPitch;
    const int* code = codes_s + (s & 1) * kCols;
    const int ncols = min(kCols, j_end - j_begin - s * kCols);
    // bit c of `starts`: column c begins another group than the column
    // before it (for c = 0, than cur). Every warp computes the same mask, so
    // the walk below goes run by run, block-uniformly, with no per-column test
    const int mine = lane < ncols ? code[lane] : 0;
    const int prev = lane == 0 ? cur : code[lane - 1];
    const unsigned starts = __ballot_sync(0xffffffffu, lane < ncols && mine != prev);
    int c = 0;
    while (c < ncols) {
      if ((starts >> c) & 1u) {
        const int g = code[c];
        if (row_ok) {
          out.put(cur, k, acc);
          const Acc zero = {0.0f, 0.0f, 0u, 0u, 0u};
          for (int e = cur + 1; e < g; ++e) out.put(e, k, zero);
        }
        acc = {0.0f, 0.0f, 0u, 0u, 0u};
        cur = g;
      }
      const unsigned later = c == kCols - 1 ? 0u : starts >> (c + 1);
      const int e = later ? min(c + __ffs(later), ncols) : ncols;  // the run's end
#pragma unroll 4
      for (; c < e; ++c) add<ACC>(acc, x[c]);
    }
    if (ahead) land(s + 1);
  }
  if (row_ok) {
    out.put(cur, k, acc);
    const Acc zero = {0.0f, 0.0f, 0u, 0u, 0u};
    for (int e = cur + 1; e < g_end; ++e) out.put(e, k, zero);
  }
}

template <typename T, int ACC>
cudaError_t launch(const void* data, const int* perm, const int* scodes, const int* offsets,
                   long long N, int size, long long blocks, int nseg, const Out& out,
                   cudaStream_t stream) {
  constexpr size_t smem = (2 * kTileWords + 2 * kCols) * sizeof(float);
  auto kernel = radixbin_kernel<T, ACC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // all of the SM's unified memory that can be shared: 3 blocks of 66 KB
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kRows, smem, stream>>>(
      static_cast<const T*>(data), perm, scodes, offsets, N, size, nseg, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_accum(int accum, const void* data, const int* perm, const int* scodes,
                         const int* offsets, long long N, int size, long long blocks, int nseg,
                         const Out& out, cudaStream_t st) {
  if (accum == 0) return launch<T, 0>(data, perm, scodes, offsets, N, size, blocks, nseg, out, st);
  if (accum == 1) return launch<T, 1>(data, perm, scodes, offsets, N, size, blocks, nseg, out, st);
  if (accum == 2) return launch<T, 2>(data, perm, scodes, offsets, N, size, blocks, nseg, out, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. accum: 0 plain, 1 kahan, 2 dd. perm, scodes
// (N,) and offsets (size + 1,) int32 are the binned codes (see above), so
// any int size fits them, and N stays below 2^31 - 32. Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue for a shape, dtype or accum it refuses.
int flox_segment_radixbin(const void* data, int dtype, const int* perm, const int* scodes,
                          const int* offsets, long long K, long long N, int size, int accum,
                          void* sums, void* nan_c, void* pos_c, void* neg_c, void* stream) {
  // perm and offsets index the columns in int32, a stage past the last one
  if (K <= 0 || N < 0 || N > 0x7fffffffLL - kCols || size <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nseg = static_cast<int>((size + (kGroups - 1LL)) / kGroups);
  const long long blocks = (K + kRows - 1) / kRows * nseg;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const Out out = {static_cast<float*>(sums), static_cast<float*>(nan_c),
                   static_cast<float*>(pos_c), static_cast<float*>(neg_c), K};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = launch_accum<float>(accum, data, perm, scodes, offsets, N, size, blocks, nseg, out, st);
  if (dtype == 1)
    err = launch_accum<uint16_t>(accum, data, perm, scodes, offsets, N, size, blocks, nseg, out,
                                 st);
  return static_cast<int>(err);
}

const char* flox_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
