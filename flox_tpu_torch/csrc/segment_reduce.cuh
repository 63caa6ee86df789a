// The grouped reduction shared by segment_sum.cu (B1), segment_multistat.cu
// (B2) and segment_minmax.cu (B3), for Hopper (sm_90a).
//
// One kernel template, segment_reduce_kernel<T, Legs>, walks data (K, N) by
// codes (N,) and keeps one accumulator per (group, row). What it accumulates
// and writes are its legs:
//
//   SumLegs<T, ACC, MINMAX> (B1; B2 with MINMAX)
//     sums, nan_c, pos_c, neg_c  float32: the sum of the finite values (non-
//         finite values are zero-filled and counted, never added) and the
//         counts of NaN, +inf and -inf;
//     mins, maxs (MINMAX only)   in the data dtype: the NaN-skipping min and
//         max. NaN is parked at each op's identity, so a group whose values
//         are all NaN, or an empty group, comes out at +inf (min) / -inf
//         (max); callers re-inject NaN from nan_c where they propagate it.
//   ExtremumLegs<T, W, MAX> (B3)
//     out  in the data dtype: the min or the max (MAX), in the working type
//         W (float for float32 and bfloat16, int for int32). An empty group
//         comes out at the op's identity (+-inf, INT32_MAX / INT32_MIN); a
//         NaN that arrives propagates to its group (an explicit isnan test:
//         once the extremum is NaN it stays so).
//
// Accumulation of the sums along N, per (group, row), under ACC:
//   0 plain  an f32 running sum
//   1 kahan  compensated (Kahan) summation
//   2 dd     a double-double (hi, lo) f32 pair: each addend is Dekker-split
//            by 4097 (values above 8e34 stay whole) and merged with Knuth
//            two_sum
//
// The codes reach the kernel binned (cuda_kernels._radixbin_bins, device ops
// over the N codes only, no host sync): perm, the columns in stable order of
// a key (invalid codes last); scodes, the codes in that order; offsets
// (size + 1,). For the run walk (below) the key is the code, and offsets[g]
// counts the valid columns whose code is below g, so group g owns columns
// perm[offsets[g] : offsets[g + 1]]. For the window walk of W groups the
// key is the first group of the code's window (the code rounded down to a
// multiple of W; invalid codes past the last window), and offsets[g] counts
// the valid columns of the windows that start below g, so the window over
// [g0, g0 + W) owns perm[offsets[g0] : offsets[min(g0 + W, size)]]. Either
// way one group's (one window's) columns lie in their original order. For
// sorted codes perm is the identity; on the month codes it joins each
// month's runs (three of ~730 hourly columns a month over 26304 hours), so a
// stage's 32 columns stay a 128-byte row segment but where a run ends.
//
// Design. Block b owns a tile of kRows = 256 rows, one thread per row, and a
// segment of `groups` whole consecutive groups; the segment index is the
// fastest (b % nseg), so the segments of one row tile run together and share
// its rows in L2. The block streams its segment's columns, perm[offsets[g0] :
// offsets[g0 + groups]], in stages of kCols = 32: each stage is a (kRows,
// kCols + 1) tile of 32-bit words in shared memory, the pitch of 33 words
// making thread r's reads of column c conflict-free, filled by cp.async
// gathers data[k0 + r, perm[j]] (warps fill along the row, lane = column),
// with the stage's codes beside it. Stage s + 1 is in flight while stage s is
// walked (bfloat16, below cp.async's 4-byte minimum, is loaded into registers
// a stage ahead and stored widened to its tile after the walk; int32 takes
// the float32 fill). Every (group, row) output is written exactly once,
// nothing is atomic, and every thread walks the same columns, so all
// branching is block-uniform but for the rare non-finite value. The walk
// takes one of two forms, fixed at compile time by the window width WIN:
//
//   Run walk (WIN = 1; B1, B2 and B3). The segment's columns come in code
//   order. Thread r walks the stage's columns in order with one group's
//   accumulator in registers, run by run: one ballot per stage marks the
//   columns where the code changes. At a change it writes the finished
//   group's outputs at out[g * K + k] (a warp writes 32 consecutive k) and
//   the empty-group values (the legs' empty accumulator) for any group it
//   passes; at the segment's end it writes every group left.
//
//   Window walk (WIN = kWindow = 8; B1 only). The segment is a window of 8
//   consecutive groups, and its columns come in column order: the bins were
//   made by window. Thread r keeps the 8 groups' accumulators in
//   registers, indexed only by compile-time constants. Per stage and group
//   w, one ballot of code == g0 + w marks that group's columns, and the
//   thread adds them to acc[w] in ascending column order. At the window's
//   end it writes all 8 groups' outputs; a group with no columns writes the
//   empty accumulator. Where neighbouring groups are neighbouring columns
//   (day-of-year codes over daily data: a window is 8 consecutive days of
//   every year), a stage's 32 lanes read 4 runs of 8 contiguous words, so
//   each 32-byte sector of a row is read by one block instead of one block
//   a group, and a block walks ~8 times the columns.
//
// Groups per block, and the window. The wrapper derives both from size, K
// and N (cuda_kernels._window, cuda_kernels._groups_per_block); neither is an
// option. B1 takes the window walk when the groups average fewer than four
// 32-column stages (N < 128 * size): then a run walk's block reads a few
// columns lying a row's period apart, a word of each 32-byte sector whose
// other words belong to other blocks, and those blocks are too short to
// keep their cp.async pipeline full. Otherwise, and always for B2 and B3,
// the run walk: one group per block, so that the size blocks of a row tile
// (the segment index is the fastest) walk its rows together and share them
// in L2; unless the groups average less than one 32-column stage each,
// where a block's set-up would outweigh its walk: then the fewest groups
// that average a stage, but never so many that the grid holds fewer blocks
// than the card's resident slots (the __launch_bounds__ below: 3 blocks of
// 4-byte data or 2 bfloat16 ones per SM, times the SM count). Measured on
// the H100 (PERF.md): at the main path's 12 month groups and K = 65160 one
// group per block gives 3060 blocks, faster than the 765 blocks of 4
// groups; on OISST's 366 day-of-year groups over 14532 days the window walk
// is faster than one group per block. Every split reads the data once: a
// segment reads only its own groups' columns.
//
// Invariants (checked on the card by chip_smoke.py):
//   - per (group, row), the sum is sequential over the group's columns in
//     column order, under the discipline applied per element exactly as in
//     segment_radixbin.cu (zero-fill and count the non-finite values; plain
//     __fadd_rn; kahan's _rn compensated update; dd's Dekker split by 4097
//     with the 8e34 guard, then two_sum merges). Everything goes through _rn
//     intrinsics, so nvcc contracts nothing into FMAs. The result does not
//     depend on where other groups' columns lie, nor on the groups per
//     block, nor on the walk: the window walk adds each group's columns in
//     the same order, so its four legs equal the run walk's bit for bit;
//   - hence B1 equals the radix-binning kernel (B5) bit for bit on the same
//     data, codes and accum at any size <= 512: both walk the same order
//     under the same discipline;
//   - B2's sums and markers equal B1's bit for bit: the min/max legs only
//     add fminf / fmaxf in registers beside the sum;
//   - B2's extrema equal B3's bit for bit on NaN-parked data: both fold
//     fminf / fmaxf over the same columns in the same order, and
//     fminf(m, NaN) = m where B3 sees the op's identity instead;
//   - B3 equals its plain version (scatter_reduce amin / amax) exactly: min
//     and max are exact in any order;
//   - two launches give the same bits.
//
// Bound on the card: one read of the data, K*N*itemsize bytes (plus the
// binned codes, 3*N*4, and the outputs: 4*size*K*4 for B1, 2*size*K*itemsize
// more for B2, size*K*itemsize for B3). At the benchmark width, 65160 x
// 26304 float32 = 6.86 GB, that is at least 2.05 ms at the H100's 3.35 TB/s
// (computed, not measured). The work per element is a shared-memory load and
// the legs' update: a finiteness test and the discipline's adds (two more
// ops with MINMAX) for the sums, a NaN test and an fminf / fmaxf for B3.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace flox {

constexpr int kRows = 256;  // rows per block, one thread each
constexpr int kWarps = kRows / 32;
constexpr int kCols = 32;  // columns per stage: one per lane when filling
constexpr int kPitch = kCols + 1;
constexpr int kTileWords = kRows * kPitch;
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kGroupCap = 512;  // the groups B1-B3 take (cuda_kernels._MAX_GROUPS)
constexpr int kWindow = 8;  // groups of the window walk (cuda_kernels._WINDOW)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float widen(uint16_t v) {
  // bfloat16 is the top half of a float32: widening is exact
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ void store_value(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_value(int* p, int v) { *p = v; }

__device__ __forceinline__ void store_value(uint16_t* p, float v) {
  // exact: every value stored through here is a bf16 input (NaN included)
  // or +-inf
  *p = static_cast<uint16_t>(__float_as_uint(v) >> 16);
}

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& err) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  err = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// B1 and B2: sums, non-finite counts and (MINMAX) the NaN-skipping extrema.
template <typename T, int ACC, bool MINMAX>
struct SumLegs {
  using W = float;  // the working type a tile word is read as
  struct Acc {      // one (group, row)'s accumulators; mn and mx only live with MINMAX
    float hi, lo;
    unsigned nan, pos, neg;
    float mn, mx;
  };

  float *sums, *nan_c, *pos_c, *neg_c;
  T *mins, *maxs;  // MINMAX only
  long long K;

  __device__ __forceinline__ static Acc empty() {
    return {0.0f, 0.0f, 0u, 0u, 0u, pos_inf(), neg_inf()};
  }

  __device__ __forceinline__ static void add(Acc& a, float x) {
    if (MINMAX) {
      // fminf / fmaxf return the other operand for a NaN: NaN parked at the
      // op's identity
      a.mn = fminf(a.mn, x);
      a.mx = fmaxf(a.mx, x);
    }
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

  __device__ __forceinline__ void put(int g, long long k, const Acc& a) const {
    const long long o = static_cast<long long>(g) * K + k;
    sums[o] = a.hi;
    nan_c[o] = static_cast<float>(a.nan);
    pos_c[o] = static_cast<float>(a.pos);
    neg_c[o] = static_cast<float>(a.neg);
    if (MINMAX) {
      store_value(mins + o, a.mn);
      store_value(maxs + o, a.mx);
    }
  }
};

// B3: the min or the max alone, NaN propagating, in the working type W
// (float for float32 and bfloat16, int for int32).
template <typename T, typename V, bool MAX>
struct ExtremumLegs {
  using W = V;
  using Acc = V;

  T* out;
  long long K;

  __device__ __forceinline__ static W empty() {
    if constexpr (std::is_integral_v<W>) {
      return MAX ? INT32_MIN : INT32_MAX;
    } else {
      return MAX ? neg_inf() : pos_inf();
    }
  }

  __device__ __forceinline__ static void add(W& a, W x) {
    if constexpr (std::is_integral_v<W>) {
      a = MAX ? max(a, x) : min(a, x);
    } else if (!isnan(a)) {
      // fminf / fmaxf, as B2's legs, so that the two agree bit for bit on
      // NaN-parked data; the NaN test keeps a NaN that arrives
      a = isnan(x) ? x : (MAX ? fmaxf(a, x) : fminf(a, x));
    }
  }

  __device__ __forceinline__ void put(int g, long long k, W a) const {
    store_value(out + static_cast<long long>(g) * K + k, a);
  }
};

template <typename T, typename Legs, int WIN>
// resident blocks per SM: 3 blocks of 4-byte data (3 x 67.8 KB of tiles), 2
// bfloat16 ones (their register loads a stage ahead need more registers);
// cuda_kernels._BLOCKS_PER_SM mirrors it. WIN: 1 for the run walk, kWindow
// for the window walk (see above)
__global__ void __launch_bounds__(kRows, sizeof(T) == 4 ? 3 : 2)
segment_reduce_kernel(const T* __restrict__ data, const int* __restrict__ perm,
                      const int* __restrict__ scodes, const int* __restrict__ offsets, long long N,
                      int size, int groups, int nseg, Legs legs) {
  using W = typename Legs::W;
  using Acc = typename Legs::Acc;
  extern __shared__ float smem[];  // 2 tiles of kRows x kPitch, then 2 x kCols codes
  int* codes_s = reinterpret_cast<int*>(smem + 2 * kTileWords);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int seg = static_cast<int>(blockIdx.x % nseg);
  const long long k0 = static_cast<long long>(blockIdx.x / nseg) * kRows;
  const long long K = legs.K;
  const int rows = static_cast<int>(K - k0 < kRows ? K - k0 : kRows);  // rows of this tile
  const long long k = k0 + threadIdx.x;
  const bool row_ok = threadIdx.x < rows;
  const int g_begin = seg * groups;  // < size
  const int g_end = size - g_begin < groups ? size : g_begin + groups;
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
        if (warp + i * kWarps < rows) cp_async4(dst + i * kWarps * kPitch, src + i * kWarps * N);
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
  if (nstages > 0) {
    fill(0);
    land(0);
  }
  if constexpr (WIN == 1) {
    // the outputs of group `from`, then the empty-group values of the groups
    // in (from, to)
    auto finish = [&](int from, int to, const Acc& a) {
      if (!row_ok) return;
      legs.put(from, k, a);
      for (int e = from + 1; e < to; ++e) legs.put(e, k, Legs::empty());
    };
    Acc acc = Legs::empty();
    int cur = g_begin;  // the group whose accumulators acc holds
    for (int s = 0; s < nstages; ++s) {
      if constexpr (sizeof(T) == 4) cp_async_wait_all();  // this thread's copies of stage s
      // every thread's stage s is in its tile, and every thread is done with
      // stage s - 1, whose buffer the next fill takes
      __syncthreads();
      const bool ahead = s + 1 < nstages;
      if (ahead) fill(s + 1);
      const W* x = reinterpret_cast<const W*>(smem + (s & 1) * kTileWords + threadIdx.x * kPitch);
      const int* code = codes_s + (s & 1) * kCols;
      const int ncols = min(kCols, j_end - j_begin - s * kCols);
      // bit c of `starts`: column c begins another group than the column
      // before it (for c = 0, than cur). Every warp computes the same mask,
      // so the walk below goes run by run, block-uniformly, with no
      // per-column test
      const int mine = lane < ncols ? code[lane] : 0;
      const int prev = lane == 0 ? cur : code[lane - 1];
      const unsigned starts = __ballot_sync(kFull, lane < ncols && mine != prev);
      int c = 0;
      while (c < ncols) {
        if ((starts >> c) & 1u) {
          const int g = code[c];
          finish(cur, g, acc);
          acc = Legs::empty();
          cur = g;
        }
        const unsigned later = c == kCols - 1 ? 0u : starts >> (c + 1);
        const int e = later ? min(c + __ffs(later), ncols) : ncols;  // the run's end
#pragma unroll 4
        for (; c < e; ++c) Legs::add(acc, x[c]);
      }
      if (ahead) land(s + 1);
    }
    finish(cur, g_end, acc);
  } else {
    Acc acc[WIN];  // acc[w]: group g_begin + w
#pragma unroll
    for (int w = 0; w < WIN; ++w) acc[w] = Legs::empty();
    for (int s = 0; s < nstages; ++s) {
      if constexpr (sizeof(T) == 4) cp_async_wait_all();
      __syncthreads();  // as in the run walk
      const bool ahead = s + 1 < nstages;
      if (ahead) fill(s + 1);
      const W* x = reinterpret_cast<const W*>(smem + (s & 1) * kTileWords + threadIdx.x * kPitch);
      const int ncols = min(kCols, j_end - j_begin - s * kCols);
      const int mine = lane < ncols ? codes_s[(s & 1) * kCols + lane] - g_begin : -1;
#pragma unroll
      for (int w = 0; w < WIN; ++w) {
        // group w's columns of the stage, added in ascending column order;
        // every warp computes the same mask
        for (unsigned m = __ballot_sync(kFull, mine == w); m; m &= m - 1)
          Legs::add(acc[w], x[__ffs(m) - 1]);
      }
      if (ahead) land(s + 1);
    }
    if (row_ok) {
#pragma unroll
      for (int w = 0; w < WIN; ++w)
        if (g_begin + w < g_end) legs.put(g_begin + w, k, acc[w]);
    }
  }
}

template <typename T, int WIN, typename Legs>
cudaError_t launch(const void* data, const int* perm, const int* scodes, const int* offsets,
                   long long N, int size, int groups, int nseg, long long blocks,
                   const Legs& legs, cudaStream_t stream) {
  constexpr size_t smem = (2 * kTileWords + 2 * kCols) * sizeof(float);
  auto kernel = segment_reduce_kernel<T, Legs, WIN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // all of the SM's unified memory that can be shared: 3 blocks of 68 KB
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kRows, smem, stream>>>(
      static_cast<const T*>(data), perm, scodes, offsets, N, size, groups, nseg, legs);
  return cudaGetLastError();
}

// The grid of a launch: nseg segments of `groups` groups per row tile, and
// the blocks. perm and offsets index the columns in int32, a stage past the
// last one, so N stays below 2^31 - 32; at most kGroupCap groups. False for
// a shape the kernel refuses.
inline bool grid(long long K, long long N, int size, int groups, int& nseg, long long& blocks) {
  if (K <= 0 || N < 0 || N > 0x7fffffffLL - kCols || size <= 0 || size > kGroupCap ||
      groups <= 0 || groups > size)
    return false;
  nseg = (size + groups - 1) / groups;
  blocks = (K + kRows - 1) / kRows * nseg;
  return blocks <= 0x7fffffffLL;
}

template <typename T, bool MINMAX>
cudaError_t launch_accum(int accum, int window, const void* data, const int* perm,
                         const int* scodes, const int* offsets, long long N, int size,
                         int groups, int nseg, long long blocks, float* const outs[4],
                         void* mins, void* maxs, long long K, cudaStream_t st) {
  auto run = [&](auto legs) {
    if constexpr (!MINMAX) {
      if (window == kWindow)
        return launch<T, kWindow>(data, perm, scodes, offsets, N, size, groups, nseg, blocks,
                                  legs, st);
    }
    return launch<T, 1>(data, perm, scodes, offsets, N, size, groups, nseg, blocks, legs, st);
  };
  T* mn = static_cast<T*>(mins);
  T* mx = static_cast<T*>(maxs);
  if (accum == 0)
    return run(SumLegs<T, 0, MINMAX>{outs[0], outs[1], outs[2], outs[3], mn, mx, K});
  if (accum == 1)
    return run(SumLegs<T, 1, MINMAX>{outs[0], outs[1], outs[2], outs[3], mn, mx, K});
  if (accum == 2)
    return run(SumLegs<T, 2, MINMAX>{outs[0], outs[1], outs[2], outs[3], mn, mx, K});
  return cudaErrorInvalidValue;
}

// B1's and B2's C entry points: dispatch over dtype (0 float32, 1 bfloat16)
// and accum (0 plain, 1 kahan, 2 dd) on the binned codes (see above),
// `groups` groups per block; `window` 1 for the run walk, or kWindow (B1
// only, with groups = min(kWindow, size), on bins made by window) for the
// window walk. Returns the cudaError_t of the launch; cudaErrorInvalidValue
// for a shape, dtype, accum or window it refuses.
template <bool MINMAX>
int dispatch_segment_reduce(const void* data, int dtype, const int* perm, const int* scodes,
                            const int* offsets, long long K, long long N, int size, int groups,
                            int window, int accum, void* sums, void* nan_c, void* pos_c,
                            void* neg_c, void* mins, void* maxs, void* stream) {
  int nseg;
  long long blocks;
  if (!grid(K, N, size, groups, nseg, blocks)) return static_cast<int>(cudaErrorInvalidValue);
  if (window != 1 && (MINMAX || window != kWindow || groups != min(kWindow, size)))
    return static_cast<int>(cudaErrorInvalidValue);
  float* const outs[4] = {static_cast<float*>(sums), static_cast<float*>(nan_c),
                          static_cast<float*>(pos_c), static_cast<float*>(neg_c)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = launch_accum<float, MINMAX>(accum, window, data, perm, scodes, offsets, N, size, groups,
                                      nseg, blocks, outs, mins, maxs, K, st);
  else if (dtype == 1)
    err = launch_accum<uint16_t, MINMAX>(accum, window, data, perm, scodes, offsets, N, size,
                                         groups, nseg, blocks, outs, mins, maxs, K, st);
  return static_cast<int>(err);
}

// B3's C entry point for one op (MAX: max, else min): dispatch over dtype (0
// float32, 1 bfloat16, 2 int32), as above.
template <bool MAX>
int dispatch_segment_extremum(const void* data, int dtype, const int* perm, const int* scodes,
                              const int* offsets, long long K, long long N, int size, int groups,
                              void* out, void* stream) {
  int nseg;
  long long blocks;
  if (!grid(K, N, size, groups, nseg, blocks)) return static_cast<int>(cudaErrorInvalidValue);
  auto run = [&](auto legs) {
    using T = std::remove_pointer_t<decltype(legs.out)>;
    return launch<T, 1>(data, perm, scodes, offsets, N, size, groups, nseg, blocks, legs,
                        static_cast<cudaStream_t>(stream));
  };
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = run(ExtremumLegs<float, float, MAX>{static_cast<float*>(out), K});
  else if (dtype == 1)
    err = run(ExtremumLegs<uint16_t, float, MAX>{static_cast<uint16_t*>(out), K});
  else if (dtype == 2)
    err = run(ExtremumLegs<int, int, MAX>{static_cast<int*>(out), K});
  return static_cast<int>(err);
}

}  // namespace flox
