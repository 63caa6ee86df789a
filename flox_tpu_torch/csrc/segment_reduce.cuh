// The grouped sum-and-markers reduction shared by segment_sum.cu (B1),
// segment_multistat.cu (B2) and segment_radixbin.cu (B5), for Hopper
// (sm_90a).
//
// One template, segment_reduce_kernel<T, ACC, MINMAX, RADIX>, computes per
// (group, row) of data (K, N) by codes (N,):
//
//   sums, nan_c, pos_c, neg_c  float32: the sum of the finite values (non-
//         finite values are zero-filled and counted, never added) and the
//         counts of NaN, +inf and -inf;
//   mins, maxs (MINMAX only)   in the data dtype: the NaN-skipping min and
//         max. NaN is parked at the op's identity, so a group whose values
//         are all NaN, or an empty group, comes out at +inf (min) / -inf
//         (max); callers re-inject NaN from nan_c where they propagate it.
//
// Both kernels are instances of the same code, so B2's sums and markers are
// bit-identical to B1's on the same input and accumulation: the min/max legs
// only add work beside the sum path, in the same walk over the chunk.
//
// Accumulation along N, per (group, row), under ACC:
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
// a fixed butterfly (xor-shuffle) tree sums their values into every lane (and,
// with MINMAX, takes their min and max the same way); popcounts of ballots
// give the marker counts. Lane 0 alone then folds the chunk's partials into
// the warp's per-group accumulators in shared memory, under the chosen
// discipline. Every step has a fixed order given the input, and there are no
// atomics, so two launches give bit-identical outputs. All float arithmetic
// in the discipline uses the _rn intrinsics, which nvcc never contracts into
// FMAs: a contracted Dekker split or two_sum would lose the error terms.
//
// Shared memory per warp: 5 words per group (hi, lo, three counts), 7 with
// MINMAX (min, max). At 128 groups x 8 warps x 7 words that is 28.7 KB.
//
// RADIX (B5) splits the group axis into kGroupBlock-wide blocks: the block at
// blockIdx.y owns groups [kGroupBlock * y, kGroupBlock * y + kGroupBlock), and
// a lane whose code falls outside them counts as invalid, as an out-of-range
// code does. Per group the walk over N, the butterflies and the lane-0
// update are the ones above, so B5 at size <= kGroupBlock is B1 bit for bit,
// and B5's block y is B1 run on the codes shifted by -kGroupBlock * y with
// the other codes dropped. Two things differ, neither touching a value:
//   - the skip rule: a warp loads its codes of a 32 * kUnroll-column step
//     first and loads the data only if one of them falls in its block (one
//     vote). A skipped step would have changed no accumulator. For sorted
//     codes each block then reads only the columns of its own groups, so a
//     launch reads the data about once; for unsorted codes every block reads
//     every column, kGroupBlock-th of the groups at a time;
//   - the output: (size, K) is written by the whole block, 8 consecutive rows
//     of one group per 32-byte sector, instead of one lane per group and row.
//     At 512 groups x 8 rows x 5 words the accumulators take 80 KB.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace flox {

constexpr int kWarps = 8;   // rows per block
constexpr int kUnroll = 4;  // 32-column chunks loaded before any is reduced
constexpr int kGroupBlock = 512;  // groups per block: B1's cap, B5's block width
constexpr long long kMaxGroupBlocks = 65535;  // gridDim.y limit
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_value(const float* p) { return __ldcs(p); }

__device__ __forceinline__ float load_value(const uint16_t* p) {
  // bfloat16 is the top half of a float32: widening is exact
  return __uint_as_float(static_cast<unsigned>(__ldcs(p)) << 16);
}

__device__ __forceinline__ void store_value(float* p, float v) { *p = v; }

__device__ __forceinline__ void store_value(uint16_t* p, float v) {
  // exact: every value stored through here is a bf16 input or +-inf
  *p = static_cast<uint16_t>(__float_as_uint(v) >> 16);
}

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

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

// The same butterfly, with the same fminf / fmaxf, as segment_minmax.cu: the
// values here hold no NaN, so B2's extrema equal B3's on NaN-parked data.
__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, s));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, s));
  return v;
}

template <int ACC, bool MINMAX>
__device__ __forceinline__ void reduce_chunk(float x, int code, int size, int stride, int lane,
                                             float* hi, float* lo, unsigned* cnt, float* mn,
                                             float* mx) {
  const bool valid = static_cast<unsigned>(code) < static_cast<unsigned>(size);
  const bool is_nan = isnan(x);
  const bool is_pos = x == pos_inf();
  const bool is_neg = x == neg_inf();
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
    float g_min = 0.0f, g_max = 0.0f;
    if (MINMAX) {
      // NaN parked at each op's identity: the skipna extrema
      g_min = warp_min(mine && !is_nan ? x : pos_inf());
      g_max = warp_max(mine && !is_nan ? x : neg_inf());
    }
    if (lane == 0) {
      cnt[g] += __popc(nan_b & peers);
      cnt[stride + g] += __popc(pos_b & peers);
      cnt[2 * stride + g] += __popc(neg_b & peers);
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
      if (MINMAX) {
        mn[g] = fminf(mn[g], g_min);
        mx[g] = fmaxf(mx[g], g_max);
      }
    }
    todo &= ~peers;
  }
}

template <bool MINMAX>
__host__ __device__ constexpr int acc_words() {
  return MINMAX ? 7 : 5;  // hi, lo, nan, pos, neg [, min, max]
}

template <typename T, int ACC, bool MINMAX, bool RADIX>
__global__ void __launch_bounds__(kWarps * 32)
segment_reduce_kernel(const T* __restrict__ data, const int* __restrict__ codes, long long K,
                      long long N, int size, float* __restrict__ sums,
                      float* __restrict__ nan_c, float* __restrict__ pos_c,
                      float* __restrict__ neg_c, T* __restrict__ mins, T* __restrict__ maxs) {
  static_assert(!(MINMAX && RADIX), "the group-block write carries no extrema");
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long k = static_cast<long long>(blockIdx.x) * kWarps + warp;
  // the groups of this block: all of them, or (RADIX) one kGroupBlock slice
  const int stride = size < kGroupBlock ? size : kGroupBlock;  // words per field per warp
  const int g0 = RADIX ? static_cast<int>(blockIdx.y) * kGroupBlock : 0;
  const int gsize = RADIX ? min(kGroupBlock, size - g0) : size;
  if (!RADIX && k >= K) return;  // whole warp; no block-wide barrier follows

  float* hi = smem + static_cast<size_t>(warp) * stride * acc_words<MINMAX>();
  float* lo = hi + stride;
  unsigned* cnt = reinterpret_cast<unsigned*>(lo + stride);  // nan | pos | neg
  float* mn = lo + 4 * stride;  // MINMAX only
  float* mx = lo + 5 * stride;
  for (int g = lane; g < gsize; g += 32) {
    hi[g] = 0.0f;
    lo[g] = 0.0f;
    cnt[g] = cnt[stride + g] = cnt[2 * stride + g] = 0u;
    if (MINMAX) {
      mn[g] = pos_inf();
      mx[g] = neg_inf();
    }
  }
  __syncwarp();

  if (k < K) {  // warp-uniform
    const T* row = data + k * N;  // 64-bit offset: K*N exceeds 2^31 at full width
    for (long long c0 = 0; c0 < N; c0 += 32 * kUnroll) {
      float x[kUnroll];
      int code[kUnroll];
      if (RADIX) {
        // codes first: the data of a step with no code in this block is not read
        bool any = false;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long c = c0 + u * 32 + lane;
          // block-local code; unsigned arithmetic, so a code below the block
          // wraps past gsize and drops out like a negative one
          code[u] = c < N ? static_cast<int>(static_cast<unsigned>(__ldg(codes + c)) -
                                             static_cast<unsigned>(g0))
                          : -1;
          any |= static_cast<unsigned>(code[u]) < static_cast<unsigned>(gsize);
        }
        if (!__any_sync(kFull, any)) continue;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long c = c0 + u * 32 + lane;
          x[u] = c < N ? load_value(row + c) : 0.0f;
        }
      } else {
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
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        reduce_chunk<ACC, MINMAX>(x[u], code[u], gsize, stride, lane, hi, lo, cnt, mn, mx);
    }
  }

  if (RADIX) {
    // every warp's accumulators, visible to the whole block; then thread t
    // writes row k0 + t % 8 of group t / 8, so 8 lanes fill one 32-byte
    // sector of the (size, K) output
    __syncthreads();
    const long long k0 = static_cast<long long>(blockIdx.x) * kWarps;
    for (int t = threadIdx.x; t < gsize * kWarps; t += kWarps * 32) {
      const int g = t / kWarps;
      const int w = t % kWarps;
      if (k0 + w >= K) continue;
      const float* whi = smem + static_cast<size_t>(w) * stride * acc_words<MINMAX>();
      const unsigned* wcnt = reinterpret_cast<const unsigned*>(whi + 2 * stride);
      const long long o = static_cast<long long>(g0 + g) * K + k0 + w;
      sums[o] = whi[g];
      nan_c[o] = static_cast<float>(wcnt[g]);
      pos_c[o] = static_cast<float>(wcnt[stride + g]);
      neg_c[o] = static_cast<float>(wcnt[2 * stride + g]);
    }
    return;
  }
  __syncwarp();  // lane 0's accumulator writes, visible to the whole warp

  for (int g = lane; g < size; g += 32) {
    const long long o = static_cast<long long>(g) * K + k;
    sums[o] = hi[g];
    nan_c[o] = static_cast<float>(cnt[g]);
    pos_c[o] = static_cast<float>(cnt[stride + g]);
    neg_c[o] = static_cast<float>(cnt[2 * stride + g]);
    if (MINMAX) {
      store_value(mins + o, mn[g]);
      store_value(maxs + o, mx[g]);
    }
  }
}

template <typename T, int ACC, bool MINMAX, bool RADIX>
cudaError_t launch_segment_reduce(const void* data, const int* codes, long long K, long long N,
                                  int size, float* sums, float* nan_c, float* pos_c,
                                  float* neg_c, void* mins, void* maxs, cudaStream_t stream) {
  const int stride = size < kGroupBlock ? size : kGroupBlock;
  const size_t smem = static_cast<size_t>(kWarps) * stride * acc_words<MINMAX>() * sizeof(float);
  auto kernel = segment_reduce_kernel<T, ACC, MINMAX, RADIX>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (K + kWarps - 1) / kWarps;
  const long long gblocks = RADIX ? (size + kGroupBlock - 1) / kGroupBlock : 1;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(gblocks));
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(data), codes, K, N, size, sums, nan_c, pos_c, neg_c,
      static_cast<T*>(mins), static_cast<T*>(maxs));
  return cudaGetLastError();
}

// The C entry points' dispatch over dtype (0 float32, 1 bfloat16) and accum
// (0 plain, 1 kahan, 2 dd). B1 and B2 take at most kGroupBlock groups, B5
// (RADIX) at most kGroupBlock * kMaxGroupBlocks. Returns the cudaError_t of
// the launch; cudaErrorInvalidValue for a shape, dtype or accum it refuses.
template <bool MINMAX, bool RADIX>
int dispatch_segment_reduce(const void* data, int dtype, const int* codes, long long K,
                            long long N, int size, int accum, void* sums, void* nan_c,
                            void* pos_c, void* neg_c, void* mins, void* maxs, void* stream) {
  const long long max_size = RADIX ? kGroupBlock * kMaxGroupBlocks : kGroupBlock;
  if (K <= 0 || N < 0 || size <= 0 || size > max_size || K > 0x7fffffffLL * kWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  float* s = static_cast<float*>(sums);
  float* a = static_cast<float*>(nan_c);
  float* p = static_cast<float*>(pos_c);
  float* m = static_cast<float*>(neg_c);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    if (accum == 0)
      err = launch_segment_reduce<float, 0, MINMAX, RADIX>(data, codes, K, N, size, s, a, p, m,
                                                           mins, maxs, st);
    if (accum == 1)
      err = launch_segment_reduce<float, 1, MINMAX, RADIX>(data, codes, K, N, size, s, a, p, m,
                                                           mins, maxs, st);
    if (accum == 2)
      err = launch_segment_reduce<float, 2, MINMAX, RADIX>(data, codes, K, N, size, s, a, p, m,
                                                           mins, maxs, st);
  } else if (dtype == 1) {
    if (accum == 0)
      err = launch_segment_reduce<uint16_t, 0, MINMAX, RADIX>(data, codes, K, N, size, s, a, p,
                                                              m, mins, maxs, st);
    if (accum == 1)
      err = launch_segment_reduce<uint16_t, 1, MINMAX, RADIX>(data, codes, K, N, size, s, a, p,
                                                              m, mins, maxs, st);
    if (accum == 2)
      err = launch_segment_reduce<uint16_t, 2, MINMAX, RADIX>(data, codes, K, N, size, s, a, p,
                                                              m, mins, maxs, st);
  }
  return static_cast<int>(err);
}

}  // namespace flox
