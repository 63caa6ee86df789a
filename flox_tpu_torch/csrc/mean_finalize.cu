// Mean finalize for Hopper (sm_90a): the skipna grouped mean, finished from
// the raw legs of the segment-sum kernels in one pass.
//
// Replaces no Pallas kernel. flox_tpu leaves this step to XLA, which fuses
// the reference's reapply_nonfinite, count, divide and fill into the kernel
// that consumes them. Eager PyTorch ran it as a dozen elementwise passes over
// (K, size) arrays, one operand of each read across the grain and a
// 1.5-2.3 GB temporary for each, 10-15 times this kernel's bound at the
// benchmark's day and day-of-year shapes (PERF.md). This kernel does the
// same arithmetic in one read of the legs and one write of the result:
//
//   sums, nan_c, pos_c, neg_c  (size, K) float32, contiguous: the four legs
//         of segment_sum.cu (B1) or segment_radixbin.cu (B5) as they write
//         them, per (group, row) the sum of the finite values and the counts
//         of NaN, +inf and -inf
//   rowcount  (size,) int32: the columns of each group
//   fill  float32: the result of a group with no value that is not NaN
//   out   (K, size) row-major, float32 or bfloat16: the caller's layout
//
// Per (group g, row k), in IEEE round-to-nearest with explicit intrinsics (no
// fast math), the bits of kernels._mean_impl's torch composition
// (cuda_kernels.mean_finalize_plain):
//
//   cnt = float(rowcount[g]) - nan_c          the values that are not NaN
//   s   = sums; +inf where pos_c > 0, -inf where neg_c > 0, NaN where both
//   out = cnt > 0 ? s / cnt : fill            rounded once to bfloat16 there
//
// Design: a 32 x 32 tile of (group, row) per block pass, 32 x 8 threads, each
// thread four (group, row) pairs. Lanes run along K, so each warp reads 128
// contiguous bytes of each leg (all sixteen loads of a thread issued before
// any use, streaming past L1); the means go to a shared tile of pitch 33, so
// that the transposed read is free of bank conflicts; lanes then run along
// size, so each warp writes consecutive words of an output row. The group
// tile is the fastest index of the block: neighbouring blocks write
// neighbouring stretches of the same 32 output rows. Nothing is read twice;
// nothing is written twice.
//
// Bound on the card: 4 * size * K * 4 bytes read and size * K * itemsize
// written (plus size * 4 of counts). At the daily cell's 1096 x 519840 that
// is 9.12 + 2.28 GB, 3.40 ms at the H100's 3.35 TB/s; at OISST's 366 x
// 1036800, 6.07 + 1.52 GB, 2.27 ms (computed, not measured). Memory-bound:
// a compare, a subtract and a divide per element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;                  // groups and rows of a tile
constexpr int kLanesY = 8;                 // threads along the tile's other side
constexpr int kPerThread = kTile / kLanesY;
constexpr int kPitch = kTile + 1;

struct Legs {
  const float* sums;
  const float* nan_c;
  const float* pos_c;
  const float* neg_c;
};

__device__ __forceinline__ float finish(float s, float nanc, float pos, float neg, float rows,
                                        float fill) {
  const float cnt = __fsub_rn(rows, nanc);
  if (pos > 0.0f) s = __int_as_float(0x7f800000);
  if (neg > 0.0f) s = __int_as_float(0xff800000);
  if (pos > 0.0f && neg > 0.0f) s = __int_as_float(0x7fc00000);
  const float m = __fdiv_rn(s, cnt);
  return cnt > 0.0f ? m : fill;
}

__device__ __forceinline__ void put(float* out, long long at, float v) { __stcs(out + at, v); }

__device__ __forceinline__ void put(uint16_t* out, long long at, float v) {
  out[at] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <typename O>
__global__ void __launch_bounds__(kTile * kLanesY)
    mean_finalize_kernel(Legs legs, const int* __restrict__ rowcount, long long K, long long size,
                         long long gtiles, long long tiles, float fill, O* __restrict__ out) {
  __shared__ float tile[kTile][kPitch];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long g0 = t % gtiles * kTile;
    const long long k0 = t / gtiles * kTile;
    const long long k = k0 + tx;
    float s[kPerThread], nanc[kPerThread], pos[kPerThread], neg[kPerThread];
    float rows[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const long long g = g0 + ty + i * kLanesY;
      if (g < size && k < K) {
        const long long at = g * K + k;
        s[i] = __ldcs(legs.sums + at);
        nanc[i] = __ldcs(legs.nan_c + at);
        pos[i] = __ldcs(legs.pos_c + at);
        neg[i] = __ldcs(legs.neg_c + at);
        rows[i] = __int2float_rn(__ldg(rowcount + g));
      }
    }
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int r = ty + i * kLanesY;
      if (g0 + r < size && k < K)
        tile[r][tx] = finish(s[i], nanc[i], pos[i], neg[i], rows[i], fill);
    }
    __syncthreads();
    const long long g = g0 + tx;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int r = ty + i * kLanesY;
      const long long kk = k0 + r;
      if (g < size && kk < K) put(out, kk * size + g, tile[tx][r]);
    }
    __syncthreads();  // the tile is refilled by the next pass
  }
}

template <typename O>
cudaError_t launch(const Legs& legs, const int* rowcount, long long K, long long size,
                   float fill, void* out, cudaStream_t stream) {
  const long long gtiles = (size + kTile - 1) / kTile;
  const long long tiles = gtiles * ((K + kTile - 1) / kTile);
  const long long blocks = tiles < 0x7fffffffLL ? tiles : 0x7fffffffLL;
  mean_finalize_kernel<O><<<static_cast<unsigned>(blocks), dim3(kTile, kLanesY), 0, stream>>>(
      legs, rowcount, K, size, gtiles, tiles, fill, static_cast<O*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// sums, nan_c, pos_c, neg_c: (size, K) float32, contiguous; rowcount (size,)
// int32; out (K, size) row-major, float32 (out_dtype 0) or bfloat16 (1).
// Returns the cudaError_t of the launch (0 on success); cudaErrorInvalidValue
// for a shape or dtype it refuses.
int flox_mean_finalize(const void* sums, const void* nan_c, const void* pos_c,
                       const void* neg_c, const int* rowcount, long long K, long long size,
                       float fill, int out_dtype, void* out, void* stream) {
  if (K <= 0 || size <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Legs legs = {static_cast<const float*>(sums), static_cast<const float*>(nan_c),
                     static_cast<const float*>(pos_c), static_cast<const float*>(neg_c)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return static_cast<int>(launch<float>(legs, rowcount, K, size, fill, out, st));
  if (out_dtype == 1)
    return static_cast<int>(launch<uint16_t>(legs, rowcount, K, size, fill, out, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flox_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
