// Segment-min/max, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flox_tpu/pallas_kernels.py:_minmax_kernel
// (built by _build_minmax, entered through segment_minmax_pallas):
//
//   data  (K, N) row-major, N contiguous, read once and in place;
//         float32, bfloat16 or int32
//   codes (N,) int32; a code outside [0, size) drops out
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
// Design: the shape of the segment-sum kernel (segment_sum.cu). One warp
// per row, 8 rows per block, coalesced loads with 4 chunks of 32 columns in
// flight; per chunk the warp walks the distinct codes present, reduces each
// group's lanes with a butterfly of xor-shuffles, and lane 0 folds the
// result into the warp's per-group accumulators in shared memory. Min and
// max are exact, so the order does not change the result.
//
// Bound on the card: one read of the data, K*N*itemsize bytes (plus N*4 of
// codes and size*K*itemsize written). At the benchmark width of 65160 x
// 26304 float32 that is 6.86 GB, at least 2.05 ms at 3.35 TB/s (computed,
// not measured).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;

// W is the working type held in registers: float for float32 and bfloat16,
// int for int32. bfloat16 widens exactly and narrows exactly back, since a
// result is always one of the inputs or the identity.
__device__ __forceinline__ float load_value(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float load_value(const uint16_t* p) {
  return __uint_as_float(static_cast<unsigned>(__ldcs(p)) << 16);
}
__device__ __forceinline__ int load_value(const int* p) { return __ldcs(p); }

__device__ __forceinline__ void store_value(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_value(uint16_t* p, float v) {
  *p = static_cast<uint16_t>(__float_as_uint(v) >> 16);
}
__device__ __forceinline__ void store_value(int* p, int v) { *p = v; }

template <bool MAX>
__device__ __forceinline__ float combine(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return MAX ? fmaxf(a, b) : fminf(a, b);
}
template <bool MAX>
__device__ __forceinline__ int combine(int a, int b) {
  return MAX ? max(a, b) : min(a, b);
}

template <typename W, bool MAX>
__device__ __forceinline__ W identity();
template <>
__device__ __forceinline__ float identity<float, true>() { return __int_as_float(0xff800000); }
template <>
__device__ __forceinline__ float identity<float, false>() { return __int_as_float(0x7f800000); }
template <>
__device__ __forceinline__ int identity<int, true>() { return INT32_MIN; }
template <>
__device__ __forceinline__ int identity<int, false>() { return INT32_MAX; }

template <typename T, typename W, bool MAX>
__global__ void __launch_bounds__(kWarps * 32)
segment_minmax_kernel(const T* __restrict__ data, const int* __restrict__ codes, long long K,
                      long long N, int size, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long k = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (k >= K) return;  // whole warp; no block-wide barrier follows

  W* acc = reinterpret_cast<W*>(smem_raw) + static_cast<size_t>(warp) * size;
  const W ident = identity<W, MAX>();
  for (int g = lane; g < size; g += 32) acc[g] = ident;
  __syncwarp();

  const T* row = data + k * N;  // 64-bit offset
  for (long long c0 = 0; c0 < N; c0 += 32 * kUnroll) {
    W x[kUnroll];
    int code[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long c = c0 + u * 32 + lane;
      if (c < N) {
        x[u] = load_value(row + c);
        code[u] = __ldg(codes + c);
      } else {
        x[u] = ident;
        code[u] = -1;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool valid = static_cast<unsigned>(code[u]) < static_cast<unsigned>(size);
      unsigned todo = __ballot_sync(kFull, valid);
      while (todo) {  // warp-uniform
        const int leader = __ffs(todo) - 1;
        const int g = __shfl_sync(kFull, code[u], leader);
        const bool mine = valid && code[u] == g;
        const unsigned peers = __ballot_sync(kFull, mine);
        W v = mine ? x[u] : ident;
#pragma unroll
        for (int s = 16; s > 0; s >>= 1) v = combine<MAX>(v, __shfl_xor_sync(kFull, v, s));
        if (lane == 0) acc[g] = combine<MAX>(acc[g], v);
        todo &= ~peers;
      }
    }
  }
  __syncwarp();

  for (int g = lane; g < size; g += 32) store_value(out + static_cast<long long>(g) * K + k, acc[g]);
}

template <typename T, typename W, bool MAX>
cudaError_t launch(const void* data, const int* codes, long long K, long long N, int size,
                   void* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kWarps) * size * sizeof(W);
  auto kernel = segment_minmax_kernel<T, W, MAX>;
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

// dtype: 0 float32, 1 bfloat16, 2 int32. op: 0 min, 1 max.
// Returns the cudaError_t of the launch (0 on success).
int flox_segment_minmax(const void* data, int dtype, const int* codes, long long K, long long N,
                        int size, int op, void* out, void* stream) {
  if (K <= 0 || N < 0 || size <= 0 || size > 512 || K > 0x7fffffffLL * kWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = op ? launch<float, float, true>(data, codes, K, N, size, out, st)
             : launch<float, float, false>(data, codes, K, N, size, out, st);
  } else if (dtype == 1) {
    err = op ? launch<uint16_t, float, true>(data, codes, K, N, size, out, st)
             : launch<uint16_t, float, false>(data, codes, K, N, size, out, st);
  } else if (dtype == 2) {
    err = op ? launch<int, int, true>(data, codes, K, N, size, out, st)
             : launch<int, int, false>(data, codes, K, N, size, out, st);
  }
  return static_cast<int>(err);
}

const char* flox_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
