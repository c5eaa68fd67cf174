// RMSNorm forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: tpu_network_operator/ops/norms.py::_fwd_kernel (the fused
// Pallas RMSNorm forward).  Same function: y = x * rsqrt(mean(x^2) + eps)
// * scale with f32 math, cast to x's dtype, plus the per-row f32 rstd the
// backward consumes.  rstd is stored as [rows], without the TPU kernel's
// 128-lane broadcast.
//
// Bound on this card: bytes.  Per row it reads hidden elements and writes
// hidden elements, doing ~4 flops each, far below the ~295 flop/byte at
// which the tensor cores (or even the f32 units) would be the limit.  The
// design reads x once: one 256-thread block per row keeps the whole row
// in registers (hidden <= 8192 -> at most 32 floats per thread), loaded
// as 16-byte vectors when the row is aligned, reduces the sum of squares
// across the block in f32, and writes y from the registers.  There is no
// row tiling or alignment rule: any row count and any hidden <= 8192 is
// accepted (the 16-row/128-lane rule of the Pallas kernel was a TPU tiling
// constraint, not part of the function).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHidden = 8192;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half(v);
}

// VEC elements per load: 16 / sizeof(T) on the vector path, 1 on the
// scalar path (unaligned rows or hidden not a multiple of the vector).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
rms_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                    T* __restrict__ y, float* __restrict__ rstd,
                    int hidden, float eps) {
  constexpr int kChunks = kMaxHidden / (kThreads * VEC);
  const int64_t row = blockIdx.x;
  const T* xr = x + row * hidden;
  T* yr = y + row * hidden;

  float vals[kChunks * VEC];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = (threadIdx.x + i * kThreads) * VEC;
    if (c < hidden) {
      alignas(16) T buf[VEC];
      if constexpr (VEC * sizeof(T) == 16) {
        *reinterpret_cast<uint4*>(buf) = *reinterpret_cast<const uint4*>(xr + c);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) buf[e] = xr[c + e];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float v = to_f32(buf[e]);
        vals[i * VEC + e] = v;
        ss += v * v;
      }
    }
  }

  // block-wide sum of squares: warp shuffles, then one value per warp
  __shared__ float partial[kThreads / 32];
  __shared__ float row_rstd;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += partial[w];
    const float r = rsqrtf(total / static_cast<float>(hidden) + eps);
    row_rstd = r;
    rstd[row] = r;
  }
  __syncthreads();
  const float r = row_rstd;

#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = (threadIdx.x + i * kThreads) * VEC;
    if (c < hidden) {
      alignas(16) T sbuf[VEC];
      alignas(16) T out[VEC];
      if constexpr (VEC * sizeof(T) == 16) {
        *reinterpret_cast<uint4*>(sbuf) = *reinterpret_cast<const uint4*>(scale + c);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) sbuf[e] = scale[c + e];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        out[e] = from_f32<T>(vals[i * VEC + e] * r * to_f32(sbuf[e]));
      }
      if constexpr (VEC * sizeof(T) == 16) {
        *reinterpret_cast<uint4*>(yr + c) = *reinterpret_cast<const uint4*>(out);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) yr[c + e] = out[e];
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* scale, void* y, float* rstd, int rows,
           int hidden, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned =
      hidden % kVec == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scale);
  T* yp = static_cast<T*>(y);
  if (aligned) {
    rms_norm_fwd_kernel<T, kVec><<<rows, kThreads, 0, stream>>>(xp, sp, yp, rstd, hidden, eps);
  } else {
    rms_norm_fwd_kernel<T, 1><<<rows, kThreads, 0, stream>>>(xp, sp, yp, rstd, hidden, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, scale and y share it).
// x and y are contiguous [rows, hidden]; rstd is [rows] float32.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int tpunet_rms_norm_fwd(const void* x, const void* scale, void* y,
                                   void* rstd, int rows, int hidden, float eps,
                                   int dtype, void* stream) {
  if (rows <= 0 || hidden <= 0 || hidden > kMaxHidden) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* r = static_cast<float*>(rstd);
  switch (dtype) {
    case 0: return launch<float>(x, scale, y, r, rows, hidden, eps, s);
    case 1: return launch<__nv_bfloat16>(x, scale, y, r, rows, hidden, eps, s);
    case 2: return launch<__half>(x, scale, y, r, rows, hidden, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
