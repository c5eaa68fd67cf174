// RMSNorm backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: tpu_network_operator/ops/norms.py::_bwd_kernel (the fused
// Pallas RMSNorm backward).  Same function, f32 math:
//   xh = x * rstd, g = dy * scale,
//   dx = rstd * (g - xh * mean(g * xh))      (in x's dtype)
//   dscale = sum over rows of dy * xh         (f32, cast to scale's dtype)
// with rstd the per-row f32 value the forward kernel saved.
//
// The TPU kernel accumulates dscale with `ds_ref[...] +=` into one resident
// block across its grid, which is only correct because the TPU runs the
// grid in order on one core.  GPU blocks run at the same time, so that
// form races here, and atomics would make dscale depend on the order the
// blocks finish in.  Instead the rows are cut into `parts` fixed groups:
// block p walks its group's rows in order, keeps each thread's columns of
// dy * xh in registers, and writes one f32 partial row; a second small
// kernel sums the partial rows column by column in a fixed order.  The
// result is the same on every run.
//
// Bound on this card: bytes.  Per row it reads x and dy and writes dx,
// with ~10 flops per element, far below the ~295 flop/byte at which the
// arithmetic would limit.  x and dy are read once, as 16-byte vectors when
// the rows are aligned; the partial rows add parts * hidden * 8 bytes
// (~4% at 12288 x 2048 with 512 parts).  A thread holds CHUNKS * VEC
// columns, sized at launch for the given hidden (hidden <= 8192), so at
// hidden 2048 in bf16 a thread holds 8 columns and many blocks share an SM.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
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

template <typename T, int VEC>
__device__ __forceinline__ void load(const T* __restrict__ p, float* out) {
  alignas(16) T buf[VEC];
  if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(buf) = *reinterpret_cast<const uint4*>(p);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) buf[e] = p[e];
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) out[e] = to_f32(buf[e]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* __restrict__ p, const float* in) {
  alignas(16) T buf[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) buf[e] = from_f32<T>(in[e]);
  if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(buf);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) p[e] = buf[e];
  }
}

// One block per row group: dx for each of its rows, and its partial
// dscale row.  Thread t owns columns (t + i * kThreads) * VEC + [0, VEC)
// for i < CHUNKS.
template <typename T, int VEC, int CHUNKS>
__global__ void __launch_bounds__(kThreads)
rms_norm_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                         const float* __restrict__ rstd, const T* __restrict__ dy,
                         T* __restrict__ dx, float* __restrict__ partial,
                         int rows, int hidden, int rows_per_part) {
  constexpr int kCols = CHUNKS * VEC;
  const int r0 = blockIdx.x * rows_per_part;
  const int r1 = min(rows, r0 + rows_per_part);

  float s[kCols];
  float ds[kCols];
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = (threadIdx.x + i * kThreads) * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      s[i * VEC + e] = 0.f;
      ds[i * VEC + e] = 0.f;
    }
    if (c < hidden) load<T, VEC>(scale + c, s + i * VEC);
  }

  // two buffers of per-warp sums, by row parity: one __syncthreads a row
  __shared__ float red[2][kWarps];
  const float inv_h = 1.f / static_cast<float>(hidden);

  for (int row = r0; row < r1; ++row) {
    const float r = rstd[row];
    const T* xr = x + static_cast<int64_t>(row) * hidden;
    const T* dyr = dy + static_cast<int64_t>(row) * hidden;
    float xh[kCols];
    float g[kCols];
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int c = (threadIdx.x + i * kThreads) * VEC;
      if (c < hidden) {
        float xv[VEC], dv[VEC];
        load<T, VEC>(xr + c, xv);
        load<T, VEC>(dyr + c, dv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int j = i * VEC + e;
          xh[j] = xv[e] * r;
          g[j] = dv[e] * s[j];
          dot += g[j] * xh[j];
          ds[j] += dv[e] * xh[j];
        }
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          xh[i * VEC + e] = 0.f;
          g[i * VEC + e] = 0.f;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    float* buf = red[row & 1];
    if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = dot;
    __syncthreads();
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += buf[w];
    const float mean = total * inv_h;

    T* dxr = dx + static_cast<int64_t>(row) * hidden;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int c = (threadIdx.x + i * kThreads) * VEC;
      if (c < hidden) {
        float out[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int j = i * VEC + e;
          out[e] = r * (g[j] - xh[j] * mean);
        }
        store<T, VEC>(dxr + c, out);
      }
    }
  }

  float* prow = partial + static_cast<int64_t>(blockIdx.x) * hidden;
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = (threadIdx.x + i * kThreads) * VEC;
    if (c < hidden) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) prow[c + e] = ds[i * VEC + e];
    }
  }
}

// dscale[c] = sum over p of partial[p, c], always in the same order:
// 8 row lanes each sum every 8th partial row, then lane 0 adds the 8.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rms_norm_bwd_dscale_kernel(const float* __restrict__ partial, T* __restrict__ dscale,
                           int parts, int hidden) {
  __shared__ float sums[kWarps][33];
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  float acc = 0.f;
  if (c < hidden) {
    for (int p = ty; p < parts; p += kWarps) acc += partial[static_cast<int64_t>(p) * hidden + c];
  }
  sums[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && c < hidden) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += sums[w][tx];
    dscale[c] = from_f32<T>(total);
  }
}

template <typename T, int VEC, int CHUNKS>
void launch_rows(const T* x, const T* scale, const float* rstd, const T* dy, T* dx,
                 float* partial, int rows, int hidden, int parts, cudaStream_t stream) {
  const int per = (rows + parts - 1) / parts;
  rms_norm_bwd_rows_kernel<T, VEC, CHUNKS><<<parts, kThreads, 0, stream>>>(
      x, scale, rstd, dy, dx, partial, rows, hidden, per);
}

// CHUNKS = the smallest power of two with CHUNKS * kThreads * VEC >= hidden;
// only the counts that hidden <= 8192 can need are instantiated.
template <typename T, int VEC>
int launch_vec(const T* x, const T* scale, const float* rstd, const T* dy, T* dx,
               float* partial, int rows, int hidden, int parts, cudaStream_t stream) {
  constexpr int kMaxChunks = kMaxHidden / (kThreads * VEC);
  const int need = (hidden + kThreads * VEC - 1) / (kThreads * VEC);
#define TPUNET_RMS_BWD_CASE(N)                                                     \
  if constexpr (kMaxChunks >= N) {                                                 \
    if (need <= N) {                                                               \
      launch_rows<T, VEC, N>(x, scale, rstd, dy, dx, partial, rows, hidden, parts, \
                             stream);                                              \
      return 0;                                                                    \
    }                                                                              \
  }
  TPUNET_RMS_BWD_CASE(1)
  TPUNET_RMS_BWD_CASE(2)
  TPUNET_RMS_BWD_CASE(4)
  TPUNET_RMS_BWD_CASE(8)
  TPUNET_RMS_BWD_CASE(16)
  TPUNET_RMS_BWD_CASE(32)
#undef TPUNET_RMS_BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch(const void* x, const void* scale, const void* rstd, const void* dy, void* dx,
           void* dscale, void* partial, int rows, int hidden, int parts,
           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned =
      hidden % kVec == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  const T* xp = static_cast<const T*>(x);
  const T* sp = static_cast<const T*>(scale);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  const float* rp = static_cast<const float*>(rstd);
  float* pp = static_cast<float*>(partial);
  const int err = aligned
      ? launch_vec<T, kVec>(xp, sp, rp, dyp, dxp, pp, rows, hidden, parts, stream)
      : launch_vec<T, 1>(xp, sp, rp, dyp, dxp, pp, rows, hidden, parts, stream);
  if (err != 0) return err;
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return static_cast<int>(launched);
  rms_norm_bwd_dscale_kernel<T><<<(hidden + 31) / 32, kThreads, 0, stream>>>(
      pp, static_cast<T*>(dscale), parts, hidden);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x, scale, dy, dx and
// dscale share it).  x, dy and dx are contiguous [rows, hidden]; rstd is
// [rows] float32; partial is float32 scratch of parts * hidden elements
// (1 <= parts <= rows).  Returns the cudaError_t of the launches (0 =
// success).
extern "C" int tpunet_rms_norm_bwd(const void* x, const void* scale, const void* rstd,
                                   const void* dy, void* dx, void* dscale, void* partial,
                                   int rows, int hidden, int parts, int dtype,
                                   void* stream) {
  if (rows <= 0 || hidden <= 0 || hidden > kMaxHidden || parts <= 0 || parts > rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, scale, rstd, dy, dx, dscale, partial, rows, hidden, parts, s);
    case 1:
      return launch<__nv_bfloat16>(x, scale, rstd, dy, dx, dscale, partial, rows, hidden, parts, s);
    case 2: return launch<__half>(x, scale, rstd, dy, dx, dscale, partial, rows, hidden, parts, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
