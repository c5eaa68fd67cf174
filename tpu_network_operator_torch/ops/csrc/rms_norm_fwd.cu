// RMSNorm forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: tpu_network_operator/ops/norms.py::_fwd_kernel (the fused
// Pallas RMSNorm forward).  Same function: y = x * rsqrt(mean(x^2) + eps)
// * scale with f32 math, cast to x's dtype, plus the per-row f32 rstd the
// backward consumes.  rstd is stored as [rows], without the TPU kernel's
// 128-lane broadcast.  Any row count and any hidden <= 8192 (the 16-row /
// 128-lane rule of the Pallas kernel was a TPU tiling constraint, not part
// of the function).
//
// Bound on this card: bytes.  Per row it reads hidden elements and writes
// hidden elements, doing ~4 flops each, far below the ~295 flops a byte at
// which the tensor cores (or even the f32 units) would be the limit.  So
// the design keeps as many of x's bytes in flight as it can and spends no
// time between them:
//
// * one warp per row: a block is one warp, the grid as many blocks as the
//   card holds at once (or one per row where there are fewer), and each
//   warp walks rows grid-stride with two rows in flight: the next row's
//   loads are issued before this row's sum;
// * each lane holds its share of the row in registers, kN loads of 16
//   bytes (at hidden 2048 in bf16, 8 loads of 8 values), all issued before
//   the reduction; the sum of squares is reduced by warp shuffles alone (no
//   shared memory, no barrier, no serial sum), lane 0 writes rstd, and y
//   is written from the registers, so x is read once;
// * kN is a template parameter the host picks from hidden; where the row
//   fits in registers (at most 8 loads a lane) the warp also keeps scale in
//   registers across all of its rows, loaded once;
// * a row longer than 16 loads a lane (hidden above 4096 in bf16 / f16,
//   above 2048 in f32) sums the rest as it streams and reads it again
//   (from L1 / L2) for y;
// * few rows (decode: 64) leave one warp per row bound by its own
//   latency, the 64 values a lane holds at hidden 2048: where every row's
//   block of eight warps fits on the card at once (up to 1,056 rows on an
//   H100), a block of eight warps takes a row, each lane holding an eighth
//   as much, and the eight warps' partial sums meet in shared memory across
//   one barrier, added in a fixed order by every thread;
// * the scalar path (rows not 16-byte aligned, or a hidden that is no
//   multiple of the vector) is the same with one element a load.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxHidden = 8192;
constexpr int kScaleRegs = 8;  // loads a lane up to which scale stays in registers
constexpr int kSmallWarps = 8;  // warps a row takes when all rows fit on the card at once

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

// VEC elements of T: one 16-byte access (VEC = 16 / sizeof(T)) or one
// element (VEC = 1, the scalar path)
template <typename T, int VEC>
struct Vec {
  static constexpr bool kWide = VEC * sizeof(T) == 16;
  static_assert(kWide || VEC == 1, "a 16-byte vector or one element");
  alignas(kWide ? 16 : alignof(T)) T e[VEC];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kWide) {
      *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(p);
    } else {
      e[0] = *p;
    }
  }
  __device__ __forceinline__ void store(T* p) const {
    if constexpr (kWide) {
      *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(e);
    } else {
      *p = e[0];
    }
  }
  __device__ __forceinline__ float sum_sq() const {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) s += to_f32(e[i]) * to_f32(e[i]);
    return s;
  }
};

// y = (x * r) * s, element by element, in f32
template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> normed(const Vec<T, VEC>& x, const Vec<T, VEC>& s, float r) {
  Vec<T, VEC> y;
#pragma unroll
  for (int i = 0; i < VEC; ++i) y.e[i] = from_f32<T>(to_f32(x.e[i]) * r * to_f32(s.e[i]));
  return y;
}

// A block of kWarps warps takes one row at a time.  Thread t's i-th load
// of a row covers elements [c, c + VEC) with c = (32 kWarps i + t) VEC:
// the block's loads are contiguous.
template <typename T, int VEC, int kN, int kWarps>
__global__ void __launch_bounds__(32 * kWarps)
rms_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ y,
                    float* __restrict__ rstd, int rows, int hidden, float eps) {
  constexpr int kRow = 32 * kWarps * VEC;  // elements a block covers per load
  constexpr bool kKeepScale = kN <= kScaleRegs;
  const int t = threadIdx.x;
  const int steps = (hidden + kRow - 1) / kRow;  // loads a thread per row
  auto col = [&](int i) { return kRow * i + t * VEC; };

  Vec<T, VEC> sv[kKeepScale ? kN : 1];
  if constexpr (kKeepScale) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      if (col(i) < hidden) sv[i].load(scale + col(i));
    }
  }
  auto load_row = [&](Vec<T, VEC>(&v)[kN], long long row) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      if (col(i) < hidden) v[i].load(x + row * hidden + col(i));
    }
  };

  Vec<T, VEC> xv[kN], xn[kN];  // this row and the next
  if (blockIdx.x < rows) load_row(xv, blockIdx.x);
  int turn = 0;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x, turn ^= 1) {
    if (row + gridDim.x < rows) load_row(xn, row + gridDim.x);
    const T* xr = x + row * hidden;
    T* yr = y + row * hidden;
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      if (col(i) < hidden) ss += xv[i].sum_sq();
    }
    for (int i = kN; i < steps; ++i) {  // a row longer than the registers hold
      if (col(i) < hidden) {
        Vec<T, VEC> v;
        v.load(xr + col(i));
        ss += v.sum_sq();
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if constexpr (kWarps > 1) {
      // two slots in turn: a warp that runs ahead to the next row never
      // overwrites a sum another warp has still to read
      __shared__ float part[2][kWarps];
      if (t % 32 == 0) part[turn][t / 32] = ss;
      __syncthreads();
      ss = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) ss += part[turn][w];
    }
    const float r = rsqrtf(ss / static_cast<float>(hidden) + eps);
    if (t == 0) rstd[row] = r;

#pragma unroll
    for (int i = 0; i < kN; ++i) {
      if (col(i) < hidden) {
        Vec<T, VEC> s;
        if constexpr (kKeepScale) {
          s = sv[i];
        } else {
          s.load(scale + col(i));
        }
        normed(xv[i], s, r).store(yr + col(i));
      }
    }
    for (int i = kN; i < steps; ++i) {
      if (col(i) < hidden) {
        Vec<T, VEC> v, s;
        v.load(xr + col(i));
        s.load(scale + col(i));
        normed(v, s, r).store(yr + col(i));
      }
    }
#pragma unroll
    for (int i = 0; i < kN; ++i) xv[i] = xn[i];
  }
}

// The card's SMs and the blocks of `kernel` it holds at once, queried once
// per device
struct Card {
  int sms, blocks;
};

template <typename Kernel>
cudaError_t card_for(Kernel kernel, int threads, Card* card) {
  constexpr int kMaxDevices = 64;
  static Card cached[kMaxDevices] = {};
  int dev = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cached[dev].blocks > 0) {
    *card = cached[dev];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&card->sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  }
  if (err != cudaSuccess) return err;
  card->blocks = card->sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cached[dev] = *card;
  return cudaSuccess;
}

template <typename T, int VEC, int kN, int kWarps>
int launch_n(const void* x, const void* scale, void* y, float* rstd, int rows, int hidden,
             float eps, cudaStream_t stream) {
  auto kernel = rms_norm_fwd_kernel<T, VEC, kN, kWarps>;
  Card card;
  cudaError_t err = card_for(kernel, 32 * kWarps, &card);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<rows < card.blocks ? rows : card.blocks, 32 * kWarps, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<T*>(y), rstd, rows,
      hidden, eps);
  return static_cast<int>(cudaGetLastError());
}

// kN: the loads a thread holds in registers, the fewest that cover the row
// (at most 16; a longer row streams the rest)
template <typename T, int VEC, int kWarps>
int launch_rows(const void* x, const void* scale, void* y, float* rstd, int rows, int hidden,
                float eps, cudaStream_t stream) {
  const int steps = (hidden + 32 * kWarps * VEC - 1) / (32 * kWarps * VEC);
  if (steps <= 1) return launch_n<T, VEC, 1, kWarps>(x, scale, y, rstd, rows, hidden, eps, stream);
  if (steps <= 2) return launch_n<T, VEC, 2, kWarps>(x, scale, y, rstd, rows, hidden, eps, stream);
  if (steps <= 4) return launch_n<T, VEC, 4, kWarps>(x, scale, y, rstd, rows, hidden, eps, stream);
  if (steps <= 8) return launch_n<T, VEC, 8, kWarps>(x, scale, y, rstd, rows, hidden, eps, stream);
  return launch_n<T, VEC, 16, kWarps>(x, scale, y, rstd, rows, hidden, eps, stream);
}

// eight warps a row where every row's block fits on the card at once,
// else one warp a row
template <typename T, int VEC>
int launch_vec(const void* x, const void* scale, void* y, float* rstd, int rows, int hidden,
               float eps, cudaStream_t stream) {
  int dev = 0, sms = 0, threads = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&threads, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return (long long)rows * 32 * kSmallWarps <= (long long)sms * threads
             ? launch_rows<T, VEC, kSmallWarps>(x, scale, y, rstd, rows, hidden, eps, stream)
             : launch_rows<T, VEC, 1>(x, scale, y, rstd, rows, hidden, eps, stream);
}

template <typename T>
int launch(const void* x, const void* scale, void* y, float* rstd, int rows, int hidden,
           float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = hidden % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  return aligned ? launch_vec<T, kVec>(x, scale, y, rstd, rows, hidden, eps, stream)
                 : launch_vec<T, 1>(x, scale, y, rstd, rows, hidden, eps, stream);
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
