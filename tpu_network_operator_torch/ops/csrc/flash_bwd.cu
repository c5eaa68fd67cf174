// Flash-attention dQ backward for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces: tpu_network_operator/ops/pallas_attention.py::_dq_kernel (the
// Pallas flash backward's dQ pass; its dK/dV pass is flash_bwd_dkv.cu).
// Same function, from the forward's f32 log-sum-exp (lse) and
// delta = rowsum(dO * O) (f32):
//   P  = exp(S - lse) with S = bf16(q * scale) K^T (masked causally),
//   dP = dO V^T,  dS = P * (dP - delta),  dQ = scale * dS K,
// with bf16 tensor-core operands (q * scale, dO and dS rounded to bf16
// where the TPU kernel rounds them) and f32 accumulation.
//
// One 128-thread block per (64-row q tile, q-head, batch) keeps its Q and
// dO rows as WMMA fragments, streams 64-key K/V tiles through shared
// memory (only the causally live ones), and keeps the [64, D] dQ
// accumulator in tensor-core accumulator fragments for the whole loop.
// Each of the four warps owns 16 rows of the block's tile; the element-
// wise part (exp, the dS product, masking) runs in f32 on a per-warp
// shared-memory copy of the [16, 64] S and dP tiles, two lanes per row.
// Bound on this card: the tensor-core rate (at S = 2048, D = 64 the three
// products per tile pair are ~16 flops per byte moved), and this design is
// far from it: the tiles are copied synchronously, with no overlap of
// copies and products, and WMMA does not reach the wgmma rate.  TMA, wgmma
// and a pipelined tile ring (hopper.cuh, as flash_fwd.cu and
// flash_bwd_dkv.cu use them) are left for a later version.  Ragged tiles
// are masked (any Sq, Sk); fully masked causal tiles are skipped.  Tensors
// are addressed through strides, so the [B,S,H,D] and [B,H,S,D] layouts
// are both read without a transpose.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kTile = 64;     // rows of every q and key tile
constexpr int kWarps = 4;     // each warp owns 16 rows of the block's tile
constexpr int kThreads = kWarps * 32;

struct Strides {
  long long b, s, h;          // element strides; the head_dim stride is 1
};

template <int D>
struct Layout {
  static constexpr int kLdT = D + 8;                  // bf16 pitch of [64, D] tiles
  static constexpr int kLdP = kTile + 8;              // bf16 pitch of [64, 64] dS
  static constexpr int kWide = D > kTile ? D : kTile;
  static constexpr int kLdS = kWide + 4;              // f32 pitch of S / dP / staging
  static constexpr size_t kTileBytes = sizeof(bf16) * kTile * kLdT;
  static constexpr size_t kF32Bytes = sizeof(float) * kTile * kLdS;
  static constexpr size_t kPBytes = sizeof(bf16) * kTile * kLdP;
  // four bf16 tiles (Q, dO, K, V), S and dP in f32, then dS in bf16
  static constexpr size_t kT0 = 0;
  static constexpr size_t kS = 4 * kTileBytes;
  static constexpr size_t kDP = kS + kF32Bytes;
  static constexpr size_t kDS = kDP + kF32Bytes;
  static constexpr size_t kBytes = kDS + kPBytes;
};

// Copy rows [row0, row0 + 64) of one head into a padded bf16 tile, 16 bytes
// per thread per step, zero-filling rows past `rows`.  With kScale each
// element becomes bf16(float(x) * scale), the TPU kernels' rounding of
// q * scale.
template <int D, bool kScale>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long row_stride,
                                          int row0, int rows, float scale) {
  constexpr int kVecs = D / 8;
  for (int i = threadIdx.x; i < kTile * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + c);
      if (kScale) {
        bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * Layout<D>::kLdT + c) = val;
  }
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// out[16, 64] = A[16, D] B^T for this warp, with A's rows at `a` and B's 64
// rows at `b` (both bf16 tiles of pitch kLdT), stored f32 at `out` (pitch
// kLdS).
template <int D>
__device__ __forceinline__ void rows_times_tile_t(float* out, const bf16* a, const bf16* b) {
  using L = Layout<D>;
#pragma unroll
  for (int n = 0; n < kTile / 16; ++n) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA fa;
      FragBCol fb;
      wmma::load_matrix_sync(fa, a + kk * 16, L::kLdT);
      wmma::load_matrix_sync(fb, b + n * 16 * L::kLdT + kk * 16, L::kLdT);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + n * 16, acc, L::kLdS, wmma::mem_row_major);
  }
}

// acc[n] += A[16, 64] B[64, D] for this warp: A bf16 of pitch kLdP at `a`,
// B the bf16 tile of pitch kLdT at `b`.
template <int D>
__device__ __forceinline__ void accumulate(FragC* acc, const bf16* a, const bf16* b) {
  using L = Layout<D>;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      FragA fa;
      FragBRow fb;
      wmma::load_matrix_sync(fa, a + kk * 16, L::kLdP);
      wmma::load_matrix_sync(fb, b + kk * 16 * L::kLdT + n * 16, L::kLdT);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// Write this warp's [16, D] f32 staging rows (pitch kLdS) to `dst` row
// `row` (if < rows): lane -> row lane / 2, half of the columns each.
template <int D>
__device__ __forceinline__ void write_rows(void* dst, long long base, long long row_stride,
                                           const float* stage, int row0, int rows,
                                           int out_f32) {
  using L = Layout<D>;
  const int lane = threadIdx.x % 32;
  const int r = lane >> 1;
  const int half = lane & 1;
  if (row0 + r >= rows) return;
  const float* src = stage + r * L::kLdS + half * (D / 2);
  const long long off = base + (long long)(row0 + r) * row_stride + half * (D / 2);
  if (out_f32) {
    float* out = static_cast<float*>(dst) + off;
#pragma unroll
    for (int j = 0; j < D / 2; j += 4) {
      *reinterpret_cast<float4*>(out + j) = make_float4(src[j], src[j + 1], src[j + 2], src[j + 3]);
    }
  } else {
    bf16* out = static_cast<bf16*>(dst) + off;
#pragma unroll
    for (int j = 0; j < D / 2; j += 8) {
      uint4 pack;
      bf16* e = reinterpret_cast<bf16*>(&pack);
#pragma unroll
      for (int u = 0; u < 8; ++u) e[u] = __float2bfloat16(src[j + u]);
      *reinterpret_cast<uint4*>(out + j) = pack;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    void* __restrict__ dq, int H, int Hkv, int Sq, int Sk,
                    Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs,
                    float scale, int causal, int out_f32) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::kT0);
  bf16* sDO = reinterpret_cast<bf16*>(smem + L::kT0 + L::kTileBytes);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::kT0 + 2 * L::kTileBytes);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::kT0 + 3 * L::kTileBytes);
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  float* sDP = reinterpret_cast<float*>(smem + L::kDP);
  bf16* sDS = reinterpret_cast<bf16*>(smem + L::kDS);

  // heaviest causal tiles (the last q rows) first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = lane >> 1;
  const int half = lane & 1;
  const int q_pos = q0 + warp * 16 + r;

  load_tile<D, true>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, Sq, scale);
  load_tile<D, false>(sDO, dout + b * dos.b + h * dos.h, dos.s, q0, Sq, 0.f);
  const long long stat = ((long long)b * H + h) * Sq;
  const float row_lse = q_pos < Sq ? lse[stat + q_pos] : 0.f;
  const float row_delta = q_pos < Sq ? delta[stat + q_pos] : 0.f;

  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  const bf16* sQw = sQ + warp * 16 * L::kLdT;
  const bf16* sDOw = sDO + warp * 16 * L::kLdT;
  float* sSw = sS + warp * 16 * L::kLdS;
  float* sDPw = sDP + warp * 16 * L::kLdS;
  bf16* sDSw = sDS + warp * 16 * L::kLdP;

  int n_tiles = (Sk + kTile - 1) / kTile;
  if (causal) {
    // key tile t is live iff its first key <= the block's last query row
    const int last_q = min(q0 + kTile, Sq) - 1;
    n_tiles = min(n_tiles, last_q / kTile + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();                       // previous tiles fully consumed
    load_tile<D, false>(sK, kb, ks.s, k0, Sk, 0.f);
    load_tile<D, false>(sV, vb, vs.s, k0, Sk, 0.f);
    __syncthreads();

    rows_times_tile_t<D>(sSw, sQw, sK);    // S  = bf16(q * scale) K^T
    rows_times_tile_t<D>(sDPw, sDOw, sV);  // dP = dO V^T
    __syncwarp();

#pragma unroll 8
    for (int j = 0; j < kTile / 2; ++j) {
      const int col = half * (kTile / 2) + j;
      const int k_pos = k0 + col;
      const bool live = k_pos < Sk && !(causal && q_pos < k_pos);
      const float p = live ? expf(sSw[r * L::kLdS + col] - row_lse) : 0.f;
      const float ds = p * (sDPw[r * L::kLdS + col] - row_delta);
      sDSw[r * L::kLdP + col] = __float2bfloat16(ds);
    }
    __syncwarp();

    accumulate<D>(acc, sDSw, sK);          // dQ += bf16(dS) K
  }

  // dQ = scale * acc, staged through this warp's S rows
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
#pragma unroll
    for (int e = 0; e < acc[n].num_elements; ++e) acc[n].x[e] *= scale;
    wmma::store_matrix_sync(sSw + n * 16, acc[n], L::kLdS, wmma::mem_row_major);
  }
  __syncwarp();
  write_rows<D>(dq, b * dqs.b + h * dqs.h, dqs.s, sSw, q0 + warp * 16, Sq, out_f32);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  // above 48 KB of dynamic shared memory needs the opt-in (per device)
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int B, int H, int Hkv, int Sq, int Sk,
              Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs, float scale,
              int causal, int out_f32, cudaStream_t stream) {
  constexpr size_t kSmem = Layout<D>::kBytes;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kTile - 1) / kTile, H, B);
  flash_bwd_dq_kernel<D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), dq, H, Hkv, Sq, Sk, qs, ks, vs, dos, dqs, scale,
      causal, out_f32);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int H, int Hkv, int Sq, int Sk) {
  return B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq <= 0 || Sk <= 0;
}

}  // namespace

// q, dout: [B, Sq, H, D]-shaped views given by element strides (batch,
// seq, head; the head_dim stride must be 1); k, v likewise with Hkv heads
// and Sk rows; lse and delta contiguous [B, H, Sq] f32; dq has q's shape
// with its own strides, f32 if out_f32 else bf16.  bf16 inputs only; D in
// {64, 128}; every stride and pointer 16-byte aligned.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int tpunet_flash_bwd_dq(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dq, int B, int H, int Hkv, int Sq, int Sk, int D,
                                   long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss, long long v_sh,
                                   long long do_sb, long long do_ss, long long do_sh,
                                   long long dq_sb, long long dq_ss, long long dq_sh,
                                   float scale, int causal, int out_f32, void* stream) {
  if (bad_shape(B, H, Hkv, Sq, Sk)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const Strides dos{do_sb, do_ss, do_sh}, dqs{dq_sb, dq_ss, dq_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Sq, Sk, qs, ks, vs, dos,
                           dqs, scale, causal, out_f32, s);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Sq, Sk, qs, ks, vs, dos,
                            dqs, scale, causal, out_f32, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
