// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: tpu_network_operator/ops/pallas_attention.py::_fwd_kernel (the
// Pallas flash forward).  Same function: per (batch, q-head) an online
// softmax over key blocks with f32 running max / sum / accumulator, q*scale
// and the probabilities rounded to bf16 before their products (as the TPU
// kernel rounds them for its matrix unit), GQA by reading kv-head
// h / (H / Hkv) with no copy, and an optional causal mask that skips key
// tiles wholly above the diagonal.  Outputs: O in the input dtype and the
// log-sum-exp as [B, H, Sq] f32 (no 128-lane broadcast).
//
// Bound on this card: at the serving path's prefill shapes (S = 128..1024,
// D = 64/128) the work is ~2*S*D flops per loaded K/V byte pair per q-tile,
// and the whole call moves Q, K, V and O once, so at short S it is bound by
// bytes and at long S by the tensor-core rate.  The design keeps the [S, S]
// score matrix out of device memory and reads K/V once per 64-row q-tile:
// one 128-thread block per (q-tile of 64 rows, q-head, batch) streams
// 64-key K/V tiles through shared memory (the TPU kernel instead held the
// kv-head's whole K/V in VMEM), each of the four warps owns 16 query rows,
// S = Q K^T and P V run on the tensor cores through WMMA (bf16 operands,
// f32 accumulation), and the softmax runs in f32 on a shared-memory copy of
// each warp's score tile.  Q/K/V/O are addressed through strides, so both
// the [B,S,H,D] and the [B,H,S,D] layouts are read without a transpose.
// TMA, wgmma and a pipelined K/V ring are left for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per streamed tile
constexpr int kWarps = 4;     // each warp owns 16 query rows
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;   // the TPU kernel's mask value

struct Strides {
  long long b, s, h;          // element strides; the head_dim stride is 1
};

template <int D>
struct Layout {
  static constexpr int kLdQ = D + 8;                  // bf16 row pitch of Q/K/V tiles
  static constexpr int kLdP = kBK + 8;                // bf16 row pitch of P
  static constexpr int kWide = D > kBK ? D : kBK;
  static constexpr int kLdS = kWide + 4;              // f32 row pitch of S / PV
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + sizeof(bf16) * kBQ * kLdQ;
  static constexpr size_t kV = kK + sizeof(bf16) * kBK * kLdQ;
  static constexpr size_t kS = kV + sizeof(bf16) * kBK * kLdQ;
  static constexpr size_t kP = kS + sizeof(float) * kBQ * kLdS;
  static constexpr size_t kBytes = kP + sizeof(bf16) * kBQ * kLdP;
};

// Copy rows [row0, row0 + 64) of one head into a padded bf16 tile, 16 bytes
// per thread per step, zero-filling rows past `rows`.  With kScale each
// element becomes bf16(float(x) * scale), the TPU kernel's rounding of
// q * scale.
template <int D, bool kScale>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long row_stride,
                                          int row0, int rows, float scale) {
  constexpr int kVecs = D / 8;
  for (int i = threadIdx.x; i < 64 * kVecs; i += kThreads) {
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
    *reinterpret_cast<uint4*>(dst + r * Layout<D>::kLdQ + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int H, int Hkv, int Sq, int Sk,
                 Strides qs, Strides ks, Strides vs, Strides os,
                 float scale, int causal) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::kQ);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::kK);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::kV);
  float* sS = reinterpret_cast<float*>(smem + L::kS);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::kP);

  // heaviest causal tiles (the last q rows) first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;

  load_tile<D, true>(sQ, qb, qs.s, q0, Sq, scale);
  __syncthreads();

  // this warp's 16 query rows as tensor-core operands, kept for every tile
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(qf[kk], sQ + warp * 16 * L::kLdQ + kk * 16, L::kLdQ);
  }

  // softmax / accumulator ownership: lane -> row r of the warp's 16 rows,
  // half of the columns (two lanes per row)
  const int r = lane >> 1;
  const int half = lane & 1;
  const int q_pos = q0 + warp * 16 + r;
  float* sSw = sS + warp * 16 * L::kLdS;
  bf16* sPw = sP + warp * 16 * L::kLdP;

  float m = kNegInf;
  float l = 0.f;
  float acc[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;

  int n_tiles = (Sk + kBK - 1) / kBK;
  if (causal) {
    // tile j is live iff its first key <= the block's last query row
    const int last_q = min(q0 + kBQ, Sq) - 1;
    n_tiles = min(n_tiles, last_q / kBK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                       // previous tile fully consumed
    load_tile<D, false>(sK, kb, ks.s, k0, Sk, 0.f);
    load_tile<D, false>(sV, vb, vs.s, k0, Sk, 0.f);
    __syncthreads();

    // S = (q * scale) K^T for this warp's rows: [16, 64] f32
#pragma unroll
    for (int n = 0; n < kBK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sK + n * 16 * L::kLdQ + kk * 16, L::kLdQ);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(sSw + n * 16, sf, L::kLdS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax on this lane's 32 scores of row r
    float s_loc[kBK / 2];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) {
      const int col = half * (kBK / 2) + j;
      const int k_pos = k0 + col;
      float s = sSw[r * L::kLdS + col];
      if (k_pos >= Sk || (causal && q_pos < k_pos)) s = kNegInf;
      s_loc[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) {
      const float p = expf(s_loc[j] - m_new);
      sum += p;
      sPw[r * L::kLdP + half * (kBK / 2) + j] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = expf(m - m_new);
    l = alpha * l + sum;
    m = m_new;
    __syncwarp();

    // PV = bf16(P) V for this warp's rows: [16, D] f32, staged through sS
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::fill_fragment(of, 0.f);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, sPw + kk * 16, L::kLdP);
        wmma::load_matrix_sync(vf, sV + kk * 16 * L::kLdQ + n * 16, L::kLdQ);
        wmma::mma_sync(of, pf, vf, of);
      }
      wmma::store_matrix_sync(sSw + n * 16, of, L::kLdS, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < D / 2; ++j) {
      acc[j] = acc[j] * alpha + sSw[r * L::kLdS + half * (D / 2) + j];
    }
    __syncwarp();
  }

  if (q_pos < Sq) {
    const float inv_l = 1.f / l;
    bf16* orow = o + b * os.b + (long long)q_pos * os.s + h * os.h + half * (D / 2);
#pragma unroll
    for (int j = 0; j < D / 2; j += 8) {
      uint4 pack;
      bf16* e = reinterpret_cast<bf16*>(&pack);
#pragma unroll
      for (int u = 0; u < 8; ++u) e[u] = __float2bfloat16(acc[j + u] * inv_l);
      *reinterpret_cast<uint4*>(orow + j) = pack;
    }
    if (half == 0) {
      lse[((long long)b * H + h) * Sq + q_pos] = m + logf(l);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int Hkv, int Sq, int Sk, Strides qs, Strides ks,
           Strides vs, Strides os, float scale, int causal, cudaStream_t stream) {
  constexpr size_t kSmem = Layout<D>::kBytes;
  // above 48 KB of dynamic shared memory needs the opt-in (per device)
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), H, Hkv, Sq, Sk, qs, ks, vs, os, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: [B, Sq, H, D]-shaped view given by element strides (batch, seq, head;
// the head_dim stride must be 1); k/v likewise with Hkv heads and Sk rows;
// o has q's shape with its own strides; lse is contiguous [B, H, Sq] f32.
// bf16 only; D in {64, 128}; every stride and pointer 16-byte aligned.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int tpunet_flash_fwd(const void* q, const void* k, const void* v, void* o,
                                void* lse, int B, int H, int Hkv, int Sq, int Sk, int D,
                                long long q_sb, long long q_ss, long long q_sh,
                                long long k_sb, long long k_ss, long long k_sh,
                                long long v_sb, long long v_ss, long long v_sh,
                                long long o_sb, long long o_ss, long long o_sh,
                                float scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq <= 0 || Sk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh};
  const Strides vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, qs, ks, vs, os, scale, causal, s);
    case 128:
      return launch<128>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, qs, ks, vs, os, scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
