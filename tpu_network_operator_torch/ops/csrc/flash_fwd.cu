// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: tpu_network_operator/ops/pallas_attention.py::_fwd_kernel (the
// Pallas flash forward).  Same function: per (batch, q-head) an online
// softmax over key blocks with f32 running max / sum / accumulator, q*scale
// and the probabilities rounded to bf16 before their products (as the TPU
// kernel rounds them for its matrix unit), GQA by reading kv-head
// h / (H / Hkv) with no copy, and an optional causal mask that skips key
// tiles wholly above the diagonal, narrowed by an optional sliding window
// (row i sees key j iff i - window < j <= i) that skips the tiles wholly
// below the band too.  Outputs: O in bf16 and the log-sum-exp
// as [B, H, Sq] f32 (no 128-lane broadcast).
//
// Bound on this card: the tensor-core rate at the training shape (S 2048,
// 2 * 64 flops per loaded K/V byte pair per 128-row q tile), the bytes of
// Q, K, V and O at short prefills.  Design:
//
// * a persistent grid: one block of three warpgroups per SM walks the
//   128-row q tiles of every (batch, q-head), each head's heaviest causal
//   tile (the last q rows) first (hopper.cuh's walk, which the dQ kernel
//   shares).  Warpgroups 0 and 1 each own 64 query
//   rows, warpgroup 2 is the producer, one thread of which issues every
//   TMA load;
// * Q tiles arrive by TMA (into two slots in turn at D 64); each consumer
//   warpgroup rounds its own rows to bf16(q * scale) in place;
// * 128-key K and V tiles stream by TMA (128-byte swizzle) through a ring
//   of shared-memory stages under full / empty mbarriers, one ring for
//   all of a block's q tiles, so the next tiles (and the next q tile's Q
//   and first K/V) load while the current ones are multiplied and
//   written out;
// * S = Q K^T is one wgmma chain (m64n128k16, both operands from shared
//   memory) into registers; the online softmax runs on those registers
//   (row max and sum over the four threads that share a row, the mask on
//   the diagonal and ragged tiles only, exp2 with log2 e folded in);
// * P is packed to bf16 in registers and is the register A operand of
//   O += P V (m64nDk16, V read MN-major); O stays in registers;
// * each warpgroup overlaps its softmax with its own products: step j
//   issues S of tile j and then P V of tile j - 1, waits for S only, and
//   runs the softmax of tile j while P V still runs; O is rescaled once
//   P V is done;
// * the epilogue stages O / l through the warpgroup's own Q rows and
//   writes 16-byte rows; the LSE (natural units, m + log l) goes out
//   per row.
//
// The producer gives up registers (setmaxnreg) to the consumers, which
// hold S (64 f32), O (up to 64 f32) and the packed P of two tiles.
// Measured on an H100 and no faster: strict ping-pong between the two
// consumer warpgroups by named barriers (PERF.md).

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kBQ = 128;           // query rows per block (two warpgroups of 64)
constexpr int kBK = 128;           // keys per streamed K/V tile
constexpr int kThreads = 384;      // two consumer warpgroups + one producer
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBK == kBQ, "softmax_tile picks the masked tiles by the block's rows");

struct Strides {
  long long b, s, h;  // element strides; the head_dim stride is 1
};

template <int D>
struct Smem {
  static constexpr int kStages = 3;  // K/V ring depth
  // Q slots: at D 64 the next work item's Q loads while this one runs;
  // at D 128 a second slot would not fit beside the ring (227 KB)
  static constexpr int kQSlots = D == 64 ? 2 : 1;
  static constexpr int kQPanel = kBQ * 128;   // bytes of one 64-column panel of Q
  static constexpr int kKVPanel = kBK * 128;  // ... of a K or V tile
  static constexpr int kQTile = kQPanel * (D / 64);
  static constexpr int kKVTile = kKVPanel * (D / 64);
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQSlots * kQTile;
  static constexpr int kV = kK + kStages * kKVTile;
  // full[kStages], empty[kStages], q_full[kQSlots], q_empty[kQSlots]
  static constexpr int kBars = kV + kStages * kKVTile;
  static constexpr int kUsed = kBars + 8 * (2 * kStages + 2 * kQSlots);
  // one block per SM: the register split of setmaxnreg below assumes it
  static constexpr int kBytes = (kUsed > 120 * 1024 ? kUsed : 120 * 1024) + 1024;
};

// S = bf16(q * scale) K^T of one tile: [64, 128] f32 into registers
template <int D>
__device__ __forceinline__ void issue_s(float (&sc)[kBK / 2], uint32_t q_rows,
                                        uint32_t k_tile) {
  using L = Smem<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss_n128(sc, desc_k(q_rows, L::kQPanel, kk), desc_k(k_tile, L::kKVPanel, kk), kk > 0);
  }
}

// O += bf16(P) V of one tile: P from registers as the A operand, V MN-major
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[kBK / 4],
                                         uint32_t v_tile) {
  using L = Smem<D>;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    if constexpr (D == 64) {
      wgmma_rs_n64(o, pa + 4 * kk, desc_mn(v_tile, L::kKVPanel, kk));
    } else {
      wgmma_rs_n128(o, pa + 4 * kk, desc_mn(v_tile, L::kKVPanel, kk));
    }
  }
}

// what the mask needs: the block's first query row, this thread's first
// row (its second is 8 below), its lane, Sk, causality and the window
// (0: none)
struct Rows {
  int q0, row, lane, Sk, causal, window;
};

// The online softmax of keys [k0, k0 + kBK) from S in `sc`, which it only
// reads (ptxas serializes wgmmas around registers that other instructions
// write while one runs): the running max m and this thread's row sums l
// move on, alpha takes O to the new max, and P goes out packed to bf16.
// kMask: the tile may hold a key past Sk, above the diagonal or below the
// window's band (a row may then see no key of the tile; every row's
// diagonal key is live in a later tile or this one).  kWindow: the kernel
// takes a window (a separate instantiation, so the causal kernel's code is
// the one it had without windows).
template <bool kMask, bool kWindow>
__device__ __forceinline__ void softmax_tile(const float (&sc)[kBK / 2], uint32_t (&pa)[kBK / 4],
                                             float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             const Rows& rows, int k0) {
  auto val = [&](int i) {
    if constexpr (kMask) {
      const int col = k0 + (i / 4) * 8 + (rows.lane % 4) * 2 + (i % 2);
      const int row = rows.row + 8 * ((i / 2) % 2);
      if (col >= rows.Sk || (rows.causal && col > row) ||
          (kWindow && col <= row - rows.window)) {
        return kNegInf;
      }
    }
    return sc[i];
  };
  // rows rows.row (r = 0) and rows.row + 8 (r = 1), over the four threads
  // that share each
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], val(i));
  float neg_ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = ex2_approx((m[r] - m_new) * kLog2e);
    // a row with no live key yet: its masked keys take P = 0 (with the
    // max at -1e30, fmaf's unrounded product would leave them P = inf)
    neg_ms[r] = kWindow && kMask && m_new == kNegInf ? 0.f : -m_new * kLog2e;
    m[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kBK / 2; i += 2) {
    const int r = (i / 2) % 2;
    const float p0 = ex2_approx(fmaf(val(i), kLog2e, neg_ms[r]));
    const float p1 = ex2_approx(fmaf(val(i + 1), kLog2e, neg_ms[r]));
    sum[r] += p0;
    sum[r] += p1;
    pa[i / 2] = pack_bf16(p0, p1);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + sum[r];
}

template <bool kWindow>
__device__ __forceinline__ void softmax_tile(const float (&sc)[kBK / 2], uint32_t (&pa)[kBK / 4],
                                             float (&m)[2], float (&l)[2], float (&alpha)[2],
                                             const Rows& rows, int k0) {
  // the block's first row, not the warpgroup's: both pick the same tiles
  // (kBK == kBQ), and a branch on a value the same in every thread of the
  // block keeps ptxas from serializing the wgmmas that run across it
  if (k0 + kBK > rows.Sk || (rows.causal && k0 + kBK - 1 > rows.q0) ||
      (kWindow && k0 <= rows.q0 + kBQ - 1 - rows.window)) {
    softmax_tile<true, kWindow>(sc, pa, m, l, alpha, rows, k0);
  } else {
    softmax_tile<false, kWindow>(sc, pa, m, l, alpha, rows, k0);
  }
}

template <int D, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o,
                 float* __restrict__ lse, int B, int H, int Hkv, int Sq, int Sk, Strides os,
                 float scale, int causal, int window) {
  using L = Smem<D>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_addr(smem);
  const uint32_t bar_full = base + L::kBars;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const uint32_t bar_qfull = bar_empty + 8 * kStages;
  const uint32_t bar_qempty = bar_qfull + 8 * L::kQSlots;

  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int n_work = n_qt * B * H;
  const int n_rep = H / Hkv;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 256);
    }
    for (int slot = 0; slot < L::kQSlots; ++slot) {
      mbar_init(bar_qfull + 8 * slot, 1);
      mbar_init(bar_qempty + 8 * slot, 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // Q tiles take the Q slots in turn and K/V tiles run through one ring
  // for all of a block's items, so the producer loads the next item's
  // first K/V tiles (and at D 64 its Q) while the consumers finish this
  // one and write it out.
  if (threadIdx.x >= 256) {
    // ---- producer warpgroup: one thread issues every load
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      int kv = 0;  // K/V tiles loaded so far: the ring's running count
      for (int n = 0; item_of(n, blockIdx.x, gridDim.x) < n_work; ++n) {
        const Work w = work_at(item_of(n, blockIdx.x, gridDim.x), H, B * H, n_qt);
        const int slot = n % L::kQSlots;
        mbar_wait(bar_qempty + 8 * slot, ((n / L::kQSlots) & 1) ^ 1);
        mbar_expect_tx(bar_qfull + 8 * slot, kBQ * D * 2);
        tma_load_rows<D>(base + L::kQ + slot * L::kQTile, &q_map, bar_qfull + 8 * slot, w.h,
                         w.qt * kBQ, w.b, L::kQPanel);
        const int j0 = kWindow ? kv_first<kBK>(w.qt * kBQ, window) : 0;
        const int nk = kv_tiles<kBQ, kBK>(w.qt * kBQ, Sq, Sk, causal) - j0;
        for (int j = j0; j < j0 + nk; ++j, ++kv) {
          const int s = kv % kStages;
          mbar_wait(bar_empty + 8 * s, ((kv / kStages) & 1) ^ 1);
          mbar_expect_tx(bar_full + 8 * s, 2 * kBK * D * 2);
          tma_load_rows<D>(base + L::kK + s * L::kKVTile, &k_map, bar_full + 8 * s,
                           w.h / n_rep, j * kBK, w.b, L::kKVPanel);
          tma_load_rows<D>(base + L::kV + s * L::kKVTile, &v_map, bar_full + 8 * s,
                           w.h / n_rep, j * kBK, w.b, L::kKVPanel);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each
    setmaxnreg_inc<240>();
    const int wg = threadIdx.x / 128;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int row_a = (t / 32) * 16 + lane / 4;  // this thread's rows: row_a, row_a + 8
    int kv = 0;  // K/V tiles consumed so far

    for (int n = 0; item_of(n, blockIdx.x, gridDim.x) < n_work; ++n) {
      const Work w = work_at(item_of(n, blockIdx.x, gridDim.x), H, B * H, n_qt);
      const int slot = n % L::kQSlots;
      const int q0 = w.qt * kBQ;
      const int wq0 = q0 + wg * 64;
      const int j0 = kWindow ? kv_first<kBK>(q0, window) : 0;  // the first key tile
      const int nk = kv_tiles<kBQ, kBK>(q0, Sq, Sk, causal) - j0;
      const int q_off = L::kQ + slot * L::kQTile;  // this item's Q slot
      const uint32_t q_rows = base + q_off + wg * 64 * 128;

      // bf16(q * scale) in place over this warpgroup's rows, 16 bytes a step
      mbar_wait(bar_qfull + 8 * slot, (n / L::kQSlots) & 1);
      for (int i = t; i < 64 * (D / 8); i += 128) {
        const int p = i / 512;
        uint4* ptr = reinterpret_cast<uint4*>(smem + q_off + p * L::kQPanel + wg * 64 * 128 +
                                              (i % 512) * 16);
        uint4 val = *ptr;
        bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
        *ptr = val;
      }
      fence_proxy_async();
      named_barrier(1 + wg, 128);

      float o_acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
      float m[2] = {kNegInf, kNegInf};
      float l[2] = {0.f, 0.f};  // this thread's partial row sums
      float alpha[2];
      float sc[kBK / 2];  // S of the newest tile, read only by the softmax
      // bf16(P) of two tiles in turn: P V reads one while the softmax of
      // the next tile writes the other.  Two arrays, not one and a copy: a
      // copy lets the compiler give both the same registers, which ptxas
      // then protects by serializing every wgmma
      uint32_t pa[kBK / 4], pb[kBK / 4];
      const Rows rows{q0, wq0 + row_a, lane, Sk, causal, window};

      // tile 0: S and its softmax
      mbar_wait(bar_full + 8 * (kv % kStages), (kv / kStages) & 1);
      wgmma_fence();
      issue_s<D>(sc, q_rows, base + L::kK + (kv % kStages) * L::kKVTile);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sc);
      softmax_tile<kWindow>(sc, pa, m, l, alpha, rows, j0 * kBK);

      // step `it` issues S of tile it and then P V of tile it - 1 (P in
      // p_run), waits for S only, and runs the softmax of tile it into
      // p_next while P V still runs; then O, which holds every tile before
      // this one, takes this tile's max
      auto step = [&](int it, const uint32_t(&p_run)[kBK / 4], uint32_t(&p_next)[kBK / 4]) {
        const int s = (kv + it) % kStages;
        const int sp = (kv + it - 1) % kStages;
        mbar_wait(bar_full + 8 * s, ((kv + it) / kStages) & 1);
        wgmma_fence();
        issue_s<D>(sc, q_rows, base + L::kK + s * L::kKVTile);
        wgmma_commit();
        issue_pv<D>(o_acc, p_run, base + L::kV + sp * L::kKVTile);
        wgmma_commit();
        wgmma_wait<1>();
        reg_fence(sc);
        softmax_tile<kWindow>(sc, p_next, m, l, alpha, rows, (j0 + it) * kBK);
        wgmma_wait_all();
        reg_fence(o_acc);
        mbar_arrive(bar_empty + 8 * sp);  // tile it - 1's K and V stage is free
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o_acc[i] *= alpha[(i / 2) % 2];
      };
      int it = 1;
      for (; it + 1 < nk; it += 2) {
        step(it, pa, pb);
        step(it + 1, pb, pa);
      }
      const bool last_in_b = it < nk;
      if (last_in_b) step(it, pa, pb);

      // P V of the last tile
      const int sl = (kv + nk - 1) % kStages;
      wgmma_fence();
      if (last_in_b) {
        issue_pv<D>(o_acc, pb, base + L::kV + sl * L::kKVTile);
      } else {
        issue_pv<D>(o_acc, pa, base + L::kV + sl * L::kKVTile);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(o_acc);
      mbar_arrive(bar_empty + 8 * sl);
      kv += nk;

      // epilogue: O / l as bf16 staged over this warpgroup's Q rows, then
      // 16-byte rows to device memory; the LSE per row
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
      const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
      for (int i = 0; i < D / 2; i += 2) {
        const int r = (i / 2) % 2;
        const int col = (i / 4) * 8 + (lane % 4) * 2;
        const int row = wg * 64 + row_a + 8 * r;
        *reinterpret_cast<uint32_t*>(smem + q_off + (col / 64) * L::kQPanel + row * 128 +
                                     (col % 64) * 2) =
            pack_bf16(o_acc[i] * inv[r], o_acc[i + 1] * inv[r]);
      }
      named_barrier(1 + wg, 128);
      for (int i = t; i < 64 * (D / 8); i += 128) {
        const int row = i / (D / 8);
        const int c8 = i % (D / 8);
        const int q = wq0 + row;
        if (q < Sq) {
          const uint4 val = *reinterpret_cast<const uint4*>(
              smem + q_off + (c8 / 8) * L::kQPanel + (wg * 64 + row) * 128 + (c8 % 8) * 16);
          *reinterpret_cast<uint4*>(o + w.b * os.b + (long long)q * os.s + w.h * os.h +
                                    c8 * 8) = val;
        }
      }
      if (lane % 4 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int q = wq0 + row_a + 8 * r;
          if (q < Sq) lse[((long long)w.b * H + w.h) * Sq + q] = m[r] + logf(l[r]);
        }
      }
      // the Q slot is free for a later item: order this thread's
      // shared-memory writes before the TMA that overwrites them
      fence_proxy_async();
      mbar_arrive(bar_qempty + 8 * slot);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int H,
           int Hkv, int Sq, int Sk, Strides qs, Strides ks, Strides vs, Strides os,
           float scale, int causal, int window, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  if (!encode_rows_map(&q_map, q, D, H, Sq, B, qs.b, qs.s, qs.h, kBQ) ||
      !encode_rows_map(&k_map, k, D, Hkv, Sk, B, ks.b, ks.s, ks.h, kBK) ||
      !encode_rows_map(&v_map, v, D, Hkv, Sk, B, vs.b, vs.s, vs.h, kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kSmem = Smem<D>::kBytes;
  const auto kernel = window ? flash_fwd_kernel<D, true> : flash_fwd_kernel<D, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int grid = 0;
  err = persistent_grid((long long)((Sq + kBQ - 1) / kBQ) * B * H, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<bf16*>(o), static_cast<float*>(lse), B, H, Hkv, Sq, Sk,
      os, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: [B, Sq, H, D]-shaped view given by element strides (batch, seq, head;
// the head_dim stride must be 1); k/v likewise with Hkv heads and Sk rows;
// o has q's shape with its own strides; lse is contiguous [B, H, Sq] f32.
// window: 0, or the sliding window's keys (causal only).  bf16 only; D in
// {64, 128}; every stride and pointer 16-byte aligned.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int tpunet_flash_fwd(const void* q, const void* k, const void* v, void* o,
                                void* lse, int B, int H, int Hkv, int Sq, int Sk, int D,
                                long long q_sb, long long q_ss, long long q_sh,
                                long long k_sb, long long k_ss, long long k_sh,
                                long long v_sb, long long v_ss, long long v_sh,
                                long long o_sb, long long o_ss, long long o_sh,
                                float scale, int causal, int window, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq <= 0 || Sk <= 0 || window < 0 ||
      (window && !causal)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh};
  const Strides vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, qs, ks, vs, os, scale, causal, window,
                        s);
    case 128:
      return launch<128>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, qs, ks, vs, os, scale, causal, window,
                         s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
