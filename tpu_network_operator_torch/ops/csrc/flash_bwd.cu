// Flash-attention dQ backward for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces: tpu_network_operator/ops/pallas_attention.py::_dq_kernel (the
// Pallas flash backward's dQ pass; its dK/dV pass is flash_bwd_dkv.cu).
// Same function, from the forward's f32 log-sum-exp (lse) and
// delta = rowsum(dO * O) (f32):
//   P  = exp(S - lse) with S = bf16(q * scale) K^T, masked causally (row i
//        sees key j iff i >= j) and by an optional sliding window (and
//        iff i - window < j; the key tiles below the band are skipped),
//   dP = dO V^T,  dS = P * (dP - delta),  dQ = scale * bf16(dS) K,
// with bf16 tensor-core operands and f32 accumulation; dQ in bf16, or in
// f32 for the ring seam's chunks.  GQA reads kv-head h / (H / Hkv) with no
// copy; both layouts are read through strides.
//
// Bound on this card: the tensor-core rate at the training shape (three
// products per q-tile / key-tile pair: at S 2048, D 64 about 3 * 64 flops
// per byte of K and V loaded per 128-row q tile, and each K/V tile is
// loaded once per q tile).  Design, the forward's (flash_fwd.cu) with a
// second product and no online max:
//
// * a persistent grid: one block of three warpgroups per SM walks the
//   128-row q tiles of every (batch, q-head), each head's heaviest causal
//   tile first (hopper.cuh's walk, shared with the forward).  Warpgroups 0
//   and 1 each own 64 q rows; one thread of warpgroup 2 (the producer)
//   issues every TMA load;
// * Q and dO of a q tile arrive by TMA into one of two slots, so the next
//   tile's load runs under this one's products; each consumer rounds its
//   own Q rows to bf16(q * scale) in place and loads its rows' lse and
//   delta into registers (plain loads: the rows of any Sq);
// * 64-key K and V tiles stream by TMA (128-byte swizzle) through a ring
//   of shared-memory stages (6 at D 64, 3 at D 128) under full / empty
//   mbarriers, only the causally live ones;
// * per key tile three wgmma chains: S = Q K^T and dP = dO V^T (operands
//   from shared memory, K and V read K-major), then dQ += bf16(dS) K with
//   dS packed in registers as the A operand and the same K stage read
//   MN-major (no transposed copy).  P and dS are computed from the
//   accumulator registers (exp2 with log2 e folded in, the mask on the
//   diagonal and ragged tiles only): S, dP and dS never reach shared
//   memory, and dQ stays in registers over the whole key loop;
// * each warpgroup overlaps its elementwise work with its own products:
//   step j issues S and dP of tile j and then dQ of tile j - 1, waits for
//   S and dP only, and computes dS of tile j while dQ of tile j - 1 runs
//   (two packed dS arrays in turn);
// * the epilogue scales dQ, stages it over the warpgroup's own Q rows (and
//   its dO rows for f32) and writes 16-byte rows; rows past Sq are not
//   written.
//
// Registers per consumer thread: S and dP of a 64-key tile (32 f32 each),
// dQ (D / 2) and two packed dS arrays (16 each).  128-key tiles at D 64
// (64 f32 each for S and dP) left too few registers for the second dS
// array: ptxas serialized every wgmma (C7512) and spilled 296 bytes; run
// in order with one dS array they were no faster than 64-key tiles on an
// H100 (PERF.md).  The producer gives registers up to the consumers
// (setmaxnreg).  No atomics: a repeat gives the same bits.

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kBQ = 128;           // q rows per work item (two warpgroups of 64)
constexpr int kBK = 64;            // keys per streamed K/V tile
constexpr int kThreads = 384;      // two consumer warpgroups + one producer
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;  // element strides; the head_dim stride is 1
};

template <int D>
struct Smem {
  static constexpr int kQSlots = 2;               // Q + dO of two work items
  static constexpr int kQPanel = kBQ * 128;       // bytes of one 64-column panel of Q
  static constexpr int kKVPanel = kBK * 128;      // ... of a K or V tile
  static constexpr int kQTile = kQPanel * (D / 64);
  static constexpr int kKVTile = kKVPanel * (D / 64);
  static constexpr int kSlot = 2 * kQTile;        // a slot: the Q tile, then dO's
  // the K/V ring: 96 KB, 6 stages deep at D 64 and 3 at D 128
  static constexpr int kStages = 96 * 1024 / (2 * kKVTile);
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQSlots * kSlot;
  static constexpr int kV = kK + kStages * kKVTile;
  // full[kStages], empty[kStages], q_full[kQSlots], q_empty[kQSlots]
  static constexpr int kBars = kV + kStages * kKVTile;
  static constexpr int kUsed = kBars + 8 * (2 * kStages + 2 * kQSlots);
  static constexpr int kBytes = kUsed + 1024;
  static_assert(kBytes <= 232448, "more shared memory than a block may have");
  // one block per SM: the register split of setmaxnreg below assumes it
  static_assert(kUsed > 232448 / 2, "two blocks would fit on an SM");
};

// acc = A B^T of one tile, [64, kBK] f32: A the warpgroup's 64 rows of
// the Q (or dO) tile, B the K (or V) tile, both K-major
template <int D>
__device__ __forceinline__ void issue_rows_keys(float (&acc)[kBK / 2], uint32_t rows,
                                                uint32_t tile) {
  using L = Smem<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss_n64(acc, desc_k(rows, L::kQPanel, kk), desc_k(tile, L::kKVPanel, kk), kk > 0);
  }
}

// dQ += bf16(dS) K of one tile: dS from registers as the A operand, the K
// stage read MN-major
template <int D>
__device__ __forceinline__ void issue_dq(float (&dq)[D / 2], const uint32_t (&ds)[kBK / 4],
                                         uint32_t k_tile) {
  using L = Smem<D>;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    if constexpr (D == 64) {
      wgmma_rs_n64(dq, ds + 4 * kk, desc_mn(k_tile, L::kKVPanel, kk));
    } else {
      wgmma_rs_n128(dq, ds + 4 * kk, desc_mn(k_tile, L::kKVPanel, kk));
    }
  }
}

// what the mask needs: the block's first query row, this thread's first
// row (its second is 8 below), its lane, Sk, causality and the window
// (0: none)
struct Rows {
  int q0, row, lane, Sk, causal, window;
};

// dS = P (dP - delta) of keys [k0, k0 + N) with P = exp(S - lse), from S
// and dP, which it only reads (ptxas serializes wgmmas around registers
// that other instructions write while one runs), packed to bf16 pairs as
// the A fragments of dQ += dS K.  nlse: this thread's two rows' -lse *
// log2 e; delta: theirs.  kMask: the tile may hold a key past Sk, above
// the diagonal or below the window's band; kWindow: the kernel takes a
// window (a separate instantiation: the causal kernel's code is the one it
// had without windows).
template <bool kMask, bool kWindow, int N>
__device__ __forceinline__ void ds_tile(const float (&sc)[N / 2], const float (&dp)[N / 2],
                                        uint32_t (&ds)[N / 4], const float (&nlse)[2],
                                        const float (&delta)[2], const Rows& rows, int k0) {
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int r = (i / 2) % 2;
    float p[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      p[e] = ex2_approx(fmaf(sc[i + e], kLog2e, nlse[r]));
      if constexpr (kMask) {
        const int col = k0 + (i / 4) * 8 + (rows.lane % 4) * 2 + e;
        const int row = rows.row + 8 * r;
        if (col >= rows.Sk || (rows.causal && col > row) ||
            (kWindow && col <= row - rows.window)) {
          p[e] = 0.f;
        }
      }
    }
    ds[i / 2] = pack_bf16(p[0] * (dp[i] - delta[r]), p[1] * (dp[i + 1] - delta[r]));
  }
}

template <bool kWindow, int N>
__device__ __forceinline__ void tile_ds(const float (&sc)[N / 2], const float (&dp)[N / 2],
                                        uint32_t (&ds)[N / 4], const float (&nlse)[2],
                                        const float (&delta)[2], const Rows& rows, int k0) {
  // the block's first row, not the warpgroup's: a branch on a value the
  // same in every thread of the block keeps ptxas from serializing the
  // wgmmas that run across it (a tile is unmasked iff its last key is at
  // most the block's first row, so both warpgroups take the same branch;
  // under a window, iff also its first key is in the band of the block's
  // last row)
  if (k0 + N > rows.Sk || (rows.causal && k0 + N - 1 > rows.q0) ||
      (kWindow && k0 <= rows.q0 + kBQ - 1 - rows.window)) {
    ds_tile<true, kWindow, N>(sc, dp, ds, nlse, delta, rows, k0);
  } else {
    ds_tile<false, kWindow, N>(sc, dp, ds, nlse, delta, rows, k0);
  }
}

template <int D, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    void* __restrict__ dq, int B, int H, int Hkv, int Sq, int Sk, Strides dqs,
                    float scale, int causal, int window, int out_f32) {
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

  // Q and dO take the slots in turn and K/V tiles run through one ring for
  // all of a block's items, so the producer loads the next item's Q, dO
  // and first K/V tiles while the consumers finish this one.
  if (threadIdx.x >= 256) {
    // ---- producer warpgroup: one thread issues every load
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      int kv = 0;  // K/V tiles loaded so far: the ring's running count
      for (int n = 0; item_of(n, blockIdx.x, gridDim.x) < n_work; ++n) {
        const Work w = work_at(item_of(n, blockIdx.x, gridDim.x), H, B * H, n_qt);
        const int slot = n % L::kQSlots;
        const uint32_t q_dst = base + L::kQ + slot * L::kSlot;
        mbar_wait(bar_qempty + 8 * slot, ((n / L::kQSlots) & 1) ^ 1);
        mbar_expect_tx(bar_qfull + 8 * slot, 2 * kBQ * D * 2);
        tma_load_rows<D>(q_dst, &q_map, bar_qfull + 8 * slot, w.h, w.qt * kBQ, w.b, L::kQPanel);
        tma_load_rows<D>(q_dst + L::kQTile, &do_map, bar_qfull + 8 * slot, w.h, w.qt * kBQ, w.b,
                         L::kQPanel);
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
      const int q_off = L::kQ + slot * L::kSlot;  // this item's slot: Q, then dO
      const uint32_t q_rows = base + q_off + wg * 64 * 128;
      const uint32_t do_rows = q_rows + L::kQTile;

      // this thread's rows' -lse * log2 e and delta; rows past Sq take 0,
      // so their zero Q and dO rows give dS = 0
      float nlse[2], dlt[2];
      const long long stat = ((long long)w.b * H + w.h) * Sq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = wq0 + row_a + 8 * r;
        nlse[r] = q < Sq ? -lse[stat + q] * kLog2e : 0.f;
        dlt[r] = q < Sq ? delta[stat + q] : 0.f;
      }

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

      float dq_acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
      float sc[kBK / 2], dp[kBK / 2];  // S and dP of the newest tile
      const Rows rows{q0, wq0 + row_a, lane, Sk, causal, window};
      auto k_tile = [&](int i) { return base + L::kK + ((kv + i) % kStages) * L::kKVTile; };
      auto v_tile = [&](int i) { return base + L::kV + ((kv + i) % kStages) * L::kKVTile; };

      // tile 0: S and dP
      mbar_wait(bar_full + 8 * (kv % kStages), (kv / kStages) & 1);
      wgmma_fence();
      issue_rows_keys<D>(sc, q_rows, k_tile(0));
      issue_rows_keys<D>(dp, do_rows, v_tile(0));
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sc);
      reg_fence(dp);
      // bf16(dS) of two tiles in turn: dQ += dS K reads one while the
      // next tile's dS is written into the other.  Two arrays, not one
      // and a copy: a copy lets the compiler give both the same
      // registers, which ptxas then protects by serializing every wgmma
      uint32_t da[kBK / 4], db[kBK / 4];
      tile_ds<kWindow, kBK>(sc, dp, da, nlse, dlt, rows, j0 * kBK);

      // step `it` issues S and dP of tile it and then dQ of tile it - 1
      // (dS in ds_run), waits for S and dP only, and computes dS of tile
      // it into ds_next while dQ still runs
      auto step = [&](int it, const uint32_t(&ds_run)[kBK / 4], uint32_t(&ds_next)[kBK / 4]) {
        mbar_wait(bar_full + 8 * ((kv + it) % kStages), ((kv + it) / kStages) & 1);
        wgmma_fence();
        issue_rows_keys<D>(sc, q_rows, k_tile(it));
        issue_rows_keys<D>(dp, do_rows, v_tile(it));
        wgmma_commit();
        issue_dq<D>(dq_acc, ds_run, k_tile(it - 1));
        wgmma_commit();
        wgmma_wait<1>();
        reg_fence(sc);
        reg_fence(dp);
        tile_ds<kWindow, kBK>(sc, dp, ds_next, nlse, dlt, rows, (j0 + it) * kBK);
        wgmma_wait_all();
        reg_fence(dq_acc);
        mbar_arrive(bar_empty + 8 * ((kv + it - 1) % kStages));  // tile it - 1 is done
      };
      int it = 1;
      for (; it + 1 < nk; it += 2) {
        step(it, da, db);
        step(it + 1, db, da);
      }
      const bool last_in_b = it < nk;
      if (last_in_b) step(it, da, db);

      // dQ of the last tile
      wgmma_fence();
      if (last_in_b) {
        issue_dq<D>(dq_acc, db, k_tile(nk - 1));
      } else {
        issue_dq<D>(dq_acc, da, k_tile(nk - 1));
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(dq_acc);
      mbar_arrive(bar_empty + 8 * ((kv + nk - 1) % kStages));
      kv += nk;

      // epilogue: dQ * scale staged over this warpgroup's rows of the slot
      // (bf16: its Q rows; f32, twice the bytes: its Q rows, then its dO
      // rows, 32 columns to a 128-byte panel row), then 16-byte rows to
      // device memory
#pragma unroll
      for (int i = 0; i < D / 2; i += 2) {
        const int col = (i / 4) * 8 + (lane % 4) * 2;
        const int row = (wg * 64 + row_a + 8 * ((i / 2) % 2)) * 128;
        if (out_f32) {
          *reinterpret_cast<float2*>(smem + q_off + (col / 32) * L::kQPanel + row +
                                     (col % 32) * 4) =
              make_float2(dq_acc[i] * scale, dq_acc[i + 1] * scale);
        } else {
          *reinterpret_cast<uint32_t*>(smem + q_off + (col / 64) * L::kQPanel + row +
                                       (col % 64) * 2) =
              pack_bf16(dq_acc[i] * scale, dq_acc[i + 1] * scale);
        }
      }
      named_barrier(1 + wg, 128);
      const int chunks = out_f32 ? D / 4 : D / 8;  // 16-byte chunks of a row
      const long long head = w.b * dqs.b + w.h * dqs.h;
      for (int i = t; i < 64 * chunks; i += 128) {
        const int row = i / chunks;
        const int c = i % chunks;
        const int q = wq0 + row;
        if (q < Sq) {
          const uint4 val = *reinterpret_cast<const uint4*>(
              smem + q_off + (c / 8) * L::kQPanel + (wg * 64 + row) * 128 + (c % 8) * 16);
          const long long at = head + (long long)q * dqs.s;
          if (out_f32) {
            *reinterpret_cast<uint4*>(static_cast<float*>(dq) + at + c * 4) = val;
          } else {
            *reinterpret_cast<uint4*>(static_cast<bf16*>(dq) + at + c * 8) = val;
          }
        }
      }
      // the slot is free for a later item: order this thread's
      // shared-memory accesses before the TMA that overwrites them
      fence_proxy_async();
      mbar_arrive(bar_qempty + 8 * slot);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, int B, int H, int Hkv, int Sq, int Sk, Strides qs,
           Strides ks, Strides vs, Strides dos, Strides dqs, float scale, int causal,
           int window, int out_f32, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, do_map;
  if (!encode_rows_map(&q_map, q, D, H, Sq, B, qs.b, qs.s, qs.h, kBQ) ||
      !encode_rows_map(&do_map, dout, D, H, Sq, B, dos.b, dos.s, dos.h, kBQ) ||
      !encode_rows_map(&k_map, k, D, Hkv, Sk, B, ks.b, ks.s, ks.h, kBK) ||
      !encode_rows_map(&v_map, v, D, Hkv, Sk, B, vs.b, vs.s, vs.h, kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kSmem = Smem<D>::kBytes;
  const auto kernel = window ? flash_bwd_dq_kernel<D, true> : flash_bwd_dq_kernel<D, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int grid = 0;
  err = persistent_grid((long long)((Sq + kBQ - 1) / kBQ) * B * H, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), dq, B, H, Hkv, Sq, Sk, dqs, scale, causal, window,
      out_f32);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dout: [B, Sq, H, D]-shaped views given by element strides (batch,
// seq, head; the head_dim stride must be 1); k, v likewise with Hkv heads
// and Sk rows; lse and delta contiguous [B, H, Sq] f32; dq has q's shape
// with its own strides, f32 if out_f32 else bf16; window 0, or the sliding
// window's keys (causal only).  bf16 inputs only; D in {64, 128}; every
// stride and pointer 16-byte aligned.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int tpunet_flash_bwd_dq(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dq, int B, int H, int Hkv, int Sq, int Sk, int D,
                                   long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss, long long v_sh,
                                   long long do_sb, long long do_ss, long long do_sh,
                                   long long dq_sb, long long dq_ss, long long dq_sh,
                                   float scale, int causal, int window, int out_f32,
                                   void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq <= 0 || Sk <= 0 || window < 0 ||
      (window && !causal)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const Strides dos{do_sb, do_ss, do_sh}, dqs{dq_sb, dq_ss, dq_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Sq, Sk, qs, ks, vs, dos, dqs,
                        scale, causal, window, out_f32, s);
    case 128:
      return launch<128>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Sq, Sk, qs, ks, vs, dos,
                         dqs, scale, causal, window, out_f32, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
