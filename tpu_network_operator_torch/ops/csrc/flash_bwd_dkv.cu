// Flash-attention dK/dV backward for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces: tpu_network_operator/ops/pallas_attention.py::_dkv_kernel.
// Same function, from the forward's f32 log-sum-exp (lse) and
// delta = rowsum(dO * O) (f32), for each key:
//   P^T = exp(S^T - lse) with S^T = K bf16(q * scale)^T (masked causally,
//   and by an optional sliding window: query i sees key j iff
//   i - window < j; each key tile's walk ends at the last q tile of its
//   band),
//   dP^T = V dO^T,  dS^T = P^T * (dP^T - delta),
//   dV = sum bf16(P^T) dO,  dK = sum bf16(dS^T) bf16(q * scale),
// with bf16 tensor-core operands and f32 accumulation.  The sums run over
// the n_rep q-heads of the kv-head's GQA group in a fixed order, inside the
// kernel: the TPU path writes per-q-head f32 partials and group-sums them
// outside, which this kernel never writes.  No atomics, so a repeat gives
// the same bits.
//
// Bound on this card: the tensor-core rate (four products per q-tile / key-
// tile pair; at S 2048, D 64 far more flops than bytes).  Design:
//
// * one block of three warpgroups per 128-key tile of one kv-head:
//   warpgroups 0 and 1 each own 64 keys, warpgroup 2 is the producer.
//   The grid runs over (kv-head, batch) first, so key tile 0, which every
//   q tile sees under the causal mask, launches first for every head;
// * K and V of the block's keys arrive once by TMA and stay in shared
//   memory; dK and dV stay in the consumers' accumulator registers over
//   the whole group and every q tile;
// * 64-row Q and dO tiles stream by TMA (128-byte swizzle) through a ring
//   of kStages stages.  The producer warpgroup rounds each Q tile in place
//   to bf16(q * scale) and loads its lse (times log2 e) and delta rows
//   beside it (plain loads: any Sq, any alignment), then marks the stage
//   ready; consumers release it through an empty mbarrier;
// * per step: S^T and dP^T by wgmma (m64n64k16, operands from shared
//   memory), P^T and dS^T from those registers (the mask on diagonal and
//   ragged steps only), packed to bf16, then dV += bf16(P^T) dO and
//   dK += bf16(dS^T) Q by wgmma with the packed registers as A and the dO
//   or Q stage read MN-major;
// * at D 64 each warpgroup overlaps its elementwise work with its own
//   products: step i issues S^T and dP^T of step i and then dV and dK of
//   step i - 1, waits for the first two only, and computes P^T and dS^T
//   while dV and dK still run.  D 128 has no registers for the fragments
//   of a second step and runs the four products of a step in order;
// * the producer gives up registers (setmaxnreg) to the consumers, which
//   hold dK and dV (2 x D / 2 f32) beside S^T and dP^T.
//
// Measured on an H100 and no faster: strict ping-pong between the two
// consumer warpgroups by named barriers (PERF.md).

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kBK = 128;       // keys per block (two warpgroups of 64)
constexpr int kBQ = 64;        // query rows per streamed step
constexpr int kStages = 4;     // Q / dO ring depth
constexpr int kThreads = 384;  // two consumer warpgroups + one producer
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;  // element strides; the head_dim stride is 1
};

template <int D>
struct Smem {
  static constexpr int kKVPanel = kBK * 128;  // bytes of one 64-column panel of K or V
  static constexpr int kQPanel = kBQ * 128;   // ... of a Q or dO step tile
  static constexpr int kQTile = kQPanel * (D / 64);
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKVPanel * (D / 64);
  static constexpr int kQ = kV + kKVPanel * (D / 64);  // kStages Q tiles
  static constexpr int kDO = kQ + kStages * kQTile;    // kStages dO tiles
  static constexpr int kStats = kDO + kStages * kQTile;  // per stage: lse[64], delta[64]
  static constexpr int kBars = kStats + kStages * 2 * kBQ * 4;
  // kv, loaded[kStages], ready[kStages], empty[kStages]
  static constexpr int kUsed = kBars + 8 * (1 + 3 * kStages);
  // one block per SM: the register split of setmaxnreg below assumes it
  static constexpr int kBytes = (kUsed > 120 * 1024 ? kUsed : 120 * 1024) + 1024;
};

template <int D>
__device__ __forceinline__ void store_rows(void* dst, const Strides& st, int b, int hk, int key,
                                           int Sk, int lane, const float (&acc)[D / 2],
                                           int out_f32) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int k = key + 8 * r;
    if (k >= Sk) continue;
    const long long row = b * st.b + (long long)k * st.s + hk * st.h;
#pragma unroll
    for (int i = 2 * r; i < D / 2; i += 4) {
      const int col = (i / 4) * 8 + (lane % 4) * 2;
      if (out_f32) {
        *reinterpret_cast<float2*>(static_cast<float*>(dst) + row + col) =
            make_float2(acc[i], acc[i + 1]);
      } else {
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(dst) + row + col) =
            pack_bf16(acc[i], acc[i + 1]);
      }
    }
  }
}

// S^T = K bf16(q * scale)^T and dP^T = V dO^T, [64 keys, 64 q], for the
// warpgroup's keys at k_rows / v_rows and the step's Q and dO tiles
template <int D>
__device__ __forceinline__ void issue_s_dp(float (&st)[kBQ / 2], float (&dpt)[kBQ / 2],
                                           uint32_t k_rows, uint32_t v_rows, uint32_t q_tile,
                                           uint32_t do_tile) {
  using L = Smem<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss_n64(st, desc_k(k_rows, L::kKVPanel, kk), desc_k(q_tile, L::kQPanel, kk), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss_n64(dpt, desc_k(v_rows, L::kKVPanel, kk), desc_k(do_tile, L::kQPanel, kk), kk > 0);
  }
}

// dV += bf16(P^T) dO and dK += bf16(dS^T) bf16(q * scale): the packed
// fragments as A, the step's dO and Q tiles read MN-major
template <int D>
__device__ __forceinline__ void issue_dv_dk(float (&dv)[D / 2], float (&dk)[D / 2],
                                            const uint32_t (&pa)[kBQ / 4],
                                            const uint32_t (&dsa)[kBQ / 4], uint32_t q_tile,
                                            uint32_t do_tile) {
  using L = Smem<D>;
#pragma unroll
  for (int kk = 0; kk < kBQ / 16; ++kk) {
    if constexpr (D == 64) {
      wgmma_rs_n64(dv, pa + 4 * kk, desc_mn(do_tile, L::kQPanel, kk));
      wgmma_rs_n64(dk, dsa + 4 * kk, desc_mn(q_tile, L::kQPanel, kk));
    } else {
      wgmma_rs_n128(dv, pa + 4 * kk, desc_mn(do_tile, L::kQPanel, kk));
      wgmma_rs_n128(dk, dsa + 4 * kk, desc_mn(q_tile, L::kQPanel, kk));
    }
  }
}

// P^T = exp(S^T - lse) and dS^T = P^T (dP^T - delta) of one step from
// S^T and dP^T, which it only reads (ptxas serializes wgmmas around
// registers that other instructions write while one runs), packed to
// bf16 as A fragments.  stats: the step's lse (times log2 e) and delta
// rows; the mask only where a row may lie past Sq, a query above its key
// or past the window's band below it.  kWindow: the kernel takes a window
// (a separate instantiation: the causal kernel's code is the one it had
// without windows)
template <bool kWindow>
__device__ __forceinline__ void step_grads(const float (&st)[kBQ / 2], const float (&dpt)[kBQ / 2],
                                           const float* stats, uint32_t (&pa)[kBQ / 4],
                                           uint32_t (&dsa)[kBQ / 4], int q0, int key0, int lane,
                                           int Sq, int causal, int window) {
  const bool masked = q0 + kBQ > Sq || (causal && q0 < key0 + 63) ||
                      (kWindow && q0 + kBQ - 1 >= key0 + window);
  float p[2], ds[2];
#pragma unroll
  for (int j = 0; j < kBQ / 2; ++j) {
    const int col = (j / 4) * 8 + (lane % 4) * 2 + (j % 2);
    float pj = ex2_approx(fmaf(st[j], kLog2e, -stats[col]));
    if (masked) {
      const int q = q0 + col;
      const int key = key0 + 8 * ((j / 2) % 2);
      if (q >= Sq || (causal && q < key) || (kWindow && q >= key + window)) pj = 0.f;
    }
    p[j % 2] = pj;
    ds[j % 2] = pj * (dpt[j] - stats[kBQ + col]);
    if (j % 2) {
      pa[j / 2] = pack_bf16(p[0], p[1]);
      dsa[j / 2] = pack_bf16(ds[0], ds[1]);
    }
  }
}

template <int D, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     void* __restrict__ dk, void* __restrict__ dv, int H, int Hkv, int Sq,
                     int Sk, Strides dks, Strides dvs, float scale, int causal, int window,
                     int out_f32) {
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_addr(smem);
  const uint32_t bar_kv = base + L::kBars;
  const uint32_t bar_loaded = bar_kv + 8;
  const uint32_t bar_ready = bar_loaded + 8 * kStages;
  const uint32_t bar_empty = bar_ready + 8 * kStages;

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int kt = blockIdx.z;  // key tile 0 sees every q tile: heaviest first
  const int n_rep = H / Hkv;
  const int k0 = kt * kBK;
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  // q tile i sees key tile kt iff its last row >= the tile's first key
  const int i0 = causal ? k0 / kBQ : 0;
  // ... and, under a window, iff its first row is in the band of the
  // tile's last key (k0 + kBK - 1 + window - 1 the last row that sees it)
  const int i1 = kWindow ? min(n_qt, (k0 + kBK + window - 2) / kBQ + 1) : n_qt;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_loaded + 8 * s, 1);
      mbar_init(bar_ready + 8 * s, 128);
      mbar_init(bar_empty + 8 * s, 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warpgroup: TMA from one thread; the scaling of Q and
    // the lse / delta rows from all 128
    setmaxnreg_dec<40>();
    const int pt = threadIdx.x - 256;
    if (pt == 0) {
      mbar_expect_tx(bar_kv, 2 * kBK * D * 2);
      tma_load_rows<D>(base + L::kK, &k_map, bar_kv, hk, k0, b, L::kKVPanel);
      tma_load_rows<D>(base + L::kV, &v_map, bar_kv, hk, k0, b, L::kKVPanel);
    }
    int step = 0;
    for (int hh = 0; hh < n_rep; ++hh) {
      const int h = hk * n_rep + hh;
      const long long stat = ((long long)b * H + h) * Sq;
      for (int i = i0; i < i1; ++i, ++step) {
        const int s = step % kStages;
        const uint32_t ph = (step / kStages) & 1;
        const int q0 = i * kBQ;
        mbar_wait(bar_empty + 8 * s, ph ^ 1);
        if (pt == 0) {
          mbar_expect_tx(bar_loaded + 8 * s, 2 * kBQ * D * 2);
          tma_load_rows<D>(base + L::kQ + s * L::kQTile, &q_map, bar_loaded + 8 * s, h, q0, b,
                           L::kQPanel);
          tma_load_rows<D>(base + L::kDO + s * L::kQTile, &do_map, bar_loaded + 8 * s, h, q0,
                           b, L::kQPanel);
        }
        float* stats = reinterpret_cast<float*>(smem + L::kStats + s * 2 * kBQ * 4);
        const int r = pt % kBQ;
        const bool in = q0 + r < Sq;
        if (pt < kBQ) {
          stats[r] = in ? lse[stat + q0 + r] * kLog2e : 0.f;
        } else {
          stats[kBQ + r] = in ? delta[stat + q0 + r] : 0.f;
        }
        mbar_wait(bar_loaded + 8 * s, ph);
        for (int c = pt; c < kBQ * (D / 8); c += 128) {
          uint4* ptr = reinterpret_cast<uint4*>(smem + L::kQ + s * L::kQTile + c * 16);
          uint4 val = *ptr;
          bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
          for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
          *ptr = val;
        }
        fence_proxy_async();
        mbar_arrive(bar_ready + 8 * s);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 keys each
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x / 128;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int row_a = (t / 32) * 16 + lane / 4;  // this thread's keys: row_a, row_a + 8
    const int wk0 = k0 + wg * 64;
    const uint32_t k_rows = base + L::kK + wg * 64 * 128;
    const uint32_t v_rows = base + L::kV + wg * 64 * 128;

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(bar_kv, 0);

    const int n_steps = n_rep * (i1 - i0);
    auto q_start = [&](int step) { return (i0 + step % (i1 - i0)) * kBQ; };
    auto stats_of = [&](int s) {
      return reinterpret_cast<const float*>(smem + L::kStats + s * 2 * kBQ * 4);
    };
    float st[kBQ / 2], dpt[kBQ / 2];
    uint32_t pa[kBQ / 4], dsa[kBQ / 4];  // bf16(P^T), bf16(dS^T) as A fragments
    if constexpr (D == 64) {
      // Step i issues S^T and dP^T of step i and then dV and dK of step
      // i - 1, waits for the first two only, and computes P^T and dS^T of
      // step i while dV and dK still run.  Every step runs its products, a
      // step wholly above the diagonal too (its P^T masks to zeros): ptxas
      // serializes wgmmas issued under a branch that may differ between
      // warpgroups.  The fragments of two steps in turn (pa, dsa and pb,
      // dsb): dV and dK read one pair while the next step writes the
      // other.  Two pairs, not one and a copy: a copy lets the compiler
      // give both the same registers, which ptxas then protects by
      // serializing every wgmma.
      uint32_t pb[kBQ / 4], dsb[kBQ / 4];
      auto step_at = [&](int step, const uint32_t(&p_run)[kBQ / 4],
                         const uint32_t(&ds_run)[kBQ / 4], uint32_t(&p_next)[kBQ / 4],
                         uint32_t(&ds_next)[kBQ / 4]) {
        const int s = step % kStages;
        const int sp = (step - 1) % kStages;
        mbar_wait(bar_ready + 8 * s, (step / kStages) & 1);
        wgmma_fence();
        issue_s_dp<D>(st, dpt, k_rows, v_rows, base + L::kQ + s * L::kQTile,
                      base + L::kDO + s * L::kQTile);
        wgmma_commit();
        issue_dv_dk<D>(dv_acc, dk_acc, p_run, ds_run, base + L::kQ + sp * L::kQTile,
                       base + L::kDO + sp * L::kQTile);
        wgmma_commit();
        wgmma_wait<1>();
        reg_fence(st);
        reg_fence(dpt);
        step_grads<kWindow>(st, dpt, stats_of(s), p_next, ds_next, q_start(step), wk0 + row_a,
                            lane, Sq, causal, window);
        wgmma_wait_all();
        reg_fence(dv_acc);
        reg_fence(dk_acc);
        mbar_arrive(bar_empty + 8 * sp);
      };
      if (n_steps > 0) {  // else no q row reaches these keys
        mbar_wait(bar_ready, 0);
        wgmma_fence();
        issue_s_dp<D>(st, dpt, k_rows, v_rows, base + L::kQ, base + L::kDO);
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(st);
        reg_fence(dpt);
        step_grads<kWindow>(st, dpt, stats_of(0), pa, dsa, q_start(0), wk0 + row_a, lane, Sq,
                            causal, window);
        int step = 1;
        for (; step + 1 < n_steps; step += 2) {
          step_at(step, pa, dsa, pb, dsb);
          step_at(step + 1, pb, dsb, pa, dsa);
        }
        const bool last_in_b = step < n_steps;
        if (last_in_b) step_at(step, pa, dsa, pb, dsb);
        const int sl = (n_steps - 1) % kStages;
        const uint32_t q_last = base + L::kQ + sl * L::kQTile;
        const uint32_t do_last = base + L::kDO + sl * L::kQTile;
        wgmma_fence();
        if (last_in_b) {
          issue_dv_dk<D>(dv_acc, dk_acc, pb, dsb, q_last, do_last);
        } else {
          issue_dv_dk<D>(dv_acc, dk_acc, pa, dsa, q_last, do_last);
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(dv_acc);
        reg_fence(dk_acc);
        mbar_arrive(bar_empty + 8 * sl);
      }
    } else {
      // D 128 has no registers for a second step's fragments: the four
      // products of a step in order
      for (int step = 0; step < n_steps; ++step) {
        const int s = step % kStages;
        const int q0 = q_start(step);
        mbar_wait(bar_ready + 8 * s, (step / kStages) & 1);
        // a step whose every (q, key) pair is masked only passes its stage on
        if ((!causal || q0 + kBQ - 1 >= wk0) && !(kWindow && q0 >= wk0 + 63 + window)) {
          const uint32_t q_tile = base + L::kQ + s * L::kQTile;
          const uint32_t do_tile = base + L::kDO + s * L::kQTile;
          wgmma_fence();
          issue_s_dp<D>(st, dpt, k_rows, v_rows, q_tile, do_tile);
          wgmma_commit();
          wgmma_wait_all();
          reg_fence(st);
          reg_fence(dpt);
          step_grads<kWindow>(st, dpt, stats_of(s), pa, dsa, q0, wk0 + row_a, lane, Sq, causal,
                              window);
          wgmma_fence();
          issue_dv_dk<D>(dv_acc, dk_acc, pa, dsa, q_tile, do_tile);
          wgmma_commit();
          wgmma_wait_all();
          reg_fence(dv_acc);
          reg_fence(dk_acc);
        }
        mbar_arrive(bar_empty + 8 * s);
      }
    }

    // q was pre-scaled, so dK needs no further scale
    store_rows<D>(dk, dks, b, hk, wk0 + row_a, Sk, lane, dk_acc, out_f32);
    store_rows<D>(dv, dvs, b, hk, wk0 + row_a, Sk, lane, dv_acc, out_f32);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dk, void* dv, int B, int H, int Hkv, int Sq, int Sk,
           Strides qs, Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
           float scale, int causal, int window, int out_f32, cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map, do_map;
  if (!encode_rows_map(&q_map, q, D, H, Sq, B, qs.b, qs.s, qs.h, kBQ) ||
      !encode_rows_map(&do_map, dout, D, H, Sq, B, dos.b, dos.s, dos.h, kBQ) ||
      !encode_rows_map(&k_map, k, D, Hkv, Sk, B, ks.b, ks.s, ks.h, kBK) ||
      !encode_rows_map(&v_map, v, D, Hkv, Sk, B, vs.b, vs.s, vs.h, kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kSmem = Smem<D>::kBytes;
  const auto kernel = window ? flash_bwd_dkv_kernel<D, true> : flash_bwd_dkv_kernel<D, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(Hkv, B, (Sk + kBK - 1) / kBK);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      q_map, k_map, v_map, do_map, static_cast<const float*>(lse),
      static_cast<const float*>(delta), dk, dv, H, Hkv, Sq, Sk, dks, dvs, scale, causal,
      window, out_f32);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dout: [B, Sq, H, D]-shaped views given by element strides (batch,
// seq, head; the head_dim stride must be 1); k, v likewise with Hkv heads
// and Sk rows; lse and delta contiguous [B, H, Sq] f32; dk and dv have k's
// shape ([B, Sk, Hkv, D] by their own strides), summed over each kv-head's
// group of H / Hkv q-heads, f32 if out_f32 else bf16; window 0, or the
// sliding window's keys (causal only).  bf16 inputs only; D in {64, 128};
// every stride and pointer 16-byte aligned.  Returns the
// cudaError_t of the launch (0 = success).
extern "C" int tpunet_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, int B, int H, int Hkv, int Sq, int Sk,
                                    int D, long long q_sb, long long q_ss, long long q_sh,
                                    long long k_sb, long long k_ss, long long k_sh,
                                    long long v_sb, long long v_ss, long long v_sh,
                                    long long do_sb, long long do_ss, long long do_sh,
                                    long long dk_sb, long long dk_ss, long long dk_sh,
                                    long long dv_sb, long long dv_ss, long long dv_sh,
                                    float scale, int causal, int window, int out_f32,
                                    void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq <= 0 || Sk <= 0 || window < 0 ||
      (window && !causal)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const Strides dos{do_sb, do_ss, do_sh}, dks{dk_sb, dk_ss, dk_sh}, dvs{dv_sb, dv_ss, dv_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Sq, Sk, qs, ks, vs, dos,
                        dks, dvs, scale, causal, window, out_f32, s);
    case 128:
      return launch<128>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Sq, Sk, qs, ks, vs,
                         dos, dks, dvs, scale, causal, window, out_f32, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
