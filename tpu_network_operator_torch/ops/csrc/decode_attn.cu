// Decode attention for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces no TPU kernel.  The JAX package leaves a decode step's
// attention to XLA, which fuses the grouped einsum over the attended
// prefix of the KV cache.  Eager PyTorch cannot fuse it: the grouped
// einsum over a [B, len, Hkv, D] slice of the [B, max_len, Hkv, D] cache
// needs K and V as batches of one stride, so every layer of every step
// made a contiguous copy of both (through the generic strided copy kernel)
// before the two products, and wrote the [B, Hkv, R, 1, len] scores out
// between a dozen small elementwise launches.  This kernel is the whole
// of it in one launch: o = softmax(q K^T / sqrt(D)) V for one new query
// row per batch row, over keys 0 .. length-1, read in place.
//
// Bound on this card: bytes.  It must read K and V of `length` keys for
// every (batch row, kv-head), plus q, and write o; it does about 4 FLOPs
// per byte read (the R = H / Hkv query heads of a GQA group share each
// K/V row), far below the ~295 at which the tensor cores would be the
// limit.  So the design reads each K/V byte once and keeps it moving:
//
// * one block per (batch row, kv-head, group of up to 16 of the group's
//   query heads): the R heads of a GQA group (padded to the 16 rows of an
//   mma.sync tile) read every K/V row once between them;
// * K and V stream straight out of the cache buffer through its strides,
//   exactly the `length` filled keys: 64-key tiles in a 3-stage ring of
//   shared memory, filled with 16-byte cp.async copies (a dead key past
//   `length` in the last tile is zero-filled, never read); the chunks of a
//   row are swizzled by the row so that ldmatrix reads them without bank
//   conflicts; two tiles are in flight while one is multiplied;
// * each of the four warps takes 16 keys of every tile and keeps its own
//   online softmax: S = q K^T by mma.sync (bf16 or f16 operands, f32
//   accumulators, so the scores are f32), the mask on the ragged last
//   tile, the running max and sum in f32 (exp2 with log2 e folded into
//   the scale), P rounded to v's dtype as the A operand of O += P V, O in
//   f32 registers; the four warps' (m, l, O) merge through shared memory
//   at the end;
// * where too few blocks stream to reach the card's bandwidth (a block
//   alone streams about 50 GB/s: small B x Hkv over long prefixes) the
//   key range splits into parts of whole tiles: each part's block writes
//   its normalised f32 O and its log-sum-exp, and a second small kernel
//   combines them (the wrapper picks the split from the shape,
//   decode_attention.split_plan).
//
// The length comes by value, or from device memory (`length_dev`), so
// that one captured launch serves every decode step of a CUDA graph: the
// split is then planned for the by-value bound (the cache's slots), and
// a part whose tiles all lie past the length writes a zero O and a
// log-sum-exp of -inf, which the combine weighs as nothing.
//
// At D 128 a block holds 96 KB of ring (two blocks an SM), at D 64 48 KB
// (four).  The [B, Hkv, R, len] scores never reach device memory.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;     // keys of one ring stage
constexpr int kWarps = 4;     // each takes 16 keys of every tile
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;    // ring depth: two tiles in flight
constexpr int kRows = 16;     // query rows of a block: the mma's M
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kTile == 16 * kWarps, "a warp's share of a tile is one 16-key k-step");

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* part_o;    // [splits, B, H, D] when the keys split, else null
  float* part_lse;  // [splits, B, H], log2 units
  const long long* length_dev;  // the length, at most `length`; null: `length`
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh;
  int B, H, Hkv, length, splits, tiles_per_split;
  float scale_log2;  // D^-0.5 * log2(e)
};

template <typename T> struct Kind;

template <> struct Kind<__nv_bfloat16> {
  __device__ static __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ static __forceinline__ __nv_bfloat16 from(float x) { return __float2bfloat16(x); }
  // c[16x8] += a[16x16] * b[16x8], f32 accumulators
  __device__ static __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <> struct Kind<__half> {
  __device__ static __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  __device__ static __forceinline__ __half from(float x) { return __float2half(x); }
  __device__ static __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; `src_bytes` 0 writes zeros and
// reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// byte offset of 16-byte chunk `col` of tile row `row` (rows of D values):
// the chunk index XOR the row's low three bits, so the eight rows an
// ldmatrix phase reads at one column land in eight different bank groups
template <int D>
__device__ __forceinline__ uint32_t tile_off(int row, int col) {
  return row * (D * 2) + ((col ^ (row & 7)) * 16);
}

template <int D>
struct Smem {
  static constexpr int kTileBytes = kTile * D * 2;  // K or V of one stage
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kRing = kStages * kStageBytes;
  // the merge: each warp's O [kRows][D], then its m and l [kRows]
  static constexpr int kMerge = kWarps * kRows * (D + 2) * 4;
  static constexpr int kBytes = kRing > kMerge ? kRing : kMerge;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_attn_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Smem<D>;
  constexpr int kChunks = D / 8;  // 16-byte chunks of a row

  const int R = a.H / a.Hkv;
  const int groups = (R + kRows - 1) / kRows;
  int item = blockIdx.x;
  const int grp = item % groups;
  item /= groups;
  const int hkv = item % a.Hkv;
  const int b = item / a.Hkv;
  const int split = blockIdx.y;
  const int row0 = grp * kRows;
  const int rows = min(kRows, R - row0);  // query rows this block writes
  const int h0 = hkv * R + row0;          // the q-head of its row 0

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;

  const int length = a.length_dev == nullptr
                         ? a.length
                         : static_cast<int>(max(0LL, min(*a.length_dev, (long long)a.length)));
  const int n_tiles = (length + kTile - 1) / kTile;
  const int t_begin = split * a.tiles_per_split;
  // >= 1 for a length by value (the host splits so); a length read from
  // device memory may leave the last parts empty
  const int n = min(a.tiles_per_split, n_tiles - t_begin);
  const long long plane = (long long)a.B * a.H;
  if (n <= 0) {
    for (int e = tid; e < rows * D; e += kThreads) {
      const int h = h0 + e / D, d = e % D;
      if (a.splits == 1) {
        static_cast<T*>(a.o)[b * a.o_sb + h * a.o_sh + d] = Kind<T>::from(0.f);
      } else {
        const long long at = split * plane + (long long)b * a.H + h;
        a.part_o[at * D + d] = 0.f;
        if (d == 0) a.part_lse[at] = -INFINITY;
      }
    }
    return;
  }

  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hkv * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hkv * a.v_sh;
  const uint32_t base = smem_addr(smem);

  auto load_tile = [&](int tile, int stage) {
    const int key0 = tile * kTile;
    const uint32_t ks = base + stage * L::kStageBytes;
    const uint32_t vs = ks + L::kTileBytes;
#pragma unroll
    for (int i = 0; i < kTile * kChunks / kThreads; ++i) {
      const int c = i * kThreads + tid;
      const int row = c / kChunks, col = c % kChunks;
      const int key = key0 + row;
      const bool live = key < length;
      const long long at = live ? key : 0;
      cp_async16(ks + tile_off<D>(row, col), kb + at * a.k_ss + col * 8, live ? 16 : 0);
      cp_async16(vs + tile_off<D>(row, col), vb + at * a.v_ss + col * 8, live ? 16 : 0);
    }
  };

  // the ring's first tiles load while q is read
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) load_tile(t_begin + s, s);
    cp_async_commit();
  }

  // q as the A operand: rows g and g + 8 of the block's 16, columns
  // [16 ks, 16 ks + 16) of k-step ks; rows past R are zero
  uint32_t qf[D / 16][4];
  {
    const T* qb = static_cast<const T*>(a.q) + b * a.q_sb;
    const bool lo = g < rows, hi = g + 8 < rows;
    const T* q_lo = qb + (long long)(h0 + g) * a.q_sh;
    const T* q_hi = qb + (long long)(h0 + g + 8) * a.q_sh;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int c = ks * 16 + 2 * t4;
      qf[ks][0] = lo ? *reinterpret_cast<const uint32_t*>(q_lo + c) : 0u;
      qf[ks][1] = hi ? *reinterpret_cast<const uint32_t*>(q_hi + c) : 0u;
      qf[ks][2] = lo ? *reinterpret_cast<const uint32_t*>(q_lo + c + 8) : 0u;
      qf[ks][3] = hi ? *reinterpret_cast<const uint32_t*>(q_hi + c + 8) : 0u;
    }
  }

  // O rows g (entries 0, 1) and g + 8 (2, 3), columns 8 j + 2 t4 + {0, 1};
  // m and l of rows g and g + 8 (l per lane until the end)
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int wrow = warp * 16;  // this warp's first row of every tile

  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i has landed for all; every warp is done with tile i - 1
    if (i + kStages - 1 < n) load_tile(t_begin + i + kStages - 1, (i + kStages - 1) % kStages);
    cp_async_commit();

    const uint32_t ks = base + (i % kStages) * L::kStageBytes;
    const uint32_t vs = ks + L::kTileBytes;
    const int key0 = (t_begin + i) * kTile + wrow;

    // S [16 rows x 16 keys] = q K^T: n-tile nt is keys 8 nt .. 8 nt + 7
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        // matrix lane / 8: the key row's 16-byte chunk 4 kk + lane / 8,
        // i.e. b0 and b1 of k-steps 2 kk and 2 kk + 1
        uint32_t kf[4];
        ldmatrix_x4(ks + tile_off<D>(wrow + nt * 8 + (lane & 7), kk * 4 + (lane >> 3)), kf);
        Kind<T>::mma(s[nt], qf[2 * kk], kf[0], kf[1]);
        Kind<T>::mma(s[nt], qf[2 * kk + 1], kf[2], kf[3]);
      }
    }

    // the online softmax, in log2 units; keys past `length` are masked
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + nt * 8 + 2 * t4 + (e & 1);
        const float x = key < length ? s[nt][e] * a.scale_log2 : -INFINITY;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float sub[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      sub[r] = m_new == -INFINITY ? 0.f : m_new;  // no key yet: p and alpha are 0
      alpha[r] = exp2f(m[r] - sub[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
    // P as the A operand of the k-step over these 16 keys: a0 / a1 from
    // n-tile 0 (rows g / g + 8), a2 / a3 from n-tile 1
    uint32_t pf[4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float p0 = exp2f(s[nt][0] - sub[0]), p1 = exp2f(s[nt][1] - sub[0]);
      const float p2 = exp2f(s[nt][2] - sub[1]), p3 = exp2f(s[nt][3] - sub[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[2 * nt] = Kind<T>::pack(p0, p1);
      pf[2 * nt + 1] = Kind<T>::pack(p2, p3);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V: V's rows are the k dim, read transposed; matrix lane / 8
    // is keys 8 (lane / 8 % 2) .. +7 of column chunk 2 j + lane / 16,
    // i.e. b0 and b1 of n-tiles 2 j and 2 j + 1
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const int mi = lane >> 3;
      uint32_t vf[4];
      ldmatrix_x4_trans(vs + tile_off<D>(wrow + (mi & 1) * 8 + (lane & 7), 2 * j + (mi >> 1)),
                        vf);
      Kind<T>::mma(o[2 * j], pf, vf[0], vf[1]);
      Kind<T>::mma(o[2 * j + 1], pf, vf[2], vf[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the merge now

  // the four warps' (m, l, O) meet in shared memory, in a fixed order
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* mo = reinterpret_cast<float*>(smem);  // [kWarps][kRows][D]
  float* mm = mo + kWarps * kRows * D;         // [kWarps][kRows]
  float* ml = mm + kWarps * kRows;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int d = 8 * j + 2 * t4;
    *reinterpret_cast<float2*>(mo + (warp * kRows + g) * D + d) = make_float2(o[j][0], o[j][1]);
    *reinterpret_cast<float2*>(mo + (warp * kRows + g + 8) * D + d) =
        make_float2(o[j][2], o[j][3]);
  }
  if (t4 == 0) {
    mm[warp * kRows + g] = m[0];
    mm[warp * kRows + g + 8] = m[1];
    ml[warp * kRows + g] = l[0];
    ml[warp * kRows + g + 8] = l[1];
  }
  __syncthreads();

  for (int e = tid; e < rows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    float top = -INFINITY;  // finite: warp 0 holds the block's first key
#pragma unroll
    for (int w = 0; w < kWarps; ++w) top = fmaxf(top, mm[w * kRows + r]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(mm[w * kRows + r] - top);
      num += wt * mo[(w * kRows + r) * D + d];
      den += wt * ml[w * kRows + r];
    }
    const int h = h0 + r;
    if (a.splits == 1) {
      static_cast<T*>(a.o)[b * a.o_sb + h * a.o_sh + d] = Kind<T>::from(num / den);
    } else {
      const long long at = split * plane + (long long)b * a.H + h;
      a.part_o[at * D + d] = num / den;
      if (d == 0) a.part_lse[at] = top + log2f(den);
    }
  }
}

// the key splits of one (batch row, q-head) weighed by their sums: one
// thread a column of D; empty parts (lse -inf) weigh nothing, and a row
// with no key at all is zero
template <typename T, int D>
__global__ void __launch_bounds__(D) decode_attn_combine_kernel(const Args a) {
  const long long plane = (long long)a.B * a.H;
  const long long bh = blockIdx.x;
  const int d = threadIdx.x;
  float top = -INFINITY;
  for (int s = 0; s < a.splits; ++s) top = fmaxf(top, a.part_lse[s * plane + bh]);
  const long long b = bh / a.H, h = bh % a.H;
  if (top == -INFINITY) {
    static_cast<T*>(a.o)[b * a.o_sb + h * a.o_sh + d] = Kind<T>::from(0.f);
    return;
  }
  float num = 0.f, den = 0.f;
  for (int s = 0; s < a.splits; ++s) {
    const float wt = exp2f(a.part_lse[s * plane + bh] - top);
    num += wt * a.part_o[(s * plane + bh) * D + d];
    den += wt;
  }
  static_cast<T*>(a.o)[b * a.o_sb + h * a.o_sh + d] = Kind<T>::from(num / den);
}

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int kSmem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(decode_attn_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (a.H / a.Hkv + kRows - 1) / kRows;
  const dim3 grid(static_cast<unsigned>((long long)a.B * a.Hkv * groups),
                  static_cast<unsigned>(a.splits));
  decode_attn_kernel<T, D><<<grid, kThreads, kSmem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  decode_attn_combine_kernel<T, D><<<static_cast<unsigned>((long long)a.B * a.H), D, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const Args& a, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: [B, 1, H, D] given by element strides (batch, head); k and v: the
// cache [B, max_len, Hkv, D] given by element strides (batch, position,
// head); the head_dim stride is 1 everywhere, every pointer and stride
// 16-byte aligned.  o: [B, 1, H, D] by strides (batch, head).  Keys 0 ..
// length-1 are read; with `length_dev` (a device int64) keys 0 ..
// min(*length_dev, length)-1, the split planned for `length`.  splits > 1: part_o [splits, B, H, D] and part_lse
// [splits, B, H] contiguous f32 scratch, split s taking tiles [s tps,
// (s + 1) tps) of the 64-key tiles, none of them empty.  dtype: 1 =
// bfloat16, 2 = float16 (q, k, v and o share it); D in {64, 128}.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int tpunet_decode_attn(const void* q, const void* k, const void* v, void* o,
                                  void* part_o, void* part_lse, int B, int H, int Hkv, int D,
                                  int length, const void* length_dev, int splits, int tiles_per_split, long long q_sb,
                                  long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                                  long long v_sb, long long v_ss, long long v_sh, long long o_sb,
                                  long long o_sh, float scale, int dtype, void* stream) {
  const int n_tiles = (length + kTile - 1) / kTile;
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || length <= 0 || splits <= 0 ||
      tiles_per_split <= 0 || (long long)(splits - 1) * tiles_per_split >= n_tiles ||
      (long long)splits * tiles_per_split < n_tiles ||
      (splits > 1 && (part_o == nullptr || part_lse == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, o, static_cast<float*>(part_o), static_cast<float*>(part_lse),
               static_cast<const long long*>(length_dev),
               q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh,
               B, H, Hkv, length, splits, tiles_per_split, scale * kLog2e};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return launch_d<__nv_bfloat16>(a, D, s);
    case 2: return launch_d<__half>(a, D, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
