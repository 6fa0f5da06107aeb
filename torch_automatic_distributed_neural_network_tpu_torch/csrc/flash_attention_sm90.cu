// Flash attention on Hopper's tensor cores (sm_90a), bf16: the forward
// kernel (K1), the dK/dV kernel (K2) and the dQ kernel (K3).
//
// Replace the Pallas TPU kernels in
//   torch_automatic_distributed_neural_network_tpu/ops/flash_attention.py:
//   K1 ::_fwd_kernel (driven by _fwd), K2 ::_dkv_kernel and K3 ::_dq_kernel
//   (both driven by _bwd_impl), for bf16 operands.  fp32 operands stay on
//   the CUDA cores in csrc/flash_attention.cu.
//
// Shapes (C-contiguous bf16, heads already broadcast for GQA):
//   q, o, do, dq    [B, Sq, H, hd]   (BSHD, read and written in place)
//   k, v, dk, dv    [B, Sk, H, hd]
//   lse, delta      [B, H, Sq] fp32
//   hd is 32, 64 or 128; causal needs Sq == Sk; window > 0 needs causal.
//
// Arithmetic, with the TPU kernels' rounding points:
//   s = (q . k) * scale in fp32 (bf16 products are exact, the tensor core
//   sums them in fp32), masked to -0.7 * FLT_MAX where the pair may not
//   attend (_pair_mask);
//   K1: online softmax over k tiles, running max clamped at half the mask
//       value, p rounded to bf16 in registers (JAX's p.astype(v.dtype))
//       before p . v, o = acc / max(l, 1e-30) in bf16,
//       lse = m + log(max(l, 1e-30));
//   K2: p = exp(s - lse); dv += p^T . do with p kept in fp32 (JAX upcasts
//       do, so its product is fp32): p = hi + lo, hi = bf16(p),
//       lo = bf16(p - hi), two bf16 products, an error ~2^-17 of p;
//       dp = do . v^T (bf16 products are exact); ds = p * (dp - delta) *
//       scale rounded to bf16 (ds.astype(q.dtype)); dk += ds^T . q;
//   K3: the same p and ds, ds rounded to bf16 (ds.astype(k.dtype)),
//       dq += ds . k in fp32, written once as bf16.
//
// What bounds them on this card: at the GPT-2 small training shape (S 1024,
// hd 64, causal) K1 must move ~51 MB for 13 GFLOP (bytes and operations
// within 1.2x of each other), K2 ~76 MB for 26 GFLOP and K3 ~64 MB for 19
// GFLOP (operations); all three near the bf16 tensor-core rate, which is
// what this design aims at.
//
// Design:
// - every product is one warpgroup's `wgmma.mma_async` (m64nNk16, fp32
//   accumulators in registers): scores with both operands in shared memory
//   (SS, K-major), the value-side products with the bf16 scores or score
//   gradients as the register A operand (RS) and the [rows][hd] tile read
//   MN-major through the descriptor's transpose bit;
// - one thread block per (b*h, tile): K1 and K3 a 128-row q tile (two
//   consumer warpgroups of 64 rows; one of 64 rows for K3 at hd 128, to
//   keep dq and the two score tiles in registers) walking k tiles of 64
//   keys (two blocks share an SM at hd <= 64), K2 a
//   128-key tile at hd <= 64 (two consumer warpgroups of 64 keys; 64 keys,
//   one warpgroup at hd 128 to keep dk, dv and the two score tiles in
//   registers) walking q tiles of 64 rows; _block_relevant becomes the
//   loops' bounds, per block and per warpgroup; causal K1 and K3 start the
//   longest q tiles first;
// - one producer warp issues TMA loads (4-D tensor maps over BSHD with
//   128-byte swizzle, 64-byte at hd 32, zero fill past the ragged edge)
//   into a two-stage ring guarded by full / empty mbarriers, so the next
//   tile lands while this one is computed; in K2 it also stages lse and
//   delta for the q tile, in K3 each thread reads its two rows' lse and
//   delta into registers once;
// - the mask is computed only on tiles that cross the diagonal, the
//   window edge or the end of the sequence;
// - outputs are written once from the accumulators; no atomics, so the
//   results do not depend on the run (dq is its own kernel, as in JAX: a
//   dq fused into K2 would sum across k-tile blocks with atomics).

#include <cuda_bf16.h>
#include <float.h>

#include <initializer_list>

#include "sm90_common.cuh"

namespace {

constexpr float kNegBig = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 2;   // the ring of streamed tiles
constexpr int kWG = 128;     // threads of a warpgroup
constexpr int kRowsWG = 64;  // rows of one wgmma (m64)

// --- shared-memory tiles ----------------------------------------------------
// A [rows][hd] bf16 tile as TMA writes it: one box per kBoxCols columns
// (all of hd at hd <= 64, two halves at hd 128), each box rows x kRowBytes
// with the matching swizzle; tiles start at 1024-byte boundaries, so the
// swizzle phase of a row is its index mod 8.
template <int HD>
struct Tile {
  static constexpr int kRowBytes = HD >= 64 ? 128 : 64;  // = the swizzle span
  static constexpr int kBoxCols = kRowBytes / 2;
  static constexpr int kBoxes = HD / kBoxCols;
  static constexpr int kAtom = 8 * kRowBytes;  // 8 rows: one swizzle period
  static constexpr uint64_t kLayout = HD >= 64 ? 1 : 2;  // wgmma: 128B / 64B
  static constexpr int kKSteps = HD / 16;                // k16 steps over hd
  __host__ __device__ static constexpr int bytes(int rows) {
    return rows * HD * 2;
  }
};

// wgmma shared-memory matrix descriptor: start, leading and stride byte
// offsets (16-byte units) and the swizzle mode.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// A tile as a K-major operand (K = hd): rows r0 .. r0 + 63 (A) or all its
// rows (B) of a tile of `rows`, k16 step kk.  Within a swizzled row the
// step moves the start by 32 bytes; 8-row groups are kAtom apart.
template <int HD>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int r0,
                                           int kk) {
  using L = Tile<HD>;
  constexpr int kPerBox = L::kBoxCols / 16;
  const uint32_t a = tile + ((kk / kPerBox) * rows + r0) * L::kRowBytes +
                     (kk % kPerBox) * 32;
  return make_desc(a, 16, L::kAtom, L::kLayout);
}

// The same tile as an MN-major B operand (K = its rows, N = hd), k16 step
// kk = rows 16 kk .. 16 kk + 15: 8-row groups kAtom apart (SBO), the
// column boxes rows * kRowBytes apart (LBO).
template <int HD>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int kk) {
  using L = Tile<HD>;
  return make_desc(tile + kk * 16 * L::kRowBytes, rows * L::kRowBytes,
                   L::kAtom, L::kLayout);
}

// Rows s0 .. s0 + rows - 1 of head h, batch b of a BSHD tensor into a
// [rows][hd] tile, one box per column block; completion on `bar`.
template <int HD>
__device__ __forceinline__ void load_tile(const CUtensorMap* map,
                                          uint64_t* bar, uint8_t* dst,
                                          int rows, int s0, int h, int b) {
  using L = Tile<HD>;
#pragma unroll
  for (int c = 0; c < L::kBoxes; ++c)
    tma_load_4d(map, bar, dst + c * rows * L::kRowBytes, c * L::kBoxCols, h,
                s0, b);
}

// --- wgmma ------------------------------------------------------------------

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keep the compiler from moving reads or writes of wgmma's registers
// across the asynchronous window (fence, mma, commit, wait).
template <int R>
__device__ __forceinline__ void hold(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void hold(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define TADNN_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define TADNN_D16(i) \
  TADNN_D4(i), TADNN_D4(i + 4), TADNN_D4(i + 8), TADNN_D4(i + 12)
#define TADNN_R16(a, b, c, e, f, g, h, k, l, m, n, o, p, q, r, s) \
  "%" #a ", %" #b ", %" #c ", %" #e ", %" #f ", %" #g ", %" #h ", %" #k   \
  ", %" #l ", %" #m ", %" #n ", %" #o ", %" #p ", %" #q ", %" #r ", %" #s

// D (64 x N fp32, N / 2 registers a thread) += A . B, bf16 in.  mma_ss: A
// and B K-major descriptors.  mma_rs: A from registers (4 x bf16x2: rows
// r, r + 8 and columns c, c + 8 of the m64k16 fragment), B an MN-major
// descriptor (transpose bit set).  acc = 0 overwrites D.
template <int N>
struct Mma;

template <>
struct Mma<32> {
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" TADNN_R16(
            0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15) "}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : TADNN_D16(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" TADNN_R16(
            0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
            15) ", " TADNN_R16(16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
                               28, 29, 30, 31) "}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : TADNN_D16(0), TADNN_D16(16)
        : "l"(a), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" TADNN_R16(
            0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
            15) ", " TADNN_R16(16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
                               28, 29, 30, 31) "}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : TADNN_D16(0), TADNN_D16(16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" TADNN_R16(
            0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
            15) ", " TADNN_R16(16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
                               28, 29, 30,
                               31) ", " TADNN_R16(32, 33, 34, 35, 36, 37, 38,
                                                  39, 40, 41, 42, 43, 44, 45,
                                                  46,
                                                  47) ", " TADNN_R16(48, 49,
                                                                     50, 51,
                                                                     52, 53,
                                                                     54, 55,
                                                                     56, 57,
                                                                     58, 59,
                                                                     60, 61,
                                                                     62,
                                                                     63) "}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : TADNN_D16(0), TADNN_D16(16), TADNN_D16(32), TADNN_D16(48)
        : "l"(a), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" TADNN_R16(
            0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
            15) ", " TADNN_R16(16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
                               28, 29, 30,
                               31) ", " TADNN_R16(32, 33, 34, 35, 36, 37, 38,
                                                  39, 40, 41, 42, 43, 44, 45,
                                                  46,
                                                  47) ", " TADNN_R16(48, 49,
                                                                     50, 51,
                                                                     52, 53,
                                                                     54, 55,
                                                                     56, 57,
                                                                     58, 59,
                                                                     60, 61,
                                                                     62,
                                                                     63) "}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : TADNN_D16(0), TADNN_D16(16), TADNN_D16(32), TADNN_D16(48)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

// --- fragments --------------------------------------------------------------
// The m64nN accumulator: thread t of the warpgroup (warp w = t / 32, lane
// l) holds rows 16 w + l / 4 (+ 8) and columns 8 n + 2 (l % 4) (+ 1);
// register 4 n + 2 i + j is (row + 8 i, column 8 n + 2 (l % 4) + j).  The
// m64k16 A fragment has the same row and column map, so the accumulator's
// n-blocks 2 kk and 2 kk + 1 are, packed to bf16x2, the A operand of k16
// step kk (FA3's register reuse).

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x: the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Registers 8 kk .. 8 kk + 7 of an accumulator as the A fragment of step kk.
template <int R>
__device__ __forceinline__ void to_a(const float (&x)[R],
                                     uint32_t (&a)[R / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// x = hi + lo, both bf16: the fp32 value to ~2^-17 of itself.
template <int R>
__device__ __forceinline__ void to_a_split(const float (&x)[R],
                                           uint32_t (&hi)[R / 8][4],
                                           uint32_t (&lo)[R / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = x[8 * kk + 2 * r], x1 = x[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h);
      hi[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][r] = pack_bf16(x0 - hf.x, x1 - hf.y);
    }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// _pair_mask: may query position qp attend key position kp?
__device__ __forceinline__ bool pair_ok(int qp, int kp, int Sq, int Sk,
                                        int causal, int window) {
  return qp < Sq && kp < Sk && (!causal || qp >= kp) &&
         (window <= 0 || qp - kp < window);
}

// Does the tile of queries [q_a, q_a + nq) x keys [k_a, k_a + nk) hold a
// pair that may not attend?  Only such tiles compute the mask.
__device__ __forceinline__ bool needs_mask(int q_a, int nq, int k_a, int nk,
                                           int Sq, int Sk, int causal,
                                           int window) {
  return q_a + nq > Sq || k_a + nk > Sk ||
         (causal && (k_a + nk - 1 > q_a ||
                     (window > 0 && q_a + nq - 1 - k_a >= window)));
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// --- K1 ---------------------------------------------------------------------
// Replaces _fwd_kernel (JAX ops/flash_attention.py:99) for bf16.

template <int HD>
struct FwdCfg {
  static constexpr int kConsumers = 2;
  static constexpr int kBN = 64;  // keys of a k tile
  static constexpr int kBM = kRowsWG * kConsumers;  // q rows of a block
  static constexpr int kThreads = kConsumers * kWG + 32;
  // 64-key tiles at hd <= 64 keep a thread's registers (scores, output,
  // bf16 p) under 112, so two blocks (four consumer warpgroups) share an
  // SM and one's softmax overlaps the other's products
  static constexpr int kMinBlocks = HD <= 64 ? 2 : 1;
  static constexpr int kQBytes = Tile<HD>::bytes(kBM);
  static constexpr int kKVBytes = Tile<HD>::bytes(kBN);
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKVBytes;
  // q | k ring | v ring | barriers (q_full, k_full, v_full, empty), and
  // the slack that aligns the start to 1024 bytes
  static constexpr int kSmem = kBarOffset + 8 * (1 + 3 * kStages) + 1024;
};

template <int HD>
__global__ void __launch_bounds__(FwdCfg<HD>::kThreads,
                                  FwdCfg<HD>::kMinBlocks)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int H, int Sq, int Sk, int causal, int window,
                   float scale) {
  using C = FwdCfg<HD>;
  constexpr int BN = C::kBN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align_1024(smem_raw);
  uint8_t* k_s = q_s + C::kQBytes;
  uint8_t* v_s = k_s + kStages * C::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(q_s + C::kBarOffset);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kBM;  // longest rows first
  int k_lo = 0, k_hi = (Sk + BN - 1) / BN - 1;
  if (causal) {
    k_hi = min(k_hi, (q0 + C::kBM - 1) / BN);
    if (window > 0) k_lo = max(0, q0 - window + 1) / BN;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&k_full[s], 1);
      bar_init(&v_full[s], 1);
      bar_init(&empty[s], C::kConsumers * 4);  // one arrival a consumer warp
    }
    bar_fence_init();
  }
  __syncthreads();

  if (warp == C::kConsumers * 4) {  // the producer warp
    if (lane == 0) {
      bar_arrive_tx(q_full, C::kQBytes);
      load_tile<HD>(&q_map, q_full, q_s, C::kBM, q0, h, b);
      for (int kt = k_lo, i = 0; kt <= k_hi; ++kt, ++i) {
        const int st = i % kStages;
        bar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        bar_arrive_tx(&k_full[st], C::kKVBytes);
        load_tile<HD>(&k_map, &k_full[st], k_s + st * C::kKVBytes, BN,
                      kt * BN, h, b);
        bar_arrive_tx(&v_full[st], C::kKVBytes);
        load_tile<HD>(&v_map, &v_full[st], v_s + st * C::kKVBytes, BN,
                      kt * BN, h, b);
      }
    }
    return;
  }

  // a consumer warpgroup: q rows q0 + 64 wg .. + 63
  const int wg = warp / 4, w = warp % 4;
  const int qa = q0 + wg * kRowsWG;
  const int row = qa + 16 * w + lane / 4;  // and row + 8
  const int col = 2 * (lane % 4);          // and + 1, within each 8 columns
  int my_lo = k_lo, my_hi = k_hi;          // this warpgroup's k tiles
  if (causal) {
    my_hi = min(my_hi, (qa + kRowsWG - 1) / BN);
    if (window > 0) my_lo = max(k_lo, max(0, qa - window + 1) / BN);
  }
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegBig, kNegBig}, lsum[2] = {0.f, 0.f};
  const uint32_t q_addr = smem_u32(q_s);
  bar_wait(q_full, 0);

  for (int kt = k_lo, i = 0; kt <= k_hi; ++kt, ++i) {
    const int st = i % kStages;
    const uint32_t ph = (i / kStages) & 1;
    bar_wait(&k_full[st], ph);
    if (kt >= my_lo && kt <= my_hi) {
      const uint32_t k_addr = smem_u32(k_s + st * C::kKVBytes);
      const uint32_t v_addr = smem_u32(v_s + st * C::kKVBytes);
      float s[BN / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < Tile<HD>::kKSteps; ++kk)
        Mma<BN>::ss(s, desc_k<HD>(q_addr, C::kBM, wg * kRowsWG, kk),
                    desc_k<HD>(k_addr, BN, 0, kk), kk > 0);
      wg_commit();
      wg_wait_all();
      hold(s);

      // mask, then the online softmax on the fragment: a row lives in
      // the 4 threads of a quad
      const bool masked =
          needs_mask(qa, kRowsWG, kt * BN, BN, Sq, Sk, causal, window);
      float mx[2] = {kNegBig, kNegBig};
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float& x = s[4 * n + 2 * r + j];
            x = !masked || pair_ok(row + 8 * r, kt * BN + 8 * n + col + j,
                                   Sq, Sk, causal, window)
                    ? x * scale
                    : kNegBig;
            mx[r] = fmaxf(mx[r], x);
          }
      float alpha[2], m2[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(fmaxf(m[r], quad_max(mx[r])), kNegBig / 2);
        alpha[r] = exp2f((m[r] - m_new) * kLog2e);
        m[r] = m_new;
        m2[r] = m_new * kLog2e;
      }
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float& x = s[4 * n + 2 * r + j];
            x = exp2f(x * kLog2e - m2[r]);
            sum[r] += x;
          }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        lsum[r] = lsum[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          acc[4 * n + 2 * r] *= alpha[r];
          acc[4 * n + 2 * r + 1] *= alpha[r];
        }

      // acc += bf16(p) . v: p from registers, v's tile MN-major
      uint32_t pa[BN / 16][4];
      to_a(s, pa);
      bar_wait(&v_full[st], ph);
      hold(acc);
      hold(pa);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        Mma<HD>::rs(acc, pa[kk], desc_mn<HD>(v_addr, BN, kk), 1);
      wg_commit();
      wg_wait_all();
      hold(acc);
    } else {
      bar_wait(&v_full[st], ph);  // nothing to do here; keep the ring's pace
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[st]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row + 8 * r;
    if (qp >= Sq) continue;
    const float l_safe = fmaxf(lsum[r], 1e-30f);
    __nv_bfloat16* orow = o + ((static_cast<size_t>(b) * Sq + qp) * H + h) * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n + col) = pack_bf16(
          acc[4 * n + 2 * r] / l_safe, acc[4 * n + 2 * r + 1] / l_safe);
    if (lane % 4 == 0)
      lse[(static_cast<size_t>(b) * H + h) * Sq + qp] = m[r] + logf(l_safe);
  }
}

// --- K2 ---------------------------------------------------------------------
// Replaces _dkv_kernel (JAX ops/flash_attention.py:214) for bf16.

template <int HD>
struct DkvCfg {
  static constexpr int kConsumers = HD >= 128 ? 1 : 2;
  static constexpr int kBK = kRowsWG * kConsumers;  // keys of a block
  static constexpr int kBQ = 64;                    // rows of a q tile
  static constexpr int kThreads = kConsumers * kWG + 32;
  static constexpr int kKBytes = Tile<HD>::bytes(kBK);
  static constexpr int kQBytes = Tile<HD>::bytes(kBQ);
  static constexpr int kStatOffset = 2 * kKBytes + 2 * kStages * kQBytes;
  static constexpr int kBarOffset = kStatOffset + 2 * kStages * kBQ * 4;
  // k | v | q ring | do ring | lse and delta rings | barriers (kv_full,
  // full, empty) | alignment slack
  static constexpr int kSmem = kBarOffset + 8 * (1 + 2 * kStages) + 1024;
};

template <int HD>
__global__ void __launch_bounds__(DkvCfg<HD>::kThreads, 1)
    flash_dkv_sm90(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap do_map,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int H, int Sq, int Sk,
                   int causal, int window, float scale) {
  using C = DkvCfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = align_1024(smem_raw);
  uint8_t* v_s = k_s + C::kKBytes;
  uint8_t* q_s = v_s + C::kKBytes;
  uint8_t* do_s = q_s + kStages * C::kQBytes;
  float* lse_s = reinterpret_cast<float*>(k_s + C::kStatOffset);
  float* delta_s = lse_s + kStages * C::kBQ;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(k_s + C::kBarOffset);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int k0 = blockIdx.y * C::kBK;  // causal: the first keys are the longest
  int q_lo = 0, q_hi = (Sq + C::kBQ - 1) / C::kBQ - 1;
  if (causal) {
    q_lo = k0 / C::kBQ;
    if (window > 0)
      q_hi = min(q_hi, (k0 + C::kBK + window - 2) / C::kBQ);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    bar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 32);  // the producer warp's lanes, one with the bytes
      bar_init(&empty[s], C::kConsumers * 4);
    }
    bar_fence_init();
  }
  __syncthreads();

  if (warp == C::kConsumers * 4) {  // the producer warp
    if (lane == 0) {
      bar_arrive_tx(kv_full, 2 * C::kKBytes);
      load_tile<HD>(&k_map, kv_full, k_s, C::kBK, k0, h, b);
      load_tile<HD>(&v_map, kv_full, v_s, C::kBK, k0, h, b);
    }
    const float* lse_b = lse + (static_cast<size_t>(b) * H + h) * Sq;
    const float* delta_b = delta + (static_cast<size_t>(b) * H + h) * Sq;
    for (int qt = q_lo, i = 0; qt <= q_hi; ++qt, ++i) {
      const int st = i % kStages;
      bar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
      if (lane == 0) {
        bar_expect_tx(&full[st], 2 * C::kQBytes);
        load_tile<HD>(&q_map, &full[st], q_s + st * C::kQBytes, C::kBQ,
                      qt * C::kBQ, h, b);
        load_tile<HD>(&do_map, &full[st], do_s + st * C::kQBytes, C::kBQ,
                      qt * C::kBQ, h, b);
      }
      for (int r = lane; r < C::kBQ; r += 32) {
        const int qp = qt * C::kBQ + r;
        lse_s[st * C::kBQ + r] = qp < Sq ? lse_b[qp] * kLog2e : 0.f;
        delta_s[st * C::kBQ + r] = qp < Sq ? delta_b[qp] : 0.f;
      }
      bar_arrive(&full[st]);
    }
    return;
  }

  // a consumer warpgroup: keys k0 + 64 wg .. + 63 (the M dimension)
  const int wg = warp / 4, w = warp % 4;
  const int ka = k0 + wg * kRowsWG;
  const int key = ka + 16 * w + lane / 4;  // and key + 8
  const int col = 2 * (lane % 4);          // q columns, within each 8
  int my_lo = q_lo, my_hi = q_hi;          // this warpgroup's q tiles
  if (causal) {
    my_lo = ka / C::kBQ;
    if (window > 0)
      my_hi = min(q_hi, (ka + kRowsWG + window - 2) / C::kBQ);
  }
  const float scale2 = scale * kLog2e;

  float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const uint32_t k_addr = smem_u32(k_s), v_addr = smem_u32(v_s);
  bar_wait(kv_full, 0);

  for (int qt = q_lo, i = 0; qt <= q_hi; ++qt, ++i) {
    const int st = i % kStages;
    bar_wait(&full[st], (i / kStages) & 1);
    if (qt >= my_lo && qt <= my_hi) {
      const uint32_t q_addr = smem_u32(q_s + st * C::kQBytes);
      const uint32_t do_addr = smem_u32(do_s + st * C::kQBytes);
      // s^T = k . q^T and dp^T = v . do^T: rows keys, columns queries
      float s[32], dp[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < Tile<HD>::kKSteps; ++kk)
        Mma<64>::ss(s, desc_k<HD>(k_addr, C::kBK, wg * kRowsWG, kk),
                    desc_k<HD>(q_addr, C::kBQ, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < Tile<HD>::kKSteps; ++kk)
        Mma<64>::ss(dp, desc_k<HD>(v_addr, C::kBK, wg * kRowsWG, kk),
                    desc_k<HD>(do_addr, C::kBQ, 0, kk), kk > 0);
      wg_commit();
      wg_wait_all();
      hold(s);
      hold(dp);

      // p^T = exp(s^T scale - lse[q]) and ds^T = p^T (dp^T - delta[q])
      // scale, in place
      const float* lse2 = lse_s + st * C::kBQ;  // lse * log2(e)
      const float* dl = delta_s + st * C::kBQ;
      const bool masked = needs_mask(qt * C::kBQ, C::kBQ, ka, kRowsWG, Sq, Sk,
                                     causal, window);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = 8 * n + col + j;
          const float l2 = lse2[c], d = dl[c];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int idx = 4 * n + 2 * r + j;
            const float p =
                !masked || pair_ok(qt * C::kBQ + c, key + 8 * r, Sq, Sk,
                                   causal, window)
                    ? exp2f(s[idx] * scale2 - l2)
                    : 0.f;
            s[idx] = p;
            dp[idx] = p * (dp[idx] - d) * scale;
          }
        }

      // dv += p^T . do (p as hi + lo), dk += bf16(ds^T) . q: the q and do
      // tiles MN-major (K = their rows)
      uint32_t p_hi[4][4], p_lo[4][4], ds_a[4][4];
      to_a_split(s, p_hi, p_lo);
      to_a(dp, ds_a);
      hold(dk_acc);
      hold(dv_acc);
      hold(p_hi);
      hold(p_lo);
      hold(ds_a);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t do_desc = desc_mn<HD>(do_addr, C::kBQ, kk);
        Mma<HD>::rs(dv_acc, p_hi[kk], do_desc, 1);
        Mma<HD>::rs(dv_acc, p_lo[kk], do_desc, 1);
        Mma<HD>::rs(dk_acc, ds_a[kk], desc_mn<HD>(q_addr, C::kBQ, kk), 1);
      }
      wg_commit();
      wg_wait_all();
      hold(dk_acc);
      hold(dv_acc);
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[st]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = key + 8 * r;
    if (kp >= Sk) continue;
    const size_t off = ((static_cast<size_t>(b) * Sk + kp) * H + h) * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * n + col) =
          pack_bf16(dk_acc[4 * n + 2 * r], dk_acc[4 * n + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * n + col) =
          pack_bf16(dv_acc[4 * n + 2 * r], dv_acc[4 * n + 2 * r + 1]);
    }
  }
}

// --- K3 ---------------------------------------------------------------------
// Replaces _dq_kernel (JAX ops/flash_attention.py:254) for bf16: K1's loop
// shape (q rows resident, k tiles streamed) with K2's arithmetic.

template <int HD>
struct DqCfg {
  static constexpr int kConsumers = HD >= 128 ? 1 : 2;
  static constexpr int kBN = 64;                    // keys of a k tile
  static constexpr int kBM = kRowsWG * kConsumers;  // q rows of a block
  static constexpr int kThreads = kConsumers * kWG + 32;
  // two blocks an SM at hd <= 64, one block's p / ds arithmetic
  // overlapping the other's products: s, dp and dq (32 + 32 + 32 fp32
  // registers at hd 64) spill ~256 bytes under the 90-register cap, and
  // on the H100 that still beats one block an SM with no spill
  static constexpr int kMinBlocks = HD <= 64 ? 2 : 1;
  static constexpr int kQBytes = Tile<HD>::bytes(kBM);
  static constexpr int kKVBytes = Tile<HD>::bytes(kBN);
  static constexpr int kBarOffset = 2 * kQBytes + 2 * kStages * kKVBytes;
  // q | do | k ring | v ring | barriers (q_full, full, empty) | alignment
  // slack
  static constexpr int kSmem = kBarOffset + 8 * (1 + 2 * kStages) + 1024;
};

template <int HD>
__global__ void __launch_bounds__(DqCfg<HD>::kThreads, DqCfg<HD>::kMinBlocks)
    flash_dq_sm90(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  const __grid_constant__ CUtensorMap do_map,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int H, int Sq, int Sk,
                  int causal, int window, float scale) {
  using C = DqCfg<HD>;
  constexpr int BN = C::kBN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align_1024(smem_raw);
  uint8_t* do_s = q_s + C::kQBytes;
  uint8_t* k_s = do_s + C::kQBytes;
  uint8_t* v_s = k_s + kStages * C::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(q_s + C::kBarOffset);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kBM;  // longest rows first
  int k_lo = 0, k_hi = (Sk + BN - 1) / BN - 1;
  if (causal) {
    k_hi = min(k_hi, (q0 + C::kBM - 1) / BN);
    if (window > 0) k_lo = max(0, q0 - window + 1) / BN;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], C::kConsumers * 4);  // one arrival a consumer warp
    }
    bar_fence_init();
  }
  __syncthreads();

  if (warp == C::kConsumers * 4) {  // the producer warp
    if (lane == 0) {
      bar_arrive_tx(q_full, 2 * C::kQBytes);
      load_tile<HD>(&q_map, q_full, q_s, C::kBM, q0, h, b);
      load_tile<HD>(&do_map, q_full, do_s, C::kBM, q0, h, b);
      for (int kt = k_lo, i = 0; kt <= k_hi; ++kt, ++i) {
        const int st = i % kStages;
        bar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        bar_arrive_tx(&full[st], 2 * C::kKVBytes);
        load_tile<HD>(&k_map, &full[st], k_s + st * C::kKVBytes, BN, kt * BN,
                      h, b);
        load_tile<HD>(&v_map, &full[st], v_s + st * C::kKVBytes, BN, kt * BN,
                      h, b);
      }
    }
    return;
  }

  // a consumer warpgroup: q rows q0 + 64 wg .. + 63
  const int wg = warp / 4, w = warp % 4;
  const int qa = q0 + wg * kRowsWG;
  const int row = qa + 16 * w + lane / 4;  // and row + 8
  const int col = 2 * (lane % 4);          // and + 1, within each 8 columns
  int my_lo = k_lo, my_hi = k_hi;          // this warpgroup's k tiles
  if (causal) {
    my_hi = min(my_hi, (qa + kRowsWG - 1) / BN);
    if (window > 0) my_lo = max(k_lo, max(0, qa - window + 1) / BN);
  }
  const float scale2 = scale * kLog2e;
  // this thread's two rows' lse (times log2(e)) and delta
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row + 8 * r;
    const size_t at = (static_cast<size_t>(b) * H + h) * Sq + qp;
    lse2[r] = qp < Sq ? lse[at] * kLog2e : 0.f;
    dl[r] = qp < Sq ? delta[at] : 0.f;
  }
  float dq_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq_acc[i] = 0.f;
  const uint32_t q_addr = smem_u32(q_s), do_addr = smem_u32(do_s);
  bar_wait(q_full, 0);

  for (int kt = k_lo, i = 0; kt <= k_hi; ++kt, ++i) {
    const int st = i % kStages;
    bar_wait(&full[st], (i / kStages) & 1);
    if (kt >= my_lo && kt <= my_hi) {
      const uint32_t k_addr = smem_u32(k_s + st * C::kKVBytes);
      const uint32_t v_addr = smem_u32(v_s + st * C::kKVBytes);
      // s = q . k^T and dp = do . v^T: rows queries, columns keys
      float s[BN / 2], dp[BN / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < Tile<HD>::kKSteps; ++kk)
        Mma<BN>::ss(s, desc_k<HD>(q_addr, C::kBM, wg * kRowsWG, kk),
                    desc_k<HD>(k_addr, BN, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < Tile<HD>::kKSteps; ++kk)
        Mma<BN>::ss(dp, desc_k<HD>(do_addr, C::kBM, wg * kRowsWG, kk),
                    desc_k<HD>(v_addr, BN, 0, kk), kk > 0);
      wg_commit();
      wg_wait_all();
      hold(s);
      hold(dp);

      // p = exp(s scale - lse) and ds = p (dp - delta) scale, in place
      const bool masked =
          needs_mask(qa, kRowsWG, kt * BN, BN, Sq, Sk, causal, window);
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int idx = 4 * n + 2 * r + j;
            const float p =
                !masked || pair_ok(row + 8 * r, kt * BN + 8 * n + col + j, Sq,
                                   Sk, causal, window)
                    ? exp2f(s[idx] * scale2 - lse2[r])
                    : 0.f;
            dp[idx] = p * (dp[idx] - dl[r]) * scale;
          }

      // dq += bf16(ds) . k: ds from registers, k's tile MN-major
      uint32_t ds_a[BN / 16][4];
      to_a(dp, ds_a);
      hold(dq_acc);
      hold(ds_a);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        Mma<HD>::rs(dq_acc, ds_a[kk], desc_mn<HD>(k_addr, BN, kk), 1);
      wg_commit();
      wg_wait_all();
      hold(dq_acc);
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[st]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row + 8 * r;
    if (qp >= Sq) continue;
    __nv_bfloat16* drow =
        dq + ((static_cast<size_t>(b) * Sq + qp) * H + h) * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(drow + 8 * n + col) =
          pack_bf16(dq_acc[4 * n + 2 * r], dq_acc[4 * n + 2 * r + 1]);
  }
}

// --- the tile check ---------------------------------------------------------
// One warpgroup, one 64-row tile of q, k and v (rows s0 .. s0 + 63 of head
// h, batch b): s = q . k^T (SS, K-major) and o = bf16(s) . v (RS, v
// MN-major), written as fp32 [64][64] and [64][hd].  It runs the loads,
// descriptors and fragment maps of K1-K3 on one tile, so that a fault in
// them shows as a wrong product against torch.matmul.

template <int HD>
__global__ void __launch_bounds__(kWG)
    tile_check_sm90(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    float* __restrict__ s_out, float* __restrict__ o_out,
                    int s0, int h, int b) {
  constexpr int kBytes = Tile<HD>::bytes(kRowsWG);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align_1024(smem_raw);
  uint8_t* k_s = q_s + kBytes;
  uint8_t* v_s = k_s + kBytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(v_s + kBytes);
  if (threadIdx.x == 0) {
    bar_init(bar, 1);
    bar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bar_arrive_tx(bar, 3 * kBytes);
    load_tile<HD>(&q_map, bar, q_s, kRowsWG, s0, h, b);
    load_tile<HD>(&k_map, bar, k_s, kRowsWG, s0, h, b);
    load_tile<HD>(&v_map, bar, v_s, kRowsWG, s0, h, b);
  }
  bar_wait(bar, 0);

  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = 16 * w + lane / 4, col = 2 * (lane % 4);
  float s[32];
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < Tile<HD>::kKSteps; ++kk)
    Mma<64>::ss(s, desc_k<HD>(smem_u32(q_s), kRowsWG, 0, kk),
                desc_k<HD>(smem_u32(k_s), kRowsWG, 0, kk), kk > 0);
  wg_commit();
  wg_wait_all();
  hold(s);
  uint32_t sa[4][4];
  to_a(s, sa);
  float o[HD / 2];
  hold(sa);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    Mma<HD>::rs(o, sa[kk], desc_mn<HD>(smem_u32(v_s), kRowsWG, kk), kk > 0);
  wg_commit();
  wg_wait_all();
  hold(o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        s_out[(row + 8 * r) * 64 + 8 * n + col + j] = s[4 * n + 2 * r + j];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        o_out[(row + 8 * r) * HD + 8 * n + col + j] = o[4 * n + 2 * r + j];
  }
}

// --- launch -----------------------------------------------------------------

// A 4-D map over a BSHD bf16 tensor, dims (hd, H, S, B), box (one column
// block, 1, rows, 1), the tile's swizzle, zero fill out of bounds.
template <int HD>
cudaError_t make_map(CUtensorMap* map, const void* base, int B, int S, int H,
                     int rows) {
  using L = Tile<HD>;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(HD) * 2;
  const cuuint64_t strides[3] = {row, row * H, row * H * S};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(L::kBoxCols), 1u,
                             static_cast<cuuint32_t>(rows), 1u};
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      HD >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename KernelFn>
cudaError_t allow_smem(KernelFn kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse_in, *delta;
  void *o, *dk, *dv, *dq;
  float* lse_out;
  int B, H, Sq, Sk, causal, window;
  float scale;
  cudaStream_t stream;
};

template <int HD>
cudaError_t launch_fwd(const Args& a) {
  using C = FwdCfg<HD>;
  CUtensorMap qm, km, vm;
  cudaError_t err;
  if ((err = make_map<HD>(&qm, a.q, a.B, a.Sq, a.H, C::kBM)) != cudaSuccess ||
      (err = make_map<HD>(&km, a.k, a.B, a.Sk, a.H, C::kBN)) != cudaSuccess ||
      (err = make_map<HD>(&vm, a.v, a.B, a.Sk, a.H, C::kBN)) != cudaSuccess)
    return err;
  auto fn = flash_fwd_sm90<HD>;
  if ((err = allow_smem(fn, C::kSmem)) != cudaSuccess) return err;
  fn<<<dim3(a.B * a.H, (a.Sq + C::kBM - 1) / C::kBM), C::kThreads, C::kSmem,
       a.stream>>>(qm, km, vm, static_cast<__nv_bfloat16*>(a.o), a.lse_out,
                   a.H, a.Sq, a.Sk, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv(const Args& a) {
  using C = DkvCfg<HD>;
  CUtensorMap qm, km, vm, dom;
  cudaError_t err;
  if ((err = make_map<HD>(&qm, a.q, a.B, a.Sq, a.H, C::kBQ)) != cudaSuccess ||
      (err = make_map<HD>(&dom, a.dout, a.B, a.Sq, a.H, C::kBQ)) !=
          cudaSuccess ||
      (err = make_map<HD>(&km, a.k, a.B, a.Sk, a.H, C::kBK)) != cudaSuccess ||
      (err = make_map<HD>(&vm, a.v, a.B, a.Sk, a.H, C::kBK)) != cudaSuccess)
    return err;
  auto fn = flash_dkv_sm90<HD>;
  if ((err = allow_smem(fn, C::kSmem)) != cudaSuccess) return err;
  fn<<<dim3(a.B * a.H, (a.Sk + C::kBK - 1) / C::kBK), C::kThreads, C::kSmem,
       a.stream>>>(qm, km, vm, dom, a.lse_in, a.delta,
                   static_cast<__nv_bfloat16*>(a.dk),
                   static_cast<__nv_bfloat16*>(a.dv), a.H, a.Sq, a.Sk,
                   a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq(const Args& a) {
  using C = DqCfg<HD>;
  CUtensorMap qm, km, vm, dom;
  cudaError_t err;
  if ((err = make_map<HD>(&qm, a.q, a.B, a.Sq, a.H, C::kBM)) != cudaSuccess ||
      (err = make_map<HD>(&dom, a.dout, a.B, a.Sq, a.H, C::kBM)) !=
          cudaSuccess ||
      (err = make_map<HD>(&km, a.k, a.B, a.Sk, a.H, C::kBN)) != cudaSuccess ||
      (err = make_map<HD>(&vm, a.v, a.B, a.Sk, a.H, C::kBN)) != cudaSuccess)
    return err;
  auto fn = flash_dq_sm90<HD>;
  if ((err = allow_smem(fn, C::kSmem)) != cudaSuccess) return err;
  fn<<<dim3(a.B * a.H, (a.Sq + C::kBM - 1) / C::kBM), C::kThreads, C::kSmem,
       a.stream>>>(qm, km, vm, dom, a.lse_in, a.delta,
                   static_cast<__nv_bfloat16*>(a.dq), a.H, a.Sq, a.Sk,
                   a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_tile_check(const Args& a, float* s_out, float* o_out,
                              int s0, int h, int b) {
  constexpr int kSmem = 3 * Tile<HD>::bytes(kRowsWG) + 8 + 1024;
  CUtensorMap qm, km, vm;
  cudaError_t err;
  if ((err = make_map<HD>(&qm, a.q, a.B, a.Sq, a.H, kRowsWG)) != cudaSuccess ||
      (err = make_map<HD>(&km, a.k, a.B, a.Sq, a.H, kRowsWG)) != cudaSuccess ||
      (err = make_map<HD>(&vm, a.v, a.B, a.Sq, a.H, kRowsWG)) != cudaSuccess ||
      (err = allow_smem(tile_check_sm90<HD>, kSmem)) != cudaSuccess)
    return err;
  tile_check_sm90<HD><<<1, kWG, kSmem, a.stream>>>(qm, km, vm, s_out, o_out,
                                                   s0, h, b);
  return cudaGetLastError();
}

cudaError_t check(const Args& a, int hd) {
  if (a.B <= 0 || a.H <= 0 || a.Sq <= 0 || a.Sk <= 0)
    return cudaErrorInvalidValue;
  if (hd != 32 && hd != 64 && hd != 128) return cudaErrorInvalidValue;
  if (a.causal && a.Sq != a.Sk) return cudaErrorInvalidValue;
  if (a.window > 0 && !a.causal) return cudaErrorInvalidValue;
  if ((long long)a.B * a.H > 0x7fffffffLL || (a.Sq + 63) / 64 > 65535 ||
      (a.Sk + 63) / 64 > 65535)
    return cudaErrorInvalidConfiguration;
  for (const void* p : {a.q, a.k, a.v, a.dout})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Each launches one kernel on `stream` and returns the launch's cudaError_t
// (0 on success).  bf16 operands only.  window <= 0: no window.  scale:
// 1 / sqrt(hd).

int tadnn_flash_forward_sm90(const void* q, const void* k, const void* v,
                             void* o, float* lse, int B, int H, int Sq,
                             int Sk, int hd, int causal, int window,
                             float scale, void* stream) {
  Args a{q,       k,       v,       q,   nullptr, nullptr, o,
         nullptr, nullptr, nullptr, lse, B,       H,       Sq,
         Sk,      causal,  window,  scale, static_cast<cudaStream_t>(stream)};
  cudaError_t err = check(a, hd);
  if (err != cudaSuccess) return err;
  switch (hd) {
    case 32:
      return launch_fwd<32>(a);
    case 64:
      return launch_fwd<64>(a);
    default:
      return launch_fwd<128>(a);
  }
}

int tadnn_flash_dkv_sm90(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, int B, int H,
                         int Sq, int Sk, int hd, int causal, int window,
                         float scale, void* stream) {
  Args a{q,  k,  v,      dout,   lse,   delta, nullptr,
         dk, dv, nullptr, nullptr, B,     H,     Sq,
         Sk, causal, window, scale, static_cast<cudaStream_t>(stream)};
  cudaError_t err = check(a, hd);
  if (err != cudaSuccess) return err;
  switch (hd) {
    case 32:
      return launch_dkv<32>(a);
    case 64:
      return launch_dkv<64>(a);
    default:
      return launch_dkv<128>(a);
  }
}

int tadnn_flash_dq_sm90(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* delta,
                        void* dq, int B, int H, int Sq, int Sk, int hd,
                        int causal, int window, float scale, void* stream) {
  Args a{q,       k,  v,      dout,   lse,   delta, nullptr,
         nullptr, nullptr, dq, nullptr, B,     H,     Sq,
         Sk,      causal,  window, scale, static_cast<cudaStream_t>(stream)};
  cudaError_t err = check(a, hd);
  if (err != cudaSuccess) return err;
  switch (hd) {
    case 32:
      return launch_dq<32>(a);
    case 64:
      return launch_dq<64>(a);
    default:
      return launch_dq<128>(a);
  }
}

// The tile check (see tile_check_sm90): q, k, v BSHD bf16 [B, S, H, hd];
// s_out fp32 [64][64], o_out fp32 [64][hd].
int tadnn_flash_sm90_tile_check(const void* q, const void* k, const void* v,
                                float* s_out, float* o_out, int B, int S,
                                int H, int hd, int s0, int h, int b,
                                void* stream) {
  const Args a{q,       k,       v,       nullptr, nullptr, nullptr,
               nullptr, nullptr, nullptr, nullptr, nullptr, B,
               H,       S,       S,       0,       0,       0.f,
               static_cast<cudaStream_t>(stream)};
  switch (hd) {
    case 32:
      return launch_tile_check<32>(a, s_out, o_out, s0, h, b);
    case 64:
      return launch_tile_check<64>(a, s_out, o_out, s0, h, b);
    case 128:
      return launch_tile_check<128>(a, s_out, o_out, s0, h, b);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
