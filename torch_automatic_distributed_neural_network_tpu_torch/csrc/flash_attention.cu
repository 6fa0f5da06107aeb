// Flash attention for Hopper (sm_90a) on the CUDA cores, fp32: the forward
// kernel (K1), the dK/dV kernel (K2) and the dQ kernel (K3).  bf16 K1-K3
// run on the tensor cores, in csrc/flash_attention_sm90.cu.
//
// Replace the Pallas TPU kernels in
//   torch_automatic_distributed_neural_network_tpu/ops/flash_attention.py:
//   K1 ::_fwd_kernel (driven by _fwd), K2 ::_dkv_kernel and K3 ::_dq_kernel
//   (both driven by _bwd_impl), for fp32 operands.
//
// Shapes (C-contiguous fp32, heads already broadcast for GQA):
//   q, o, do, dq       [B, Sq, H, hd]  read in place (BSHD)
//   k, v, dk, dv       [B, Sk, H, hd]
//   lse, delta         [B, H, Sq]
//   hd is 32, 64 or 128; causal needs Sq == Sk; window > 0 needs causal.
//
// Arithmetic, as the TPU kernels do it in fp32:
//   s = (q . k) * scale, masked to -0.7 * FLT_MAX where the pair may not
//   attend (key padding, causality, the window band: _pair_mask);
//   K1: online softmax over k tiles, running max clamped at half the mask
//       value, o = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30));
//   K2: p = exp(s - lse), dv += p^T . do, dp = do . v^T,
//       ds = p * (dp - delta) * scale, dk += ds^T . q;
//   K3: the same p and ds, dq += ds . k.
//
// What bounds them on this card: operations.  At the GPT-2 small training
// shape (S 1024, hd 64, causal) each kernel does ~128-256 flops per byte it
// must move, and computes its products with fp32 FMA on the CUDA cores (67
// TFLOP/s): TF32 on the tensor cores would keep ~3 decimal digits, too few
// for the fp32 kernels' 1e-4 bound against their plain versions.
//
// Design:
// - the TPU kernels carry (m, l, acc) or the dk/dv/dq accumulators across a
//   sequential grid axis in VMEM; here that axis is a loop inside one
//   thread block: K1 and K3 one block per (b*h, 64-row q tile) looping over
//   k tiles, K2 one block per (b*h, 64-key k tile) looping over q tiles;
// - each loop starts and stops at the first and last tile with a pair that
//   may attend (_block_relevant turned into loop bounds), so causal work is
//   the lower triangle and windowed work the band;
// - tiles are staged in shared memory, rows padded by one float so column
//   reads are free of bank conflicts; the next tile's 16-byte loads into
//   registers start before the current tile is computed;
// - each thread owns 4 rows of a 64 x 64 score tile (16 row groups of
//   threads, the threads of a row group reduce a row with warp shuffles)
//   and the same 4 rows of the output accumulator, in registers;
// - the ragged edge (S not a multiple of 64) is masked in the kernel: rows
//   past the end are loaded as zeros, never attend, and are not written;
// - the tiles take 65-162 KB of dynamic shared memory (K2 at hd 128 the
//   most), opted into with cudaFuncSetAttribute before each launch; a
//   refused launch comes back as its error code.
// Every accumulator is private to one block, so results do not depend on
// the run (no atomics).

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <initializer_list>

namespace {

// Rows of a q tile and keys of a k tile.  64 keeps K2's six fp32 tiles
// (k, v, q, do at hd 128, the p and ds score tiles) within one block's
// shared memory (162 KB of 227 KB) and splits evenly into 16 row groups
// of 4 rows, while a causal S = 1024 still gives 16 x 16 tiles, enough
// blocks to fill 132 SMs at the training shapes.
constexpr int kTile = 64;
constexpr int kRows = 4;    // tile rows per thread: 64 rows over 16 row groups
constexpr float kNegBig = -0.7f * FLT_MAX;

template <int HD>
struct Geom {
  // 256 threads at hd 128 keep the per-thread accumulators of K2 (4 rows x
  // 8 columns of both dk and dv) inside the register file
  static constexpr int kThreads = HD >= 128 ? 256 : 128;
  static constexpr int kCG = kThreads / 16;  // threads sharing a row group
  static constexpr int kSC = kTile / kCG;    // score columns per thread
  static constexpr int kOC = HD / kCG;       // output columns per thread
  static constexpr int kLd = HD + 1;         // smem row stride of a [64][hd] tile
  static constexpr int kLdS = kTile + 1;     // smem row stride of a [64][64] tile
};

// Reductions over the kCG threads of a row group (neighbouring lanes).
template <int CG>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = CG / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
template <int CG>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = CG / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// One [64][hd] tile of a BSHD tensor, staged in registers between its
// 16-byte loads from device memory and its store to shared memory.
template <int HD>
struct TileRegs {
  using G = Geom<HD>;
  static constexpr int kEl = 4;                        // floats per chunk
  static constexpr int kCpr = HD / kEl;                // chunks per row
  static constexpr int kPer = kTile * kCpr / G::kThreads;  // chunks per thread
  static_assert(kTile * kCpr % G::kThreads == 0, "tile must split evenly");

  uint4 c[kPer];

  // rows t0 .. t0 + 63 of `base` (row r at base + r * row_stride); rows at
  // or past `n_rows` load as zeros
  __device__ __forceinline__ void load(const float* __restrict__ base,
                                       size_t row_stride, int t0, int n_rows,
                                       int tid) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int chunk = tid + j * G::kThreads;
      const int row = t0 + chunk / kCpr;
      c[j] = make_uint4(0u, 0u, 0u, 0u);
      if (row < n_rows)
        c[j] = reinterpret_cast<const uint4*>(base + row * row_stride)
            [chunk % kCpr];
    }
  }

  __device__ __forceinline__ void store(float* dst, int tid) const {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int chunk = tid + j * G::kThreads;
      const int r = chunk / kCpr;
      const int d0 = (chunk % kCpr) * kEl;
      float* d = dst + r * G::kLd + d0;
      d[0] = __uint_as_float(c[j].x);
      d[1] = __uint_as_float(c[j].y);
      d[2] = __uint_as_float(c[j].z);
      d[3] = __uint_as_float(c[j].w);
    }
  }
};

// _pair_mask: may query position qp attend key position kp?
__device__ __forceinline__ bool pair_ok(int qp, int kp, int Sq, int Sk,
                                        int causal, int window) {
  return qp < Sq && kp < Sk && (!causal || qp >= kp) &&
         (window <= 0 || qp - kp < window);
}

// _block_relevant as loop bounds: the k tiles a q tile starting at q0 may
// attend, and the q tiles a k tile starting at k0 may be attended from.
__device__ __forceinline__ void k_range(int q0, int nk, int causal,
                                        int window, int* lo, int* hi) {
  *lo = 0;
  *hi = nk - 1;
  if (causal) {
    *hi = min(*hi, (q0 + kTile - 1) / kTile);
    if (window > 0) *lo = max(0, q0 - window + 1) / kTile;
  }
}
__device__ __forceinline__ void q_range(int k0, int nq, int causal,
                                        int window, int* lo, int* hi) {
  *lo = 0;
  *hi = nq - 1;
  if (causal) {
    *lo = k0 / kTile;
    if (window > 0) *hi = min(*hi, (k0 + kTile + window - 2) / kTile);
  }
}

// s[i][j] = sum_d a[row_i][d] * b[col_j][d] over two smem tiles: rows
// rg * 4 + i of `a`, columns cg + kCG * j of `b`.
template <int HD>
__device__ __forceinline__ void tile_dots(const float* a, const float* b,
                                          int rg, int cg,
                                          float (&s)[kRows][Geom<HD>::kSC]) {
  using G = Geom<HD>;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < G::kSC; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float av[kRows], bv[G::kSC];
#pragma unroll
    for (int i = 0; i < kRows; ++i) av[i] = a[(rg * kRows + i) * G::kLd + d];
#pragma unroll
    for (int j = 0; j < G::kSC; ++j) bv[j] = b[(cg + G::kCG * j) * G::kLd + d];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < G::kSC; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][j] += sum_r w[r][row_i] * x[r][col_j] (transposed = true) or
// sum_r w[row_i][r] * x[r][col_j] (false): w a [64][64] smem tile, x a
// [64][hd] smem tile; rows rg * 4 + i, columns cg + kCG * j.
template <int HD, bool kTransposed>
__device__ __forceinline__ void tile_accumulate(
    const float* w, const float* x, int rg, int cg,
    float (&acc)[kRows][Geom<HD>::kOC]) {
  using G = Geom<HD>;
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    float wv[kRows], xv[G::kOC];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = rg * kRows + i;
      wv[i] = kTransposed ? w[r * G::kLdS + row] : w[row * G::kLdS + r];
    }
#pragma unroll
    for (int j = 0; j < G::kOC; ++j) xv[j] = x[r * G::kLd + cg + G::kCG * j];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < G::kOC; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
  }
}

template <int HD>
size_t smem_floats(int kernel) {
  using G = Geom<HD>;
  const size_t t = (size_t)kTile * G::kLd, s = (size_t)kTile * G::kLdS;
  switch (kernel) {
    case 0:  // K1: q, k, v tiles and the p tile
      return 3 * t + s;
    case 1:  // K2: k, v, q, do tiles, the p and ds tiles, lse and delta
      return 4 * t + 2 * s + 2 * kTile;
    default:  // K3: q, do, k, v tiles and the ds tile
      return 4 * t + s;
  }
}

// --- K1 --------------------------------------------------------------------
// Replaces _fwd_kernel (JAX ops/flash_attention.py:99).  Bound: at the
// GPT-2 training shape it must move ~51 MB and do 1.3e10 flops, so the
// bound is bytes (0.015 ms); this version is held back by its fp32 FMA
// from shared memory instead.  Design: q tile staged once, k/v tiles
// streamed with the next pair's loads in flight, (m, l, acc) in
// registers for the whole k loop, one write of o and lse at the end.

template <int HD>
__global__ void __launch_bounds__(Geom<HD>::kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int Sq, int Sk,
                     int causal, int window, float scale) {
  using G = Geom<HD>;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kTile * G::kLd;
  float* v_s = k_s + kTile * G::kLd;
  float* p_s = v_s + kTile * G::kLd;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // longest rows first
  const int tid = threadIdx.x, rg = tid / G::kCG, cg = tid % G::kCG;
  const size_t rs = (size_t)H * HD;
  const float* qb = q + ((size_t)b * Sq * H + h) * HD;
  const float* kb = k + ((size_t)b * Sk * H + h) * HD;
  const float* vb = v + ((size_t)b * Sk * H + h) * HD;

  int k_lo, k_hi;
  k_range(q0, (Sk + kTile - 1) / kTile, causal, window, &k_lo, &k_hi);

  TileRegs<HD> qr, kr, vr;
  qr.load(qb, rs, q0, Sq, tid);
  kr.load(kb, rs, k_lo * kTile, Sk, tid);
  vr.load(vb, rs, k_lo * kTile, Sk, tid);
  qr.store(q_s, tid);

  float m[kRows], l[kRows], acc[kRows][G::kOC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < G::kOC; ++j) acc[i][j] = 0.f;
  }

  for (int kt = k_lo; kt <= k_hi; ++kt) {
    kr.store(k_s, tid);
    vr.store(v_s, tid);
    __syncthreads();
    if (kt < k_hi) {  // in flight while this tile is computed
      kr.load(kb, rs, (kt + 1) * kTile, Sk, tid);
      vr.load(vb, rs, (kt + 1) * kTile, Sk, tid);
    }
    float s[kRows][G::kSC];
    tile_dots<HD>(q_s, k_s, rg, cg, s);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = rg * kRows + i;
      float mx = kNegBig;
#pragma unroll
      for (int j = 0; j < G::kSC; ++j) {
        const int kp = kt * kTile + cg + G::kCG * j;
        s[i][j] = pair_ok(q0 + row, kp, Sq, Sk, causal, window)
                      ? s[i][j] * scale
                      : kNegBig;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = group_max<G::kCG>(mx);
      const float m_new = fmaxf(fmaxf(m[i], mx), kNegBig / 2);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < G::kSC; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        p_s[row * G::kLdS + cg + G::kCG * j] = p;
      }
      sum = group_sum<G::kCG>(sum);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < G::kOC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    tile_accumulate<HD, false>(p_s, v_s, rg, cg, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + rg * kRows + i;
    if (qp >= Sq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    float* orow = o + (((size_t)b * Sq + qp) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < G::kOC; ++j) orow[cg + G::kCG * j] = acc[i][j] / l_safe;
    if (cg == 0) lse[((size_t)b * H + h) * Sq + qp] = m[i] + logf(l_safe);
  }
}

// --- K2 --------------------------------------------------------------------
// Replaces _dkv_kernel (JAX ops/flash_attention.py:214).  Bound: four
// products over ~76 MB at the GPT-2 training shape, operations (0.026
// ms).  Design: the k and v tiles stay in shared memory while the q and
// do tiles stream past; dk and dv accumulate in registers and are
// written once, so no atomics and no second pass.

template <int HD>
__global__ void __launch_bounds__(Geom<HD>::kThreads)
    flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int Sq, int Sk, int causal,
                     int window, float scale) {
  using G = Geom<HD>;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTile * G::kLd;
  float* q_s = v_s + kTile * G::kLd;
  float* do_s = q_s + kTile * G::kLd;
  float* p_s = do_s + kTile * G::kLd;
  float* ds_s = p_s + kTile * G::kLdS;
  float* lse_s = ds_s + kTile * G::kLdS;
  float* delta_s = lse_s + kTile;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int k0 = blockIdx.y * kTile;  // causal: the first keys are the longest
  const int tid = threadIdx.x, rg = tid / G::kCG, cg = tid % G::kCG;
  const size_t rs = (size_t)H * HD;
  const float* qb = q + ((size_t)b * Sq * H + h) * HD;
  const float* dob = dout + ((size_t)b * Sq * H + h) * HD;
  const float* lse_b = lse + ((size_t)b * H + h) * Sq;
  const float* delta_b = delta + ((size_t)b * H + h) * Sq;

  int q_lo, q_hi;
  q_range(k0, (Sq + kTile - 1) / kTile, causal, window, &q_lo, &q_hi);

  TileRegs<HD> ar, br;  // k and v, then q and do
  ar.load(k + ((size_t)b * Sk * H + h) * HD, rs, k0, Sk, tid);
  br.load(v + ((size_t)b * Sk * H + h) * HD, rs, k0, Sk, tid);
  ar.store(k_s, tid);
  br.store(v_s, tid);
  ar.load(qb, rs, q_lo * kTile, Sq, tid);
  br.load(dob, rs, q_lo * kTile, Sq, tid);

  float dk_acc[kRows][G::kOC], dv_acc[kRows][G::kOC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < G::kOC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int qt = q_lo; qt <= q_hi; ++qt) {
    ar.store(q_s, tid);
    br.store(do_s, tid);
    if (tid < kTile) {
      const int qp = qt * kTile + tid;
      lse_s[tid] = qp < Sq ? lse_b[qp] : 0.f;
      delta_s[tid] = qp < Sq ? delta_b[qp] : 0.f;
    }
    __syncthreads();
    if (qt < q_hi) {
      ar.load(qb, rs, (qt + 1) * kTile, Sq, tid);
      br.load(dob, rs, (qt + 1) * kTile, Sq, tid);
    }
    // scores and dp: rows are queries, columns keys
    float s[kRows][G::kSC], dp[kRows][G::kSC];
    tile_dots<HD>(q_s, k_s, rg, cg, s);
    tile_dots<HD>(do_s, v_s, rg, cg, dp);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = rg * kRows + i;
      const int qp = qt * kTile + row;
#pragma unroll
      for (int j = 0; j < G::kSC; ++j) {
        const int col = cg + G::kCG * j;
        const float p = pair_ok(qp, k0 + col, Sq, Sk, causal, window)
                            ? expf(s[i][j] * scale - lse_s[row])
                            : 0.f;
        p_s[row * G::kLdS + col] = p;
        ds_s[row * G::kLdS + col] = p * (dp[i][j] - delta_s[row]) * scale;
      }
    }
    __syncthreads();
    // accumulators: rows are keys, columns the head dimension
    tile_accumulate<HD, true>(p_s, do_s, rg, cg, dv_acc);
    tile_accumulate<HD, true>(ds_s, q_s, rg, cg, dk_acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int kp = k0 + rg * kRows + i;
    if (kp >= Sk) continue;
    const size_t off = (((size_t)b * Sk + kp) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < G::kOC; ++j) {
      dk[off + cg + G::kCG * j] = dk_acc[i][j];
      dv[off + cg + G::kCG * j] = dv_acc[i][j];
    }
  }
}

// --- K3 --------------------------------------------------------------------
// Replaces _dq_kernel (JAX ops/flash_attention.py:254).  Bound: three
// products over ~64 MB, operations (0.020 ms).  Design: as K1, with lse
// and delta read once per row into registers and dq accumulated in
// registers; it recomputes p rather than share it with K2 (two kernels,
// results independent of the run).

template <int HD>
__global__ void __launch_bounds__(Geom<HD>::kThreads)
    flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int Sq, int Sk, int causal, int window,
                    float scale) {
  using G = Geom<HD>;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kTile * G::kLd;
  float* k_s = do_s + kTile * G::kLd;
  float* v_s = k_s + kTile * G::kLd;
  float* ds_s = v_s + kTile * G::kLd;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // longest rows first
  const int tid = threadIdx.x, rg = tid / G::kCG, cg = tid % G::kCG;
  const size_t rs = (size_t)H * HD;
  const float* kb = k + ((size_t)b * Sk * H + h) * HD;
  const float* vb = v + ((size_t)b * Sk * H + h) * HD;

  int k_lo, k_hi;
  k_range(q0, (Sk + kTile - 1) / kTile, causal, window, &k_lo, &k_hi);

  TileRegs<HD> ar, br;  // q and do, then k and v
  ar.load(q + ((size_t)b * Sq * H + h) * HD, rs, q0, Sq, tid);
  br.load(dout + ((size_t)b * Sq * H + h) * HD, rs, q0, Sq, tid);
  ar.store(q_s, tid);
  br.store(do_s, tid);
  ar.load(kb, rs, k_lo * kTile, Sk, tid);
  br.load(vb, rs, k_lo * kTile, Sk, tid);

  float lse_r[kRows], delta_r[kRows], dq_acc[kRows][G::kOC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + rg * kRows + i;
    const size_t at = ((size_t)b * H + h) * Sq + qp;
    lse_r[i] = qp < Sq ? lse[at] : 0.f;
    delta_r[i] = qp < Sq ? delta[at] : 0.f;
#pragma unroll
    for (int j = 0; j < G::kOC; ++j) dq_acc[i][j] = 0.f;
  }

  for (int kt = k_lo; kt <= k_hi; ++kt) {
    ar.store(k_s, tid);
    br.store(v_s, tid);
    __syncthreads();
    if (kt < k_hi) {
      ar.load(kb, rs, (kt + 1) * kTile, Sk, tid);
      br.load(vb, rs, (kt + 1) * kTile, Sk, tid);
    }
    float s[kRows][G::kSC], dp[kRows][G::kSC];
    tile_dots<HD>(q_s, k_s, rg, cg, s);
    tile_dots<HD>(do_s, v_s, rg, cg, dp);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = rg * kRows + i;
#pragma unroll
      for (int j = 0; j < G::kSC; ++j) {
        const int col = cg + G::kCG * j;
        const float p =
            pair_ok(q0 + row, kt * kTile + col, Sq, Sk, causal, window)
                ? expf(s[i][j] * scale - lse_r[i])
                : 0.f;
        ds_s[row * G::kLdS + col] = p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();
    tile_accumulate<HD, false>(ds_s, k_s, rg, cg, dq_acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + rg * kRows + i;
    if (qp >= Sq) continue;
    float* row = dq + (((size_t)b * Sq + qp) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < G::kOC; ++j) row[cg + G::kCG * j] = dq_acc[i][j];
  }
}

// --- launch ----------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse_in, *delta;
  void *o, *dq, *dk, *dv;
  float* lse_out;
  int B, H, Sq, Sk, causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename KernelFn>
cudaError_t prepare(KernelFn kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int HD>
cudaError_t launch(int kernel, const Args& a) {
  using G = Geom<HD>;
  const size_t smem = smem_floats<HD>(kernel) * sizeof(float);
  const int nq = (a.Sq + kTile - 1) / kTile, nk = (a.Sk + kTile - 1) / kTile;
  const dim3 threads(G::kThreads);
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  cudaError_t err;
  switch (kernel) {
    case 0: {
      auto fn = flash_fwd_kernel<HD>;
      if ((err = prepare(fn, smem)) != cudaSuccess) return err;
      fn<<<dim3(a.B * a.H, nq), threads, smem, a.stream>>>(
          q, k, v, static_cast<float*>(a.o), a.lse_out, a.H, a.Sq, a.Sk,
          a.causal, a.window, a.scale);
      break;
    }
    case 1: {
      auto fn = flash_dkv_kernel<HD>;
      if ((err = prepare(fn, smem)) != cudaSuccess) return err;
      fn<<<dim3(a.B * a.H, nk), threads, smem, a.stream>>>(
          q, k, v, dout, a.lse_in, a.delta, static_cast<float*>(a.dk),
          static_cast<float*>(a.dv), a.H, a.Sq, a.Sk, a.causal, a.window,
          a.scale);
      break;
    }
    default: {
      auto fn = flash_dq_kernel<HD>;
      if ((err = prepare(fn, smem)) != cudaSuccess) return err;
      fn<<<dim3(a.B * a.H, nq), threads, smem, a.stream>>>(
          q, k, v, dout, a.lse_in, a.delta, static_cast<float*>(a.dq), a.H,
          a.Sq, a.Sk, a.causal, a.window, a.scale);
      break;
    }
  }
  return cudaGetLastError();
}

cudaError_t run(int kernel, int hd, const Args& a) {
  if (a.B <= 0 || a.H <= 0 || a.Sq <= 0 || a.Sk <= 0)
    return cudaErrorInvalidValue;
  if (a.causal && a.Sq != a.Sk) return cudaErrorInvalidValue;
  if (a.window > 0 && !a.causal) return cudaErrorInvalidValue;
  if ((long long)a.B * a.H > 0x7fffffffLL ||
      (a.Sq + kTile - 1) / kTile > 65535 || (a.Sk + kTile - 1) / kTile > 65535)
    return cudaErrorInvalidConfiguration;
  for (const void* p : {a.q, a.k, a.v, a.dout})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  switch (hd) {
    case 32:
      return launch<32>(kernel, a);
    case 64:
      return launch<64>(kernel, a);
    case 128:
      return launch<128>(kernel, a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Each launches one kernel on `stream` and returns the launch's cudaError_t
// (0 on success).  fp32 operands only.  window <= 0: no window.  scale:
// 1 / sqrt(hd).

int tadnn_flash_forward(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int H, int Sq, int Sk,
                        int hd, int causal, int window, float scale,
                        void* stream) {
  Args a{q,  k,  v, nullptr, nullptr, nullptr, o,      nullptr, nullptr,
         nullptr, lse, B, H, Sq, Sk, causal, window, scale,
         static_cast<cudaStream_t>(stream)};
  a.dout = q;  // nothing to read; keeps the alignment check uniform
  return run(0, hd, a);
}

int tadnn_flash_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, int B, int H, int Sq, int Sk,
                    int hd, int causal, int window, float scale,
                    void* stream) {
  Args a{q,   k,  v,  dout,   lse, delta, nullptr, nullptr, dk,
         dv, nullptr, B, H, Sq, Sk, causal, window, scale,
         static_cast<cudaStream_t>(stream)};
  return run(1, hd, a);
}

int tadnn_flash_dq(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int B, int H, int Sq, int Sk, int hd,
                   int causal, int window, float scale, void* stream) {
  Args a{q,  k,  v,  dout,   lse, delta, nullptr, dq, nullptr,
         nullptr, nullptr, B, H, Sq, Sk, causal, window, scale,
         static_cast<cudaStream_t>(stream)};
  return run(2, hd, a);
}

const char* tadnn_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
