// Paged decode attention for Hopper (sm_90a): one query token per slot,
// keys and values read from a block-paged pool through a per-slot block
// table.
//
// Replaces the Pallas TPU kernel
//   torch_automatic_distributed_neural_network_tpu/ops/paged_attention.py
//   ::_decode_kernel (driven by _paged_attention_local).
//
// Shapes (C-contiguous):
//   q       [S, kvH, G, hd]    fp32 or bf16 (the [S, Hq, hd] query, kv-major)
//   k, v    [NB, bs, kvH, hd]  fp32, bf16 or int8 (one layer of the pool)
//   k_scale [NB, bs, kvH]      fp32, int8 pools only (one scale per token, head)
//   tables  [S, MB]            int32 block ids, null-padded
//   ctx     [S]                int32, keys 0..ctx inclusive are attended
//   out     [S, kvH, G, hd]    q's type
//   hd is 32, 64 or 128.
//
// What bounds it: device-memory bytes.  A decode step reads every cached
// key and value row of every slot once and does 4 flops per element read
// (two dot products), far below the card's ~20 fp32 flops per byte, so
// the floor is sum_s (ctx_s + 1) * kvH * hd * 2 * itemsize over the HBM
// rate.
//
// Design (simple and correct first; split-K over blocks, TMA page loads
// and tensor-core products are later work):
// - one thread block per (slot, kv head); its G query rows are the GQA
//   group of that kv head, so no head broadcast is ever materialized;
// - the block walks the slot's tokens in tiles of 32 (one warp's lanes),
//   from the first block a sliding window can reach to the block holding
//   ctx: the same block skip as the TPU kernel;
// - each tile's K and V rows are gathered through the table with 16-byte
//   loads into registers, and the NEXT tile's loads are issued before the
//   current tile is computed, so device-memory latency overlaps the math;
//   rows land in shared memory as fp32 (int8 rows multiplied by their
//   scale), padded by one float so column reads are free of bank
//   conflicts;
// - one warp per query row computes the tile's 32 scores (lane = token),
//   masks them, and folds them into the row's online-softmax state
//   (running max m, sum l) with warp shuffles; then all threads update
//   the fp32 accumulator acc[G][hd] = acc * alpha + p . V.
// The TPU kernel's guards are kept: masked scores are -0.7 * FLT_MAX,
// the running max is clamped at half of that, and l is floored at 1e-30
// on output, so a slot with no attended key yields zeros, not NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 32;      // tokens per tile: one per lane of a warp
constexpr int kThreads = 128;  // four warps per block
constexpr int kWarps = kThreads / 32;
constexpr float kNegBig = -0.7f * FLT_MAX;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The 16 / sizeof(KVT) elements of one 16-byte chunk, as floats.
__device__ __forceinline__ void unpack(const uint4& c, float* out, float) {
  out[0] = __uint_as_float(c.x);
  out[1] = __uint_as_float(c.y);
  out[2] = __uint_as_float(c.z);
  out[3] = __uint_as_float(c.w);
}
__device__ __forceinline__ void unpack(const uint4& c, float* out,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 is the high half of an fp32
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& c, float* out, int8_t) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)  // sign-extend byte b of word i
      out[4 * i + b] =
          static_cast<float>(static_cast<int32_t>(w[i] << (24 - 8 * b)) >> 24);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_bytes(int G, int hd) {
  const int ld = hd + 1;
  return sizeof(float) *
         (size_t)(2 * kTile * ld + 2 * G * hd + G * kTile + 3 * G);
}

// One tile's K and V chunks, staged in registers between their load
// from device memory and their store to shared memory.
template <typename KVT, int HD>
struct TileRegs {
  static constexpr int kEl = 16 / sizeof(KVT);  // elements per chunk
  static constexpr int kCpr = HD / kEl;          // chunks per row
  static constexpr int kChunks = kTile * kCpr;   // chunks per tile
  static constexpr int kPer = (kChunks + kThreads - 1) / kThreads;
  static constexpr bool kScaled = std::is_same<KVT, int8_t>::value;

  uint4 k[kPer], v[kPer];
  float ks[kPer], vs[kPer];

  __device__ __forceinline__ void load(const KVT* __restrict__ k_pool,
                                       const KVT* __restrict__ v_pool,
                                       const float* __restrict__ k_scale,
                                       const float* __restrict__ v_scale,
                                       const int* __restrict__ table, int t0,
                                       int tok_end, int bs, int kvH, int h,
                                       int tid) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = tid + j * kThreads;
      k[j] = v[j] = make_uint4(0u, 0u, 0u, 0u);
      ks[j] = vs[j] = 1.f;
      const int pos = t0 + c / kCpr;
      if (c < kChunks && pos < tok_end) {
        const size_t row =
            ((size_t)table[pos / bs] * bs + pos % bs) * kvH + h;
        const int off = c % kCpr;
        k[j] = reinterpret_cast<const uint4*>(k_pool + row * HD)[off];
        v[j] = reinterpret_cast<const uint4*>(v_pool + row * HD)[off];
        if (kScaled) {
          ks[j] = k_scale[row];
          vs[j] = v_scale[row];
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* k_s, float* v_s,
                                        int tid) const {
    constexpr int ld = HD + 1;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = tid + j * kThreads;
      if (c < kChunks) {
        const int t = c / kCpr;
        const int d0 = (c % kCpr) * kEl;
        float kx[kEl], vx[kEl];
        unpack(k[j], kx, KVT());
        unpack(v[j], vx, KVT());
#pragma unroll
        for (int e = 0; e < kEl; ++e) {
          k_s[t * ld + d0 + e] = kScaled ? kx[e] * ks[j] : kx[e];
          v_s[t * ld + d0 + e] = kScaled ? vx[e] * vs[j] : vx[e];
        }
      }
    }
  }
};

template <typename QT, typename KVT, int HD>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const QT* __restrict__ q,
                        const KVT* __restrict__ k_pool,
                        const KVT* __restrict__ v_pool,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ tables,
                        const int* __restrict__ ctx_lens,
                        QT* __restrict__ out, int kvH, int G, int bs, int MB,
                        int window, float scale) {
  extern __shared__ float smem[];
  constexpr int ld = HD + 1;
  float* k_s = smem;                // [kTile][ld]
  float* v_s = k_s + kTile * ld;    // [kTile][ld]
  float* q_s = v_s + kTile * ld;    // [G][HD]
  float* acc_s = q_s + G * HD;      // [G][HD]
  float* p_s = acc_s + G * HD;      // [G][kTile]
  float* m_s = p_s + G * kTile;     // [G]
  float* l_s = m_s + G;             // [G]
  float* alpha_s = l_s + G;         // [G]

  const int s = blockIdx.x / kvH;
  const int h = blockIdx.x % kvH;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ctx = ctx_lens[s];
  const int* table = tables + (size_t)s * MB;
  const size_t qo = ((size_t)s * kvH + h) * (size_t)G * HD;

  for (int i = tid; i < G * HD; i += kThreads) {
    q_s[i] = to_float(q[qo + i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegBig;
    l_s[g] = 0.f;
  }

  // attended keys: lo..ctx, where a window keeps only keys > ctx - window;
  // tokens are walked from the start of lo's block to the end of the
  // block holding ctx (never past the table's MB blocks)
  const int lo = window > 0 ? max(0, ctx - window + 1) : 0;
  const int tok_begin = (lo / bs) * bs;
  const int tok_end = ctx < 0 ? tok_begin : min(ctx / bs + 1, MB) * bs;

  TileRegs<KVT, HD> regs;
  if (tok_begin < tok_end)
    regs.load(k_pool, v_pool, k_scale, v_scale, table, tok_begin, tok_end,
              bs, kvH, h, tid);

  for (int t0 = tok_begin; t0 < tok_end; t0 += kTile) {
    regs.store(k_s, v_s, tid);
    __syncthreads();
    if (t0 + kTile < tok_end)  // in flight while this tile is computed
      regs.load(k_pool, v_pool, k_scale, v_scale, table, t0 + kTile,
                tok_end, bs, kvH, h, tid);

    for (int g = warp; g < G; g += kWarps) {
      const float* qg = q_s + g * HD;
      const float* kt = k_s + lane * ld;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) dot += qg[d] * kt[d];
      const int pos = t0 + lane;
      const bool valid = pos <= ctx && pos >= lo && pos < tok_end;
      const float sc = valid ? dot * scale : kNegBig;
      const float m_prev = m_s[g];
      const float m_new = fmaxf(fmaxf(m_prev, warp_max(sc)), kNegBig / 2);
      const float p = expf(sc - m_new);
      const float row_sum = warp_sum(p);
      p_s[g * kTile + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + row_sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * HD; i += kThreads) {
      const int g = i / HD;
      const int d = i - g * HD;
      const float* pg = p_s + g * kTile;
      float a = acc_s[i] * alpha_s[g];
#pragma unroll 8
      for (int t = 0; t < kTile; ++t) a += pg[t] * v_s[t * ld + d];
      acc_s[i] = a;
    }
    __syncthreads();
  }
  __syncthreads();  // no tile: the init above must still be visible

  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD;
    store(out + qo + i, acc_s[i] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename QT, typename KVT, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* tables,
                   const void* ctx, void* out, int S, int kvH, int G, int bs,
                   int MB, int window, float scale, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<QT, KVT, HD>;
  const size_t smem = smem_bytes(G, HD);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<S * kvH, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k),
      static_cast<const KVT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(ctx), static_cast<QT*>(out), kvH, G, bs, MB,
      window, scale);
  return cudaGetLastError();
}

template <typename QT, typename KVT>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const void* ks, const void* vs, const void* tables,
                        const void* ctx, void* out, int S, int kvH, int G,
                        int bs, int MB, int window, float scale,
                        cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<QT, KVT, 32>(q, k, v, ks, vs, tables, ctx, out, S, kvH,
                                 G, bs, MB, window, scale, stream);
    case 64:
      return launch<QT, KVT, 64>(q, k, v, ks, vs, tables, ctx, out, S, kvH,
                                 G, bs, MB, window, scale, stream);
    case 128:
      return launch<QT, KVT, 128>(q, k, v, ks, vs, tables, ctx, out, S, kvH,
                                  G, bs, MB, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename QT>
cudaError_t dispatch_kv(int kv_dtype, int hd, const void* q, const void* k,
                        const void* v, const void* ks, const void* vs,
                        const void* tables, const void* ctx, void* out, int S,
                        int kvH, int G, int bs, int MB, int window,
                        float scale, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return dispatch_hd<QT, float>(hd, q, k, v, ks, vs, tables, ctx, out, S,
                                    kvH, G, bs, MB, window, scale, stream);
    case 1:
      return dispatch_hd<QT, __nv_bfloat16>(hd, q, k, v, ks, vs, tables, ctx,
                                            out, S, kvH, G, bs, MB, window,
                                            scale, stream);
    case 2:
      return dispatch_hd<QT, int8_t>(hd, q, k, v, ks, vs, tables, ctx, out, S,
                                     kvH, G, bs, MB, window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns the launch's cudaError_t
// (0 on success).  q_dtype: 0 fp32, 1 bf16.  kv_dtype: 0 fp32, 1 bf16,
// 2 int8 (k_scale / v_scale then required).  hd: 32, 64 or 128; the
// pools 16-byte aligned.  window <= 0: no window.
int tadnn_paged_attention_decode(const void* q, const void* k_pool,
                                 const void* v_pool, const void* k_scale,
                                 const void* v_scale, const void* tables,
                                 const void* ctx_lens, void* out, int q_dtype,
                                 int kv_dtype, int S, int kvH, int G, int hd,
                                 int bs, int MB, int window, float scale,
                                 void* stream) {
  if (S <= 0 || kvH <= 0 || G <= 0 || bs <= 0 || MB <= 0)
    return cudaErrorInvalidValue;
  if ((kv_dtype == 2) != (k_scale != nullptr && v_scale != nullptr))
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(k_pool) |
       reinterpret_cast<uintptr_t>(v_pool)) % 16)
    return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0:
      return dispatch_kv<float>(kv_dtype, hd, q, k_pool, v_pool, k_scale,
                                v_scale, tables, ctx_lens, out, S, kvH, G, bs,
                                MB, window, scale, st);
    case 1:
      return dispatch_kv<__nv_bfloat16>(kv_dtype, hd, q, k_pool, v_pool,
                                        k_scale, v_scale, tables, ctx_lens,
                                        out, S, kvH, G, bs, MB, window, scale,
                                        st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory one launch needs, for the wrapper's checks.
size_t tadnn_paged_attention_smem_bytes(int G, int hd) {
  return smem_bytes(G, hd);
}

const char* tadnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
