// Paged decode attention for Hopper (sm_90a): one query token per slot,
// keys and values read from a block-paged pool through a per-slot block
// table, the context split over several thread blocks.
//
// Replaces the Pallas TPU kernel
//   torch_automatic_distributed_neural_network_tpu/ops/paged_attention.py
//   ::_decode_kernel (driven by _paged_attention_local).
//
// Shapes (C-contiguous):
//   q        [S, kvH, G, hd]    fp32 or bf16 (the [S, Hq, hd] query, kv-major)
//   k, v     [NB, bs, kvH, hd]  fp32, bf16 or int8 (one layer of the pool)
//   k_scale  [NB, bs, kvH]      fp32, int8 pools only (one scale per token, head)
//   tables   [S, MB]            int32 block ids, null-padded
//   ctx      [S]                int32, keys 0..ctx inclusive are attended
//   out      [S, kvH, G, hd]    q's type
//   hd is 32, 64 or 128; any block size bs.
//
// What bounds it: device-memory bytes.  A decode step reads every cached
// key and value row of every slot once and does 4 flops per element read
// (two dot products per query row of the group), ~4 G flops per byte at
// G query rows per kv head: far below the ~20 fp32 flops per byte of the
// CUDA cores, and further below the tensor cores' ~300 bf16 flops per
// byte, so tensor cores would not help and the math stays on the CUDA
// cores.  The floor is sum_s (ctx_s + 1) * kvH * hd * 2 * itemsize over
// the HBM rate.
//
// Design:
// - the grid is (slot * kv head, split, query-row group): the split count
//   comes from the shapes alone (the wrapper aims at two blocks an SM), so
//   a launch is reproducible; each block takes a page-aligned chunk of its
//   slot's attended pages (from the first page a sliding window reaches
//   to the page holding ctx: the TPU kernel's block skip), and a block's G
//   query rows (at most 8; more go to further blocks on grid z) are the
//   GQA group of its kv head, so no head broadcast is materialized;
// - bytes in flight: each of the block's four warps streams its share of
//   the chunk (segments of up to 16 rows of one page of one head) through
//   its own ring of 2-8 shared-memory stages (~8 KB), filled by TMA (4-D tensor
//   maps over the pool, box one segment of one head, the page id read
//   from the block table that the block loads itself); a warp refills a
//   stage as soon as it has read it, so the whole ring stays in flight.
//   Pages land as stored (bf16 / int8, not fp32 staging); the int8 scales
//   (4-byte rows, under TMA's 16-byte box minimum) are ordinary loads,
//   started before the stage's wait;
// - the math on the CUDA cores: a warp reads rows as 16-byte chunks (8
//   bytes for int8), kL lanes a row, 32 / kL rows at once, conflict-free;
//   each lane group keeps its own online-softmax state (running max m,
//   sum l, its chunk of acc[G][hd]) over its rows, rescaled once for every
//   four of them (their dot products independent of each other: the
//   warps' chains of dependent operations are what bound the kernel once
//   the pages are in flight), and the groups and the warps are merged
//   once at the end, in exp2 units;
// - the splits are merged inside the same launch: each block writes its
//   partial (m, l, acc) in fp32 to a workspace, then the last block of a
//   (slot, head, group), which finds out through a __threadfence and an
//   atomicAdd on a per-(slot, head, group) counter, merges the partials in
//   split order (so the result does not depend on the run), writes the
//   output and resets the counter to 0 for the next launch.  One split:
//   no workspace, the block writes the output itself.
// The TPU kernel's guards are kept: masked scores are -0.7 * FLT_MAX,
// the running max is clamped at half of that, and l is floored at 1e-30
// on output, so a slot with no attended key yields zeros, not NaN; a chunk
// with no attended key contributes m = -0.7 * FLT_MAX, l = 0.

#include <cuda_bf16.h>
#include <float.h>

#include <type_traits>

#include "sm90_common.cuh"

namespace {

constexpr int kWarps = 4;               // warps of a block, each its own stream
constexpr int kThreads = 32 * kWarps;
constexpr int kSegRows = 16;            // rows of one TMA box (a page, or 16 rows of one)
constexpr float kNegBig = -0.7f * FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;

// How a warp reads rows of a KVT pool at head dim HD.
template <typename KVT, int HD>
struct Rows {
  static constexpr int kChunk = sizeof(KVT) == 1 ? 8 : 16;  // bytes a lane reads
  static constexpr int kEl = kChunk / sizeof(KVT);          // elements a lane reads
  static constexpr int kL = HD / kEl;                       // lanes a row
  static constexpr int kR = 32 / kL;                        // rows a warp reads at once
  static constexpr int kRowBytes = HD * sizeof(KVT);
  static constexpr int kSegBytes = kSegRows * kRowBytes;    // one K or V box
  // stages a warp keeps in flight: ~8 KB of K and V, at least 2 (so a
  // block's ring stays small enough for several blocks an SM)
  static constexpr int kStages =
      8192 / (2 * kSegBytes) < 2   ? 2
      : 8192 / (2 * kSegBytes) > 8 ? 8
                                   : 8192 / (2 * kSegBytes);
  static constexpr int kRingBytes = kWarps * kStages * 2 * kSegBytes;
  static constexpr int kPasses = kSegRows / kR;  // row passes of a full segment
  static constexpr int kB = kPasses < 4 ? kPasses : 4;  // passes a softmax step
  static constexpr bool kScaled = std::is_same<KVT, int8_t>::value;
  static_assert(kL >= 1 && kL <= 32 && 32 % kL == 0, "a row's lanes");
};

// The kEl elements of one lane's chunk at `p` (shared memory), as floats.
__device__ __forceinline__ void unpack(const uint8_t* p, float (&x)[4],
                                       float) {
  const float4 c = *reinterpret_cast<const float4*>(p);
  x[0] = c.x;
  x[1] = c.y;
  x[2] = c.z;
  x[3] = c.w;
}
__device__ __forceinline__ void unpack(const uint8_t* p, float (&x)[8],
                                       __nv_bfloat16) {
  const uint4 c = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 is the high half of an fp32
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint8_t* p, float (&x)[8],
                                       int8_t) {
  const uint2 c = *reinterpret_cast<const uint2*>(p);
  const uint32_t w[2] = {c.x, c.y};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)  // sign-extend byte b of word i
      x[4 * i + b] =
          static_cast<float>(static_cast<int32_t>(w[i] << (24 - 8 * b)) >> 24);
}

__device__ __forceinline__ float load_q(const void* q, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i])
              : static_cast<const float*>(q)[i];
}
__device__ __forceinline__ void store_out(void* out, size_t i, float x,
                                          int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(out)[i] = x;
}

// (m, l, acc) += (m_o, l_o, acc_o): the online-softmax merge of two
// partial states, m in log2 units.  An empty state (m = -0.7 FLT_MAX,
// l = 0, acc = 0) leaves the other one as it is.
__device__ __forceinline__ void merge_weights(float m, float m_o, float* a,
                                              float* b, float* m_new) {
  *m_new = fmaxf(m, m_o);
  *a = exp2f(m - *m_new);
  *b = exp2f(m_o - *m_new);
}

// Shared memory of a launch, in bytes (the host's and the kernel's layout):
// the warps' rings (reused by the final merge), their full barriers and
// the slot's row of the block table.
template <typename KVT, int HD, int GM>
struct Smem {
  using R = Rows<KVT, HD>;
  static constexpr int kMergeBytes = kWarps * GM * (HD + 2) * 4;
  static constexpr int kRegion =
      R::kRingBytes > kMergeBytes ? R::kRingBytes : kMergeBytes;
  static constexpr int kBarOffset = kRegion;
  static constexpr int kIdsOffset = kBarOffset + kWarps * R::kStages * 8;
  static size_t bytes(int MB) { return kIdsOffset + 4 * (size_t)MB + 1024; }
};

// The pages [p_lo, p_end) of the table that hold keys lo .. ctx, and the
// chunk of them split `c` of `n_split` takes: [pb, pe).  The plain model of
// the same partition is ops/paged_attention.py::split_chunks.
__device__ __forceinline__ void chunk_of(int ctx, int window, int bs, int MB,
                                         int c, int n_split, int* lo,
                                         int* pb, int* pe) {
  *lo = window > 0 ? max(0, ctx - window + 1) : 0;
  const int p_lo = *lo / bs;
  const int p_end = ctx < 0 ? p_lo : min(ctx / bs + 1, MB);
  const int n_pages = max(p_end - p_lo, 0);
  const int per = (n_pages + n_split - 1) / n_split;
  *pb = p_lo + c * per;
  *pe = min(*pb + per, p_lo + n_pages);
}

template <typename KVT, int HD, int GM>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const void* __restrict__ q, int q_bf16,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ tables,
                        const int* __restrict__ ctx_lens,
                        void* __restrict__ out, float* __restrict__ partial,
                        int* __restrict__ counters, int kvH, int G, int bs,
                        int MB, int window, float scale) {
  using R = Rows<KVT, HD>;
  using L = Smem<KVT, HD, GM>;
  constexpr int kEl = R::kEl, kL = R::kL, kR = R::kR, kSw = R::kStages;
  constexpr int kW = GM * (HD + 2);  // floats of one partial: m, l, acc
  const float scale2 = scale * kLog2e;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* region = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
      ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(region + L::kBarOffset);
  int* row = reinterpret_cast<int*>(region + L::kIdsOffset);  // table[s]
  __shared__ int is_last;

  const int s = blockIdx.x / kvH, h = blockIdx.x % kvH;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int g0 = blockIdx.z * GM;
  const int lin = blockIdx.x * gridDim.z + blockIdx.z;  // (slot, head, group)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / kL, ch = lane % kL;  // row within a pass, chunk
  if (tid == 0) {
    tma_prefetch_map(&k_map);
    tma_prefetch_map(&v_map);
    for (int i = 0; i < kWarps * kSw; ++i) bar_init(&full[i], 1);
    bar_fence_init();
  }
  // the slot's whole table row, loaded beside ctx rather than after it
  const int ctx = ctx_lens[s];
  const int* table = tables + (size_t)s * MB;
  for (int i = tid; i < MB; i += kThreads) row[i] = table[i];
  int lo, pb, pe;
  chunk_of(ctx, window, bs, MB, split, n_split, &lo, &pb, &pe);
  const int np = max(pe - pb, 0);
  const int rows = min(bs, kSegRows);      // rows of a segment (the TMA box)
  const int spp = (bs + rows - 1) / rows;  // segments a page
  const int n_seg = np * spp;
  const int* ids = row + pb;               // this block's pages
  // this lane's chunk of the group's query rows, as fp32
  float qr[GM][kEl];
  const size_t q_row0 = ((size_t)s * kvH + h) * G + g0;
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < kEl; ++e)
      qr[g][e] = g0 + g < G
                     ? load_q(q, (q_row0 + g) * HD + ch * kEl + e, q_bf16)
                     : 0.f;
  __syncthreads();

  // this warp's segments: t = warp + kWarps * n of the chunk's n_seg
  uint8_t* ring = region + warp * kSw * 2 * R::kSegBytes;
  uint64_t* my_full = full + warp * kSw;
  const int n_mine = n_seg > warp ? (n_seg - warp + kWarps - 1) / kWarps : 0;
  auto fetch = [&](int n) {
    const int t = warp + kWarps * n, st = n % kSw;
    uint8_t* dst = ring + st * 2 * R::kSegBytes;
    const int page = ids[t / spp], r0 = (t % spp) * rows;
    bar_arrive_tx(&my_full[st], 2 * rows * R::kRowBytes);
    tma_load_4d(&k_map, &my_full[st], dst, 0, h, r0, page);
    tma_load_4d(&v_map, &my_full[st], dst + R::kSegBytes, 0, h, r0, page);
  };
  if (lane == 0)
    for (int n = 0; n < min(kSw, n_mine); ++n) fetch(n);

  float m[GM], l[GM], acc[GM][kEl];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegBig;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kEl; ++e) acc[g][e] = 0.f;
  }

  const int n_pass = (rows + kR - 1) / kR;  // row passes of a segment
  for (int n = 0; n < n_mine; ++n) {
    const int t = warp + kWarps * n, st = n % kSw;
    const int pi = t / spp, r0 = (t % spp) * rows;
    const int pos0 = (pb + pi) * bs + r0;  // position of the segment's row 0
    // int8: this lane's rows' scales, in flight while the stage lands
    float ks[R::kPasses], vs[R::kPasses];
#pragma unroll
    for (int pass = 0; pass < R::kPasses; ++pass) {
      ks[pass] = vs[pass] = 1.f;
      const int r = pass * kR + grp;
      if (R::kScaled && r < rows && r0 + r < bs) {
        const size_t at = ((size_t)ids[pi] * bs + r0 + r) * kvH + h;
        ks[pass] = k_scale[at];
        vs[pass] = v_scale[at];
      }
    }
    bar_wait(&my_full[st], (n / kSw) & 1);
    const uint8_t* kseg = ring + st * 2 * R::kSegBytes;
    const uint8_t* vseg = kseg + R::kSegBytes;
    // kB passes at a time: their scores first (independent dot products),
    // then one rescale of the running state, then their p . v
#pragma unroll
    for (int p0 = 0; p0 < R::kPasses; p0 += R::kB) {
      if (p0 >= n_pass) break;  // uniform across the warp
      float sc[GM][R::kB];
      bool ok[R::kB];
#pragma unroll
      for (int b = 0; b < R::kB; ++b) {
        const int r = (p0 + b) * kR + grp;  // < kSegRows: inside the stage
        const int pos = pos0 + r;
        ok[b] = p0 + b < n_pass && r < rows && r0 + r < bs && pos >= lo &&
                pos <= ctx;
        float kx[kEl];
        unpack(kseg + r * R::kRowBytes + ch * R::kChunk, kx, KVT());
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < kEl; ++e) d = fmaf(qr[g][e], kx[e], d);
#pragma unroll
          for (int o = 1; o < kL; o <<= 1)
            d += __shfl_xor_sync(0xffffffffu, d, o);
          sc[g][b] = ok[b] ? d * ks[p0 + b] * scale2 : kNegBig;  // log2 units
        }
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float mx = sc[g][0];
#pragma unroll
        for (int b = 1; b < R::kB; ++b) mx = fmaxf(mx, sc[g][b]);
        // no attended row among them: the state stays as it is (so a chunk
        // with no attended key keeps m = -0.7 FLT_MAX, l = 0)
        const float m_new =
            mx == kNegBig ? m[g] : fmaxf(fmaxf(m[g], mx), kNegBig / 2);
        const float alpha = exp2f(m[g] - m_new);
        l[g] *= alpha;
#pragma unroll
        for (int e = 0; e < kEl; ++e) acc[g][e] *= alpha;
        m[g] = m_new;
      }
#pragma unroll
      for (int b = 0; b < R::kB; ++b) {
        if (!ok[b]) continue;  // rows past the chunk: stale or zero-filled
        float vx[kEl];
        unpack(vseg + ((p0 + b) * kR + grp) * R::kRowBytes + ch * R::kChunk,
               vx, KVT());
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          const float p = exp2f(sc[g][b] - m[g]);
          l[g] += p;
          const float pv = p * vs[p0 + b];
#pragma unroll
          for (int e = 0; e < kEl; ++e) acc[g][e] = fmaf(pv, vx[e], acc[g][e]);
        }
      }
    }
    __syncwarp();
    if (lane == 0 && n + kSw < n_mine) {
      fence_proxy_async();  // the warp's reads of the stage before its refill
      fetch(n + kSw);
    }
  }

  // merge the warp's row groups (lanes kL, 2 kL, ... apart)
#pragma unroll
  for (int o = kL; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float a, b, m_new;
      merge_weights(m[g], __shfl_xor_sync(0xffffffffu, m[g], o), &a, &b,
                    &m_new);
      l[g] = l[g] * a + __shfl_xor_sync(0xffffffffu, l[g], o) * b;
#pragma unroll
      for (int e = 0; e < kEl; ++e)
        acc[g][e] =
            acc[g][e] * a + __shfl_xor_sync(0xffffffffu, acc[g][e], o) * b;
      m[g] = m_new;
    }

  // then the warps, in shared memory (the rings are drained)
  float* red = reinterpret_cast<float*>(region);  // [kWarps][GM][HD + 2]
  __syncthreads();
  if (grp == 0)
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float* rw = red + (warp * GM + g) * (HD + 2);
#pragma unroll
      for (int e = 0; e < kEl; ++e) rw[2 + ch * kEl + e] = acc[g][e];
      if (ch == 0) {
        rw[0] = m[g];
        rw[1] = l[g];
      }
    }
  __syncthreads();
  float* mine = n_split == 1 ? nullptr
                             : partial + ((size_t)lin * n_split + split) * kW;
  const size_t out_row0 = ((size_t)s * kvH + h) * G + g0;
  for (int x = tid; x < GM * HD; x += kThreads) {
    const int g = x / HD, d = x % HD;
    float mm = kNegBig, a = 0.f, ll = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* rw = red + (w * GM + g) * (HD + 2);
      float wa, wb, m_new;
      merge_weights(mm, rw[0], &wa, &wb, &m_new);
      a = a * wa + rw[2 + d] * wb;
      ll = ll * wa + rw[1] * wb;
      mm = m_new;
    }
    if (n_split == 1) {
      if (g0 + g < G)
        store_out(out, (out_row0 + g) * HD + d, a / fmaxf(ll, 1e-30f),
                  q_bf16);
    } else {
      mine[2 * GM + g * HD + d] = a;
      if (d == 0) {
        mine[g] = mm;
        mine[GM + g] = ll;
      }
    }
  }
  if (n_split == 1) return;

  // the last block of this (slot, head, group) merges the splits in order
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&counters[lin], 1) == n_split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* all = partial + (size_t)lin * n_split * kW;
  for (int x = tid; x < GM * HD; x += kThreads) {
    const int g = x / HD, d = x % HD;
    if (g0 + g >= G) continue;
    float mm = kNegBig, a = 0.f, ll = 0.f;
    for (int c = 0; c < n_split; ++c) {
      const float* pc = all + (size_t)c * kW;
      float wa, wb, m_new;
      merge_weights(mm, __ldcg(pc + g), &wa, &wb, &m_new);
      a = a * wa + __ldcg(pc + 2 * GM + g * HD + d) * wb;
      ll = ll * wa + __ldcg(pc + GM + g) * wb;
      mm = m_new;
    }
    store_out(out, (out_row0 + g) * HD + d, a / fmaxf(ll, 1e-30f), q_bf16);
  }
  if (tid == 0) counters[lin] = 0;  // ready for the next launch
}

// --- launch -----------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *ks, *vs, *tables, *ctx;
  void *out, *partial, *counters;
  int q_bf16, S, NB, kvH, G, bs, MB, window, n_split;
  float scale;
  cudaStream_t stream;
};

// Query rows a block takes: the group, or 8 at a time.
int group_rows(int G) { return G <= 1 ? 1 : G <= 4 ? 4 : 8; }

// A 4-D map over one pool [NB, bs, kvH, hd], dims (hd, kvH, bs, NB), box
// one segment of one head (hd, 1, rows, 1); rows past bs read as zeros.
template <typename KVT, int HD>
cudaError_t make_map(CUtensorMap* map, const void* base, const Args& a) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const CUtensorMapDataType type =
      sizeof(KVT) == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
      : sizeof(KVT) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                         : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(a.kvH),
                              static_cast<cuuint64_t>(a.bs),
                              static_cast<cuuint64_t>(a.NB)};
  const cuuint64_t row = static_cast<cuuint64_t>(HD) * sizeof(KVT);
  const cuuint64_t strides[3] = {row, row * a.kvH, row * a.kvH * a.bs};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(HD), 1u,
                             static_cast<cuuint32_t>(a.bs < kSegRows
                                                         ? a.bs
                                                         : kSegRows),
                             1u};
  const cuuint32_t unit[4] = {1u, 1u, 1u, 1u};
  const CUresult r = encode(
      map, type, 4, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename KVT, int HD, int GM>
cudaError_t launch(const Args& a) {
  using L = Smem<KVT, HD, GM>;
  CUtensorMap km, vm;
  cudaError_t err;
  if ((err = make_map<KVT, HD>(&km, a.k, a)) != cudaSuccess ||
      (err = make_map<KVT, HD>(&vm, a.v, a)) != cudaSuccess)
    return err;
  auto kernel = paged_decode_kernel<KVT, HD, GM>;
  const size_t smem = L::bytes(a.MB);
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           static_cast<int>(smem))) != cudaSuccess)
    return err;
  const dim3 grid(a.S * a.kvH, a.n_split, (a.G + GM - 1) / GM);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      km, vm, a.q, a.q_bf16, static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.ctx), a.out, static_cast<float*>(a.partial),
      static_cast<int*>(a.counters), a.kvH, a.G, a.bs, a.MB, a.window,
      a.scale);
  return cudaGetLastError();
}

template <typename KVT, int HD>
cudaError_t dispatch_g(const Args& a) {
  switch (group_rows(a.G)) {
    case 1:
      return launch<KVT, HD, 1>(a);
    case 4:
      return launch<KVT, HD, 4>(a);
    default:
      return launch<KVT, HD, 8>(a);
  }
}

template <typename KVT>
cudaError_t dispatch_hd(int hd, const Args& a) {
  switch (hd) {
    case 32:
      return dispatch_g<KVT, 32>(a);
    case 64:
      return dispatch_g<KVT, 64>(a);
    case 128:
      return dispatch_g<KVT, 128>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename KVT, int HD>
size_t smem_of(int G, int MB) {
  switch (group_rows(G)) {
    case 1:
      return Smem<KVT, HD, 1>::bytes(MB);
    case 4:
      return Smem<KVT, HD, 4>::bytes(MB);
    default:
      return Smem<KVT, HD, 8>::bytes(MB);
  }
}

template <typename KVT>
size_t smem_hd(int hd, int G, int MB) {
  return hd == 32 ? smem_of<KVT, 32>(G, MB)
         : hd == 64 ? smem_of<KVT, 64>(G, MB)
                    : smem_of<KVT, 128>(G, MB);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns the launch's cudaError_t
// (0 on success).  q_dtype: 0 fp32, 1 bf16.  kv_dtype: 0 fp32, 1 bf16,
// 2 int8 (k_scale / v_scale then required).  hd: 32, 64 or 128; the
// pools 16-byte aligned.  window <= 0: no window.  n_split >= 1 blocks
// share each (slot, kv head, query-row group); above 1, `partial` (fp32,
// tadnn_paged_attention_sizes' floats) and `counters` (int32, as many,
// zero on entry and left zero) are required.
int tadnn_paged_attention_decode(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* tables, const void* ctx_lens, void* out,
    void* partial, void* counters, int q_dtype, int kv_dtype, int S, int NB,
    int kvH, int G, int hd, int bs, int MB, int window, int n_split,
    float scale, void* stream) {
  if (S <= 0 || NB <= 0 || kvH <= 0 || G <= 0 || bs <= 0 || MB <= 0 ||
      n_split <= 0 || q_dtype < 0 || q_dtype > 1)
    return cudaErrorInvalidValue;
  if ((kv_dtype == 2) != (k_scale != nullptr && v_scale != nullptr))
    return cudaErrorInvalidValue;
  if (n_split > 1 && (partial == nullptr || counters == nullptr))
    return cudaErrorInvalidValue;
  if ((long long)S * kvH > 0x7fffffffLL || n_split > 65535 ||
      (G + 7) / 8 > 65535)
    return cudaErrorInvalidConfiguration;
  if ((reinterpret_cast<uintptr_t>(k_pool) |
       reinterpret_cast<uintptr_t>(v_pool)) % 16)
    return cudaErrorMisalignedAddress;
  const Args a{q,       k_pool, v_pool, k_scale, v_scale, tables, ctx_lens,
               out,     partial, counters, q_dtype, S,     NB,     kvH,
               G,       bs,      MB,       window,  n_split, scale,
               static_cast<cudaStream_t>(stream)};
  switch (kv_dtype) {
    case 0:
      return dispatch_hd<float>(hd, a);
    case 1:
      return dispatch_hd<__nv_bfloat16>(hd, a);
    case 2:
      return dispatch_hd<int8_t>(hd, a);
    default:
      return cudaErrorInvalidValue;
  }
}

// What one launch needs: its dynamic shared memory in bytes, and the
// floats of `partial` and int32 entries of `counters` (n_split > 1).
void tadnn_paged_attention_sizes(int kv_dtype, int S, int kvH, int G, int hd,
                                 int MB, int n_split, size_t* smem,
                                 size_t* partial_floats, size_t* counters) {
  const int gm = group_rows(G), gz = (G + gm - 1) / gm;
  *smem = kv_dtype == 0   ? smem_hd<float>(hd, G, MB)
          : kv_dtype == 1 ? smem_hd<__nv_bfloat16>(hd, G, MB)
                          : smem_hd<int8_t>(hd, G, MB);
  *counters = static_cast<size_t>(S) * kvH * gz;
  *partial_floats = *counters * n_split * gm * (hd + 2);
}

const char* tadnn_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
