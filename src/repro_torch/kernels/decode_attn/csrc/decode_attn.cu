// GQA flash-decode attention for Hopper (sm_90a): one query token per
// sequence against a (B, Smax, KVH, dh) KV cache with ragged lengths.
//
// Replaces the TPU kernel src/repro/kernels/decode_attn/kernel.py::
// decode_attn_pallas (body _kernel) and the vmap of ops.py::decode_attention.
// For every sequence b and query head h (KV head h / G):
//
//   s[t]   = (q[b,h] . k[b,t,h/G]) / sqrt(dh) + (t < lengths[b] ? 0 : -1e30)
//   out    = sum_t exp(s[t] - max s) v[b,t,h/G] / max(sum_t exp(s[t] - max s), 1e-30)
//
// in float32, written in q's type (float or bfloat16).
//
// What bounds it on this card: every K and V byte up to lengths[b] is read
// once and used for G heads, ~4*G flops a byte, far below the ~20 float32
// flops a byte of an H100: bytes, (K + V up to the lengths + q + out) over
// 3.35 TB/s.  To reach that the card needs ~25 KB in flight per SM, every
// SM busy for the whole call, and no second pass.  The design:
//
// * One launch.  The TPU kernel carries (m, l, acc) across a sequential KV
//   grid axis; CUDA CTAs run in no order, so S is split over CTAs (split,
//   kvh, b).  The split length is chosen on the host from Smax, the card's
//   SM count and the CTAs an SM holds (decode_attn_occupancy below;
//   kernel.py::plan_splits), so the grid is about one wave of 3 CTAs an
//   SM: at the serving shape (B*KVH = 64, Smax 2113) 6 splits of 384
//   positions, 384 CTAs.  Each CTA writes its partial
//   (m, l, acc) and takes a ticket from a per-(b, kvh) counter; the last
//   CTA to finish merges the partials of its G heads and resets the
//   counter to 0 for the next call.  With one split the CTA writes the
//   output directly.
// * The ring: tiles of 32 positions are copied in their storage type with
//   16-byte cp.async and an L2::128B prefetch hint, 2 deep (35 KB a CTA at
//   dh 128 in bf16); one __syncthreads a tile.  Measured on an H100
//   (PERF.md): deeper rings were no faster, and at long caches the kernel
//   streams K and V at ~88 % of the card's 3.35 TB/s.
// * bf16 with G <= 8 (decode_attn_tc, the serving path): q.K runs on the
//   tensor cores, mma.sync.m16n8k16 with the group's G heads as the rows of
//   A (padded to 16; q and K are bf16, so the products are exact and
//   summed in float32).  Each of the 4 warps takes 8 positions of every
//   tile for all G heads and keeps its own online softmax; the 4 states
//   merge in shared memory at the end of the CTA.  p.V stays float32 on
//   the CUDA cores, as in the reference (rounding p to bf16 would be a
//   different result): lane i holds columns [i*dh/32, (i+1)*dh/32) of
//   every head, reads a position's V slice with one vector load and takes
//   p by shuffle.  Per position the CTA issues ~25 instructions against
//   ~100 with one warp per head (the CUDA-core kernel below).
// * float32, or G > 8 (decode_attn_kernel, off the serving path: the
//   float32 replay and tests): one warp per query head of the group, q in
//   shared memory as float32, lane j scores position j of a tile from
//   16-byte reads of its K row, rows padded by 16 bytes against bank
//   conflicts; p.V broadcasts p_j by shuffle and lane i accumulates columns
//   i + 32 c.  Float32 arithmetic throughout.
// * Either way K and V are read from device memory once for all G heads.
// * Ragged lengths: a CTA stops at lengths[b] (for lengths >= 1 a masked
//   weight exp(-1e30 - m) is exactly 0 in float32, so skipping is exact);
//   splits past the length skip their loads and write an empty state
//   (m = -inf, l = 0).  With lengths[b] <= 0 every position is masked and
//   all Smax are visited, which gives the reference's uniform mean of V.
// * lengths stays on the device: the host never reads it.
//
// Build without --use_fast_math (expf, not __expf): the float32 tolerance against the
// plain version is 2e-5.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;            // KV positions a tile (one per lane)
constexpr float kMasked = -1e30f;    // the reference's additive mask
constexpr unsigned kFull = 0xffffffffu;

template <class T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16 bytes of T at p (shared memory) as float32: 4 floats or 8 bfloat16s.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// N consecutive bfloat16s at p (2N-byte aligned) as float32, in vector loads.
template <int N>
__device__ __forceinline__ void load_slice(const __nv_bfloat16* p, float* out) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 8) load16(p + i, out + i);
  } else if constexpr (N == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const auto* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
    out[0] = f0.x; out[1] = f0.y; out[2] = f1.x; out[3] = f1.y;
  } else if constexpr (N == 2) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = f.x; out[1] = f.y;
  } else {
    out[0] = __bfloat162float(p[0]);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1, with a 128-byte L2 prefetch hint
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n"
               :: "r"(smem_u32(smem)), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// d += a (16x16, row; rows 8-15 zero) * b (16x8, col), bf16 in, float32 out
__device__ __forceinline__ void mma_rows8(float (&d)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                          uint32_t b1) {
  const uint32_t zero = 0;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(zero), "r"(a2), "r"(zero), "r"(b0), "r"(b1));
}

// Column of acc's i-th value in lane `lane`: lane + 32 i (kStrided, the
// CUDA-core kernel) or lane * kPerLane + i (the tensor-core kernel).
template <int kPerLane, bool kStrided>
__device__ __forceinline__ int column(int lane, int i) {
  return kStrided ? lane + 32 * i : lane * kPerLane + i;
}

// Write head's partial (m, l, acc) of this split, or its output where the
// split is the only one.
template <class T, int kPerLane, bool kStrided>
__device__ __forceinline__ void write_split(float m, float l, const float (&acc)[kPerLane],
                                            int64_t head, int64_t split, int64_t nsplit,
                                            float* part_m, float* part_l, float* part_acc,
                                            T* out, int lane) {
  constexpr int dh = 32 * kPerLane;
  if (nsplit == 1) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      out[head * dh + column<kPerLane, kStrided>(lane, i)] = from_f32<T>(acc[i] / den);
    }
    return;
  }
  const int64_t slot = head * nsplit + split;
  if (lane == 0) {
    part_m[slot] = m;
    part_l[slot] = l;
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) part_acc[slot * dh + column<kPerLane, kStrided>(lane, i)] = acc[i];
}

// After every thread has written its partials: true in the CTA that
// finished last among the nsplit CTAs of `counter`'s (b, kvh).
__device__ __forceinline__ bool last_of_splits(int32_t* counter, int64_t nsplit, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(counter, 1) == nsplit - 1;
  __syncthreads();
  if (!*flag) return false;
  __threadfence();
  return true;
}

// out = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30), w_s = exp(m_s - max m),
// over the nsplit partials of `head`, by one warp.  Split 0 always holds a
// position, so max m is finite; empty splits (m = -inf, l = 0, acc = 0) get
// weight 0.  The partials were written by other CTAs: read through L2.
template <class T, int kPerLane, bool kStrided>
__device__ __forceinline__ void merge_splits(const float* part_m, const float* part_l,
                                             const float* part_acc, T* out, int64_t head,
                                             int64_t nsplit, int lane) {
  constexpr int dh = 32 * kPerLane;
  const float* pm = part_m + head * nsplit;
  const float* pl = part_l + head * nsplit;
  float mx = -INFINITY;
  for (int64_t s = lane; s < nsplit; s += 32) mx = fmaxf(mx, __ldcg(pm + s));
  mx = warp_max(mx);
  float den = 0.0f;
  for (int64_t s = lane; s < nsplit; s += 32) den += __ldcg(pl + s) * expf(__ldcg(pm + s) - mx);
  den = fmaxf(warp_sum(den), 1e-30f);
  float num[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) num[i] = 0.0f;
  for (int64_t s = 0; s < nsplit; ++s) {
    const float w = expf(__ldcg(pm + s) - mx);
    const float* pa = part_acc + (head * nsplit + s) * dh;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      num[i] = fmaf(__ldcg(pa + column<kPerLane, kStrided>(lane, i)), w, num[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    out[head * dh + column<kPerLane, kStrided>(lane, i)] = from_f32<T>(num[i] / den);
  }
}

// grid (nsplit, KVH, B), block 32*G threads; warp g serves query head
// kvh*G+g.  kPerLane = dh / 32 output columns a lane: column lane + 32*i.
template <class T, int kPerLane>
__global__ void decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                   const T* __restrict__ v,
                                   const int32_t* __restrict__ lengths,
                                   float* __restrict__ part_m, float* __restrict__ part_l,
                                   float* __restrict__ part_acc, int32_t* __restrict__ counters,
                                   T* __restrict__ out, int64_t smax, int kvh_count, int group,
                                   int64_t split_len, float scale) {
  constexpr int dh = 32 * kPerLane;
  constexpr int kVec = 16 / sizeof(T);            // elements in 16 bytes
  constexpr int kRow = dh + kVec;                 // padded row, in elements
  constexpr int kChunks = dh / kVec;              // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);                 // group x dh
  T* tiles = reinterpret_cast<T*>(qs + group * dh);               // [2][K|V][kTile][kRow]
  __shared__ int last_cta;
  const int64_t b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int64_t split = blockIdx.x;
  const int64_t nsplit = gridDim.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t heads = static_cast<int64_t>(kvh_count) * group;
  const int64_t head0 = b * heads + static_cast<int64_t>(kvh) * group;

  const int64_t len = lengths ? static_cast<int64_t>(lengths[b]) : smax;
  const int64_t n = len >= 1 ? (len < smax ? len : smax) : smax;
  const int64_t start = split * split_len;
  const int64_t end = start + split_len < n ? start + split_len : n;
  const int ntiles = end > start ? static_cast<int>((end - start + kTile - 1) / kTile) : 0;

  const T* qb = q + head0 * dh;
  for (int i = threadIdx.x; i < group * dh; i += blockDim.x) qs[i] = to_f32(qb[i]);
  const int64_t row = static_cast<int64_t>(kvh_count) * dh;   // between positions
  const T* kb = k + (b * smax * kvh_count + kvh) * dh;
  const T* vb = v + (b * smax * kvh_count + kvh) * dh;

  // stage tile `tile` into buffer `buf`: rows past `end` are left unread
  auto stage = [&](int tile, int buf) {
    const int64_t t0 = start + static_cast<int64_t>(tile) * kTile;
    const int nt = static_cast<int>(end - t0 < kTile ? end - t0 : kTile);
    T* ks = tiles + static_cast<size_t>(buf) * 2 * kTile * kRow;
    T* vs = ks + kTile * kRow;
    for (int i = threadIdx.x; i < nt * kChunks; i += blockDim.x) {
      const int r = i / kChunks;
      const int c = (i - r * kChunks) * kVec;
      const int64_t off = (t0 + r) * row + c;
      cp_async16(ks + r * kRow + c, kb + off);
      cp_async16(vs + r * kRow + c, vb + off);
    }
  };

  float m = -INFINITY, l = 0.0f;
  float acc[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = 0.0f;
  const float* qh = qs + warp * dh;

  if (ntiles > 0) stage(0, 0);
  cp_async_commit();
  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile + 1 < ntiles) stage(tile + 1, (tile + 1) & 1);
    cp_async_commit();       // possibly empty: keeps wait_group 1 exact
    cp_async_wait<1>();      // this tile's copies (and qs) have landed
    __syncthreads();
    const int64_t t0 = start + static_cast<int64_t>(tile) * kTile;
    const int nt = static_cast<int>(end - t0 < kTile ? end - t0 : kTile);
    const T* ks = tiles + static_cast<size_t>(tile & 1) * 2 * kTile * kRow;
    const T* vs = ks + kTile * kRow;
    float s = -INFINITY;
    if (lane < nt) {
      const T* kr = ks + lane * kRow;
      float dot = 0.0f;
#pragma unroll 4
      for (int c = 0; c < dh; c += kVec) {
        float kv[kVec], qv[kVec];
        load16(kr + c, kv);
#pragma unroll
        for (int j = 0; j < kVec; j += 4) load16(qh + c + j, qv + j);
#pragma unroll
        for (int j = 0; j < kVec; ++j) dot = fmaf(qv[j], kv[j], dot);
      }
      s = dot * scale + (t0 + lane < len ? 0.0f : kMasked);
    }
    const float m_new = fmaxf(m, warp_max(s));
    const float p = lane < nt ? expf(s - m_new) : 0.0f;
    const float alpha = expf(m - m_new);   // 0 on the first tile (m = -inf)
    l = l * alpha + warp_sum(p);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[i] *= alpha;
    for (int j = 0; j < nt; ++j) {
      const float pj = __shfl_sync(kFull, p, j);
      const T* vr = vs + j * kRow + lane;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) acc[i] = fmaf(pj, to_f32(vr[32 * i]), acc[i]);
    }
    m = m_new;
    __syncthreads();         // every warp is done with this buffer
  }

  write_split<T, kPerLane, true>(m, l, acc, head0 + warp, split, nsplit, part_m, part_l,
                                 part_acc, out, lane);
  if (nsplit == 1) return;
  int32_t* counter = counters + b * kvh_count + kvh;
  if (!last_of_splits(counter, nsplit, &last_cta)) return;
  merge_splits<T, kPerLane, true>(part_m, part_l, part_acc, out, head0 + warp, nsplit, lane);
  if (threadIdx.x == 0) *counter = 0;   // ready for the next call on this stream
}

constexpr int kTcThreads = 128;      // 4 warps, each 8 positions of a tile
constexpr int kTcStages = 2;         // ring depth of the tensor-core kernel

// bf16 with G <= kG <= 8 on the tensor cores for q.K.  grid (nsplit, KVH,
// B), block kTcThreads.  Rows are padded by 16 bytes, so the 8 rows an
// ldmatrix reads fall in 8 bank groups.
template <int kPerLane, int kG>
__global__ void __launch_bounds__(kTcThreads)
decode_attn_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ lengths,
               float* __restrict__ part_m, float* __restrict__ part_l,
               float* __restrict__ part_acc, int32_t* __restrict__ counters,
               __nv_bfloat16* __restrict__ out, int64_t smax, int kvh_count, int group,
               int64_t split_len, float scale) {
  using bf16 = __nv_bfloat16;
  constexpr int dh = 32 * kPerLane;
  constexpr int kRowP = dh + 8;                   // padded row, in elements
  constexpr int kChunks = dh / 8;                 // 16-byte chunks a row
  constexpr int kStages = kTcStages;
  constexpr int kWarps = kTcThreads / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);  // [kStages][K|V][kTile][kRowP]
  __shared__ int last_cta;
  const int64_t b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int64_t split = blockIdx.x;
  const int64_t nsplit = gridDim.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;                       // fragment row: head of the group
  const int tq = lane & 3;                        // fragment column pair: positions
  const int col = lane * kPerLane;
  const int64_t head0 = (b * kvh_count + kvh) * group;

  const int64_t len = lengths ? static_cast<int64_t>(lengths[b]) : smax;
  const int64_t n = len >= 1 ? (len < smax ? len : smax) : smax;
  const int64_t start = split * split_len;
  const int64_t end = start + split_len < n ? start + split_len : n;
  const int ntiles = end > start ? static_cast<int>((end - start + kTile - 1) / kTile) : 0;

  // q as the A operand, rows = the group's heads (zero past G): a0, a2
  uint32_t qa[dh / 16][2];
#pragma unroll
  for (int s = 0; s < dh / 16; ++s) {
    qa[s][0] = qa[s][1] = 0u;
    if (gq < group) {
      const bf16* qr = q + (head0 + gq) * dh + 16 * s + 2 * tq;
      qa[s][0] = *reinterpret_cast<const uint32_t*>(qr);
      qa[s][1] = *reinterpret_cast<const uint32_t*>(qr + 8);
    }
  }
  const int64_t row = static_cast<int64_t>(kvh_count) * dh;   // between positions
  const bf16* kb = k + (b * smax * kvh_count + kvh) * dh;
  const bf16* vb = v + (b * smax * kvh_count + kvh) * dh;

  auto stage = [&](int tile, int buf) {
    const int64_t t0 = start + static_cast<int64_t>(tile) * kTile;
    const int nt = static_cast<int>(end - t0 < kTile ? end - t0 : kTile);
    bf16* ks = ring + static_cast<size_t>(buf) * 2 * kTile * kRowP;
    bf16* vs = ks + kTile * kRowP;
    for (int i = threadIdx.x; i < nt * kChunks; i += kTcThreads) {
      const int r = i / kChunks;
      const int c = (i - r * kChunks) * 8;
      const int64_t off = (t0 + r) * row + c;
      cp_async16(ks + r * kRowP + c, kb + off);
      cp_async16(vs + r * kRowP + c, vb + off);
    }
  };

  // online softmax of head gq over this warp's positions (rows 8w..8w+7 of
  // every tile); lane i accumulates columns [col, col + kPerLane) of each head
  float m = -INFINITY, l = 0.0f;
  float acc[kG][kPerLane];
#pragma unroll
  for (int hh = 0; hh < kG; ++hh)
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[hh][i] = 0.0f;
  const int row0 = 8 * warp;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) stage(s, s);
    cp_async_commit();
  }
  for (int tile = 0; tile < ntiles; ++tile) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = tile + kStages - 1;
    if (next < ntiles) stage(next, next % kStages);
    cp_async_commit();
    const int64_t t0 = start + static_cast<int64_t>(tile) * kTile;
    const int nt = static_cast<int>(end - t0 < kTile ? end - t0 : kTile);
    const int nw = nt - row0;                     // this warp's positions, if > 0
    if (nw <= 0) continue;                        // warp-uniform
    const bf16* ks = ring + static_cast<size_t>(tile % kStages) * 2 * kTile * kRowP;
    const bf16* vs = ks + kTile * kRowP;

    // scores: (heads x 8 positions) = q (heads x dh) . K (8 x dh)^T
    float sacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kk = 0; kk < dh; kk += 32) {
      uint32_t kf[4];
      ldsm_x4(kf, ks + (row0 + (lane & 7)) * kRowP + kk + (lane >> 3) * 8);
      mma_rows8(sacc, qa[kk / 16][0], qa[kk / 16][1], kf[0], kf[1]);
      mma_rows8(sacc, qa[kk / 16 + 1][0], qa[kk / 16 + 1][1], kf[2], kf[3]);
    }
    // positions row0 + 2 tq + e of head gq; rows past nt hold stale data
    float sc[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = row0 + 2 * tq + e;
      sc[e] = j < nt ? sacc[e] * scale + (t0 + j < len ? 0.0f : kMasked) : -INFINITY;
    }
    float mt = fmaxf(sc[0], sc[1]);
    mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 2));
    const float m_new = fmaxf(m, mt);             // finite: position row0 is valid
    const float p0 = expf(sc[0] - m_new);
    const float p1 = expf(sc[1] - m_new);
    const float alpha = expf(m - m_new);          // 0 on the warp's first tile
    float ps = p0 + p1;
    ps += __shfl_xor_sync(kFull, ps, 1);
    ps += __shfl_xor_sync(kFull, ps, 2);
    l = l * alpha + ps;
    m = m_new;
#pragma unroll
    for (int hh = 0; hh < kG; ++hh) {
      const float al = __shfl_sync(kFull, alpha, 4 * hh);
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) acc[hh][i] *= al;
    }
    // p.V in float32: p of (head hh, position j) lives in lane 4 hh + j / 2
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < nw) {
        float vv[kPerLane];
        load_slice<kPerLane>(vs + (row0 + j) * kRowP + col, vv);
#pragma unroll
        for (int hh = 0; hh < kG; ++hh) {
          const float pj = __shfl_sync(kFull, (j & 1) ? p1 : p0, 4 * hh + (j >> 1));
#pragma unroll
          for (int i = 0; i < kPerLane; ++i) acc[hh][i] = fmaf(pj, vv[i], acc[hh][i]);
        }
      }
    }
  }

  // merge the warps' states through shared memory (the ring is free now)
  cp_async_wait<0>();
  __syncthreads();
  float* wm = reinterpret_cast<float*>(smem_raw);  // [kWarps][kG]
  float* wl = wm + kWarps * kG;                    // [kWarps][kG]
  float* wacc = wl + kWarps * kG;                  // [kWarps][kG][dh]
  if (tq == 0 && gq < kG) {
    wm[warp * kG + gq] = m;
    wl[warp * kG + gq] = l;
  }
#pragma unroll
  for (int hh = 0; hh < kG; ++hh)
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) wacc[(warp * kG + hh) * dh + col + i] = acc[hh][i];
  __syncthreads();
  for (int hh = warp; hh < group; hh += kWarps) {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * kG + hh]);
    float den = 0.0f;
    float num[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) num[i] = 0.0f;
    if (mx != -INFINITY) {                         // else the split is empty
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float e = expf(wm[w * kG + hh] - mx);
        den = fmaf(wl[w * kG + hh], e, den);
#pragma unroll
        for (int i = 0; i < kPerLane; ++i)
          num[i] = fmaf(wacc[(w * kG + hh) * dh + col + i], e, num[i]);
      }
    }
    write_split<bf16, kPerLane, false>(mx, den, num, head0 + hh, split, nsplit, part_m, part_l,
                                part_acc, out, lane);
  }
  if (nsplit == 1) return;
  int32_t* counter = counters + b * kvh_count + kvh;
  if (!last_of_splits(counter, nsplit, &last_cta)) return;
  for (int hh = warp; hh < group; hh += kWarps)
    merge_splits<bf16, kPerLane, false>(part_m, part_l, part_acc, out, head0 + hh, nsplit, lane);
  if (threadIdx.x == 0) *counter = 0;   // ready for the next call on this stream
}

// A call's pointers and sizes (see decode_attn below).
struct Args {
  const void *q, *k, *v;
  const int32_t* lengths;
  float *part_m, *part_l, *part_acc;
  int32_t* counters;
  void* out;
  int64_t B, smax, kvh, group, split_len;
  float scale;
  cudaStream_t stream;
};

// The launch for kernel instance (T, kPerLane, kG): kG > 0 is the
// tensor-core kernel for bf16 with G <= kG, kG = 0 the CUDA-core kernel.
// With `ctas` null it launches; otherwise it launches nothing and sets
// *ctas to the CTAs of this launch that an SM holds at once.
template <class T, int kPerLane, int kG>
cudaError_t launch(const Args& a, int* ctas) {
  constexpr int dh = 32 * kPerLane;
  size_t smem;
  unsigned threads;
  void (*kernel)(const T*, const T*, const T*, const int32_t*, float*, float*, float*,
                 int32_t*, T*, int64_t, int, int, int64_t, float);
  if constexpr (kG > 0) {
    const size_t ring = static_cast<size_t>(kTcStages) * 2 * kTile * (dh + 8) * sizeof(T);
    const size_t merge = sizeof(float) * (2 * 4 * kG + 4 * kG * dh);
    smem = ring > merge ? ring : merge;
    threads = kTcThreads;
    kernel = decode_attn_tc<kPerLane, kG>;
  } else {
    constexpr int kRow = dh + 16 / static_cast<int>(sizeof(T));
    smem = a.group * dh * sizeof(float) + 2 * 2 * kTile * kRow * sizeof(T);
    threads = static_cast<unsigned>(32 * a.group);
    kernel = decode_attn_kernel<T, kPerLane>;
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (ctas != nullptr) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, static_cast<int>(threads),
                                                         smem);
  }
  const int64_t nsplit = (a.smax + a.split_len - 1) / a.split_len;
  const dim3 grid(static_cast<unsigned>(nsplit), static_cast<unsigned>(a.kvh),
                  static_cast<unsigned>(a.B));
  kernel<<<grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.lengths, a.part_m, a.part_l, a.part_acc, a.counters, static_cast<T*>(a.out), a.smax,
      static_cast<int>(a.kvh), static_cast<int>(a.group), a.split_len, a.scale);
  return cudaGetLastError();
}

// bf16 with G <= 8 goes to the tensor-core kernel (kG = G rounded up to a
// power of two), everything else to the CUDA-core kernel (kG = 0)
template <class T, int kPerLane>
cudaError_t launch_any(const Args& a, int* ctas) {
  if constexpr (sizeof(T) == 2) {
    if (a.group <= 1) return launch<T, kPerLane, 1>(a, ctas);
    if (a.group <= 2) return launch<T, kPerLane, 2>(a, ctas);
    if (a.group <= 4) return launch<T, kPerLane, 4>(a, ctas);
    if (a.group <= 8) return launch<T, kPerLane, 8>(a, ctas);
  }
  return launch<T, kPerLane, 0>(a, ctas);
}

template <class T>
cudaError_t dispatch(int64_t dh, const Args& a, int* ctas) {
  switch (dh) {
    case 32: return launch_any<T, 1>(a, ctas);
    case 64: return launch_any<T, 2>(a, ctas);
    case 128: return launch_any<T, 4>(a, ctas);
    case 256: return launch_any<T, 8>(a, ctas);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_dtype(int dtype, int64_t dh, const Args& a, int* ctas) {
  if (a.group < 1 || a.group > 32) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return dispatch<float>(dh, a, ctas);
    case 1: return dispatch<__nv_bfloat16>(dh, a, ctas);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16 (q, k, v and out alike).  q (B, KVH*G, dh),
// k/v (B, smax, KVH, dh), lengths (B,) int32 or null (all of smax), out like
// q; scratch part_m/part_l (B, KVH*G, nsplit) and part_acc (B, KVH*G, nsplit,
// dh) float32 with nsplit = ceil(smax / split_len); counters (B, KVH) int32,
// zero before the call and left zero after it; split_len a multiple of 32.
// All contiguous on the current device, k and v 16-byte aligned; launched on
// `stream`.  dh is 32, 64, 128 or 256.  The caller checks shapes (G <= 32,
// B and KVH <= 65535).  Returns cudaGetLastError() after the launch (0 on
// success).
int decode_attn(int dtype, const void* q, const void* k, const void* v, const void* lengths,
                void* part_m, void* part_l, void* part_acc, void* counters, void* out,
                int64_t B, int64_t smax, int64_t kvh, int64_t group, int64_t dh,
                int64_t split_len, float scale, void* stream) {
  if (B == 0 || kvh == 0) return cudaSuccess;
  if (smax <= 0 || split_len <= 0 || split_len % kTile) return cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const int32_t*>(lengths), static_cast<float*>(part_m),
               static_cast<float*>(part_l), static_cast<float*>(part_acc),
               static_cast<int32_t*>(counters), out, B, smax, kvh, group, split_len, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch_dtype(dtype, dh, a, nullptr);
}

// The CTAs of decode_attn's launch for (dtype, dh, G) that one SM of the
// current device holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// for the kernel, block and shared memory that launch uses), in *ctas.
// Returns the CUDA error (0 on success).
int decode_attn_occupancy(int dtype, int64_t dh, int64_t group, int* ctas) {
  Args a{};
  a.group = group;
  return dispatch_dtype(dtype, dh, a, ctas);
}

const char* decode_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
