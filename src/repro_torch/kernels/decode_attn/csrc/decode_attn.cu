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
// What bounds it: every K and V byte up to lengths[b] is read once and used
// for G heads, ~4*G flops a byte, far below the card's ~20 f32 flops a byte:
// the kernel is bandwidth-bound, (K + V bytes up to the lengths + q + out)
// over 3.35 TB/s.  Its design:
//
// * The TPU kernel carries (m, l, acc) in scratch across a sequential KV
//   grid axis.  CUDA CTAs run in no order, so S is split: CTA (split, kvh, b)
//   runs the online softmax over its SPLIT positions and writes its partial
//   (m, l, acc) to scratch; a second kernel combines the partials of each
//   (b, h).  At B*KVH = 64 a CTA per (b, kvh) would fill under half the SMs.
// * One warp per query head of the group, so each K/V tile is read from
//   device memory once for all G heads.  Tiles of 32 positions are copied
//   to shared memory in their storage type with cp.async, two stages deep,
//   so the next tile's loads overlap this tile's arithmetic; rows are
//   padded by 16 bytes against bank conflicts.  Lane j scores position j
//   (16-byte reads of its K row, q broadcast from shared memory as
//   float32); the p.V product broadcasts p_j with a shuffle and every lane
//   accumulates dh/32 output columns.
// * Ragged lengths: a CTA stops at lengths[b] (for lengths >= 1 a masked
//   weight exp(-1e30 - m) is exactly 0 in float32, so skipping is exact);
//   splits past the length write an empty state (m = -inf, l = 0).  With
//   lengths[b] <= 0 every position is masked and all Smax are visited, which
//   gives the reference's uniform mean of V.
// * lengths stays on the device: the host never reads it.
//
// The wrapper takes dh a multiple of 32 (up to 256) and 16-byte aligned
// k and v.  Build without --use_fast_math (expf, not __expf): the float32
// tolerance against the plain version is 2e-5.  TMA and bf16 tensor-core
// dot products are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;            // KV positions staged at once (one per lane)
constexpr float kMasked = -1e30f;    // the reference's additive mask
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n"); }

// grid (nsplit, KVH, B), block 32*G threads; warp g serves query head kvh*G+g.
// kPerLane = dh / 32 output columns a lane: column lane + 32*i.
template <class T, int kPerLane>
__global__ void decode_attn_split(const T* __restrict__ q, const T* __restrict__ k,
                                  const T* __restrict__ v,
                                  const int32_t* __restrict__ lengths,
                                  float* __restrict__ part_m, float* __restrict__ part_l,
                                  float* __restrict__ part_acc, int64_t smax, int kvh_count,
                                  int group, int64_t split_len, float scale) {
  constexpr int dh = 32 * kPerLane;
  constexpr int kVec = 16 / sizeof(T);            // elements in 16 bytes
  constexpr int kRow = dh + kVec;                 // padded row, in elements
  constexpr int kChunks = dh / kVec;              // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);                 // group x dh
  T* tiles = reinterpret_cast<T*>(qs + group * dh);               // [2][K|V][kTile][kRow]
  const int64_t b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int64_t split = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t heads = static_cast<int64_t>(kvh_count) * group;

  const int64_t len = lengths ? static_cast<int64_t>(lengths[b]) : smax;
  const int64_t n = len >= 1 ? (len < smax ? len : smax) : smax;
  const int64_t start = split * split_len;
  const int64_t end = start + split_len < n ? start + split_len : n;
  const int ntiles = end > start ? static_cast<int>((end - start + kTile - 1) / kTile) : 0;

  const T* qb = q + (b * heads + static_cast<int64_t>(kvh) * group) * dh;
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
    cp_async_wait1();        // this tile's copies (and qs) have landed
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

  const int64_t slot = (b * heads + static_cast<int64_t>(kvh) * group + warp) * gridDim.x
                       + split;
  if (lane == 0) {
    part_m[slot] = m;
    part_l[slot] = l;
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) part_acc[slot * dh + lane + 32 * i] = acc[i];
}

// grid (B*H), block kCombineThreads: out = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30)
// with w_s = exp(m_s - max m).  Split 0 always holds a position, so max m is
// finite; empty splits (m = -inf, l = 0, acc = 0) get weight 0.
constexpr int kCombineThreads = 128;

template <class T>
__global__ void __launch_bounds__(kCombineThreads)
decode_attn_combine(const float* __restrict__ part_m, const float* __restrict__ part_l,
                    const float* __restrict__ part_acc, T* __restrict__ out, int nsplit,
                    int dh) {
  const int64_t bh = blockIdx.x;
  const float* pm = part_m + bh * nsplit;
  const float* pl = part_l + bh * nsplit;
  const float* pa = part_acc + bh * nsplit * dh;
  float mx = -INFINITY;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, pm[s]);
  float den = 0.0f;
  for (int s = 0; s < nsplit; ++s) den += pl[s] * expf(pm[s] - mx);
  den = fmaxf(den, 1e-30f);
  for (int e = threadIdx.x; e < dh; e += blockDim.x) {
    float num = 0.0f;
    for (int s = 0; s < nsplit; ++s) num += pa[static_cast<int64_t>(s) * dh + e] * expf(pm[s] - mx);
    out[bh * dh + e] = from_f32<T>(num / den);
  }
}

template <class T, int kPerLane>
cudaError_t launch(const void* q, const void* k, const void* v, const int32_t* lengths,
                   float* pm, float* pl, float* pa, void* out, int64_t B, int64_t smax,
                   int64_t kvh, int64_t group, int64_t split_len, float scale,
                   cudaStream_t stream) {
  constexpr int dh = 32 * kPerLane;
  constexpr int kRow = dh + 16 / static_cast<int>(sizeof(T));
  const int64_t nsplit = (smax + split_len - 1) / split_len;
  const size_t smem = group * dh * sizeof(float) + 2 * 2 * kTile * kRow * sizeof(T);
  auto split_kernel = decode_attn_split<T, kPerLane>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(nsplit), static_cast<unsigned>(kvh),
                  static_cast<unsigned>(B));
  split_kernel<<<grid, static_cast<unsigned>(32 * group), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      pm, pl, pa, smax, static_cast<int>(kvh), static_cast<int>(group), split_len, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_attn_combine<T><<<static_cast<unsigned>(B * kvh * group), kCombineThreads, 0, stream>>>(
      pm, pl, pa, static_cast<T*>(out), static_cast<int>(nsplit), dh);
  return cudaGetLastError();
}

template <class T>
cudaError_t dispatch(int64_t dh, const void* q, const void* k, const void* v,
                     const int32_t* lengths, float* pm, float* pl, float* pa, void* out,
                     int64_t B, int64_t smax, int64_t kvh, int64_t group, int64_t split_len,
                     float scale, cudaStream_t s) {
  switch (dh) {
    case 32: return launch<T, 1>(q, k, v, lengths, pm, pl, pa, out, B, smax, kvh, group, split_len, scale, s);
    case 64: return launch<T, 2>(q, k, v, lengths, pm, pl, pa, out, B, smax, kvh, group, split_len, scale, s);
    case 128: return launch<T, 4>(q, k, v, lengths, pm, pl, pa, out, B, smax, kvh, group, split_len, scale, s);
    case 256: return launch<T, 8>(q, k, v, lengths, pm, pl, pa, out, B, smax, kvh, group, split_len, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16 (q, k, v and out alike).  q (B, KVH*G, dh),
// k/v (B, smax, KVH, dh), lengths (B,) int32 or null (all of smax), out like
// q; scratch part_m/part_l (B, KVH*G, nsplit) and part_acc (B, KVH*G, nsplit,
// dh) float32 with nsplit = ceil(smax / split_len); split_len a multiple of
// 32.  All contiguous on the current device, k and v 16-byte aligned;
// launched on `stream`.  dh is 32, 64, 128 or 256.  The caller checks
// shapes (G <= 32, B and KVH <= 65535).  Returns
// cudaGetLastError() after the launches (0 on success).
int decode_attn(int dtype, const void* q, const void* k, const void* v, const void* lengths,
                void* part_m, void* part_l, void* part_acc, void* out, int64_t B,
                int64_t smax, int64_t kvh, int64_t group, int64_t dh, int64_t split_len,
                float scale, void* stream) {
  if (B == 0 || kvh == 0) return cudaSuccess;
  if (smax <= 0 || group < 1 || group > 32 || split_len <= 0 || split_len % kTile) {
    return cudaErrorInvalidValue;
  }
  const auto* len = static_cast<const int32_t*>(lengths);
  auto* pm = static_cast<float*>(part_m);
  auto* pl = static_cast<float*>(part_l);
  auto* pa = static_cast<float*>(part_acc);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(dh, q, k, v, len, pm, pl, pa, out, B, smax, kvh, group, split_len, scale, s);
    case 1: return dispatch<__nv_bfloat16>(dh, q, k, v, len, pm, pl, pa, out, B, smax, kvh, group, split_len, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* decode_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
