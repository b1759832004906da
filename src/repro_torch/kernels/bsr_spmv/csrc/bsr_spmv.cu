// Block-ELL semiring SpMV for Hopper (sm_90a), batched over machines.
//
// Replaces the TPU kernel src/repro/kernels/bsr_spmv/kernel.py::spmv_pallas
// (body _make_kernel), in each of its storage types (float32, bfloat16,
// float16: the message dtype of the BSP backends).  For every machine m and
// block-row r:
//
//   y[m, r*bm + i] = (+)_k (+)_j  blocks[m, r, k, i, j] (x) x[m, cols[m, r, k]*bm + j]
//
// under (+,x) (semiring 0), (min,+) (semiring 1) or (or,and) over 0/1 floats
// (semiring 2).  y starts at the semiring's zero: 0, +inf, 0.  Padding ELL
// slots point at block-column 0 and hold `absent` blocks, whose products are
// the zero by the annihilator property.
//
// Rounding follows the reference's Pallas body.  In float32 everything is
// float32.  In a 16-bit type T, (+,x) takes each ELL slot's products and
// their row sum in float32 (the reference's jnp.dot with
// preferred_element_type), rounds that sum once to T, and folds it into a y
// held in T in ascending k, one rounding per slot.  (min,+) and (or,and)
// round each product a (x) x once to T and fold with min/max, which is exact
// in any order.  Blocks and x are widened to float32 in registers; nothing
// is computed in 16-bit arithmetic.
//
// What bounds it: every block cell is read once and used once, so the work
// is p*R*K*bm^2 loads and as many semiring ops; at the slice's size
// (p=9, R=K=251, bm=128) that is 37.2 GB in float32 and 18.6 GB in a 16-bit
// type against 3.35 TB/s of HBM.  The kernel is bandwidth-bound, and its
// design aims only at streaming the blocks:
//
// * grid (row tile, block-row, machine); one warp per output row, kWarps rows
//   per CTA.  The TPU kernel revisits y across a sequential K grid axis; GPU
//   CTAs run in no fixed order, so the K loop runs inside the CTA, in
//   ascending k, and no CTA touches another's y (no atomics);
// * the x slices of kChunk ELL slots are staged in shared memory once per
//   CTA, widened to float32, and shared by its warps;
// * lanes read a block row coalesced, four values a lane (a float4 in
//   float32, a uint2 in 16-bit) when bm % 4 == 0, and combine with (x).
//   Under float32 (+,x), (min,+) and (or,and) each lane folds into its own
//   accumulator and one __shfl_xor_sync tree at the end combines the lanes;
//   (min,+) and (or,and) are exact in any order, so they match the plain
//   version bitwise, and float32 (+,x) reassociates the sum (and contracts
//   a*x+acc into an FMA).  16-bit (+,x) needs each slot's row sum before it
//   rounds, so it runs the xor tree once per slot: every lane then holds the
//   same y;
// * every offset is int64: p*R*K*bm^2 is 9.3e9 elements at the slice's size.
//
// Build without --use_fast_math: flush-to-zero and relaxed inf/NaN handling
// would break the bitwise (min,+) contract and float16 subnormals and
// overflow to inf.  wgmma, TMA and a sparse-aware layout are later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // output rows (one warp each) per CTA
constexpr int kChunk = 8;   // ELL slots whose x slices are staged together

// Storage types: widen to float32, round a float32 to the type (returned as
// the float32 it represents), store, and load four consecutive values.
template <class T>
struct Store;

template <>
struct Store<float> {
  static constexpr bool kNarrow = false;
  static __device__ __forceinline__ float to_float(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float from_float(float v) { return v; }
  static __device__ __forceinline__ float load1(const float* p) { return __ldcs(p); }
  static __device__ __forceinline__ float4 load4(const float* p) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  }
};

template <>
struct Store<__nv_bfloat16> {
  static constexpr bool kNarrow = true;
  static __device__ __forceinline__ float to_float(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float load1(const __nv_bfloat16* p) {
    return __uint_as_float(
        static_cast<uint32_t>(__ldcs(reinterpret_cast<const unsigned short*>(p))) << 16);
  }
  // a bfloat16 is the upper half of the float32 with the same bits
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  }
};

template <>
struct Store<__half> {
  static constexpr bool kNarrow = true;
  static __device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
  static __device__ __forceinline__ float round(float v) {
    return __half2float(__float2half_rn(v));
  }
  static __device__ __forceinline__ __half from_float(float v) { return __float2half_rn(v); }
  static __device__ __forceinline__ float load1(const __half* p) {
    return __half2float(__ushort_as_half(__ldcs(reinterpret_cast<const unsigned short*>(p))));
  }
  static __device__ __forceinline__ float4 load4(const __half* p) {
    const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
    const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
    const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
};

struct PlusTimes {
  static constexpr bool kSum = true;
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float times(float a, float x) { return a * x; }
  static __device__ __forceinline__ float plus(float a, float b) { return a + b; }
};

// min and max propagate NaN (torch.minimum / jnp.minimum semantics);
// fminf/fmaxf would drop it.
struct MinPlus {
  static constexpr bool kSum = false;
  static __device__ __forceinline__ float zero() { return __int_as_float(0x7f800000); }
  static __device__ __forceinline__ float times(float a, float x) { return a + x; }
  static __device__ __forceinline__ float plus(float a, float b) {
    return (a < b || a != a) ? a : b;
  }
};

struct OrAnd {
  static constexpr bool kSum = false;
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float times(float a, float x) { return a * x; }
  static __device__ __forceinline__ float plus(float a, float b) {
    return (a > b || a != a) ? a : b;
  }
};

template <class S>
__device__ __forceinline__ float warp_fold(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = S::plus(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// a (x) x: under (+,x) in float32 (summed before any rounding); under
// (min,+) and (or,and) rounded once to the storage type
template <class S, class St>
__device__ __forceinline__ float product(float a, float x) {
  return S::kSum ? S::times(a, x) : St::round(S::times(a, x));
}

template <class S, class T, bool kVec4>
__global__ void __launch_bounds__(kWarps * 32)
bsr_spmv_kernel(const int32_t* __restrict__ cols, const T* __restrict__ blocks,
                const T* __restrict__ x, T* __restrict__ y,
                int64_t R, int64_t K, int64_t C, int bm) {
  using St = Store<T>;
  // 16-bit (+,x): each slot's row sum is rounded on its own (see the top)
  constexpr bool kSlotSum = S::kSum && St::kNarrow;
  extern __shared__ __align__(16) float xs[];  // kChunk * bm staged x values
  const int64_t m = blockIdx.z;
  const int64_t mr = m * R + blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  const bool live = row < bm;
  const int64_t bm2 = static_cast<int64_t>(bm) * bm;
  const int32_t* cols_r = cols + mr * K;
  const T* xm = x + m * C * bm;
  const T* arow = blocks + mr * K * bm2 + static_cast<int64_t>(row) * bm;

  float acc = S::zero();
  for (int64_t k0 = 0; k0 < K; k0 += kChunk) {
    const int nk = static_cast<int>(K - k0 < kChunk ? K - k0 : kChunk);
    __syncthreads();  // every warp is done with the previous chunk
    for (int t = threadIdx.x; t < nk * bm; t += blockDim.x) {
      const int kk = t / bm;
      xs[t] = St::to_float(xm[static_cast<int64_t>(cols_r[k0 + kk]) * bm + (t - kk * bm)]);
    }
    __syncthreads();
    if (!live) continue;   // warp-uniform: a whole warp skips or stays
    const T* a = arow + k0 * bm2;
#pragma unroll 4
    for (int kk = 0; kk < nk; ++kk) {
      const T* ak = a + kk * bm2;
      const float* xk = xs + kk * bm;
      float part = kSlotSum ? 0.0f : acc;
      if (kVec4) {
        for (int j = lane * 4; j < bm; j += 128) {
          const float4 av = St::load4(ak + j);
          const float4 xv = *reinterpret_cast<const float4*>(xk + j);
          part = S::plus(part, product<S, St>(av.x, xv.x));
          part = S::plus(part, product<S, St>(av.y, xv.y));
          part = S::plus(part, product<S, St>(av.z, xv.z));
          part = S::plus(part, product<S, St>(av.w, xv.w));
        }
      } else {
        for (int j = lane; j < bm; j += 32) {
          part = S::plus(part, product<S, St>(St::load1(ak + j), xk[j]));
        }
      }
      if (kSlotSum) {
        // the slot's row sum in float32, rounded once; the fold rounds once
        acc = St::round(acc + St::round(warp_fold<S>(part)));
      } else {
        acc = part;
      }
    }
  }
  if (!kSlotSum) acc = warp_fold<S>(acc);
  if (live && lane == 0) y[mr * bm + row] = St::from_float(acc);
}

template <class S, class T>
void launch(bool vec4, dim3 grid, size_t smem, cudaStream_t stream, const int32_t* cols,
            const T* blocks, const T* x, T* y, int64_t R, int64_t K, int64_t C, int bm) {
  if (vec4) {
    bsr_spmv_kernel<S, T, true><<<grid, kWarps * 32, smem, stream>>>(cols, blocks, x, y, R, K,
                                                                     C, bm);
  } else {
    bsr_spmv_kernel<S, T, false><<<grid, kWarps * 32, smem, stream>>>(cols, blocks, x, y, R, K,
                                                                      C, bm);
  }
}

template <class T>
int run(const void* cols, const void* blocks, const void* x, void* y, int64_t p, int64_t R,
        int64_t K, int64_t C, int64_t bm, int64_t semiring, void* stream) {
  if (p == 0 || R == 0) return cudaSuccess;
  const dim3 grid(static_cast<unsigned>((bm + kWarps - 1) / kWarps), static_cast<unsigned>(R),
                  static_cast<unsigned>(p));
  const size_t smem = static_cast<size_t>(kChunk) * bm * sizeof(float);
  const bool vec4 =
      bm % 4 == 0 && reinterpret_cast<uintptr_t>(blocks) % (4 * sizeof(T)) == 0;
  const auto* c = static_cast<const int32_t*>(cols);
  const auto* b = static_cast<const T*>(blocks);
  const auto* xv = static_cast<const T*>(x);
  auto* yv = static_cast<T*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  const int bmi = static_cast<int>(bm);
  switch (semiring) {
    case 0: launch<PlusTimes, T>(vec4, grid, smem, s, c, b, xv, yv, R, K, C, bmi); break;
    case 1: launch<MinPlus, T>(vec4, grid, smem, s, c, b, xv, yv, R, K, C, bmi); break;
    case 2: launch<OrAnd, T>(vec4, grid, smem, s, c, b, xv, yv, R, K, C, bmi); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// cols (p,R,K) int32, blocks (p,R,K,bm,bm) T, x (p,C*bm) T -> y (p,R*bm) T,
// all contiguous on the current device; launched on `stream`.  The caller
// checks shapes (R, p <= 65535; kChunk*bm*4 bytes <= 48 KiB).  Each returns
// cudaGetLastError() after the launch (0 on success).
int bsr_spmv_f32(const void* cols, const void* blocks, const void* x, void* y, int64_t p,
                 int64_t R, int64_t K, int64_t C, int64_t bm, int64_t semiring, void* stream) {
  return run<float>(cols, blocks, x, y, p, R, K, C, bm, semiring, stream);
}

int bsr_spmv_bf16(const void* cols, const void* blocks, const void* x, void* y, int64_t p,
                  int64_t R, int64_t K, int64_t C, int64_t bm, int64_t semiring, void* stream) {
  return run<__nv_bfloat16>(cols, blocks, x, y, p, R, K, C, bm, semiring, stream);
}

int bsr_spmv_f16(const void* cols, const void* blocks, const void* x, void* y, int64_t p,
                 int64_t R, int64_t K, int64_t C, int64_t bm, int64_t semiring, void* stream) {
  return run<__half>(cols, blocks, x, y, p, R, K, C, bm, semiring, stream);
}

const char* bsr_spmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
