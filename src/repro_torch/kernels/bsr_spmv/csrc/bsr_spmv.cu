// Block-ELL semiring SpMV for Hopper (sm_90a), batched over machines.
//
// Replaces the TPU kernel src/repro/kernels/bsr_spmv/kernel.py::spmv_pallas
// (body _make_kernel).  For every machine m and block-row r:
//
//   y[m, r*bm + i] = (+)_k (+)_j  blocks[m, r, k, i, j] (x) x[m, cols[m, r, k]*bm + j]
//
// under (+,x) (semiring 0), (min,+) (semiring 1) or (or,and) over 0/1 floats
// (semiring 2).  y starts at the semiring's zero: 0, +inf, 0.  Padding ELL
// slots point at block-column 0 and hold `absent` blocks, whose products are
// the zero by the annihilator property.
//
// What bounds it: every block cell is read once and used once, so the work
// is p*R*K*bm^2 float32 loads and as many semiring ops; at the slice's size
// (p=9, R=K=251, bm=128) that is 37 GB against 3.35 TB/s of HBM.  The kernel
// is bandwidth-bound, and its design aims only at streaming the blocks:
//
// * grid (row tile, block-row, machine); one warp per output row, kWarps rows
//   per CTA.  The TPU kernel revisits y across a sequential K grid axis; GPU
//   CTAs run in no fixed order, so the K loop runs inside the CTA, in
//   ascending k, and no CTA touches another's y (no atomics);
// * the x slices of kChunk ELL slots are staged in shared memory once per
//   CTA and shared by its warps;
// * lanes read a block row coalesced (float4 when bm % 4 == 0), combine with
//   (x) and fold into a per-lane accumulator under (+); one __shfl_xor_sync
//   tree under (+) at the end combines the lanes.  (min,+) and (or,and) are
//   exact in any order, so they match the plain version bitwise; (+,x)
//   reassociates the sum (and contracts a*x+acc into an FMA);
// * every offset is int64: p*R*K*bm^2 is 9.3e9 elements at the slice's size.
//
// Build without --use_fast_math: flush-to-zero and relaxed inf/NaN handling
// would break the bitwise (min,+) contract.  wgmma, TMA and a sparse-aware
// layout are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;   // output rows (one warp each) per CTA
constexpr int kChunk = 8;   // ELL slots whose x slices are staged together

struct PlusTimes {
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float times(float a, float x) { return a * x; }
  static __device__ __forceinline__ float plus(float a, float b) { return a + b; }
};

// min and max propagate NaN (torch.minimum / jnp.minimum semantics);
// fminf/fmaxf would drop it.
struct MinPlus {
  static __device__ __forceinline__ float zero() { return __int_as_float(0x7f800000); }
  static __device__ __forceinline__ float times(float a, float x) { return a + x; }
  static __device__ __forceinline__ float plus(float a, float b) {
    return (a < b || a != a) ? a : b;
  }
};

struct OrAnd {
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float times(float a, float x) { return a * x; }
  static __device__ __forceinline__ float plus(float a, float b) {
    return (a > b || a != a) ? a : b;
  }
};

template <class S, bool kVec4>
__global__ void __launch_bounds__(kWarps * 32)
bsr_spmv_kernel(const int32_t* __restrict__ cols, const float* __restrict__ blocks,
                const float* __restrict__ x, float* __restrict__ y,
                int64_t R, int64_t K, int64_t C, int bm) {
  extern __shared__ __align__(16) float xs[];  // kChunk * bm staged x values
  const int64_t m = blockIdx.z;
  const int64_t mr = m * R + blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  const bool live = row < bm;
  const int64_t bm2 = static_cast<int64_t>(bm) * bm;
  const int32_t* cols_r = cols + mr * K;
  const float* xm = x + m * C * bm;
  const float* arow = blocks + mr * K * bm2 + static_cast<int64_t>(row) * bm;

  float acc = S::zero();
  for (int64_t k0 = 0; k0 < K; k0 += kChunk) {
    const int nk = static_cast<int>(K - k0 < kChunk ? K - k0 : kChunk);
    __syncthreads();  // every warp is done with the previous chunk
    for (int t = threadIdx.x; t < nk * bm; t += blockDim.x) {
      const int kk = t / bm;
      xs[t] = xm[static_cast<int64_t>(cols_r[k0 + kk]) * bm + (t - kk * bm)];
    }
    __syncthreads();
    if (!live) continue;
    const float* a = arow + k0 * bm2;
#pragma unroll 4
    for (int kk = 0; kk < nk; ++kk) {
      const float* ak = a + kk * bm2;
      const float* xk = xs + kk * bm;
      if (kVec4) {
        for (int j = lane * 4; j < bm; j += 128) {
          const float4 av = __ldcs(reinterpret_cast<const float4*>(ak + j));
          const float4 xv = *reinterpret_cast<const float4*>(xk + j);
          acc = S::plus(acc, S::times(av.x, xv.x));
          acc = S::plus(acc, S::times(av.y, xv.y));
          acc = S::plus(acc, S::times(av.z, xv.z));
          acc = S::plus(acc, S::times(av.w, xv.w));
        }
      } else {
        for (int j = lane; j < bm; j += 32) {
          acc = S::plus(acc, S::times(__ldcs(ak + j), xk[j]));
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = S::plus(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  }
  if (live && lane == 0) y[mr * bm + row] = acc;
}

template <class S>
void launch(bool vec4, dim3 grid, size_t smem, cudaStream_t stream,
            const int32_t* cols, const float* blocks, const float* x, float* y,
            int64_t R, int64_t K, int64_t C, int bm) {
  if (vec4) {
    bsr_spmv_kernel<S, true><<<grid, kWarps * 32, smem, stream>>>(
        cols, blocks, x, y, R, K, C, bm);
  } else {
    bsr_spmv_kernel<S, false><<<grid, kWarps * 32, smem, stream>>>(
        cols, blocks, x, y, R, K, C, bm);
  }
}

}  // namespace

extern "C" {

// cols (p,R,K) int32, blocks (p,R,K,bm,bm) f32, x (p,C*bm) f32 -> y (p,R*bm)
// f32, all contiguous on the current device; launched on `stream`.  The
// caller checks shapes (R, p <= 65535; kChunk*bm*4 bytes <= 48 KiB).
// Returns cudaGetLastError() after the launch (0 on success).
int bsr_spmv_f32(const void* cols, const void* blocks, const void* x, void* y,
                 int64_t p, int64_t R, int64_t K, int64_t C, int64_t bm,
                 int64_t semiring, void* stream) {
  if (p == 0 || R == 0) return cudaSuccess;
  const dim3 grid(static_cast<unsigned>((bm + kWarps - 1) / kWarps),
                  static_cast<unsigned>(R), static_cast<unsigned>(p));
  const size_t smem = static_cast<size_t>(kChunk) * bm * sizeof(float);
  const bool vec4 = bm % 4 == 0 && reinterpret_cast<uintptr_t>(blocks) % 16 == 0;
  const auto* c = static_cast<const int32_t*>(cols);
  const auto* b = static_cast<const float*>(blocks);
  const auto* xv = static_cast<const float*>(x);
  auto* yv = static_cast<float*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  const int bmi = static_cast<int>(bm);
  switch (semiring) {
    case 0: launch<PlusTimes>(vec4, grid, smem, s, c, b, xv, yv, R, K, C, bmi); break;
    case 1: launch<MinPlus>(vec4, grid, smem, s, c, b, xv, yv, R, K, C, bmi); break;
    case 2: launch<OrAnd>(vec4, grid, smem, s, c, b, xv, yv, R, K, C, bmi); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

const char* bsr_spmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
